"""Parallelism on torch.distributed (port of ``sparsebit_tpu/parallel``):
the device mesh and data-parallel helpers (``mesh``), process-group setup
(``multihost``) and tensor parallelism for LLaMA serving (``tp``).

One process per rank: each rank holds its own weight and KV-head shards
and runs the per-rank body, with explicit collectives where the JAX
package's ``shard_map`` bodies psum, all_gather and pmax. The backend is
the caller's (``multihost.initialize_multihost``: NCCL on ``cuda``, gloo
on ``cpu`` or when named), never switched behind its back.
"""

from sparsebit_tpu_torch.parallel.mesh import (  # noqa: F401
    dp_shard_batch,
    make_mesh,
)
from sparsebit_tpu_torch.parallel.tp import (  # noqa: F401
    shard_llama_params_tp,
    tp_llama_forward,
    tp_llama_loss,
)
