"""Parallelism on torch.distributed (port of ``sparsebit_tpu/parallel``):
the device mesh and data-parallel helpers (``mesh``), process-group setup
(``multihost``), tensor parallelism for LLaMA serving and training
(``tp``), sequence parallelism (``sp``), GPipe pipeline parallelism with
pipelined QLoRA (``pp``) and the multichip dry run (``dryrun``).

One process per rank: each rank holds its own weight and KV-head shards
or pipeline stage and runs the per-rank body, with explicit collectives
where the JAX package's ``shard_map`` bodies psum, all_gather, pmax and
ppermute. Every collective is differentiable, its backward chosen for
how the ranks use its result (``tp``'s collectives section): after one
step's backward each rank holds its share of each gradient, and
``mesh.sum_grads`` (``pp.pp_sum_grads``) makes it the unsharded model's.
The backend is the caller's (``multihost.initialize_multihost``: NCCL on
``cuda``, gloo on ``cpu`` or when named), never switched behind its back.
"""

from sparsebit_tpu_torch.parallel.mesh import (  # noqa: F401
    dp_shard_batch,
    make_mesh,
    sum_grads,
)
from sparsebit_tpu_torch.parallel.pp import (  # noqa: F401
    densify_llama_params,
    pp_extract_lora,
    pp_llama_loss,
    pp_merge_lora,
    pp_qlora_loss,
    pp_qlora_train_step,
    pp_tp_llama_loss,
    pp_tp_qlora_loss,
    stack_llama_stages,
)
from sparsebit_tpu_torch.parallel.sp import sp_llama_loss  # noqa: F401
from sparsebit_tpu_torch.parallel.tp import (  # noqa: F401
    shard_llama_params_tp,
    tp_llama_forward,
    tp_llama_loss,
)
