"""The pruning regime of the port (port of ``sparsebit_tpu/sparse``;
reference: sparsebit/sparse/): the config tree (``parse_sconfig``), the
sparsers that turn a weight into a {0, 1} mask (``sparsers``), the
SModules that multiply their wrapped op's weight by it (``modules``) and
``SparseModel``, which traces a model of ``sparsebit_tpu_torch.nn`` and
runs the flow. Masks are elementwise PyTorch and the masked ops are
PyTorch calls: the JAX package has no Pallas kernel on this regime."""

from sparsebit_tpu_torch.sparse.sparse_config import (  # noqa: F401
    parse_sconfig,
)
from sparsebit_tpu_torch.sparse.sparse_model import (  # noqa: F401
    SparseModel,
)
