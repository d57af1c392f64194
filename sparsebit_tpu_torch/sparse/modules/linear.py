"""Sparse linear (port of ``sparsebit_tpu/sparse/modules/linear.py``;
reference: sparsebit/sparse/modules/linear.py:8-35). The port's linear
weight is (out, in), so its out channels are axis 0 (the JAX package's
(in, out): 1)."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.sparse.modules import register_smodule
from sparsebit_tpu_torch.sparse.modules.base import SparseOpr


@register_smodule(sources=[nn.Linear])
class SLinear(SparseOpr):
    HAS_WEIGHT = True
    W_CH_AXIS = 0  # (out, in)
