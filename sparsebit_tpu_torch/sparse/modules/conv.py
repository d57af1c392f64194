"""Sparse conv (port of ``sparsebit_tpu/sparse/modules/conv.py``;
reference: sparsebit/sparse/modules/conv.py:8-44). The port's conv
weight is OIHW, so its out channels are axis 0 (the JAX package's HWIO:
3); a grouped or depthwise conv masks its out channels the same way."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.sparse.modules import register_smodule
from sparsebit_tpu_torch.sparse.modules.base import SparseOpr


@register_smodule(sources=[nn.Conv2d])
class SConv2d(SparseOpr):
    HAS_WEIGHT = True
    W_CH_AXIS = 0  # OIHW
