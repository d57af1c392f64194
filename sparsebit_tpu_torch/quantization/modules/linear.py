"""Quantized linear (port of ``sparsebit_tpu/quantization/modules/
linear.py``; reference: sparsebit/quantization/modules/linear.py:8)."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr


@register_qmodule(sources=[nn.Linear])
class QLinear(QuantOpr):
    WEIGHT_QUANT = True
    W_CH_AXIS = 0  # (out, in) weight: out channels (JAX package: 1)
