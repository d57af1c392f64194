"""Quantized conv ops (port of ``sparsebit_tpu/quantization/modules/
conv.py``; reference: sparsebit/quantization/modules/conv.py:8-82). The
port's weights are OIHW and (in, out // groups, kh, kw), so the weight
channel axis is 0 for both (the JAX package's HWIO puts it at 3)."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr


@register_qmodule(sources=[nn.Conv2d])
class QConv2d(QuantOpr):
    WEIGHT_QUANT = True
    W_CH_AXIS = 0  # OIHW: out channels


@register_qmodule(sources=[nn.ConvTranspose2d])
class QConvTranspose2d(QuantOpr):
    WEIGHT_QUANT = True
    W_CH_AXIS = 0  # (in, out // groups, kh, kw): the reference's axis 0
