"""Quantized pooling (port of ``sparsebit_tpu/quantization/modules/
pool.py``; MaxPool2d passes through unquantized)."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr


@register_qmodule(sources=[nn.AvgPool2d])
class QAvgPool2d(QuantOpr):
    pass


@register_qmodule(sources=[nn.AdaptiveAvgPool2d])
class QAdaptiveAvgPool2d(QuantOpr):
    pass
