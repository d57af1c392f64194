"""Quantized activations (port of
``sparsebit_tpu/quantization/modules/activations.py``; reference:
sparsebit/quantization/modules/activations.py:9-233). ``F.relu`` and
``nn.ReLU`` lower to the same op-module, so both become a QReLU."""

from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr


@register_qmodule(sources=[nn.ReLU])
class QReLU(QuantOpr):
    pass


@register_qmodule(sources=[nn.ReLU6])
class QReLU6(QuantOpr):
    pass


@register_qmodule(sources=[nn.LeakyReLU])
class QLeakyReLU(QuantOpr):
    pass


@register_qmodule(sources=[nn.Sigmoid])
class QSigmoid(QuantOpr):
    pass


@register_qmodule(sources=[nn.SiLU])
class QSiLU(QuantOpr):
    pass


@register_qmodule(sources=[nn.GELU])
class QGELU(QuantOpr):
    pass


@register_qmodule(sources=[nn.Mish])
class QMish(QuantOpr):
    pass


@register_qmodule(sources=[nn.Hardsigmoid])
class QHardsigmoid(QuantOpr):
    pass


@register_qmodule(sources=[nn.Tanh])
class QTanh(QuantOpr):
    pass
