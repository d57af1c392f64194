"""Quantized elementwise math ops (port of
``sparsebit_tpu/quantization/modules/math.py``; reference:
sparsebit/quantization/modules/math.py:12-84)."""

from sparsebit_tpu_torch.nn import functional as F
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import (
    MultipleInputsQuantOpr,
    QuantOpr,
)


@register_qmodule(sources=[F.Add])
class QAdd(MultipleInputsQuantOpr):
    """Input quantization gated by A.QADD.ENABLE_QUANT (math.py:12-26)."""

    @staticmethod
    def input_quant_enabled(config):
        return bool(config.A.QADD.ENABLE_QUANT)


@register_qmodule(sources=[F.Subtract])
class QSubtract(MultipleInputsQuantOpr):
    pass


@register_qmodule(sources=[F.Mul])
class QMul(MultipleInputsQuantOpr):
    pass


@register_qmodule(sources=[F.Divide])
class QDivide(MultipleInputsQuantOpr):
    pass


@register_qmodule(sources=[F.FloorDiv])
class QFloorDiv(MultipleInputsQuantOpr):
    pass


@register_qmodule(sources=[F.Mean])
class QMean(QuantOpr):
    pass
