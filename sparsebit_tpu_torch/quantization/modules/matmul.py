"""Quantized matmul, multi-input: both operands get QIdentity quantizers
(port of ``sparsebit_tpu/quantization/modules/matmul.py``; reference:
sparsebit/quantization/modules/matmul.py:8)."""

from sparsebit_tpu_torch.nn import functional as F
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import (
    MultipleInputsQuantOpr,
)


@register_qmodule(sources=[F.MatMul])
class MatMul(MultipleInputsQuantOpr):
    pass
