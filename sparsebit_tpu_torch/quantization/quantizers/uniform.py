"""Uniform (pure STE) quantizer (port of
``sparsebit_tpu/quantization/quantizers/uniform.py``; reference:
quantizers/uniform.py:7-16)."""

from sparsebit_tpu_torch.quantization.quantizers import register_quantizer
from sparsebit_tpu_torch.quantization.quantizers.base import (
    Quantizer as BaseQuantizer,
)


@register_quantizer
class Quantizer(BaseQuantizer):
    TYPE = "uniform"
