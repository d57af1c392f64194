"""Quantized resize ops (port of ``sparsebit_tpu/quantization/modules/
resize.py``; reference: sparsebit/quantization/modules/resize.py:16-24):
nearest -> the input quantizer fake-fused; other modes force 8-bit input
quantization."""

from sparsebit_tpu_torch.nn import functional as F
from sparsebit_tpu_torch.nn import modules as nn
from sparsebit_tpu_torch.quantization.modules import register_qmodule
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr


class _ResizeQuantMixin:
    def build_quantizer(self, config):
        super().build_quantizer(config)
        mode = getattr(self.module, "mode", None)
        if self.input_quantizer is not None:
            if mode == "nearest":
                self.input_quantizer.set_fake_fused()
            elif self.input_quantizer.bit < 8:
                self.input_quantizer.set_bit(8)


@register_qmodule(sources=[nn.Upsample])
class QUpsample(_ResizeQuantMixin, QuantOpr):
    pass


@register_qmodule(sources=[F.Interpolate])
class QInterpolate(_ResizeQuantMixin, QuantOpr):
    def build_quantizer(self, config):
        QuantOpr.build_quantizer(self, config)
        if self.input_quantizer is not None and self.input_quantizer.bit < 8:
            self.input_quantizer.set_bit(8)
