"""DoReFa quantizer: tanh-normalise, then STE fake quantization (port of
``sparsebit_tpu/quantization/quantizers/dorefa.py``; reference:
sparsebit/quantization/quantizers/dorefa.py:8-27). The observer sees the
normalised tensor."""

import torch

from sparsebit_tpu_torch.quantization.fake_quant import fake_quant
from sparsebit_tpu_torch.quantization.quantizers import register_quantizer
from sparsebit_tpu_torch.quantization.quantizers.base import (
    Quantizer as BaseQuantizer,
)


def _normalised(x):
    t = torch.tanh(x)
    return t / t.abs().max().detach()


@register_quantizer
class Quantizer(BaseQuantizer):
    TYPE = "dorefa"

    def _forward(self, x, scale, zero_point, params=None):
        return fake_quant(_normalised(x), self.scale, self.zero_point,
                          self.qdesc.qmin, self.qdesc.qmax)

    def update_observer(self, x):
        self.dims = x.dim()
        self.observer.update(_normalised(x.detach()))
