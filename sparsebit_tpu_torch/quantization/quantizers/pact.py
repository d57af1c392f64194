"""PACT quantizer: a learnable clip alpha, features only, per tensor
(port of ``sparsebit_tpu/quantization/quantizers/pact.py``; reference:
sparsebit/quantization/quantizers/pact.py:12-46). The scale follows the
clip range [-alpha or 0, alpha] with alpha detached; alpha learns through
the clamp (its gradient where x > alpha, PACT's own), the rounding
through fake_quant's STE."""

import torch

from sparsebit_tpu_torch.quantization.common import QuantTarget
from sparsebit_tpu_torch.quantization.fake_quant import fake_quant
from sparsebit_tpu_torch.quantization.observers.base import (
    qparams_from_range,
)
from sparsebit_tpu_torch.quantization.quantizers import register_quantizer
from sparsebit_tpu_torch.quantization.quantizers.base import (
    Quantizer as BaseQuantizer,
    learnable,
)


@register_quantizer
class Quantizer(BaseQuantizer):
    TYPE = "pact"

    def __init__(self, config):
        super().__init__(config)
        assert self.qdesc.target == QuantTarget.FEATURE, (
            "PACT only support feature quantization")
        assert not self.qdesc.is_perchannel, (
            "PACT not yet supports per-channel")
        self.init_alpha_value = config.QUANTIZER.PACT.ALPHA_VALUE
        self.alpha = learnable(float(self.init_alpha_value))

    def calc_qparams(self):
        if self.fake_fused:
            return self.scale, self.zero_point
        scale, zero_point = self.observer.calc_qparams()
        self.scale = self._broadcast_qparams(scale)
        self.zero_point = self._broadcast_qparams(zero_point)
        self.alpha = learnable(float(self.init_alpha_value))
        return self.scale, self.zero_point

    def trainable_params(self):
        return {"alpha": self.alpha}

    def _qparams_preprocess(self, x, params):
        alpha = params.get("alpha", self.alpha) if params else self.alpha
        lower = -alpha if self.qdesc.qmin < 0 else torch.zeros_like(alpha)
        scale, zp = qparams_from_range(lower.detach(), alpha.detach(),
                                       *self.qdesc.qrange, self.is_symmetric)
        self._clip = (lower, alpha)
        return scale, zp

    def _forward(self, x, scale, zero_point, params=None):
        lower, alpha = self._clip
        x_clamp = torch.minimum(torch.maximum(x, lower), alpha)
        return fake_quant(x_clamp, scale, zero_point, self.qdesc.qmin,
                          self.qdesc.qmax)
