"""LSQ+ quantizer, learnable scale and zero point (port of
``sparsebit_tpu/quantization/quantizers/lsq_plus.py``; reference:
sparsebit/quantization/quantizers/lsq_plus.py:13-82). Weights: per
channel, symmetric, scale from max |mean -+ 3 std| (the population std);
activations: per tensor, affine, scale and zero point from the observer
and both learned; gradients scaled as LSQ's."""

import math

import torch

from sparsebit_tpu_torch.quantization.common import Granularity, div_exact
from sparsebit_tpu_torch.quantization.fake_quant import fake_quant, grad_scale
from sparsebit_tpu_torch.quantization.quantizers import register_quantizer
from sparsebit_tpu_torch.quantization.quantizers.base import (
    Quantizer as BaseQuantizer,
    learnable,
)


@register_quantizer
class Quantizer(BaseQuantizer):
    TYPE = "lsq+"

    def __init__(self, config):
        super().__init__(config)
        self.init_params = False
        self._zp_learnable = False

    def calc_qparams(self):
        if self.fake_fused:
            return self.scale, self.zero_point
        if not self.init_params:
            qmin, qmax = self.qdesc.qrange
            if self.is_perchannel:
                x_oc = self.observer.data_cache.get_data_for_calibration(
                    Granularity.CHANNELWISE)
                assert self.is_symmetric, (
                    "LSQ+ only support per-channel-symmetric quant for "
                    "weight")
                mean = x_oc.mean(dim=1)
                std = x_oc.std(dim=1, correction=0)
                scale = div_exact(2 * torch.maximum(
                    (mean - 3 * std).abs(), (mean + 3 * std).abs()),
                    qmax - qmin)
                self.observer.data_cache.reset()
                self.scale = learnable(self._broadcast_qparams(scale))
                self.zero_point = self.scale.detach().new_zeros(
                    self.scale.shape)
                self._zp_learnable = False
            else:
                assert not self.is_symmetric, (
                    "LSQ+ only support per-tensor-affine quant for "
                    "activation")
                scale, zero_point = self.observer.calc_qparams()
                self.scale = learnable(self._broadcast_qparams(scale))
                self.zero_point = learnable(self._broadcast_qparams(
                    torch.clamp(zero_point, qmin, qmax)))
                self._zp_learnable = True
            self.init_params = True
        return self.scale, self.zero_point

    def trainable_params(self):
        out = {"scale": self.scale}
        if self._zp_learnable:
            out["zero_point"] = self.zero_point
        return out

    def _qparams_preprocess(self, x, params):
        scale = params.get("scale", self.scale) if params else self.scale
        zp = (params.get("zero_point", self.zero_point) if params
              else self.zero_point)
        return scale.abs(), zp.clamp(self.qdesc.qmin, self.qdesc.qmax)

    def _forward(self, x, scale, zero_point, params=None):
        n = self._grad_elements(x)
        ratio = 1.0 / math.sqrt(n * self.qdesc.qmax)
        scale = grad_scale(scale, ratio)
        if self._zp_learnable:
            zero_point = grad_scale(zero_point, ratio)
        return fake_quant(x, scale, zero_point, self.qdesc.qmin,
                          self.qdesc.qmax)
