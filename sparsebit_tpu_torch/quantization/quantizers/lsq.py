"""LSQ quantizer, Learned Step-size Quantization (port of
``sparsebit_tpu/quantization/quantizers/lsq.py``; reference:
sparsebit/quantization/quantizers/lsq.py:13-76). The scale is initialised
from the calibration data as 2 mean|x| / sqrt(qmax), learned, and its
gradient scaled by 1 / sqrt(N qmax) (grad_scale, N the elements a
channel or the tensor's)."""

import math
import warnings

from sparsebit_tpu_torch.quantization.common import Granularity, div_exact
from sparsebit_tpu_torch.quantization.fake_quant import fake_quant, grad_scale
from sparsebit_tpu_torch.quantization.quantizers import register_quantizer
from sparsebit_tpu_torch.quantization.quantizers.base import (
    Quantizer as BaseQuantizer,
    learnable,
)


@register_quantizer
class Quantizer(BaseQuantizer):
    TYPE = "lsq"

    def __init__(self, config):
        super().__init__(config)
        self.init_params = False  # LSQ initialises from calibration data

    def calc_qparams(self):
        if self.fake_fused:
            return self.scale, self.zero_point
        if not self.init_params:
            x_oc = self.observer.data_cache.get_data_for_calibration(
                Granularity.CHANNELWISE)
            if float(x_oc.min()) < 0 and not self.qdesc.is_symmetric:
                warnings.warn(
                    "Found data less than 0, reset quantizer scheme as "
                    "symmetric")
                self.qdesc.set_symmetric(True)
            root = math.sqrt(self.qdesc.qmax)
            if self.is_perchannel:
                scale = div_exact(2 * x_oc.abs().mean(dim=1), root)
            else:
                scale = div_exact(2 * x_oc.abs().mean(), root)
            self.observer.data_cache.reset()
            self.scale = learnable(self._broadcast_qparams(scale))
            self.zero_point = self.scale.detach().new_zeros(self.scale.shape)
            self.init_params = True
        return self.scale, self.zero_point

    def trainable_params(self):
        return {"scale": self.scale}

    def _qparams_preprocess(self, x, params):
        scale = params.get("scale", self.scale) if params else self.scale
        zp = self.zero_point.clamp(self.qdesc.qmin, self.qdesc.qmax)
        return scale.abs(), zp

    def _forward(self, x, scale, zero_point, params=None):
        n = self._grad_elements(x)
        scale = grad_scale(scale, 1.0 / math.sqrt(n * self.qdesc.qmax))
        return fake_quant(x, scale, zero_point, self.qdesc.qmin,
                          self.qdesc.qmax)
