"""ACIQ observer: analytic clipping under a Gaussian or Laplace
assumption (port of ``sparsebit_tpu/quantization/observers/aciq.py``;
reference: sparsebit/quantization/observers/aciq.py:9-124: the alpha
tables per bit, half-range detection, a feature's element count per
sample)."""

import math

import torch

from sparsebit_tpu_torch.quantization.common import (
    Granularity,
    QuantTarget,
    div_exact,
)
from sparsebit_tpu_torch.quantization.observers import register_observer
from sparsebit_tpu_torch.quantization.observers.base import (
    Observer as BaseObserver,
)

ALPHA_GAUS = {1: 1.24, 2: 1.71, 3: 2.15, 4: 2.55, 5: 2.93, 6: 3.28, 7: 3.61,
              8: 3.92}
ALPHA_GAUS_POSITIVE = {1: 1.71, 2: 2.15, 3: 2.55, 4: 2.93, 5: 3.28, 6: 3.61,
                       7: 3.92, 8: 4.2}
ALPHA_LAPLACE = {0: 1.05, 1: 1.86, 2: 2.83, 3: 3.89, 4: 5.03, 5: 6.2,
                 6: 7.41, 7: 8.64, 8: 9.89}
ALPHA_LAPLACE_POSITIVE = {0: 1.86, 1: 2.83, 2: 3.89, 3: 5.02, 4: 6.2,
                          5: 7.41, 6: 8.64, 7: 9.89, 8: 11.16}
GAUS_CONST = (0.5 * 0.35) * (1 + (math.pi * math.log(4)) ** 0.5)


@register_observer
class Observer(BaseObserver):
    TYPE = "aciq"

    def __init__(self, config, qdesc):
        super().__init__(config, qdesc)
        self.distribution = config.OBSERVER.ACIQ.DISTRIBUTION.lower()
        assert self.distribution in ("gaus", "laplace"), (
            "ACIQ distribution must be 'gaus' or 'laplace', got {!r}".format(
                self.distribution))

    def calc_laplace_minmax(self):
        if self.is_perchannel:
            data = self.data_cache.get_data_for_calibration(
                Granularity.CHANNELWISE)
            b = (data - data.mean(dim=1, keepdim=True)).abs().mean(dim=1)
        else:
            data = self.data_cache.get_data_for_calibration(
                Granularity.LAYERWISE)
            b = (data - data.mean()).abs().mean()
        is_half_range = bool(data.min() >= 0)
        self.data_cache.reset()
        if not self.qdesc.is_symmetric and is_half_range:
            max_val = ALPHA_LAPLACE_POSITIVE[self.qdesc.bit] * b
            min_val = torch.zeros_like(max_val)
        else:
            max_val = ALPHA_LAPLACE[self.qdesc.bit] * b
            min_val = -max_val
        return min_val, max_val

    def calc_gaus_minmax(self):
        batch_size = None
        if self.qdesc.target == QuantTarget.FEATURE:
            batch_size = self.data_cache.get_batch_size()
        if self.is_perchannel:
            data = self.data_cache.get_data_for_calibration(
                Granularity.CHANNELWISE)
            max_val, min_val = data.amax(dim=1), data.amin(dim=1)
        else:
            data = self.data_cache.get_data_for_calibration(
                Granularity.LAYERWISE)
            max_val, min_val = data.max(), data.min()
        is_half_range = bool(data.min() >= 0)
        num_elements = data.numel()
        self.data_cache.reset()
        if self.qdesc.target == QuantTarget.FEATURE:
            num_elements /= batch_size
        std = div_exact((max_val - min_val) * GAUS_CONST,
                        (2 * math.log(num_elements)) ** 0.5)
        if not self.qdesc.is_symmetric and is_half_range:
            max_val = ALPHA_GAUS_POSITIVE[self.qdesc.bit] * std
            min_val = torch.zeros_like(max_val)
        else:
            max_val = ALPHA_GAUS[self.qdesc.bit] * std
            min_val = -max_val
        return min_val, max_val

    def calc_minmax(self):
        if self.distribution == "laplace":
            min_val, max_val = self.calc_laplace_minmax()
        else:
            min_val, max_val = self.calc_gaus_minmax()
        self.min_val, self.max_val = min_val, max_val
        return min_val, max_val
