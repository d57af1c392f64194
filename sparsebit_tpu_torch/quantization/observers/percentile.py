"""Percentile observer: clips an alpha fraction of each tail (port of
``sparsebit_tpu/quantization/observers/percentile.py``; reference:
sparsebit/quantization/observers/percentile.py:16-46, a per-channel
kthvalue over the positive and the negative values).

One sort of every channel and a gather replace the per-channel loop, as
in the JAX package: max = the (n - round(pos * alpha))-th smallest value,
min = the max(round(neg * alpha), 1)-th, pos and neg counting the values
>= 0 and < 0. A sort, not ``torch.quantile``, which refuses inputs of
more than 2^24 elements (a 7B weight has 45M).
"""

import torch

from sparsebit_tpu_torch.quantization.common import Granularity
from sparsebit_tpu_torch.quantization.observers import register_observer
from sparsebit_tpu_torch.quantization.observers.base import (
    Observer as BaseObserver,
)


@register_observer
class Observer(BaseObserver):
    TYPE = "percentile"

    def __init__(self, config, qdesc):
        super().__init__(config, qdesc)
        self.alpha = config.OBSERVER.PERCENTILE.ALPHA

    def calc_minmax(self):
        if self.is_perchannel:
            data = self.data_cache.get_data_for_calibration(
                Granularity.CHANNELWISE)
        else:
            data = self.data_cache.get_data_for_calibration(
                Granularity.LAYERWISE).reshape(1, -1)
        self.data_cache.reset()
        n = data.shape[1]
        neg_length = (data < 0).sum(dim=-1)
        pos_length = (data >= 0).sum(dim=-1)
        data_sorted = torch.sort(data, dim=-1).values
        # kthvalue(x, k) == sorted[k - 1] (percentile.py:33-43)
        k_max = n - torch.clamp(
            torch.round(pos_length.to(torch.float32) * self.alpha),
            min=0).to(torch.long)
        k_min = torch.clamp(
            torch.round(neg_length.to(torch.float32) * self.alpha),
            min=1).to(torch.long)
        max_val = torch.gather(
            data_sorted, 1, torch.clamp(k_max - 1, 0, n - 1)[:, None])[:, 0]
        min_val = torch.gather(
            data_sorted, 1, torch.clamp(k_min - 1, 0, n - 1)[:, None])[:, 0]
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        max_val = torch.where(pos_length > 0, max_val, zero)
        min_val = torch.where(neg_length > 0, min_val, zero)
        if not self.is_perchannel:
            min_val, max_val = min_val[0], max_val[0]
        self.min_val, self.max_val = min_val, max_val
        return min_val, max_val
