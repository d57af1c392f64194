"""MinMax observer (port of
``sparsebit_tpu/quantization/observers/minmax.py``; reference:
sparsebit/quantization/observers/minmax.py:7-25)."""

from sparsebit_tpu_torch.quantization.common import Granularity
from sparsebit_tpu_torch.quantization.observers import register_observer
from sparsebit_tpu_torch.quantization.observers.base import (
    Observer as BaseObserver,
)


@register_observer
class Observer(BaseObserver):
    TYPE = "minmax"

    def calc_minmax(self):
        if self.is_perchannel:
            data = self.data_cache.get_data_for_calibration(
                Granularity.CHANNELWISE)
            min_val, max_val = data.amin(dim=1), data.amax(dim=1)
        else:
            data = self.data_cache.get_data_for_calibration(
                Granularity.LAYERWISE)
            min_val, max_val = data.min(), data.max()
        self.data_cache.reset()
        self.min_val, self.max_val = min_val, max_val
        return min_val, max_val
