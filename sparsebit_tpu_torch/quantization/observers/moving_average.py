"""Moving-average (EMA) observer, features only (port of
``sparsebit_tpu/quantization/observers/moving_average.py``; reference:
sparsebit/quantization/observers/moving_average.py:19-34): the running
min and max start at the first sample's and move by ema_ratio over every
later sample, batch after batch."""

from sparsebit_tpu_torch.quantization.common import QuantTarget
from sparsebit_tpu_torch.quantization.observers import register_observer
from sparsebit_tpu_torch.quantization.observers.base import (
    Observer as BaseObserver,
)


@register_observer
class Observer(BaseObserver):
    TYPE = "moving_average"

    def __init__(self, config, qdesc):
        super().__init__(config, qdesc)
        assert self.qdesc.target == QuantTarget.FEATURE, (
            "Moving_average observer only support feature observing!")
        self.ema_ratio = config.OBSERVER.MOVING_AVERAGE.EMA_RATIO

    def calc_minmax(self):
        data = self.data_cache.get_data_cache()
        self.data_cache.reset()
        ratio = self.ema_ratio
        max_val = min_val = None
        for batch in data:
            if self.qdesc.bs_axis > 0:
                batch = batch.transpose(0, self.qdesc.bs_axis)
            flat = batch.reshape(batch.shape[0], -1)
            smax, smin = flat.amax(dim=-1), flat.amin(dim=-1)
            start = 0
            if max_val is None:
                max_val, min_val, start = smax[0], smin[0], 1
            for i in range(start, smax.shape[0]):
                max_val = ratio * max_val + (1 - ratio) * smax[i]
                min_val = ratio * min_val + (1 - ratio) * smin[i]
        self.min_val, self.max_val = min_val, max_val
        return min_val, max_val
