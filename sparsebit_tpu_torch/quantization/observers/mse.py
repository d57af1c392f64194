"""MSE observer: an 80-step shrink-grid search for the range of least
fake-quantization MSE (port of
``sparsebit_tpu/quantization/observers/mse.py``; reference:
sparsebit/quantization/observers/mse.py:28-63).

Shrink p = 1 - 0.01 i, i < 80, per channel (or for the whole tensor):
qparams of [p * min, p * max], the mean squared error of fake_quant, and
the first p of least error kept. The JAX package runs the search under
jit, where XLA makes each divide by a constant (the code range, the
row length of the mean) a multiply by its reciprocal; the port does the
same, so that the candidates' qparams are the same numbers.
"""

import torch

from sparsebit_tpu_torch.quantization.common import Granularity
from sparsebit_tpu_torch.quantization.fake_quant import fake_quant
from sparsebit_tpu_torch.quantization.observers import register_observer
from sparsebit_tpu_torch.quantization.observers.base import (
    Observer as BaseObserver,
    qparams_from_range,
)


def _mse_grid_search(data, min_val, max_val, qmin, qmax, symmetric):
    """data (C, N); min/max (C,). Returns the best (scale, zero_point) of
    each row."""
    C, N = data.shape
    best_scale = torch.ones((C,), dtype=torch.float32, device=data.device)
    best_zp = torch.zeros_like(best_scale)
    best_loss = torch.full_like(best_scale, 1e10)
    shrinks = 1.0 - torch.arange(80, dtype=torch.float32,
                                 device=data.device) * 0.01
    for shrink in shrinks:
        scale, zp = qparams_from_range(min_val * shrink, max_val * shrink,
                                       qmin, qmax, symmetric, inv=True)
        dq = fake_quant(data, scale[:, None], zp[:, None], qmin, qmax)
        loss = ((data - dq) ** 2).sum(dim=-1) * (1.0 / N)
        better = loss < best_loss
        best_scale = torch.where(better, scale, best_scale)
        best_zp = torch.where(better, zp, best_zp)
        best_loss = torch.where(better, loss, best_loss)
    return best_scale, best_zp


@register_observer
class Observer(BaseObserver):
    TYPE = "mse"

    def calc_minmax(self, data_c_first):
        if self.is_perchannel:
            min_val = data_c_first.amin(dim=1)
            max_val = data_c_first.amax(dim=1)
        else:
            min_val, max_val = data_c_first.min(), data_c_first.max()
        self.min_val, self.max_val = min_val, max_val
        return min_val, max_val

    def calc_qparams(self):
        data_c_first = self.data_cache.get_data_for_calibration(
            Granularity.CHANNELWISE)
        self.data_cache.reset()
        min_val, max_val = self.calc_minmax(data_c_first)
        qmin, qmax = self.qdesc.qrange
        with torch.no_grad():
            if self.is_perchannel:
                return _mse_grid_search(data_c_first, min_val, max_val,
                                        qmin, qmax, self.is_symmetric)
            scale, zp = _mse_grid_search(
                data_c_first.reshape(1, -1), min_val.reshape(1),
                max_val.reshape(1), qmin, qmax, self.is_symmetric)
        return scale[0], zp[0]
