"""Observer base and DataCache (port of
``sparsebit_tpu/quantization/observers/base.py``; reference:
sparsebit/quantization/observers/base.py:7-87). The cache keeps the
observed tensors where they are (the card or the CPU) and flattens them
per channel or per layer on demand; the statistics are torch ops on that
device."""

import torch

from sparsebit_tpu_torch.quantization.common import (
    Granularity,
    QuantTarget,
    div_exact,
)


class DataCache:
    def __init__(self, qdesc):
        self.qdesc = qdesc
        self._data_cache = []

    def update(self, data):
        self._data_cache.append(torch.as_tensor(data).detach())

    def reset(self):
        self._data_cache = []

    def __len__(self):
        return len(self._data_cache)

    def get_data_for_calibration(self, granularity):
        """The cache as (C, N) for CHANNELWISE (concatenated along ch_axis,
        which is swapped to the front, the rest flattened) or (N,) for
        LAYERWISE (observers/base.py:21-36)."""
        assert len(self._data_cache), "No data cached!"
        assert granularity in (Granularity.LAYERWISE, Granularity.CHANNELWISE)
        if granularity == Granularity.LAYERWISE:
            return torch.cat([d.reshape(-1) for d in self._data_cache])
        ch_axis = self.qdesc.ch_axis
        if ch_axis >= self._data_cache[0].dim():
            # channels-last layouts on lower-rank data (a pooled (B, C) fc
            # input): the channel axis is the last one
            ch_axis = self._data_cache[0].dim() - 1
        data = torch.cat(self._data_cache, dim=ch_axis)
        if ch_axis != 0:
            data = data.transpose(0, ch_axis)
        return data.reshape(data.shape[0], -1)

    def get_batch_size(self):
        if self.qdesc.target == QuantTarget.WEIGHT:
            return None
        return sum(int(d.shape[self.qdesc.bs_axis]) for d in self._data_cache)

    def get_data_cache(self):
        assert len(self._data_cache), "No data cached!"
        return self._data_cache


def qparams_from_range(min_val, max_val, qmin, qmax, symmetric, inv=False):
    """scale and zero point of the range [min_val, max_val] widened to
    hold 0 (observers/base.py:63-79, scale >= 1e-6). ``inv`` divides by
    the code range as a multiply by its reciprocal, which is what XLA runs
    for the JAX package's jitted callers (the MSE search); eager callers
    divide (div_exact)."""
    min_neg = torch.clamp(min_val, max=0.0)
    max_pos = torch.clamp(max_val, min=0.0)
    span = float(qmax - qmin)

    def per_code(v):
        return v * (1.0 / span) if inv else div_exact(v, span)

    if symmetric:
        max_pos = torch.maximum(-min_neg, max_pos)
        scale = torch.clamp(per_code(max_pos * 2.0), min=1e-6)
        return scale, torch.zeros_like(scale)
    scale = torch.clamp(per_code(max_pos - min_neg), min=1e-6)
    return scale, torch.round(-min_neg / scale)


class Observer:
    TYPE = "base"

    def __init__(self, config, qdesc):
        self.cfg = config
        self.qdesc = qdesc
        self.min_val = None
        self.max_val = None
        self.data_cache = DataCache(qdesc)

    def update(self, data):
        self.data_cache.update(data)

    def calc_minmax(self):
        raise NotImplementedError

    def calc_qparams(self):
        min_val, max_val = self.calc_minmax()
        return self.calc_qparams_with_minmax(min_val, max_val)

    def calc_qparams_with_minmax(self, min_val, max_val):
        min_val = torch.as_tensor(min_val, dtype=torch.float32)
        max_val = torch.as_tensor(max_val, dtype=torch.float32)
        return qparams_from_range(min_val, max_val, *self.qdesc.qrange,
                                  self.is_symmetric)

    @property
    def is_perchannel(self):
        return self.qdesc.is_perchannel

    @property
    def is_symmetric(self):
        return self.qdesc.is_symmetric
