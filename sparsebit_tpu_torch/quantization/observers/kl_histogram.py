"""KL-histogram (entropy) observer, TensorRT-style calibration (port of
``sparsebit_tpu/quantization/observers/kl_histogram.py``; reference:
sparsebit/quantization/observers/kl_histogram.py:15-151).

``calc_minmax`` runs the search on the data's device
(``kl_device.kl_thresholds_device``). ``_kl_divergences`` and
``kl_thresholds`` stay in numpy, as the oracle the tests hold the device
search to. The indexing is the standard TensorRT one (divergence indexed
by the candidate half-width, threshold = (i + 0.5) * bin width), as in the
JAX package.
"""

import numpy as np
import torch

from sparsebit_tpu_torch.quantization.common import Granularity
from sparsebit_tpu_torch.quantization.observers import register_observer
from sparsebit_tpu_torch.quantization.observers.base import (
    Observer as BaseObserver,
)
from sparsebit_tpu_torch.quantization.observers.kl_device import (
    kl_thresholds_device,
)


def _kl_divergences(hist, dst_bins):
    """hist: (C, src_bins) histograms centred on 0. Returns (C,
    n_candidates) KL divergences for the half-widths i in [dst_bins // 2,
    src_bins // 2); candidate i keeps bins [zero - i, zero + i + 1)."""
    c, src_bins = hist.shape
    zero = src_bins // 2
    half_dst = dst_bins // 2
    candidates = range(half_dst, zero)
    divergences = np.full((c, len(candidates)), np.inf, dtype=np.float64)
    for ci, i in enumerate(candidates):
        lo, hi = zero - i, zero + i + 1
        n = hi - lo
        p = hist[:, lo:hi].astype(np.float64).copy()
        # outliers are absorbed into the edge bins
        p[:, 0] += hist[:, :lo].sum(axis=1)
        p[:, -1] += hist[:, hi:].sum(axis=1)
        sliced = hist[:, lo:hi].astype(np.float64)
        nm = n // dst_bins
        if nm == 0:
            continue
        # merge into dst_bins coarse bins (the remainder folds into the last)
        edges = np.arange(dst_bins) * nm
        quantized = np.add.reduceat(sliced, edges, axis=1)
        nonzero = (p != 0).astype(np.float64)
        norm = np.add.reduceat(nonzero, edges, axis=1)
        bin_of = np.minimum(np.arange(n) // nm, dst_bins - 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            expanded = np.where(norm[:, bin_of] > 0,
                                quantized[:, bin_of] / norm[:, bin_of], 0.0)
        q = np.where(nonzero > 0, expanded, 0.0)
        # smoothed, normalized KL(p || q) (scipy.stats.entropy semantics)
        p_s = np.where(p == 0, 1e-4, p)
        q_s = np.where(q == 0, 1e-4, q)
        p_s = p_s / p_s.sum(axis=1, keepdims=True)
        q_s = q_s / q_s.sum(axis=1, keepdims=True)
        divergences[:, ci] = np.sum(p_s * np.log(p_s / q_s), axis=1)
    return divergences


def kl_thresholds(data, bit, bins=2048):
    """data: (C, N) numpy. Returns each channel's |threshold| by the KL
    search."""
    data = np.asarray(data, dtype=np.float32)
    c = data.shape[0]
    abs_max = np.maximum(np.abs(data).max(axis=1), 1e-8)
    dst_bins = 2 ** bit - 1
    hist = np.empty((c, bins), dtype=np.float64)
    for ch in range(c):
        hist[ch] = np.histogram(data[ch], bins=bins,
                                range=(-abs_max[ch], abs_max[ch]))[0]
    divs = _kl_divergences(hist, dst_bins)
    best = np.argmin(divs, axis=1) + dst_bins // 2
    bin_width = 2 * abs_max / bins
    return (best + 0.5) * bin_width


@register_observer
class Observer(BaseObserver):
    TYPE = "kl_histogram"

    def __init__(self, config, qdesc):
        super().__init__(config, qdesc)
        self.bins = 2048

    def calc_minmax(self):
        if self.is_perchannel:
            data = self.data_cache.get_data_for_calibration(
                Granularity.CHANNELWISE)
        else:
            data = self.data_cache.get_data_for_calibration(
                Granularity.LAYERWISE).reshape(1, -1)
        self.data_cache.reset()
        th = kl_thresholds_device(data, self.qdesc.bit, self.bins)
        max_val = th
        min_val = torch.where(data.amin(dim=1) < 0, -th,
                              torch.zeros_like(th))
        if not self.is_perchannel:
            max_val, min_val = max_val[0], min_val[0]
        self.min_val, self.max_val = min_val, max_val
        return min_val, max_val
