"""The KL (entropy) threshold search on the data's device (port of
``sparsebit_tpu/quantization/observers/kl_device.py``).

The textbook algorithm slices a window of a different width for every
candidate; here every candidate works on the full (C, bins) histogram and
a chunk of candidates runs as one batch of tensor ops:

- the histogram is a segment count: each value's bin is
  ``floor((x + amax) / width)`` (the JAX package's formula, so the bins are
  the same), counted per (channel, bin) with ``bincount``, exact in int64;
- candidate i's window [zero - i, zero + i + 1) is a mask; the mass
  outside it folds into the edge bins from one prefix sum;
- the merge into 2^bit - 1 coarse bins is a segment sum over the
  candidate's segment ids clip((j - lo) // nm, 0, dst - 1) (``scatter_add``
  of integer counts, exact in any order), and the expansion back is a
  gather;
- KL(p || q) with the reference's 1e-4 smoothing, masked to the window, in
  float64 (the numpy oracle's precision); the first least divergence wins,
  as in the oracle.
"""

import torch

_CHUNK_ELEMS = 1 << 22  # elements of one (candidates, C, bins) operand


def device_histograms(data, abs_max, bins):
    """data (C, N) float32, abs_max (C,) -> (C, bins) counts over [-amax,
    amax] a channel (the last bin closed on the right, as
    ``numpy.histogram``), float64."""
    C = data.shape[0]
    width = 2.0 * abs_max / bins
    idx = torch.floor((data + abs_max[:, None]) / width[:, None])
    idx = idx.clamp(0, bins - 1).long()
    rows = torch.arange(C, device=data.device)[:, None] * bins
    counts = torch.bincount((idx + rows).reshape(-1), minlength=C * bins)
    return counts.reshape(C, bins).double()


def _kl_search(hist, dst_bins, bins):
    """hist (C, bins) -> each channel's best candidate half-width i in
    [dst_bins // 2, bins // 2)."""
    C = hist.shape[0]
    dev = hist.device
    zero = bins // 2
    half_dst = dst_bins // 2
    csum = hist.cumsum(dim=1)
    total = csum[:, -1]
    j = torch.arange(bins, device=dev)
    best_div = torch.full((C,), float("inf"), dtype=torch.float64,
                          device=dev)
    best_i = torch.full((C,), half_dst, dtype=torch.long, device=dev)
    chunk = max(1, _CHUNK_ELEMS // (C * bins))
    for k0 in range(half_dst, zero, chunk):
        i = torch.arange(k0, min(k0 + chunk, zero), device=dev)  # (K,)
        K = i.numel()
        lo, hi = zero - i, zero + i + 1
        nm = (2 * i + 1) // dst_bins  # >= 1 for every candidate
        in_win = (j >= lo[:, None]) & (j < hi[:, None])  # (K, bins)
        left = torch.where(lo > 0, csum[:, (lo - 1).clamp(min=0)],
                           torch.zeros((), dtype=hist.dtype, device=dev))
        right = total[:, None] - csum[:, hi - 1]  # (C, K)
        sliced = torch.where(in_win[:, None, :], hist[None], 0.0)
        p = (sliced + (j == lo[:, None])[:, None, :] * left.T[:, :, None]
             + (j == hi[:, None] - 1)[:, None, :] * right.T[:, :, None])
        seg = torch.div(j - lo[:, None], nm[:, None], rounding_mode="floor")
        seg = seg.clamp(0, dst_bins - 1)[:, None, :].expand(K, C, bins)
        quantized = torch.zeros((K, C, dst_bins), dtype=hist.dtype,
                                device=dev).scatter_add_(2, seg, sliced)
        nonzero = torch.where(in_win[:, None, :], (p != 0).double(), 0.0)
        norm = torch.zeros_like(quantized).scatter_add_(2, seg, nonzero)
        ratio = torch.where(norm > 0, quantized / norm.clamp(min=1.0), 0.0)
        q = torch.where(nonzero > 0, ratio.gather(2, seg), 0.0)
        win = in_win[:, None, :]
        p_s = torch.where(win, torch.where(p == 0, 1e-4, p), 0.0)
        q_s = torch.where(win, torch.where(q == 0, 1e-4, q), 0.0)
        p_s = p_s / p_s.sum(dim=2, keepdim=True)
        q_s = q_s / q_s.sum(dim=2, keepdim=True)
        div = torch.where(win, p_s * torch.log(p_s / q_s), 0.0).sum(dim=2)
        k_min = div.argmin(dim=0)  # the first least divergence (K, C)
        d_min = div.gather(0, k_min[None])[0]
        take = d_min < best_div
        best_div = torch.where(take, d_min, best_div)
        best_i = torch.where(take, i[k_min], best_i)
    return best_i


def kl_thresholds_device(data, bit, bins=2048):
    """data (C, N) -> each channel's |threshold|, float32 (C,), on data's
    device; threshold = (best + 0.5) * bin width, as the numpy oracle."""
    data = data.float()
    abs_max = data.abs().amax(dim=1).clamp(min=1e-8)
    dst_bins = 2 ** bit - 1
    hist = device_histograms(data, abs_max, bins)
    best = _kl_search(hist, dst_bins, bins)
    bin_width = 2.0 * abs_max / bins
    return (best.float() + 0.5) * bin_width
