"""Sparser base class (port of ``sparsebit_tpu/sparse/sparsers/base.py``;
reference: sparsebit/sparse/sparsers/base.py:6-23).

A Sparser turns a weight tensor into a {0, 1} mask of its dtype, on its
device:

- ``unstructure``: an elementwise mask, the weight's shape: the scores
  at or above their RATIO quantile (``quantile_linear``) are kept;
- ``structure``: a mask per output channel (axis 0 of the port's OIHW
  and (out, in) weights); ``int(n * RATIO)`` channels are pruned (at
  most n - 1), the threshold being the sorted scores' ``[n_prune]``,
  and SparseModel threads the channel mask into the following BatchNorm
  and the bias.
"""

import numpy as np
import torch


def quantile_linear(x, q):
    """The ``q`` quantile of the float32 tensor ``x`` (all elements),
    ``numpy.quantile(x, q)``'s "linear" method in its float32 arithmetic,
    bit for bit: the virtual index ``f32(n - 1) * f32(q)``, then
    ``a + (b - a) * g`` (``b - (b - a) * (1 - g)`` where ``g >= 0.5``)
    between the two order statistics around it. The order statistics come
    from one ``torch.sort``, so that any size works (``torch.quantile``
    refuses inputs over 2^24 elements; two ``torch.kthvalue`` calls took
    12.4 ms a linear over bert_base's 2.4 M-element linears in
    chip_smoke.py's prunebert path on an NVIDIA H100 80GB HBM3 at
    700 W). A 0-d tensor on ``x``'s device."""
    f32 = np.float32
    x = x.reshape(-1).to(torch.float32)
    n = x.numel()
    v = f32(n - 1) * f32(q)
    if v >= f32(n - 1):
        return x.max()
    lo = int(np.floor(v))
    g = v - f32(lo)
    a, b = (f32(t) for t in torch.sort(x).values[lo:lo + 2].tolist())
    d = b - a
    t = b - d * (f32(1) - g) if g >= f32(0.5) else a + d * g
    return torch.tensor(t, dtype=torch.float32, device=x.device)


class Sparser:
    TYPE = "base"

    def __init__(self, config):
        self.config = config
        self.strategy = config.SPARSER.STRATEGY
        self.ratio = float(config.SPARSER.RATIO)

    @property
    def is_structured(self):
        return self.strategy == "structure"

    # ---- importance scores; subclasses override ---------------------------
    def channel_scores(self, weight, ch_axis):
        raise NotImplementedError

    def element_scores(self, weight):
        raise NotImplementedError

    def calc_mask(self, weight, ch_axis):
        """(w_mask, channel mask or None). ``ch_axis``: the out-channel
        axis of the weight (0 for the port's conv and linear)."""
        weight = weight.detach()
        if self.ratio <= 0.0:
            full = torch.ones_like(weight)
            return full, (torch.ones(weight.shape[ch_axis], dtype=weight.dtype,
                                     device=weight.device)
                          if self.is_structured else None)
        if self.is_structured:
            scores = self.channel_scores(weight, ch_axis)
            n = scores.shape[0]
            n_prune = min(int(n * self.ratio), n - 1)
            # keep the (n - n_prune) highest-score channels
            thresh = torch.sort(scores).values[n_prune]
            ch_mask = (scores >= thresh).to(weight.dtype)
            shape = [1] * weight.dim()
            shape[ch_axis] = -1
            return (ch_mask.reshape(shape).expand(weight.shape).contiguous(),
                    ch_mask)
        scores = self.element_scores(weight)
        thresh = quantile_linear(scores, self.ratio)
        return (scores >= thresh).to(weight.dtype), None

    def __repr__(self):
        return "{}(strategy={}, ratio={})".format(
            type(self).__name__, self.strategy, self.ratio)
