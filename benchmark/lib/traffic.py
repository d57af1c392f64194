"""The one traffic generator: it reads a mix's parameters from
``benchmark/workloads/<traffic>.json`` and makes the requests or the
training batches of a run from its seed.

A serving mix has ``block`` base sizes: prompt lengths at the quantiles
(i + 1/2) / block of their distribution, i = 0 .. block - 1, the i-th
with the (i * pair_stride mod block)-th output length. The requests take
these pairs cycle after cycle in one fixed order (drawn from the mix's
``order_seed``, not the run's). The run's seed draws each request's
sizes around its pair's: the prompt length uniform within
``prompt_jitter`` of the base and within the base's power-of-two range,
the output length uniform among those that take as many decode chunks of
``chunk`` tokens as the base (the first token comes with the prompt),
and the token ids. So which sizes a run meets differs from seed to seed
while the schedule of a closed loop, and with it the work of a window,
stays the same: the order decides which requests finish together and are
admitted together, and a tail over some hundred requests swings with it
(on one H100, a seed's own order of the same sizes moved the chat
cell's p90 time to first token by some 20 % from seed to seed).
"""

import math

import numpy as np


def _quantile(dist, q):
    if dist["dist"] == "lognormal":
        from statistics import NormalDist

        return dist["median"] * math.exp(dist["sigma"]
                                         * NormalDist().inv_cdf(q))
    if dist["dist"] == "loguniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"])
        return math.exp(lo + q * (hi - lo))
    raise ValueError("unknown length distribution {!r}".format(dist["dist"]))


def quantile_grid(dist, block):
    """The ``block`` quantiles (i + 1/2) / block of ``dist``, rounded and
    clipped to [min, max]."""
    return [min(dist["max"], max(dist["min"], round(
        _quantile(dist, (i + 0.5) / block)))) for i in range(block)]


def size_pairs(spec):
    """The mix's ``block`` (prompt length, output length) pairs."""
    block = spec["block"]
    plen = quantile_grid(spec["prompt_len"], block)
    olen = quantile_grid(spec["output_len"], block)
    return [(plen[i], olen[i * spec["pair_stride"] % block])
            for i in range(block)]


def drawn_sizes(spec, pair, rng):
    """(prompt, output) lengths drawn around a base pair: see the module
    docstring."""
    p, o = pair
    d = spec["prompt_len"]
    lo = max(d["min"], math.ceil(p * (1 - spec["prompt_jitter"])),
             2 ** max(0, math.ceil(math.log2(p)) - 1) + 1)
    hi = min(d["max"], math.floor(p * (1 + spec["prompt_jitter"])),
             2 ** math.ceil(math.log2(p)))
    c = spec["engine"]["chunk"]
    d = spec["output_len"]
    k = -(-(o - 1) // c)  # decode chunks after the first token
    o_lo = max(d["min"], c * (k - 1) + 2)
    o_hi = min(d["max"], c * k + 1)
    return (int(rng.integers(min(lo, p), max(hi, p) + 1)),
            int(rng.integers(min(o_lo, o), max(o_hi, o) + 1)))


def requests(spec, seed, vocab):
    """The request pool of a serving mix: a list of (prompt int32 array,
    max new tokens), token ids uniform. With ``distinct_first_token``
    every prompt starts with a token no other prompt of the pool starts
    with, so that no prompt extends another and the engine's exact-prefix
    cache never hits."""
    rng = np.random.default_rng(int(seed))
    n, block = spec["requests"], spec["block"]
    pairs = size_pairs(spec)
    order = np.random.default_rng(spec["order_seed"]).permutation(block)
    sizes = [drawn_sizes(spec, pairs[order[j % block]], rng)
             for j in range(n)]
    if spec.get("distinct_first_token"):
        if n > vocab:
            raise ValueError("more requests than first tokens")
        first = rng.permutation(vocab)[:n]
    out = []
    for i, (p_len, o_len) in enumerate(sizes):
        p = rng.integers(0, vocab, size=p_len, dtype=np.int64)
        if spec.get("distinct_first_token"):
            p[0] = first[i]
        out.append((p.astype(np.int32), o_len))
    return out


class Batches:
    """The training feed: batches (batch, seq_len) of token ids uniform
    over the vocabulary, drawn on the device by one generator seeded from
    the run's seed, so that every row of every step differs."""

    def __init__(self, spec, seed, vocab, device):
        import torch

        from benchmark.lib.weights import sub_seed

        self.shape = (spec["batch"], spec["seq_len"])
        self.vocab, self.device = vocab, device
        self.gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "batches"))

    def next(self):
        import torch

        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)
