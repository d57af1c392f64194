"""The traffic generator: the same seed gives the same traffic; another
seed gives each request other sizes and token ids, drawn around one
fixed order of base sizes so that a closed loop's schedule stays."""

from collections import Counter

import numpy as np
import torch

from benchmark.lib import traffic
from benchmark.tests.conftest import load

SEEDS = (3, 2 ** 31 + 11)


def _pool(seed, vocab=32768):
    return traffic.requests(load("workloads", "chat-closed32"), seed, vocab)


def test_same_seed_same_requests():
    a, b = _pool(SEEDS[1]), _pool(SEEDS[1])
    assert len(a) == len(b)
    for (pa, na), (pb, nb) in zip(a, b):
        assert na == nb and np.array_equal(pa, pb)


def test_seeds_differ_in_sizes_and_tokens():
    a, b = _pool(SEEDS[0]), _pool(SEEDS[1])
    spec = load("workloads", "chat-closed32")
    block, chunk = spec["block"], spec["engine"]["chunk"]
    assert not all(np.array_equal(pa[:8], pb[:8]) for (pa, _), (pb, _)
                   in zip(a, b))
    sa = [(len(p), n) for p, n in a]
    sb = [(len(p), n) for p, n in b]
    # which sizes a request gets differs from seed to seed ...
    assert sum(x != y for x, y in zip(sa, sb)) > 0.9 * len(sa)
    assert len({p for p, _ in sa}) > 4 * block
    # ... around one fixed order of base pairs: each prompt within its
    # base's power-of-two range, each answer taking its base's decode
    # chunks after the first token
    pairs = traffic.size_pairs(spec)
    assert len(set(pairs)) == block
    order = np.random.default_rng(spec["order_seed"]).permutation(block)
    for sizes in (sa, sb):
        for j, (p, n) in enumerate(sizes):
            bp, bn = pairs[order[j % block]]
            assert (p - 1).bit_length() == (bp - 1).bit_length()
            assert abs(p - bp) <= spec["prompt_jitter"] * bp
            assert -(-(n - 1) // chunk) == -(-(bn - 1) // chunk)
    # every prompt fits its slot with its answer
    assert max(p + n for p, n in sa + sb) <= spec["engine"]["max_len"]


def test_lengths_follow_the_mix():
    spec = load("workloads", "chat-closed32")
    pool = _pool(SEEDS[0])
    plen = np.array([len(p) for p, _ in pool])
    olen = np.array([n for _, n in pool])
    for arr, d in ((plen, spec["prompt_len"]), (olen, spec["output_len"])):
        assert arr.min() >= d["min"] and arr.max() <= d["max"]
        assert abs(np.median(arr) - d["median"]) <= 0.1 * d["median"]


def test_no_prompt_extends_another():
    pool = _pool(SEEDS[1])
    first = [int(p[0]) for p, _ in pool]
    assert len(set(first)) == len(first)


def test_training_batches_repeat_by_seed_and_rows_differ():
    spec = load("workloads", "sft-b16-s256")
    cpu = torch.device("cpu")
    a = traffic.Batches(spec, SEEDS[1], 102400, cpu)
    b = traffic.Batches(spec, SEEDS[1], 102400, cpu)
    c = traffic.Batches(spec, SEEDS[0], 102400, cpu)
    x, y, z = a.next(), b.next(), c.next()
    assert x.shape == (spec["batch"], spec["seq_len"])
    assert torch.equal(x, y) and not torch.equal(x, z)
    assert not torch.equal(a.next(), x)
    assert len({tuple(r.tolist()) for r in x}) == spec["batch"]
