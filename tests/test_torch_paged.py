"""The port's PagedDecodeEngine on the CPU: against the port's fixed-slot
engine (exact greedy tokens, the reference's cross-path contract,
tests/test_serving.py:135-193), against the JAX PagedDecodeEngine, and
through its block allocator (prefix-block sharing, pool exhaustion).

The model is the tiny fused LLaMA of tests/test_torch_engine.py, made by
the JAX package and carried across; pools have 16-row blocks so that a
few tokens cross block boundaries.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import decode as JD
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu.llm.serving import PagedDecodeEngine as JPaged
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.convert import params_from_numpy
from sparsebit_tpu_torch.llm.quant import DenseLinear
from sparsebit_tpu_torch.llm.serving import DecodeEngine, PagedDecodeEngine
from test_torch_engine import jax_tree_to_numpy

torch.set_num_threads(1)

MAX_LEN, BLOCK = 48, 16


@pytest.fixture(scope="module")
def model():
    kw = dict(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=384,
              max_seq_len=MAX_LEN)
    cfg_j = JL.llama_tiny(**kw)
    params = JL.fuse_llama_params(
        JL.init_llama_params(cfg_j, jax.random.PRNGKey(0)))
    qparams = JL.quantize_llama_params(
        params, lambda p, lin: JQuant.from_dense(
            lin.w.astype(jnp.float32), bits=4, groupsize=64))
    tparams = params_from_numpy(jax_tree_to_numpy(qparams), "cpu")
    return cfg_j, qparams, TL.llama_tiny(**kw), tparams


PROMPTS = [np.array([3, 17, 91, 30, 7], np.int32),
           np.array([5, 9], np.int32),
           np.array([8, 1, 2, 3, 4, 5], np.int32)]


def _pin_prefill_at(eng):
    """Admissions through prefill_at, the fixed-slot engine's prefill, so
    that the comparison isolates the decode paths (as the reference's own
    test does)."""
    eng._prefill_call = types.MethodType(
        lambda self, tokens, scratch, lasts, offsets: TD.prefill_at(
            self.params, tokens, scratch, self.cfg, lasts, offsets), eng)


def _held_equals_cached(eng):
    held = sum(1 for bid in range(len(eng._ref) - 1) if eng._ref[bid] > 0)
    cached = sum(len(e["blocks"]) for e in eng._prefix.values())
    return held == cached and len(eng._free) == len(eng._ref) - 1 - cached


def test_paged_engine_matches_fixed_slot_engine(model):
    """Two slots for three requests, 16-row blocks: the paged engine's
    greedy tokens EQUAL the fixed-slot engine's (both decode on K4, row
    for row the same arithmetic); afterwards only prefix-cache entries
    hold blocks."""
    _, _, cfg, tparams = model
    ref_eng = DecodeEngine(tparams, cfg, max_batch=2, max_len=MAX_LEN,
                           device="cpu")
    assert ref_eng._stacked_chunks
    eng = PagedDecodeEngine(tparams, cfg, max_batch=2, block=BLOCK,
                            n_blocks=8, max_len=MAX_LEN, device="cpu")
    _pin_prefill_at(eng)
    rids = [ref_eng.add_request(p, max_new_tokens=5) for p in PROMPTS]
    rids_p = [eng.add_request(p, max_new_tokens=5) for p in PROMPTS]
    ref, got = ref_eng.run(), eng.run()
    for a, b in zip(rids, rids_p):
        assert got[b] == ref[a]
    assert _held_equals_cached(eng)


def test_paged_engine_matches_jax(model):
    """The port's paged engine against the JAX one (cold admissions on
    prefill_cold_scanned on both sides, decode on the megakernel): equal
    greedy tokens. As in tests/test_torch_engine.py, free-running tokens
    agree only away from near ties (bf16 roundings differ, ~0.05 in the
    logits); these requests' decisions clear that noise."""
    cfg_j, qparams, cfg, tparams = model
    kw = dict(max_batch=2, block=BLOCK, n_blocks=8, max_len=MAX_LEN)
    jeng = JPaged(qparams, cfg_j, **kw)
    eng = PagedDecodeEngine(tparams, cfg, device="cpu", **kw)
    for p in PROMPTS:
        jeng.add_request(p, max_new_tokens=5)
        eng.add_request(p, max_new_tokens=5)
    ref, got = jeng.run(), eng.run()
    assert sorted(got) == sorted(ref)
    for rid in ref:
        assert got[rid] == [int(t) for t in ref[rid]], rid


def test_paged_engine_prefix_block_sharing(model):
    """Identical 20-token prompts: the second admission shares the first's
    full 16-row block (refcount 2 while both live; the partial tail is
    prefilled again) and emits the same tokens."""
    _, _, cfg, tparams = model
    prompt = np.arange(2, 22, dtype=np.int32)
    eng = PagedDecodeEngine(tparams, cfg, max_batch=2, block=BLOCK,
                            n_blocks=6, max_len=MAX_LEN, prefix_cache_size=4,
                            device="cpu")
    r1 = eng.add_request(prompt, max_new_tokens=4)
    out1 = eng.run()
    assert eng.prefix_hits == 0 and len(eng._prefix) == 1
    shared = next(iter(eng._prefix.values()))["blocks"][0]
    r2 = eng.add_request(prompt.copy(), max_new_tokens=12)
    first = eng.step()  # admits with the hit, decodes one chunk, lives on
    assert eng.prefix_hits == 1
    assert eng._slot_blocks[0][0] == shared and eng._ref[shared] == 2
    rest = eng.run()
    assert (first[r2] + rest[r2])[:4] == out1[r1]
    assert _held_equals_cached(eng)


def test_paged_engine_pool_exhaustion_reclaims_then_raises(model):
    """(a) with the pool held by prefix-cache entries, a new admission
    evicts them to reclaim blocks and succeeds; (b) with the pool held by
    live slots, allocation raises (test_serving.py:240-286)."""
    _, _, cfg, tparams = model
    eng = PagedDecodeEngine(tparams, cfg, max_batch=1, block=BLOCK,
                            n_blocks=4, max_len=MAX_LEN, prefix_cache_size=8,
                            device="cpu")
    eng.add_request(np.arange(2, 19, dtype=np.int32), max_new_tokens=4)
    eng.run()
    assert len(eng._prefix) == 1
    r2 = eng.add_request(np.arange(40, 57, dtype=np.int32), max_new_tokens=4)
    assert len(eng.run()[r2]) == 4
    assert len(eng._prefix) >= 1

    eng2 = PagedDecodeEngine(tparams, cfg, max_batch=2, block=BLOCK,
                             n_blocks=3, max_len=MAX_LEN, prefix_cache_size=0,
                             device="cpu")
    eng2.add_request(np.arange(2, 19, dtype=np.int32), max_new_tokens=30)
    with pytest.raises(RuntimeError, match="exhausted"):
        eng2.run()


def test_idle_slots_write_only_the_trash_block(model):
    """One live request in two slots: the idle slot decodes with the
    batch, and every row it writes lands in the trash block."""
    _, _, cfg, tparams = model
    eng = PagedDecodeEngine(tparams, cfg, max_batch=2, block=BLOCK,
                            n_blocks=5, max_len=MAX_LEN, prefix_cache_size=0,
                            device="cpu")
    eng.add_request(PROMPTS[0], max_new_tokens=20)
    eng.step()  # admit + one chunk, slot 1 idle, slot 0 still live
    live = set(eng._slot_blocks[0])
    untouched = [b for b in range(eng._trash) if b not in live]
    assert untouched and not eng.pcache.k[:, untouched].any()
    assert eng.pcache.k[:, eng._trash].any()


def test_paged_engine_needs_a_megakernel_model():
    """A model K4 does not take (separate dense projections) is refused
    at construction, with the reason."""
    cfg = TL.llama_tiny(dim=256, n_heads=2, n_kv_heads=2, ffn_dim=256,
                        n_layers=1, vocab_size=64, max_seq_len=32)
    g = torch.Generator().manual_seed(0)

    def dense(K, N):
        return DenseLinear(torch.randn((K, N), generator=g).to(
            torch.bfloat16))

    layer = {"attn_norm": torch.ones(256, dtype=torch.bfloat16),
             "ffn_norm": torch.ones(256, dtype=torch.bfloat16),
             "wq": dense(256, 256), "wk": dense(256, 256),
             "wv": dense(256, 256), "wo": dense(256, 256),
             "w1": dense(256, 256), "w3": dense(256, 256),
             "w2": dense(256, 256)}
    params = {"tok_embed": torch.zeros((64, 256), dtype=torch.bfloat16),
              "layers": [layer], "norm": torch.ones(256,
                                                     dtype=torch.bfloat16),
              "lm_head": dense(256, 64)}
    with pytest.raises(ValueError, match="megakernel"):
        PagedDecodeEngine(params, cfg, max_batch=1, block=16, max_len=32,
                          device="cpu")
