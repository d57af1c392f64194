"""The port's int4 KV cache, and the paged cache's ``offset`` and
``n_blocks``, against the JAX package on the CPU.

- ``_quant_heads`` / ``_dequant_heads`` in int4: codes and scales bit
  for bit against the reference as its callers run it, under ``jax.jit``,
  where XLA makes ``absmax / 7.0`` a multiply by f32(1/7); the eager
  division gives other scales, which the test pins so the choice shows;
- ``cache_update`` / ``cache_read`` in int4 (codes, scales, the
  dequantized layer) bit for bit, a block near the end clamped as
  dynamic_update_slice clamps it;
- ``prefill`` + ``decode_step`` over an int4 cache against the full
  forward within 0.3 (tests/test_llm.py:131-143), and the port's logits
  against the JAX package's over the same cache within ATOL 0.1 with
  argmax equal where the top-2 margin exceeds 2 ATOL (bf16 activations
  round differently when f32 sums are taken in another order);
  ``prefill_cold_scanned`` the same way; ``generate(kv_quantized="int4")``
  and ``DecodeEngine(kv_quantized="int4")`` greedy tokens equal to the
  reference's up to a request's first difference, where the port's logits
  hold a near tie (test_torch_engine.py's rule);
- ``paged_write_rows`` with ``offset > 0`` and rows past ``n_rows``
  dropped, and ``PagedKVCache.n_blocks``, against the reference's
  scatter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import decode as JD
from sparsebit_tpu.llm import kv_cache as JK
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.serving import DecodeEngine as JEngine
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import kv_cache as TK
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.serving import DecodeEngine

from test_torch_engine import (  # noqa: F401  (model: a fixture)
    NEAR_TIE,
    _record_decisions,
    _requests,
    model,
)

torch.set_num_threads(1)

ATOL = 0.1


def _heads(shape, seed):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 50.0, shape[:-1] + (1,))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero head: the 1e-8 floor
    return x


def test_int4_quant_heads_bit_equal_to_jitted_jax():
    x = _heads((3, 7, 4, 64), 0)
    jq, js = jax.jit(lambda a: JK._quant_heads(a, "int4"))(jnp.asarray(x))
    tq, ts = TK._quant_heads(torch.from_numpy(x), "int4")
    assert tq.dtype == torch.uint8 and tuple(tq.shape) == (3, 7, 4, 32)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    lo, hi = tq.numpy() & 15, tq.numpy() >> 4
    assert lo.min() >= 1 and lo.max() <= 15 and hi.min() >= 1
    # the eager reference divides, which rounds some scales differently:
    # the port follows the jitted callers (prefill, decode_step, engines)
    _, eager = JK._quant_heads(jnp.asarray(x), "int4")
    assert not np.array_equal(ts.numpy(), np.asarray(eager))
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        td = TK._dequant_heads(tq, ts, dt, "int4")
        jdq = jax.jit(lambda q, s: JK._dequant_heads(q, s, jdt, "int4"))(
            jq, js)
        assert np.array_equal(td.float().numpy(),
                              np.asarray(jdq.astype(jnp.float32)))
    # int8 mode unchanged: bf16-rounded scales
    t8, s8 = TK._quant_heads(torch.from_numpy(x))
    j8, js8 = jax.jit(JK._quant_heads)(jnp.asarray(x))
    assert np.array_equal(t8.numpy(), np.asarray(j8))
    assert np.array_equal(s8.numpy(), np.asarray(js8))


def test_int4_cache_update_and_read_match_jax():
    cfg_j = JL.llama_tiny(dim=256, n_heads=4, n_kv_heads=2, n_layers=2)
    cfg_t = TL.llama_tiny(dim=256, n_heads=4, n_kv_heads=2, n_layers=2)
    jc = JK.init_kv_cache(cfg_j, 2, 16, "int4")
    tc = TK.init_kv_cache(cfg_t, 2, 16, "int4", device="cpu")
    assert tc.quantized == jc.quantized == "int4"
    assert tuple(tc.k.shape) == (2,) + jc.k[0].shape
    assert tc.k.dtype == torch.uint8 and tc.k_scale.dtype == torch.float32
    for step, (pos, seed) in enumerate((([3, 9], 1), ([0, 14], 2))):
        k = _heads((2, 4, 2, 64), seed)
        v = _heads((2, 4, 2, 64), seed + 10)
        li = step % 2
        upd = jax.jit(lambda c, a, b, p: JK.cache_update(c, li, a, b, p))(
            jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32))
        jc = JD._replace_layer(jc, li, upd)
        TK.cache_update(tc, li, torch.from_numpy(k), torch.from_numpy(v),
                        torch.tensor(pos, dtype=torch.int32))
        for name in ("k", "v", "k_scale", "v_scale"):
            for lj in range(2):
                assert np.array_equal(getattr(tc, name)[lj].numpy(),
                                      np.asarray(getattr(jc, name)[lj]))
        tk, tv = TK.cache_read(tc, li, torch.bfloat16)
        jk, jv = JK.cache_read(jc, li, jnp.bfloat16)
        assert np.array_equal(tk.float().numpy(),
                              np.asarray(jk.astype(jnp.float32)))
        assert np.array_equal(tv.float().numpy(),
                              np.asarray(jv.astype(jnp.float32)))


def _check_rows(rows):
    for lj, lt in rows:
        np.testing.assert_allclose(lt, lj, atol=ATOL)
        top2 = np.sort(lj, -1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 2 * ATOL
        np.testing.assert_array_equal(lt.argmax(-1)[decisive],
                                      lj.argmax(-1)[decisive])


def _prompt(B=2, S=11, seed=12):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def test_int4_prefill_and_decode_match_full_forward_and_jax(model):
    """tests/test_llm.py's oracle (cached decode == the full forward
    within 0.3 over an int4 cache) on the port, and the port's logits
    against the JAX package's through prefill, three decode_steps fed the
    reference's greedy tokens, and prefill_cold_scanned."""
    cfg_j, qparams, cfg_t, tparams = model
    prompt = _prompt()
    full = TL.llama_forward(tparams, torch.from_numpy(prompt).long(), cfg_t)
    tc = TK.init_kv_cache(cfg_t, 2, 32, "int4", device="cpu")
    _, tc = TD.prefill(tparams, torch.from_numpy(prompt[:, :-1]).long(), tc,
                       cfg_t)
    step, tc = TD.decode_step(tparams, torch.from_numpy(prompt[:, -1]), tc,
                              cfg_t)
    np.testing.assert_allclose(step.numpy(), full[:, -1].float().numpy(),
                               rtol=0.3, atol=0.3)
    assert tc.length.tolist() == [11, 11] and tc.k.dtype == torch.uint8

    jc = JK.init_kv_cache(cfg_j, 2, 32, "int4")
    tc = TK.init_kv_cache(cfg_t, 2, 32, "int4", device="cpu")
    jl, jc = JD.prefill(qparams, jnp.asarray(prompt), jc, cfg_j)
    tl, tc = TD.prefill(tparams, torch.from_numpy(prompt).long(), tc, cfg_t)
    rows = [(np.asarray(jl, np.float32), tl.numpy())]
    for _ in range(3):
        tok = rows[-1][0].argmax(-1).astype(np.int32)
        jl, jc = JD.decode_step(qparams, jnp.asarray(tok), jc, cfg_j)
        tl, tc = TD.decode_step(tparams, torch.from_numpy(tok), tc, cfg_t)
        rows.append((np.asarray(jl, np.float32), tl.numpy()))
    _check_rows(rows)

    sj = JD.stack_layers(qparams)
    st = TD.stack_layers(tparams)
    last = np.array([10, 6], np.int32)
    jc = JK.init_kv_cache(cfg_j, 2, 16, "int4")
    tc = TK.init_kv_cache(cfg_t, 2, 16, "int4", device="cpu")
    jl, jc = JD.prefill_cold_scanned(sj, jnp.asarray(prompt[:, :16]), jc,
                                     cfg_j, jnp.asarray(last))
    tl, tc = TD.prefill_cold_scanned(st, torch.from_numpy(prompt).long(), tc,
                                     cfg_t, torch.from_numpy(last))
    _check_rows([(np.asarray(jl, np.float32), tl.numpy())])
    assert tc.length.tolist() == [11, 7] and tc.k.dtype == torch.uint8
    assert tc.k_scale[:, :, :11].min() > 0


def _first_difference_near_tie(out, ref, logits, min_agree):
    """Equal tokens up to each request's first difference, where the
    port's logits hold a near tie; at least min_agree tokens agree."""
    agree = 0
    for rid, want in ref.items():
        want = [int(t) for t in want]
        assert len(out[rid]) == len(want)
        for i, (a, b) in enumerate(zip(out[rid], want)):
            if a != b:
                row = logits(rid, i)
                assert row[a] - row[b] <= NEAR_TIE, (rid, i)
                break
            agree += 1
    assert agree >= min_agree, agree


def test_int4_generate_matches_jax(model):
    cfg_j, qparams, cfg_t, tparams = model
    prompt = _prompt(seed=13)
    ref = JD.generate(qparams, jnp.asarray(prompt), cfg_j, max_new_tokens=6,
                      kv_quantized="int4")
    seen = []
    orig = TD.decode_step

    def step(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[0].clone())
        return out

    TD.decode_step = step
    try:
        out = TD.generate(tparams, prompt, cfg_t, max_new_tokens=6,
                          kv_quantized="int4", device="cpu")
    finally:
        TD.decode_step = orig
    assert tuple(out.shape) == (2, 6)
    first, _ = TD.prefill(tparams, torch.from_numpy(prompt).long(),
                          TK.init_kv_cache(cfg_t, 2, 17, "int4",
                                           device="cpu"), cfg_t)
    rows = [first] + seen

    _first_difference_near_tie(
        {b: out[b].tolist() for b in range(2)},
        {b: np.asarray(ref[b]).tolist() for b in range(2)},
        lambda b, i: rows[i][b], 8)


def test_int4_engine_tokens_match_jax(model, monkeypatch):
    """The engines' int4 slot cache: decode on decode_chunk (K4 reads an
    int8 cache only), admission over int4 scratch caches, a prefix hit
    whose entry keeps its scales; tokens as the JAX engine's, up to a
    near tie."""
    cfg_j, qparams, cfg_t, tparams = model
    kw = dict(max_batch=3, max_len=128, chunk=4, kv_quantized="int4")
    jeng = JEngine(qparams, cfg_j, **kw)
    teng = DecodeEngine(tparams, cfg_t, device="cpu", **kw)
    assert not jeng._stacked_chunks and not teng._stacked_chunks
    assert teng.cache.k.dtype == torch.uint8
    logits = _record_decisions(teng, monkeypatch)
    for r in _requests():
        jeng.add_request(r, max_new_tokens=6)
        teng.add_request(r, max_new_tokens=6)
    ref, out = jeng.run(), teng.run()
    assert teng.prefix_hits == jeng.prefix_hits == 1
    assert sorted(out) == sorted(ref)
    for entry in teng._prefix.values():
        assert entry["k"].dtype == torch.uint8
        assert entry["k_scale"] is not None and entry["v_scale"] is not None
    _first_difference_near_tie(out, ref, lambda rid, i: logits[rid][i], 12)


@pytest.mark.parametrize("offset,n_rows", [(0, 20), (21, 9), (40, 3)])
def test_paged_write_rows_offset_matches_jax(offset, n_rows):
    """Rows land at logical row offset + i through the slot's blocks;
    rows of the buffer past n_rows are not written."""
    cfg_j = JL.llama_tiny(dim=256, n_heads=4, n_kv_heads=2, n_layers=2)
    cfg_t = TL.llama_tiny(dim=256, n_heads=4, n_kv_heads=2, n_layers=2)
    nb, block, S_buf = 7, 8, 24
    jp = JK.init_paged_kv_cache(cfg_j, 2, nb, block, max_chunks=6)
    tp = TK.init_paged_kv_cache(cfg_t, 2, nb, block, max_chunks=6,
                                device="cpu")
    assert tp.n_blocks == jp.n_blocks == nb and tp.block == jp.block
    rng = np.random.default_rng(offset + n_rows)
    slot = np.array([5, 2, 6, 0, 3, 1], np.int32)
    shape = (2, S_buf, 2, 64)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = np.asarray(jnp.asarray(rng.uniform(0.01, 1, shape[:3]),
                                jnp.bfloat16).astype(jnp.float32))
    vs = np.asarray(jnp.asarray(rng.uniform(0.01, 1, shape[:3]),
                                jnp.bfloat16).astype(jnp.float32))
    jp = JK.paged_write_rows(
        jp, jnp.asarray(slot), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16),
        jnp.int32(n_rows), jnp.int32(offset))
    out = TK.paged_write_rows(
        tp, torch.from_numpy(slot), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ks), torch.from_numpy(vs), n_rows, offset=offset)
    assert out is tp
    assert np.array_equal(tp.k.numpy(), np.asarray(jp.k))
    assert np.array_equal(tp.v.numpy(), np.asarray(jp.v))
    # the reference's scale pools are bf16 and transposed (L, nb, n_kv, b)
    for t, j in ((tp.k_scale, jp.k_scale), (tp.v_scale, jp.v_scale)):
        assert np.array_equal(
            t.numpy(), np.swapaxes(np.asarray(j.astype(jnp.float32)), 2, 3))
    written = int((tp.k_scale != 0).any(-1).sum())
    assert written == 2 * n_rows
