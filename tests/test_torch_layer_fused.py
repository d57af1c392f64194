"""The port's decode megakernel (K4) and its int8 attention against the
JAX package, on the CPU.

The JAX side runs its Pallas megakernel in interpret mode, as
tests/test_layer_fused.py does; the port runs the plain version of K4
(ops/layer_fused._fused_layers_plain), which its CUDA kernel matches bit
for bit on the card. The configuration is the reference tests' tiny one:
dim 512, 4 heads of 128, ffn 384, groupsize 64, two layers. Inputs come
from numpy seeds; weights are s4r row pairs with bf16 qparams, as served.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.ops import attention as JA
from sparsebit_tpu.ops import layer_fused as JLF
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.quant import QuantLinear
from sparsebit_tpu_torch.ops import attention as TA
from sparsebit_tpu_torch.ops import layer_fused as TLF
from sparsebit_tpu_torch.ops import quant_matmul as QM
from sparsebit_tpu_torch.ops.packing import pack_s4_rows

torch.set_num_threads(1)

GS, LX, S, D, H = 64, 2, 256, 128, 4
CFG_KW = dict(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=384,
              max_seq_len=S)
# the reference's oracle tolerance (tests/test_layer_fused.py); the port
# and the JAX kernel differ only in the order of f32 sums
RTOL, ATOL = 2e-2, 9e-2


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _weights(seed):
    """Layer stacks (w s4r uint8, s bf16, z bf16) for wqkv, wo, w13, w2
    and f32 norms, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for K, N in ((512, 3 * 512), (512, 512), (512, 2 * 384), (384, 512)):
        codes = torch.from_numpy(rng.integers(0, 16, (LX, K, N)).astype(
            np.uint8))
        out.append((pack_s4_rows(codes),
                    _bf16(rng.uniform(0.002, 0.02, (LX, K // GS, N))),
                    _bf16(rng.integers(4, 12, (LX, K // GS, N)))))
    an = (1 + 0.1 * rng.standard_normal((LX, 512))).astype(np.float32)
    fn = (1 + 0.1 * rng.standard_normal((LX, 512))).astype(np.float32)
    return out, torch.from_numpy(an), torch.from_numpy(fn)


def _cache(seed, B):
    """Contiguous int8 cache (LX, B, S, H, D) with bf16-rounded f32
    scales (LX, B, S, H)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (LX, B, S, H, D)).astype(np.int8)
    v = rng.integers(-127, 128, (LX, B, S, H, D)).astype(np.int8)
    ks = _bf16(rng.uniform(0.001, 0.01, (LX, B, S, H))).float()
    vs = _bf16(rng.uniform(0.001, 0.01, (LX, B, S, H))).float()
    return [torch.from_numpy(k), torch.from_numpy(v), ks, vs]


def _rope(pos):
    """Full-width cos/sin (B, D) made by JAX, fed to both sides."""
    inv = JL.rope_frequencies(JL.llama_tiny(**CFG_KW))
    ang = jnp.asarray(pos)[:, None].astype(jnp.float32) * inv
    return (np.asarray(jnp.concatenate([jnp.cos(ang)] * 2, 1)),
            np.asarray(jnp.concatenate([jnp.sin(ang)] * 2, 1)))


def _port(x, pos, ws, an, fn, cache, bt=None, s_active=None):
    cos, sin = _rope(pos)
    flat = [t for w in ws for t in w]
    out, *cache = TLF.fused_decoder_layers(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cos),
        torch.from_numpy(sin), *flat, an, fn, *cache,
        TL.llama_tiny(**CFG_KW), GS, bt=bt, s_active=s_active)
    return out.numpy(), cache


def _jax(x, pos, ws, an, fn, cache, bt=None):
    """The JAX megakernel in interpret mode over the same operands, with
    the caches in its serving layout (scales transposed, bf16)."""
    cos, sin = _rope(pos)
    flat = []
    for w, s, z in ws:
        flat += [jnp.asarray(w.numpy()),
                 jnp.asarray(s.float().numpy()).astype(jnp.bfloat16),
                 jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)]
    k, v, ks, vs = [jnp.asarray(t.numpy()) for t in cache]
    ks = jnp.swapaxes(ks, 2, 3).astype(jnp.bfloat16)
    vs = jnp.swapaxes(vs, 2, 3).astype(jnp.bfloat16)
    run = jax.jit(lambda: JLF.fused_decoder_layers(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cos),
        jnp.asarray(sin), *flat, jnp.asarray(an.numpy()),
        jnp.asarray(fn.numpy()), k, v, ks, vs, JL.llama_tiny(**CFG_KW), GS,
        interpret=True, signed=True,
        bt=None if bt is None else jnp.asarray(bt.numpy())))
    out, k, v, ks, vs = run()
    back = [np.asarray(k), np.asarray(v),
            np.asarray(jnp.swapaxes(ks, 2, 3).astype(jnp.float32)),
            np.asarray(jnp.swapaxes(vs, 2, 3).astype(jnp.float32))]
    return np.asarray(out), back


def _inputs(B, seed=0):
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal((B, 512)).astype(np.float32)
    pos = np.array([5, 130, 77][:B], np.int32)  # 130: the second chunk
    return x, pos


@pytest.fixture(scope="module")
def weights():
    return _weights(1)


@pytest.mark.parametrize("B", [1, 3])
def test_flat_attention_rows_int8_matches_jax(B):
    """The port's int8 attention over patched slabs against the
    reference's flat formulation with its fresh-row column correction:
    scores are exact int32 (checked against numpy), output within 1e-5."""
    rng = np.random.default_rng(B)
    Hkv, Hq, Sl = 2, 4, 64
    n_rep = Hq // Hkv
    k = rng.integers(-127, 128, (B, Sl, Hkv, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, Sl, Hkv, D)).astype(np.int8)
    ks = _bf16(rng.uniform(0.001, 0.01, (B, Sl, Hkv))).float().numpy()
    vs = _bf16(rng.uniform(0.001, 0.01, (B, Sl, Hkv))).float().numpy()
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    length = np.array([3, 40, 63][:B], np.int32)
    q8, qs = TA.quant_q_rows(torch.from_numpy(q))
    out = TA.flat_attention_rows_int8(
        q8, qs, *[torch.from_numpy(a) for a in (k, v, ks, vs)],
        torch.from_numpy(length)).numpy()

    # the reference: flat slabs that are STALE at each length column,
    # corrected from the fresh rows (here the true rows at length)
    rows = np.arange(B)
    kst, vst = k.copy(), v.copy()
    kst[rows, length] = 0
    vst[rows, length] = 0
    kslabs = [jnp.asarray(kst[b].reshape(Sl, Hkv * D)) for b in range(B)]
    vslabs = [jnp.asarray(vst[b].reshape(Sl, Hkv * D)) for b in range(B)]
    ksl = [jnp.asarray(ks[b].T).astype(jnp.bfloat16) for b in range(B)]
    vsl = [jnp.asarray(vs[b].T).astype(jnp.bfloat16) for b in range(B)]
    q8n = q8.numpy()
    qbd = np.zeros((B * Hq, Hkv * D), np.int8)
    for b in range(B):
        for j in range(Hq):
            h = j // n_rep
            qbd[b * Hq + j, h * D:(h + 1) * D] = q8n[b, j]
    selT = JA._head_sel(Hkv, Hq, 0, n_rep).T
    kf = jnp.asarray(k[rows, length].reshape(B, Hkv * D))
    vf = jnp.asarray(v[rows, length].reshape(B, Hkv * D))
    ksf = jnp.asarray(ks[rows, length])
    vsf = jnp.asarray(vs[rows, length])
    sel = jnp.asarray(np.repeat(np.eye(B, dtype=bool), Hq, axis=0))
    ref = jax.jit(JA._flat_attention_rows_int8, static_argnums=(7,))(
        kslabs, vslabs, jnp.asarray(qbd), jnp.asarray(qs.numpy()).reshape(
            -1, 1), ksl, vsl, jnp.asarray(length), n_rep, selT, kf, vf,
        ksf, vsf, sel)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    # the int32 scores: exact against numpy's int64 dot
    si = np.einsum("bhd,bshd->bhs", q8n.astype(np.int64),
                   np.repeat(k, n_rep, axis=2).astype(np.int64))
    got = torch.einsum("bhd,bshd->bhs", q8.float(), torch.from_numpy(
        np.repeat(k, n_rep, axis=2)).float()).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), si)


@pytest.fixture(scope="module")
def contiguous_runs(weights):
    """Port and JAX over the contiguous cache at B = 1 and 2."""
    ws, an, fn = weights
    runs = {}
    for B in (1, 2):
        x, pos = _inputs(B)
        cache = _cache(7, B)
        jout, jcache = _jax(x, pos, ws, an, fn, cache)
        tout, tcache = _port(x, pos, ws, an, fn,
                             [t.clone() for t in cache])
        runs[B] = (tout, tcache, jout, jcache)
    return runs


@pytest.mark.parametrize("B", [1, 2])
def test_fused_decoder_layers_matches_jax(contiguous_runs, B):
    """Output within the reference's oracle tolerance; KV codes equal and
    scales equal after the bf16 cast, the new rows included."""
    tout, tcache, jout, jcache = contiguous_runs[B]
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    for t, j in zip(tcache, jcache):
        np.testing.assert_array_equal(t.numpy(), j)


def _to_pool(cache, bt, n_blocks):
    """Contiguous (LX, B, S, ...) cache -> pool of n_blocks blocks of 128
    rows under block table bt; spare blocks hold garbage."""
    pools = []
    for t in cache:
        fill = 7 if t.dtype == torch.int8 else float("nan")
        pool = torch.full((LX, n_blocks, 128) + t.shape[3:], fill,
                          dtype=t.dtype)
        for b in range(bt.shape[0]):
            for c in range(bt.shape[1]):
                pool[:, bt[b, c]] = t[:, b, c * 128:(c + 1) * 128]
        pools.append(pool)
    return pools


def _from_pool(pool, bt):
    return torch.stack([torch.cat([pool[:, bt[b, c]]
                                   for c in range(bt.shape[1])], dim=1)
                        for b in range(bt.shape[0])], dim=1)


BT = torch.tensor([[5, 2], [0, 3]], dtype=torch.int32)  # scrambled


def test_paged_matches_contiguous(weights, contiguous_runs):
    """Pools under a scrambled block table (as test_layer_fused.py:327):
    the same output as the contiguous cache, exactly, and the pool rows
    gather back to the contiguous result."""
    ws, an, fn = weights
    x, pos = _inputs(2)
    pools = _to_pool(_cache(7, 2), BT, 6)
    out, pools = _port(x, pos, ws, an, fn, pools, bt=BT)
    tout, tcache = contiguous_runs[2][:2]
    np.testing.assert_array_equal(out, tout)
    for p, t in zip(pools, tcache):
        np.testing.assert_array_equal(_from_pool(p, BT).numpy(), t.numpy())


def test_paged_matches_jax(weights):
    """The port's paged call against the JAX paged call (bf16 scale pools
    transposed per block)."""
    ws, an, fn = weights
    x, pos = _inputs(2)
    pools = _to_pool(_cache(7, 2), BT, 6)
    jout, jback = _jax(x, pos, ws, an, fn, pools, bt=BT)
    out, pools = _port(x, pos, ws, an, fn, pools, bt=BT)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    for p, j in zip(pools, jback):
        np.testing.assert_array_equal(_from_pool(p, BT).numpy(),
                                      _from_pool(torch.from_numpy(j),
                                                 BT).numpy())


def test_s_active_matches_full_width(weights):
    """A context bucket that holds every position changes nothing: output
    and cache are identical to the full-width call
    (test_layer_fused.py:778)."""
    ws, an, fn = weights
    x = np.random.default_rng(5).standard_normal((3, 512)).astype(
        np.float32)
    pos = np.array([5, 90, 126], np.int32)
    full, cf = _port(x, pos, ws, an, fn, _cache(9, 3))
    bucket, cb = _port(x, pos, ws, an, fn, _cache(9, 3), s_active=128)
    np.testing.assert_array_equal(bucket, full)
    for a, b in zip(cb, cf):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_b1_and_batched_rows_exact(weights):
    """Decoding a row alone and as row 0 of a batch gives identical bits:
    the serving engines' cross-path contract (test_layer_fused.py:713)."""
    ws, an, fn = weights
    x = np.random.default_rng(6).standard_normal((3, 512)).astype(
        np.float32)
    pos = np.array([7, 21, 140], np.int32)
    cache = _cache(11, 3)
    out_b, cb = _port(x, pos, ws, an, fn, [t.clone() for t in cache])
    out_1, c1 = _port(x[:1], pos[:1], ws, an, fn,
                      [t[:, :1].clone() for t in cache])
    np.testing.assert_array_equal(out_1[0], out_b[0])
    for a, b in zip(c1, cb):
        np.testing.assert_array_equal(a[:, 0].numpy(), b[:, 0].numpy())


def test_idle_row_write_is_clamped(weights):
    """A row whose position is past the cache writes its K/V at the last
    row, as the reference's write clamp, and leaves other rows alone."""
    ws, an, fn = weights
    x = np.random.default_rng(8).standard_normal((2, 512)).astype(
        np.float32)
    pos = np.array([3, S + 40], np.int32)
    cache = _cache(13, 2)
    _, after = _port(x, pos, ws, an, fn, [t.clone() for t in cache])
    changed = (after[0] != cache[0]).any(dim=(3, 4))  # (LX, B, S)
    assert changed[:, 1, :S - 1].sum() == 0 and changed[:, 1, S - 1].all()
    assert changed[:, 0, 3].all() and changed[:, 0].sum() == LX


def _tiny_model_layers(F=384):
    cfg = TL.llama_tiny(**dict(CFG_KW, ffn_dim=F))
    g = torch.Generator().manual_seed(0)

    def q(K, N):
        rows = torch.randint(0, 256, (LX, K // 2, N), dtype=torch.uint8,
                             generator=g)
        s = torch.full((LX, K // GS, N), 0.01, dtype=torch.bfloat16)
        return QuantLinear({"s4r": rows}, s, torch.full_like(s, 8.0), 4,
                           GS, N)

    return cfg, {"wqkv": q(512, 1536), "wo": q(512, 512),
                 "w13": q(512, 2 * F), "w2": q(F, 512),
                 "attn_norm": torch.ones(LX, 512),
                 "ffn_norm": torch.ones(LX, 512)}


def test_route_predicate(monkeypatch):
    """A fused s4r model takes the megakernel route on the CPU as on the
    card, over an int8 cache only; FORCE_LAYER_KERNEL = False sends it to
    the unfused route, and a shape K4 does not take (B > 64) stays
    unfused."""
    cfg, layers = _tiny_model_layers()
    assert TD._scan_uses_layer_kernel(1, layers, "int8", cfg, 8)
    assert not TD._scan_uses_layer_kernel(1, layers, False, cfg, 8)
    assert not TD._scan_uses_layer_kernel(4, layers, "int8", cfg, 8)
    assert not TD._scan_uses_layer_kernel(1, layers, "int8", cfg, 65)
    monkeypatch.setattr(TD, "FORCE_LAYER_KERNEL", False)
    assert not TD._scan_uses_layer_kernel(1, layers, "int8", cfg, 8)
    assert TD._layer_kernel_ok(layers, cfg, 8)



def test_one_layer_at_a_time_matches_the_backbone(weights):
    """fused_decoder_layer over each layer in turn == one
    fused_decoder_layers call over the stack (test_layer_fused.py:138),
    exactly: the single-layer form is a view of the same stacks."""
    ws, an, fn = weights
    x, pos = _inputs(2)
    cos, sin = (torch.from_numpy(t) for t in _rope(pos))
    flat = [t for w in ws for t in w]
    cfg = TL.llama_tiny(**CFG_KW)
    whole, *c_whole = TLF.fused_decoder_layers(
        torch.from_numpy(x), torch.from_numpy(pos), cos, sin, *flat, an, fn,
        *_cache(3, 2), cfg, GS)
    h, cache = torch.from_numpy(x), _cache(3, 2)
    for li in range(LX):
        h, *cache = TLF.fused_decoder_layer(
            h, torch.from_numpy(pos), cos, sin, li, *flat, an, fn, *cache,
            cfg, GS)
    np.testing.assert_array_equal(h.numpy(), whole.numpy())
    for a, b in zip(cache, c_whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---- K4's plain version where its K-split plan splits ---------------------


def test_s4_splits_read_no_batch_size():
    """K4's four s4r matmuls take s4_plan(K, N, gs): no batch size, no
    card (the reference's contract that a row decodes alike alone and in
    a batch rests on it)."""
    K_N = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096))
    plans = [(QM.s4_plan(k, n, 128), -(-(k // 128) // QM.s4_plan(k, n, 128)))
             for k, n in K_N]
    assert TLF.s4_splits(K_N, 128) == plans
    assert any(1 < gps < k // 128 for (gps, _), (k, _) in zip(plans, K_N))


def test_fused_layers_split_plain_matches_jax():
    """One layer at dim 1024, ffn 2816, gs 64, where W13's plan splits
    (gps 2 of 16 groups): the port's plain K4 (every s4r matmul in split
    order) against the JAX megakernel in interpret mode, output within
    the reference's oracle tolerance, KV codes and scales equal."""
    gs, S_, D_ = 64, 256, 128
    kw = dict(dim=1024, n_heads=8, n_kv_heads=8, ffn_dim=2816,
              max_seq_len=S_)
    cfg_t, cfg_j = TL.llama_tiny(**kw), JL.llama_tiny(**kw)
    dim, F, H = cfg_t.dim, cfg_t.ffn_dim, cfg_t.n_heads
    K_N = ((dim, 3 * dim), (dim, dim), (dim, 2 * F), (F, dim))
    assert any(1 < gps < K // gs
               for (gps, _), (K, _) in zip(TLF.s4_splits(K_N, gs), K_N))
    rng = np.random.default_rng(4)
    ws = []
    for K, N in K_N:
        codes = rng.integers(0, 16, (1, K, N)).astype(np.uint8)
        ws.append((pack_s4_rows(torch.from_numpy(codes)),
                   _bf16(rng.uniform(0.002, 0.02, (1, K // gs, N))),
                   _bf16(rng.integers(4, 12, (1, K // gs, N)))))
    an = torch.from_numpy((1 + 0.1 * rng.standard_normal((1, dim))).astype(
        np.float32))
    fn = torch.from_numpy((1 + 0.1 * rng.standard_normal((1, dim))).astype(
        np.float32))
    B = 2
    k = rng.integers(-127, 128, (1, B, S_, H, D_)).astype(np.int8)
    v = rng.integers(-127, 128, (1, B, S_, H, D_)).astype(np.int8)
    ks = _bf16(rng.uniform(0.001, 0.01, (1, B, S_, H))).float()
    vs = _bf16(rng.uniform(0.001, 0.01, (1, B, S_, H))).float()
    x = rng.standard_normal((B, dim)).astype(np.float32)
    pos = np.array([9, 140], np.int32)
    inv = JL.rope_frequencies(cfg_j)
    ang = jnp.asarray(pos)[:, None].astype(jnp.float32) * inv
    cos = np.asarray(jnp.concatenate([jnp.cos(ang)] * 2, 1))
    sin = np.asarray(jnp.concatenate([jnp.sin(ang)] * 2, 1))

    cache = [torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
             ks.clone(), vs.clone()]
    tout, *tcache = TLF.fused_decoder_layers(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cos),
        torch.from_numpy(sin), *[t for w in ws for t in w], an, fn, *cache,
        cfg_t, gs)
    flat = []
    for w, s, z in ws:
        flat += [jnp.asarray(w.numpy()),
                 jnp.asarray(s.float().numpy()).astype(jnp.bfloat16),
                 jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)]
    jks = jnp.swapaxes(jnp.asarray(ks.numpy()), 2, 3).astype(jnp.bfloat16)
    jvs = jnp.swapaxes(jnp.asarray(vs.numpy()), 2, 3).astype(jnp.bfloat16)
    run = jax.jit(lambda: JLF.fused_decoder_layers(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cos),
        jnp.asarray(sin), *flat, jnp.asarray(an.numpy()),
        jnp.asarray(fn.numpy()), jnp.asarray(k), jnp.asarray(v), jks, jvs,
        cfg_j, gs, interpret=True, signed=True))
    jout, jk, jv, jks, jvs = run()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    jback = [np.asarray(jk), np.asarray(jv),
             np.asarray(jnp.swapaxes(jks, 2, 3).astype(jnp.float32)),
             np.asarray(jnp.swapaxes(jvs, 2, 3).astype(jnp.float32))]
    for t, j in zip(tcache, jback):
        np.testing.assert_array_equal(t.numpy(), j)
