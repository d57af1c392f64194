"""K5, the port's decode attention (its plain version on the CPU), against
the JAX package's decode_attention / decode_attention_stacked in
interpret mode: int8 and bf16 caches, GQA n_rep 1/2/4, ragged lengths.

Tolerance 2e-4, the reference's own oracle (tests/test_attention.py:43):
f32 dots and softmax sums taken in another order.

At the end, K10's plain version (ops/flash_attention.flash_attention_plain,
what the wrapper runs for CPU tensors) against JAX's bundled flash
attention kernel in interpret mode (force_tpu_interpret_mode) and, at
ragged S the TPU kernel does not take, against the JAX package's masked
causal_attention. Tolerances: f32 1e-5 (dots and sums in another order);
bf16 1.6e-2, one bf16 ulp of outputs in [2, 4): the TPU kernel rounds P
after dividing by l at a one-tile S and before it otherwise, the port
always before. The bound K10 itself is held to on the card
(flash_tolerance, per element) is checked here against planted faults.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as j_flash)

from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.ops.attention import decode_attention as j_attn
from sparsebit_tpu.ops.attention import (
    decode_attention_stacked as j_attn_stacked)
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.ops import attention as TA
from sparsebit_tpu_torch.ops import flash_attention as TF

torch.set_num_threads(1)

L, B, S, Hkv, D = 2, 4, 64, 4, 128
LENGTH = np.array([0, 13, 40, 63], np.int32)  # rows [0, length] attend


def _bf16_pair(a):
    """One bf16 array for both packages: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


def _cache(quantized, rng):
    if quantized:
        k = rng.integers(-128, 128, (L, B, S, Hkv, D)).astype(np.int8)
        v = rng.integers(-128, 128, (L, B, S, Hkv, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (L, B, S, Hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (L, B, S, Hkv)).astype(np.float32)
        j = [jnp.asarray(a) for a in (k, v, ks, vs)]
        t = [torch.from_numpy(a) for a in (k, v, ks, vs)]
        return j, t
    (jk, tk), (jv, tv) = (_bf16_pair(rng.standard_normal((L, B, S, Hkv, D)))
                          for _ in range(2))
    return [jk, jv, None, None], [tk, tv, None, None]


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("stacked", [False, True])
def test_decode_attention_matches_jax(quantized, n_rep, stacked):
    rng = np.random.default_rng(n_rep + 10 * quantized)
    H = Hkv * n_rep
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(quantized, rng)
    jl, tl = jnp.asarray(LENGTH), torch.from_numpy(LENGTH)
    if stacked:
        ref = j_attn_stacked(jnp.asarray(q), jk, jv, jks, jvs, 1, jl, H,
                             interpret=True)
        out = TA.decode_attention_stacked(torch.from_numpy(q), tk, tv, tks,
                                          tvs, 1, tl)
    else:
        sl = (lambda a: None if a is None else a[1])
        ref = j_attn(jnp.asarray(q), jk[1], jv[1], sl(jks), sl(jvs), jl, H,
                     interpret=True)
        out = TA.decode_attention(torch.from_numpy(q), tk[1], tv[1], sl(tks),
                                  sl(tvs), tl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_decode_attention_supported_rule():
    """head_dim a multiple of 128 and an int8 or float cache; no Hkv
    tiling rule (a Mosaic limit, fault R3)."""
    assert TA.decode_attention_supported((1, 32, 128), "int8")
    assert TA.decode_attention_supported((1, 32, 128), False)
    assert not TA.decode_attention_supported((1, 8, 64), "int8")
    assert not TA.decode_attention_supported((1, 32, 128), "int4")


S2 = 80  # the split oracle's cache: rows_per_split 64 leaves a 16-row split
LENGTH2 = np.array([0, 13, 70, S2 - 1], np.int32)


def _cache2(quantized, rng):
    """One layer-stacked cache of S2 rows (L, B, S2, Hkv, D) for both
    packages, as _cache makes it."""
    if quantized:
        k = rng.integers(-128, 128, (L, B, S2, Hkv, D)).astype(np.int8)
        v = rng.integers(-128, 128, (L, B, S2, Hkv, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (L, B, S2, Hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (L, B, S2, Hkv)).astype(np.float32)
        return ([jnp.asarray(a) for a in (k, v, ks, vs)],
                [torch.from_numpy(a) for a in (k, v, ks, vs)])
    (jk, tk), (jv, tv) = (_bf16_pair(rng.standard_normal((L, B, S2, Hkv, D)))
                          for _ in range(2))
    return [jk, jv, None, None], [tk, tv, None, None]


@pytest.mark.parametrize("rows_per_split", [1, 7, 64, S2])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_split_oracle_matches_plain_and_jax(rows_per_split, quantized,
                                            n_rep):
    """K5's algorithm on the CPU (splits of rows_per_split rows, online
    softmax partials, merge in split order) against _decode_attn_plain and
    against the JAX decode_attention (stacked for 7 and S2 rows a split),
    atol/rtol 2e-4. Lengths 0 and S2 - 1; at 1, 7 and 64 rows a split some
    splits lie wholly past a row's length (m = -inf, weight 0)."""
    rng = np.random.default_rng(100 + rows_per_split + 7 * n_rep
                                + 3 * quantized)
    H = Hkv * n_rep
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache2(quantized, rng)
    jl, tl = jnp.asarray(LENGTH2), torch.from_numpy(LENGTH2)
    sl = (lambda a: None if a is None else a[1])
    got = TA._decode_attn_split_plain(torch.from_numpy(q), tk[1], tv[1],
                                      sl(tks), sl(tvs), tl, rows_per_split)
    plain = TA._decode_attn_plain(torch.from_numpy(q), tk[1], tv[1], sl(tks),
                                  sl(tvs), tl)
    if rows_per_split in (7, S2):
        ref = j_attn_stacked(jnp.asarray(q), jk, jv, jks, jvs, 1, jl, H,
                             interpret=True)
    else:
        ref = j_attn(jnp.asarray(q), jk[1], jv[1], sl(jks), sl(jvs), jl, H,
                     interpret=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("tile_rows", [1, 3, 16])
@pytest.mark.parametrize("quantized", [True, False])
def test_split_oracle_tiles_match_plain(tile_rows, quantized):
    """The online softmax across tiles inside a split (the kernel's
    pipeline stages): 64 rows a split walked in tiles of 1, 3 or 16 rows
    equals _decode_attn_plain within 2e-4."""
    rng = np.random.default_rng(200 + tile_rows + quantized)
    q = torch.from_numpy(rng.standard_normal((B, 2 * Hkv, D)).astype(
        np.float32))
    _, (tk, tv, tks, tvs) = _cache2(quantized, rng)
    sl = (lambda a: None if a is None else a[0])
    tl = torch.from_numpy(LENGTH2)
    got = TA._decode_attn_split_plain(q, tk[0], tv[0], sl(tks), sl(tvs), tl,
                                      64, tile_rows)
    plain = TA._decode_attn_plain(q, tk[0], tv[0], sl(tks), sl(tvs), tl)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_kernel_grid_sizing():
    """K5's rows a split and K9's K split, as the wrappers pass them to
    the kernels: at least two blocks per SM where the rows allow (K5
    splits of 64-256 rows, K9 K ranges of at most 1024 rows)."""
    from sparsebit_tpu_torch.ops import matvec as TM

    assert TA.rows_per_split(1, 2048, 32, 1, 132) == 128
    assert TA.rows_per_split(8, 2048, 32, 1, 132) == 256
    assert TA.rows_per_split(8, 2048, 8, 4, 132) == 256
    assert TA.rows_per_split(1, 700, 1, 12, 132) == 64
    assert TM.k_splits(4096, 32000, 132) == 4
    assert TM.k_splits(11008, 1002, 132) == 66
    assert TM.k_splits(64, 256, 132) == 64


# ---- K10: flash attention ----------------------------------------------------

FLASH_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
_JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _qkv(shape, kv_heads, dtype, seed):
    """q (B, H, S, D) and k, v with kv_heads heads, seeded numpy normals
    rounded to dtype once; returned as (jax arrays, torch tensors)."""
    B, H, S, D = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, h, S, D)).astype(np.float32)
            for h in (H, kv_heads, kv_heads)]
    ts = [torch.from_numpy(a).to(dtype) for a in arrs]
    js = [jnp.asarray(t.float().numpy(), _JDT[dtype]) for t in ts]
    return js, ts


def _j_flash(jq, jk, jv, sm_scale):
    with pltpu.force_tpu_interpret_mode():
        out = j_flash(jq, jk, jv, causal=True, sm_scale=sm_scale)
        return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,S,D", [(1, 2, 128, 64), (2, 2, 256, 64),
                                     (1, 4, 128, 128), (2, 2, 256, 128),
                                     (1, 2, 128, 256), (1, 2, 256, 256)])
def test_flash_plain_matches_jax_flash_kernel(dtype, B, H, S, D):
    """Causal, sm_scale 1/sqrt(D) as llama.causal_attention passes it."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((B, H, S, D), H, dtype, S + D + B)
    ref = _j_flash(jq, jk, jv, D ** -0.5)
    out = TF.flash_attention(tq, tk, tv, sm_scale=D ** -0.5)
    assert out.dtype == dtype and out.shape == (B, H, S, D)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hkv", [1, 2])
def test_flash_plain_gqa_matches_jax_flash_kernel(dtype, Hkv):
    """k/v with Hkv < H heads: query head h reads kv head h // (H / Hkv),
    as JAX's kernel over jnp.repeat'ed kv heads."""
    H, S, D = 4, 128, 128
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, H, S, D), Hkv, dtype, 50 + Hkv)
    rep = H // Hkv
    ref = _j_flash(jq, jnp.repeat(jk, rep, axis=1),
                   jnp.repeat(jv, rep, axis=1), D ** -0.5)
    out = TF.flash_attention(tq, tk, tv, sm_scale=D ** -0.5)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,D", [(1, 2, 2, 384, 128),
                                         (1, 4, 1, 384, 64),
                                         (1, 4, 2, 512, 128),
                                         (2, 4, 2, 256, 128),
                                         (1, 4, 2, 256, 256),
                                         (1, 2, 2, 384, 256),
                                         (1, 4, 1, 256, 256)])
def test_flash_plain_at_k10_width_matches_jax_flash_kernel(dtype, B, H, Hkv,
                                                          S, D):
    """The plain version over several of K10's key tiles (fwd_block_k: at
    bf16 head_dim 64/128 128 keys, three and four tiles, and 64 at
    head_dim 256, four and six; f32 64 keys, four to eight tiles, and 32
    at head_dim 256, eight to twelve; so the running max moves between
    tiles and across the kernels' q tiles), MHA and GQA (also 4 -> 1 at
    head_dim 256), against JAX's bundled kernel over jnp.repeat'ed kv
    heads, with the tolerance of the cases above."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((B, H, S, D), Hkv, dtype, S + D + Hkv)
    rep = H // Hkv
    ref = _j_flash(jq, jnp.repeat(jk, rep, axis=1),
                   jnp.repeat(jv, rep, axis=1), D ** -0.5)
    out = TF.flash_attention(tq, tk, tv, sm_scale=D ** -0.5)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,D", [(100, 128), (200, 64), (1, 128),
                                 (300, 128), (257, 64)])
def test_flash_plain_ragged_matches_jax_masked_attention(dtype, S, D):
    """S not a multiple of the tile (fault R7: the TPU kernel refuses it,
    K10 masks the ragged tile): the port's flash route against the JAX
    package's masked causal_attention on the CPU, (B, S, H, D) layout,
    GQA 4 -> 2."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, 4, S, D), 2, dtype, S + D)
    sw = (lambda a: jnp.swapaxes(a, 1, 2))
    ref = JL.causal_attention(sw(jq), JL.repeat_kv(sw(jk), 2),
                              JL.repeat_kv(sw(jv), 2))
    out = TF.flash_attention(tq, tk, tv, sm_scale=D ** -0.5)
    np.testing.assert_allclose(out.transpose(1, 2).float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0,
                               atol=FLASH_TOL[dtype])


def _biased_attention(q, k, v, sm_scale, bias):
    """Causal softmax attention in f32 with an additive (S, S) score bias
    (-inf drops a key): a planted fault for flash_tolerance."""
    S = q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    above = torch.ones((S, S), dtype=torch.bool).triu(1)
    s = (s + bias).masked_fill(above, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


@pytest.mark.parametrize("fault,share", [("far_tile", 1.0),
                                         ("rescaled_tile", 1.0),
                                         ("diagonal", 0.85)])
def test_flash_tolerance_rejects_planted_faults(fault, share):
    """The per-element bound K10 is held to (flash_tolerance) against
    planted faults at bf16 S = 512: key tile 0 skipped where it lies two
    or more tiles below the diagonal (rows >= 128) and key tile 0's
    weights mis-rescaled by e^0.5 (a stale running max) are caught in
    every row they touch; each row missing its own key (the diagonal mask
    off by one) in most rows (not where that key's weight is within P's
    rounding). A correct attention in another order, f32 softmax with P
    not rounded, stays within the bound."""
    B, H, S, D = 1, 4, 512, 128
    _, (q, k, v) = _qkv((B, H, S, D), H, torch.bfloat16, 70)
    scale = D ** -0.5
    ref = TF.flash_attention_plain(q, k, v, sm_scale=scale)
    tol = TF.flash_tolerance(q, k, v, ref, sm_scale=scale)

    def over(bias):
        out = _biased_attention(q, k, v, scale, bias)
        return ((out.float() - ref.float()).abs() > tol).any(dim=-1)

    assert not over(torch.zeros((S, S))).any()
    bias = torch.zeros((S, S))
    first = 1 if fault == "diagonal" else 128
    if fault == "diagonal":
        idx = torch.arange(1, S)
        bias[idx, idx] = float("-inf")
    else:
        bias[first:, :64] = float("-inf") if fault == "far_tile" else 0.5
    assert over(bias)[..., first:].float().mean().item() >= share


@pytest.mark.parametrize("fault,share", [("far_tile", 1.0),
                                         ("rescaled_tile", 1.0),
                                         ("diagonal", 0.85)])
def test_flash_tolerance_rejects_planted_faults_at_k10_width(fault, share):
    """The planted faults above at the width of K10's key tiles on the
    Hopper kernel (fwd_block_k: 128 keys at bf16 head_dim 128), against
    the plain version at that width: key tile 0 (keys 0-127) skipped or
    mis-rescaled where it lies two or more tiles below the diagonal (rows
    >= 256), and the diagonal off by one."""
    B, H, S, D = 1, 4, 512, 128
    _, (q, k, v) = _qkv((B, H, S, D), H, torch.bfloat16, 72)
    bk = TF.fwd_block_k(torch.bfloat16, D)
    scale = D ** -0.5
    ref = TF.flash_attention_plain(q, k, v, sm_scale=scale)
    tol = TF.flash_tolerance(q, k, v, ref, sm_scale=scale)

    def over(bias):
        out = _biased_attention(q, k, v, scale, bias)
        return ((out.float() - ref.float()).abs() > tol).any(dim=-1)

    assert not over(torch.zeros((S, S))).any()
    bias = torch.zeros((S, S))
    first = 1 if fault == "diagonal" else 2 * bk
    if fault == "diagonal":
        idx = torch.arange(1, S)
        bias[idx, idx] = float("-inf")
    else:
        bias[first:, :bk] = float("-inf") if fault == "far_tile" else 0.5
    assert over(bias)[..., first:].float().mean().item() >= share


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_tolerance_admits_one_ulp(dtype):
    """Every output element one ulp further from zero (the output's own
    rounding on the other side of a midpoint) stays within the bound."""
    _, (q, k, v) = _qkv((2, 4, 200, 64), 2, dtype, 71)
    ref = TF.flash_attention_plain(q, k, v, sm_scale=0.125)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    nudged = (ref.view(bits) + 1).view(dtype)
    assert not torch.equal(nudged, ref)
    tol = TF.flash_tolerance(q, k, v, ref, sm_scale=0.125)
    assert ((nudged.float() - ref.float()).abs() <= tol).all()


def test_flash_check_refuses_what_k10_does_not_take():
    """The wrapper's gate on the card: head_dim outside 64/128/256, f16,
    mixed dtypes, mismatched or non-dividing kv heads, a strided last
    dimension (checked before the device, so CPU tensors show it)."""
    def t(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    q = t((1, 4, 16, 128))
    cases = [
        ((t((1, 4, 16, 96)),) * 3, "head_dim"),
        ((t((1, 4, 16, 128), torch.float16),) * 3, "bf16 or f32"),
        ((q, t((1, 4, 16, 128), torch.float32), q), "bf16 or f32"),
        ((q, t((1, 3, 16, 128)), t((1, 3, 16, 128))), "do not match"),
        ((q, t((1, 4, 8, 128)), t((1, 4, 8, 128))), "do not match"),
        ((t((1, 4, 16, 256))[..., ::2], q, q), "strides"),
    ]
    for args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            TF.flash_check(*args)


def test_flash_route_ignores_the_tpu_block_rule():
    """llama._flash_ok: never for CPU tensors (the masked route, as the
    JAX package's CPU route); on the card for head_dim 64/128/256 at any
    S, ragged or short (fault R7), and not for head_dim 96."""
    def q(S, hd, device):
        return types.SimpleNamespace(shape=(1, S, 4, hd),
                                     device=torch.device(device))

    assert not TL._flash_ok(torch.zeros((1, 128, 4, 128)))
    for S in (1, 100, 127, 2047, 2048):
        for hd in TF.HEAD_DIMS:
            assert TL._flash_ok(q(S, hd, "cuda"))
    assert not TL._flash_ok(q(2048, 96, "cuda"))
    assert [TF.block_k(torch.bfloat16, d) for d in TF.HEAD_DIMS] == [64] * 3
    assert [TF.block_k(torch.float32, d)
            for d in TF.HEAD_DIMS] == [64, 64, 32]


def test_fwd_block_k_is_k10s_key_tile():
    """The forward plain version's key tile is K10's: on the Hopper
    kernels (bf16 at every head_dim, on_sm90) 128 keys, 64 at head_dim
    256 (flash_fwd_d256_kernel); 64 on the f32 kernel (32 at head_dim
    256); the backward's tiles (block_k): 64 for bf16, the f32 K11's and
    K12's K10's f32 tile."""
    bf, f32 = torch.bfloat16, torch.float32
    assert [TF.fwd_block_k(bf, d) for d in TF.HEAD_DIMS] == [128, 128, 64]
    assert [TF.fwd_block_k(f32, d) for d in TF.HEAD_DIMS] == [64, 64, 32]
    assert TF.on_sm90(bf) and not TF.on_sm90(f32)
    assert [TF.block_k(bf, d) for d in TF.HEAD_DIMS] == [64, 64, 64]
    assert [TF.block_k(f32, d) for d in TF.HEAD_DIMS] == [
        TF.fwd_block_k(f32, d) for d in TF.HEAD_DIMS]


# ---- K11, K12: the flash backward ---------------------------------------------
#
# The port's flash_attention with operands that require a gradient is an
# autograd.Function whose backward, for CPU tensors, is the plain version of
# K11 (dK, dV) and K12 (dQ), flash_attention_bwd_plain. Tolerance against
# JAX's backward kernels (jax.vjp of its bundled flash_attention, in
# interpret mode): f32 2e-5 of max |grad| (the same f32 sums in another
# order, P from the log-sum-exp against exp(s - m) / l); bf16 2^-6 of max
# |grad|: both round P and dS to bf16 before their products, and the
# reference's output O (its di = sum O dO) and P differ from the port's by
# an ulp here and there (FLASH_TOL), which moves a rounding of dS.

BWD_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-5}


def _grads_close(got, ref, dtype):
    for g, r in zip(got, ref):
        r = np.asarray(r.astype(jnp.float32)) if not isinstance(
            r, torch.Tensor) else r.float().numpy()
        err = np.abs(g.float().numpy() - r).max()
        assert err <= BWD_TOL[dtype] * np.abs(r).max(), (err,
                                                         np.abs(r).max())


def _port_grads(tq, tk, tv, do, sm_scale):
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = TF.flash_attention(q, k, v, sm_scale=sm_scale)
    out.backward(do)
    return out, (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("dtype,B,H,Hkv,S,D", [
    (torch.bfloat16, 1, 2, 2, 128, 64), (torch.float32, 1, 2, 2, 256, 64),
    (torch.bfloat16, 1, 2, 2, 256, 128), (torch.float32, 1, 2, 2, 128, 128),
    (torch.bfloat16, 1, 4, 2, 128, 64), (torch.float32, 1, 4, 1, 128, 64),
    (torch.float32, 1, 4, 2, 256, 128), (torch.float32, 2, 4, 2, 384, 64),
    (torch.float32, 1, 4, 2, 128, 256), (torch.float32, 1, 2, 2, 384, 128),
    (torch.float32, 1, 4, 1, 256, 256), (torch.bfloat16, 1, 2, 2, 128, 256),
    (torch.bfloat16, 1, 4, 1, 256, 256), (torch.bfloat16, 1, 4, 2, 256, 256)])
def test_flash_bwd_plain_matches_jax_flash_kernels(dtype, B, H, Hkv, S, D):
    """dQ, dK, dV of the port's flash_attention (K11/K12's plain version)
    against jax.vjp of JAX's bundled flash kernels in interpret mode, under
    jax.jit, the reference's kernel over repeated kv heads under GQA (its
    dK, dV summed back through jnp.repeat's transpose). The f32 cases
    span four to six of the f32 K11's and K12's 64-key tiles (block_k)
    and, at head_dim 256, four and eight of their 32-key tiles
    (GQA 4 -> 2 and 4 -> 1); the bf16 head_dim-256 cases two and four of
    the bf16 kernels' 64-key tiles (MHA, GQA 4 -> 1 and 4 -> 2)."""
    import jax

    (jq, jk, jv), (tq, tk, tv) = _qkv((B, H, S, D), Hkv, dtype,
                                      S + D + H + Hkv)
    rng = np.random.default_rng(S + D)
    do = torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(
        np.float32)).to(dtype)
    jdo = jnp.asarray(do.float().numpy(), _JDT[dtype])
    rep = H // Hkv

    def f(a, b, c):
        return j_flash(a, jnp.repeat(b, rep, axis=1),
                       jnp.repeat(c, rep, axis=1), causal=True,
                       sm_scale=D ** -0.5)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda a, b, c, g: jax.vjp(f, a, b, c)[1](g))(
            jq, jk, jv, jdo)
    _, got = _port_grads(tq, tk, tv, do, D ** -0.5)
    assert [g.dtype for g in got] == [dtype] * 3
    assert tuple(got[1].shape) == (B, Hkv, S, D)
    _grads_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,D,B,H,Hkv", [
    pytest.param(100, 64, 2, 4, 2, id="100"),
    pytest.param(257, 64, 2, 4, 2, id="257"),
    pytest.param(320, 64, 2, 4, 2, id="320"),
    pytest.param(330, 64, 2, 4, 2, id="330"),
    pytest.param(320, 128, 1, 8, 2, id="320-hd128-gqa4"),
    pytest.param(330, 128, 1, 8, 2, id="330-hd128-gqa4"),
    pytest.param(1024, 128, 1, 8, 2, id="1024-hd128-gqa4")])
def test_flash_bwd_plain_ragged_matches_masked_autograd(dtype, S, D, B, H,
                                                        Hkv):
    """At S the TPU kernel refuses (fault R7), and at the shapes the
    card's tests give K11/K12's Hopper kernels (S = 320 / 330 off their
    128-row q tiles, 128-key blocks at head_dim 64 and 64-key blocks at
    128; GQA n_rep 4 over 1024 rows): the flash route's gradients against
    torch autograd of the masked attention_scores on the same operands,
    (B, S, H, D) layout; the masked route keeps P and dS in f32, so bf16
    is held to BWD_TOL as against JAX."""
    _, (tq, tk, tv) = _qkv((B, H, S, D), Hkv, dtype, S + 3)
    do = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (B, H, S, D)).astype(np.float32)).to(dtype)
    _, got = _port_grads(tq, tk, tv, do, D ** -0.5)
    q, k, v = (t.transpose(1, 2).clone().requires_grad_()
               for t in (tq, tk, tv))
    mask = torch.triu(torch.full((S, S), -1e9), diagonal=1)[None, None]
    rep = H // Hkv
    out = TL.attention_scores(q, TL.repeat_kv(k, rep), TL.repeat_kv(v, rep),
                              mask)
    out.backward(do.transpose(1, 2))
    _grads_close(got, [t.grad.transpose(1, 2) for t in (q, k, v)], dtype)


def _bwd_dense(q, k, v, lse, do, di, scale, round_to, fault=None):
    """The backward as whole (S, S) matrices in f64 (another order than
    the plain version's tiles), P and dS rounded to ``round_to`` (None:
    kept unrounded), with a planted fault: "skip_q_tile" (K11 skips query
    tile 2 for key tile 0), "no_di" (dS without its di term, in K11 and
    K12) or "no_diag_tile" (K12 skips each row's own key tile). Returns
    (dq, dk, dv) in f64, kv heads not repeated (H == Hkv)."""
    f64 = torch.float64
    q, k, v, do = (t.to(f64) for t in (q, k, v, do))
    S = q.shape[2]
    above = torch.ones((S, S), dtype=torch.bool).triu(1)
    s = (q @ k.transpose(-1, -2) * scale).masked_fill(above, float("-inf"))
    p = torch.exp(s - lse.to(f64)[..., None])
    dp = do @ v.transpose(-1, -2)
    ds = (dp - (0.0 if fault == "no_di" else di.to(f64)[..., None])) * p \
        * scale

    def rnd(t):
        return t if round_to is None else t.to(round_to).to(f64)

    p, ds = rnd(p), rnd(ds)
    pk, dsk, dsq = p.clone(), ds.clone(), ds.clone()
    if fault == "skip_q_tile":
        pk[..., 128:192, 0:64] = 0.0
        dsk[..., 128:192, 0:64] = 0.0
    if fault == "no_diag_tile":
        for t0 in range(0, S, 64):
            dsq[..., t0:t0 + 64, t0:t0 + 64] = 0.0
    return dsq @ k, dsk.transpose(-1, -2) @ q, pk.transpose(-1, -2) @ do


@pytest.mark.parametrize("fault,touched,share", [
    ("skip_q_tile", ("dk", "dv"), 1.0), ("no_di", ("dq", "dk"), 0.95),
    ("no_diag_tile", ("dq",), 0.95)])
def test_flash_bwd_tolerance_rejects_planted_faults(fault, touched, share):
    """The per-element bounds K11/K12 are held to (flash_bwd_tolerance)
    at bf16 S = 512: a correct backward in another order stays within
    them, with P and dS rounded where the kernels round them or not
    rounded at all; each planted fault puts an element over the bound in
    at least ``share`` of the rows it touches (dK/dV rows of key tile 0
    for a skipped query tile, every row for dS without di, the rows past
    the first tile for a skipped diagonal tile)."""
    B, H, S, D = 1, 4, 512, 128
    _, (q, k, v) = _qkv((B, H, S, D), H, torch.bfloat16, 72)
    do = torch.from_numpy(np.random.default_rng(73).standard_normal(
        (B, H, S, D)).astype(np.float32)).to(torch.bfloat16)
    scale = D ** -0.5
    out, lse = TF.flash_attention_plain(q, k, v, sm_scale=scale,
                                        return_lse=True)
    di = TF.flash_di(out, do)
    dk, dv = TF.flash_bwd_dkv_plain(q, k, v, lse, do, di, sm_scale=scale)
    dq = TF.flash_bwd_dq_plain(q, k, v, lse, do, di, sm_scale=scale)
    refs = {"dq": dq, "dk": dk, "dv": dv}
    tols = dict(zip(("dq", "dk", "dv"), TF.flash_bwd_tolerance(
        q, k, v, lse, do, di, dq, dk, dv, sm_scale=scale)))

    def over(grads):
        return {n: ((g - refs[n].double()).abs() > tols[n].double()).any(
            dim=-1) for n, g in zip(("dq", "dk", "dv"), grads)}

    for round_to in (torch.bfloat16, None):
        assert not any(o.any() for o in over(_bwd_dense(
            q, k, v, lse, do, di, scale, round_to)).values())
    bad = over(_bwd_dense(q, k, v, lse, do, di, scale, torch.bfloat16,
                          fault))
    rows = {"skip_q_tile": slice(0, 64), "no_di": slice(0, S),
            "no_diag_tile": slice(64, S)}[fault]
    for n in touched:
        assert bad[n][..., rows].float().mean().item() >= share, n
