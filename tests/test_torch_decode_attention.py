"""K5, the port's decode attention (its plain version on the CPU), against
the JAX package's decode_attention / decode_attention_stacked in
interpret mode: int8 and bf16 caches, GQA n_rep 1/2/4, ragged lengths.

Tolerance 2e-4, the reference's own oracle (tests/test_attention.py:43):
f32 dots and softmax sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.ops.attention import decode_attention as j_attn
from sparsebit_tpu.ops.attention import (
    decode_attention_stacked as j_attn_stacked)
from sparsebit_tpu_torch.ops import attention as TA

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
