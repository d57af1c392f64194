"""The port's ops (sparsebit_tpu_torch.ops) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. The
port's wrappers run their plain PyTorch versions on CPU tensors; the JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them. Tolerances are stated per test with their reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.ops import packing as jpk
from sparsebit_tpu.ops.attention import decode_attention_update as j_attn
from sparsebit_tpu.ops.ffn_fused import ffn_block_fused as j_ffn
from sparsebit_tpu.ops.int8_matmul import tokenwise_quant as j_tq
from sparsebit_tpu.ops.matvec import bf16_matvec as j_mv
from sparsebit_tpu.ops.quant_matmul import (
    _quant_matmul_pallas_u4,
    _quant_matmul_pallas_u4_stacked,
)
from sparsebit_tpu_torch.ops import attention as A
from sparsebit_tpu_torch.ops import ffn_fused as FF
from sparsebit_tpu_torch.ops import matvec as MV
from sparsebit_tpu_torch.ops import packing as pk
from sparsebit_tpu_torch.ops import quant_matmul as QM
from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _bf16_pair(a):
    """f32 numpy -> (jax bf16 array, torch bf16 tensor) of equal bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    bits = np.asarray(j).view(np.uint16).view(np.int16)
    return j, _t(bits).view(torch.bfloat16)


# ---- packing: bit-exact ----------------------------------------------------


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_columns_bit_exact(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 2 ** bits, (16, 64)).astype(np.uint8)
    jp = jpk.pack_columns(jnp.asarray(q), bits)
    tp = pk.pack_columns(_t(q), bits)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    np.testing.assert_array_equal(pk.unpack_columns(tp, bits, 64).numpy(), q)


def test_row_pair_packing_bit_exact():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 16, (3, 32, 48)).astype(np.uint8)  # stacked
    for jf, tf, ju, tu in ((jpk.pack_u4_rows, pk.pack_u4_rows,
                            jpk.unpack_u4_rows, pk.unpack_u4_rows),
                           (jpk.pack_s4_rows, pk.pack_s4_rows,
                            jpk.unpack_s4_rows, pk.unpack_s4_rows)):
        packed = tf(_t(q))
        np.testing.assert_array_equal(packed.numpy(),
                                      np.asarray(jf(jnp.asarray(q))))
        np.testing.assert_array_equal(tu(packed).numpy(),
                                      np.asarray(ju(jnp.asarray(packed))))
        np.testing.assert_array_equal(tu(packed).numpy(), q)
    assert pk.unpack_columns({"s4r": pk.pack_s4_rows(_t(q))}, 4, 48).equal(
        _t(q))


def test_tokenwise_quant_codes_exact():
    """Against the reference as it always runs, under jit (XLA turns its
    division by 127 into a multiply); bf16-valued inputs hit exact .5
    ties, where a 1-ulp scale difference would move codes."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((64, 96)) * rng.uniform(0.1, 5, (64, 1)))
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    x[3] = 0.0  # the eps floor
    jq, js = jax.jit(j_tq)(jnp.asarray(x))
    tq, ts = tokenwise_quant(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---- K1: W4A8 over s4r weights -----------------------------------------------


def _k1_inputs(rng, M, K, N, gs, L=None):
    lead = (L,) if L else ()
    codes = rng.integers(0, 16, lead + (K, N)).astype(np.uint8)
    scales = rng.uniform(0.001, 0.02, lead + (K // gs, N)).astype(np.float32)
    zeros = rng.integers(0, 16, lead + (K // gs, N)).astype(np.float32)
    x8 = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = pk.pack_s4_rows(_t(codes))
    return x8, w, scales, zeros


@pytest.mark.parametrize("M", [5, 80])  # decode grid and B-tiled grid
@pytest.mark.parametrize("sz", ["f32", "bf16"])
def test_k1_plain_matches_pallas(M, sz):
    """rtol/atol 2e-4: f32 sums over groups in another order."""
    K, N, gs = 256, 256, 64
    x8, w, s, z = _k1_inputs(np.random.default_rng(M), M, K, N, gs)
    if sz == "bf16":
        js, ts = _bf16_pair(s)
        jz, tz = _bf16_pair(z)
    else:
        js, ts, jz, tz = jnp.asarray(s), _t(s), jnp.asarray(z), _t(z)
    ref = _quant_matmul_pallas_u4(
        jnp.asarray(x8), jnp.asarray(w.numpy()), js, jz, gs, N,
        interpret=True, signed=True)
    ones = torch.ones((M, 1))
    out = QM.quant_matmul_s4(_t(x8), ones, w, ts, tz, gs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("M", [3, 72])
def test_k1_stacked_plain_matches_pallas(M):
    K, N, gs, L, li = 128, 256, 64, 3, 2
    x8, w, s, z = _k1_inputs(np.random.default_rng(10 + M), M, K, N, gs, L)
    ref = _quant_matmul_pallas_u4_stacked(
        jnp.asarray(x8), jnp.asarray(w.numpy()), jnp.asarray(s),
        jnp.asarray(z), jnp.int32(li), gs, N, interpret=True, signed=True)
    out = QM.quant_matmul_s4(_t(x8), torch.ones((M, 1)), w, _t(s), _t(z),
                             gs, li=li)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


# ---- K1's K-split plan and the plain version in its split order ---------
# The CUDA tile splits K at group boundaries and adds the splits' partials
# in split order; _qmm_s4_plain(gps=...) repeats that order, so kernel and
# plain version agree bit for bit on the card.


def _s4_operands(rng, M, K, N, gs):
    codes = rng.integers(0, 16, (K, N)).astype(np.uint8)
    x8 = rng.integers(-128, 128, (M, K)).astype(np.int8)
    s = rng.uniform(0.002, 0.02, (K // gs, N)).astype(np.float32)
    z = rng.integers(4, 12, (K // gs, N)).astype(np.float32)
    return x8, pk.pack_s4_rows(_t(codes)), s, z


@pytest.mark.parametrize("K,N,gs", [
    (256, 320, 64), (4096, 12288, 128), (4096, 4096, 128),
    (4096, 22016, 128), (11008, 4096, 128), (1024, 5632, 64),
    (2816, 2048, 64), (384, 200, 128)])
def test_s4_plan_covers_k_at_group_boundaries(K, N, gs):
    """gps groups a split, 1 <= gps <= G: the splits start at multiples of
    gps groups and the last one ends at G (it may be shorter)."""
    G = K // gs
    gps = QM.s4_plan(K, N, gs)
    splits = -(-G // gps)
    assert 1 <= gps <= G
    assert (splits - 1) * gps < G <= splits * gps
    starts = [p * gps * gs for p in range(splits)]
    assert all(k % gs == 0 and k < K for k in starts)


def test_k1_plan_reads_no_batch_size():
    """The plan is a function of (K, N, gs): K1 takes the same gps at every
    M up to the crossover, and the groups in order above it."""
    K, N, gs = 4096, 4096, 128
    gps = QM.s4_plan(K, N, gs)
    assert 1 < gps < K // gs  # this shape splits
    for M in (1, 8, 33, QM.K1_STREAM_MAX_M):
        assert QM.k1_plan(M, K, N, gs) == ("stream", gps)
    for M in (QM.K1_STREAM_MAX_M + 1, 512, 770):
        assert QM.k1_plan(M, K, N, gs) == ("admit", K // gs)


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("sz", ["f32", "bf16"])
def test_k1_split_plain_matches_pallas(M, sz):
    """At a shape the plan splits (K = 1024, gs 64: 16 groups, gps 2),
    the wrapper's plain version on the CPU is _qmm_s4_plain in split
    order, bit for bit, and agrees with the JAX kernel (interpret mode)
    at test_k1_plain_matches_pallas' tolerance (rtol/atol 2e-4: f32 sums
    over the groups in another order); gps = 1 is the sequential sum
    exactly."""
    K, N, gs = 1024, 4352, 64
    gps = QM.s4_plan(K, N, gs)
    assert 1 < gps < K // gs
    x8, w, s, z = _s4_operands(np.random.default_rng(M), M, K, N, gs)
    if sz == "bf16":
        js, ts = _bf16_pair(s)
        jz, tz = _bf16_pair(z)
    else:
        js, jz, ts, tz = jnp.asarray(s), jnp.asarray(z), _t(s), _t(z)
    xs = torch.ones((M, 1))
    out = QM.quant_matmul_s4(_t(x8), xs, w, ts, tz, gs)
    split = QM._qmm_s4_plain(_t(x8), xs, w, ts, tz, gs, gps)
    assert torch.equal(out, split)
    assert torch.equal(QM._qmm_s4_plain(_t(x8), xs, w, ts, tz, gs, 1),
                       QM._qmm_s4_plain(_t(x8), xs, w, ts, tz, gs))
    ref = _quant_matmul_pallas_u4(
        jnp.asarray(x8), jnp.asarray(w.numpy()), js, jz, gs, N,
        interpret=True, signed=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("M", [64, 65])
def test_k1_crossover_plain(M):
    """Either side of K1's crossover the CPU route is the plain version
    in its tile's order: the split at M = 64, the groups in order at
    M = 65; both within 2e-4 of the sequential order."""
    K, N, gs = 1024, 4352, 64
    x8, w, s, z = _s4_operands(np.random.default_rng(M), M, K, N, gs)
    xs = torch.full((M, 1), 0.01)
    out = QM.quant_matmul_s4(_t(x8), xs, w, _t(s), _t(z), gs)
    tile, gps = QM.k1_plan(M, K, N, gs)
    assert tile == ("stream" if M <= 64 else "admit")
    assert torch.equal(out, QM._qmm_s4_plain(_t(x8), xs, w, _t(s), _t(z),
                                             gs, gps))
    seq = QM._qmm_s4_plain(_t(x8), xs, w, _t(s), _t(z), gs)
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_k1_split_plain_rows_independent_of_batch():
    """Row 0 of an 8-row call equals the 1-row call bit for bit at a
    split shape: the split order does not depend on M."""
    K, N, gs = 1024, 4352, 64
    x8, w, s, z = _s4_operands(np.random.default_rng(3), 8, K, N, gs)
    xs = torch.full((8, 1), 0.02)
    out8 = QM.quant_matmul_s4(_t(x8), xs, w, _t(s), _t(z), gs)
    out1 = QM.quant_matmul_s4(_t(x8[:1]), xs[:1], w, _t(s), _t(z), gs)
    assert torch.equal(out8[:1], out1)


# ---- K2: int8 row commit + decode attention -------------------------------


def test_k2_plain_matches_pallas():
    """GQA n_rep = 2. Cache codes and scales exact; out atol 2e-3 (bf16
    products summed in another order)."""
    rng = np.random.default_rng(3)
    L, B, S, H, Hkv, D, li = 2, 3, 16, 4, 2, 128, 1
    k = rng.integers(-128, 128, (L, B, S, Hkv, D)).astype(np.int8)
    v = rng.integers(-128, 128, (L, B, S, Hkv, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (L, B, S, Hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (L, B, S, Hkv)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32) * 2
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    length = np.array([0, 5, 15], np.int32)
    pad = ((0, 0),) * 3 + ((0, 128 - Hkv),)  # the TPU kernel's lane padding
    out_j, k_j, v_j, ks_j, vs_j = j_attn(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(np.pad(ks, pad)),
        jnp.asarray(np.pad(vs, pad)), jnp.int32(li), jnp.asarray(length),
        interpret=True)
    tk, tv, tks, tvs = _t(k), _t(v), _t(ks), _t(vs)
    out = A.decode_attention_update(_t(q), _t(kn), _t(vn), tk, tv, tks, tvs,
                                    li, _t(length))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(ks_j)[..., :Hkv])
    np.testing.assert_array_equal(tvs.numpy(), np.asarray(vs_j)[..., :Hkv])
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-3)


def test_k2_cluster_plain_matches_plain_and_pallas():
    """K2's cluster-order oracle at 1, 2, 4 and 8 CTAs over lengths 0, 1,
    31 (a split boundary: 32 rows split evenly) and S - 1: codes and
    scales exact, out within 1e-5 of the plain version and 2e-3 of the JAX
    kernel in interpret mode."""
    rng = np.random.default_rng(5)
    L, B, S, H, Hkv, D, li = 2, 4, 64, 4, 2, 128, 0
    k = rng.integers(-128, 128, (L, B, S, Hkv, D)).astype(np.int8)
    v = rng.integers(-128, 128, (L, B, S, Hkv, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (L, B, S, Hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (L, B, S, Hkv)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    length = np.array([0, 1, 31, S - 1], np.int32)
    pad = ((0, 0),) * 3 + ((0, 128 - Hkv),)  # the TPU kernel's lane padding
    out_j, k_j, v_j, ks_j, vs_j = j_attn(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(np.pad(ks, pad)),
        jnp.asarray(np.pad(vs, pad)), jnp.int32(li), jnp.asarray(length),
        interpret=True)
    caches = [_t(t) for t in (k, v, ks, vs)]
    ref = A._attn_update_plain(_t(q), _t(kn), _t(vn),
                               *[t.clone() for t in caches], li, _t(length))
    for C in (1, 2, 4, 8):
        got = [t.clone() for t in caches]
        out = A._attn_update_cluster_plain(_t(q), _t(kn), _t(vn), *got, li,
                                           _t(length), C)
        for a, b in zip(got, (k_j, v_j, ks_j, vs_j)):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b)[..., :a.shape[-1]]
                                          if a.dim() == 4 else np.asarray(b))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-3)


def test_k2_cluster_plan():
    """The cluster grows until the grid holds two CTAs an SM, keeping 64
    rows a CTA, and far enough that a CTA's scores fit; every shape the
    gate admits gets at most 8 CTAs."""
    sms = 132
    assert A.k2_cluster(8, 512, 32, sms) == 2   # 256 clusters < 264
    assert A.k2_cluster(8, 2048, 32, sms) == 2
    assert A.k2_cluster(32, 2048, 32, sms) == 1
    assert A.k2_cluster(1, 2048, 32, sms) == 8
    assert A.k2_cluster(1, 100, 32, sms) == 1   # 64 rows a CTA at least
    S = A.K2_MAX_SCORES - 1                     # n_rep 1, the gate's edge
    C = A.k2_cluster(64, S, 64, sms)
    assert C == 4 and -(-S // C) <= A.K2_CTA_ROWS
    assert A.k2_cluster(1, S, 1, sms) == A.K2_MAX_CLUSTER


# ---- K3: fused FFN block -----------------------------------------------------


def test_k3_plain_matches_pallas():
    """rtol/atol 2e-4, as the reference's fused-vs-unfused FFN test."""
    rng = np.random.default_rng(4)
    L, B, dim, F, gs, li = 2, 3, 256, 256, 64, 1
    c13 = rng.integers(0, 16, (L, dim, 2 * F)).astype(np.uint8)
    c2 = rng.integers(0, 16, (L, F, dim)).astype(np.uint8)
    s13 = rng.uniform(0.001, 0.01, (L, dim // gs, 2 * F)).astype(np.float32)
    s2 = rng.uniform(0.001, 0.01, (L, F // gs, dim)).astype(np.float32)
    z13 = rng.integers(4, 12, s13.shape).astype(np.float32)
    z2 = rng.integers(4, 12, s2.shape).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal((L, dim))).astype(np.float32)
    x = rng.standard_normal((B, dim)).astype(np.float32)
    w13, w2 = pk.pack_s4_rows(_t(c13)), pk.pack_s4_rows(_t(c2))
    ref = j_ffn(jnp.asarray(x), jnp.asarray(w13.numpy()), jnp.asarray(s13),
                jnp.asarray(z13), jnp.asarray(w2.numpy()), jnp.asarray(s2),
                jnp.asarray(z2), jnp.asarray(nw), jnp.int32(li), gs, 1e-6,
                interpret=True, signed=True)
    out = FF.ffn_block_fused(_t(x), w13, _t(s13), _t(z13), w2, _t(s2),
                             _t(z2), _t(nw), li, gs, 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dim,F", [(1024, 4352), (2048, 2304)])
def test_k3_split_plain_matches_pallas(dim, F):
    """The plain version in K3's order at widths where s4_plan splits
    both matmuls into runs of more than one group (gs 64), against the JAX
    kernel in interpret mode: rtol/atol 2e-4."""
    gs, B = 64, 2
    for K, N in ((dim, 2 * F), (F, dim)):
        assert 1 < QM.s4_plan(K, N, gs) < K // gs
    rng = np.random.default_rng(dim)
    c13 = rng.integers(0, 16, (1, dim, 2 * F)).astype(np.uint8)
    c2 = rng.integers(0, 16, (1, F, dim)).astype(np.uint8)
    s13 = rng.uniform(0.001, 0.01, (1, dim // gs, 2 * F)).astype(np.float32)
    s2 = rng.uniform(0.001, 0.01, (1, F // gs, dim)).astype(np.float32)
    z13 = rng.integers(4, 12, s13.shape).astype(np.float32)
    z2 = rng.integers(4, 12, s2.shape).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal((1, dim))).astype(np.float32)
    x = rng.standard_normal((B, dim)).astype(np.float32)
    w13, w2 = pk.pack_s4_rows(_t(c13)), pk.pack_s4_rows(_t(c2))
    ref = j_ffn(jnp.asarray(x), jnp.asarray(w13.numpy()), jnp.asarray(s13),
                jnp.asarray(z13), jnp.asarray(w2.numpy()), jnp.asarray(s2),
                jnp.asarray(z2), jnp.asarray(nw), jnp.int32(0), gs, 1e-6,
                interpret=True, signed=True)
    out = FF.ffn_block_fused(_t(x), w13, _t(s13), _t(z13), w2, _t(s2),
                             _t(z2), _t(nw), 0, gs, 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


# ---- K9: bf16 matvec -----------------------------------------------------------


@pytest.mark.parametrize("B", [1, 3])
def test_k9_plain_matches_pallas(B):
    """atol 1e-5: bf16 products are exact in f32, only the sum order
    differs."""
    rng = np.random.default_rng(5 + B)
    x = rng.standard_normal((B, 256)).astype(np.float32)
    jw, tw = _bf16_pair(rng.standard_normal((256, 384)) * 0.05)
    ref = j_mv(jnp.asarray(x), jw, interpret=True)
    np.testing.assert_allclose(MV.bf16_matvec(_t(x), tw).numpy(),
                               np.asarray(ref), atol=1e-5)


# ---- wrappers never hand a device tensor to a plain version ------------------


def test_wrappers_refuse_non_cpu_tensors_without_cuda():
    """A tensor that is not on the CPU goes to the kernel path, which needs
    CUDA tensors: it raises instead of running the plain version."""
    m = torch.device("meta")
    x8 = torch.zeros((2, 128), dtype=torch.int8, device=m)
    w = torch.zeros((64, 128), dtype=torch.uint8, device=m)
    s = torch.ones((1, 128), device=m)
    with pytest.raises(ValueError):
        QM.quant_matmul_s4(x8, torch.ones((2, 1), device=m), w, s, s, 128)
    with pytest.raises(ValueError):
        MV.bf16_matvec(torch.zeros((2, 128), device=m),
                       torch.zeros((128, 64), dtype=torch.bfloat16, device=m))
    kc = torch.zeros((1, 2, 4, 2, 128), dtype=torch.int8, device=m)
    sc = torch.zeros((1, 2, 4, 2), device=m)
    with pytest.raises(ValueError):
        A.decode_attention_update(
            torch.zeros((2, 2, 128), device=m),
            torch.zeros((2, 2, 128), device=m),
            torch.zeros((2, 2, 128), device=m), kc, kc, sc, sc, 0,
            torch.zeros((2,), dtype=torch.int32, device=m))
    w13 = torch.zeros((1, 64, 256), dtype=torch.uint8, device=m)
    w2 = torch.zeros((1, 64, 128), dtype=torch.uint8, device=m)
    with pytest.raises(ValueError):
        FF.ffn_block_fused(
            torch.zeros((2, 128), device=m), w13,
            torch.ones((1, 1, 256), device=m), torch.ones((1, 1, 256),
                                                          device=m),
            w2, torch.ones((1, 1, 128), device=m),
            torch.ones((1, 1, 128), device=m), torch.ones((1, 128),
                                                          device=m),
            0, 128, 1e-6)
    for fn in (QM.quant_matmul_s4, MV.bf16_matvec,
               A.decode_attention_update, FF.ffn_block_fused):
        assert fn.launches == 0
