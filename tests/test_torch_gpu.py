"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test skips without CUDA (decided inside the fixture, so that
all workers collect the same tests). Run them on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(tests/conftest.py configures JAX, which the GPU machine need not have).

chip_smoke.py repeats these checks at LLaMA-7B shapes with timings.
"""

import numpy as np
import pytest
import torch

from sparsebit_tpu_torch.ops import attention as A
from sparsebit_tpu_torch.llm.llama import llama_tiny
from sparsebit_tpu_torch.ops import ffn_fused as FF
from sparsebit_tpu_torch.ops import flash_attention as FA
from sparsebit_tpu_torch.ops import layer_fused as LF
from sparsebit_tpu_torch.ops import matvec as MV
from sparsebit_tpu_torch.ops import quant_matmul as QM
from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant
from sparsebit_tpu_torch.ops.packing import pack_columns, pack_s4_rows

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    return torch.device("cuda")


def _s4(rng, lead, K, N, gs, dev):
    codes = torch.from_numpy(rng.integers(0, 16, lead + (K, N)).astype(
        np.uint8))
    s = torch.from_numpy(rng.uniform(0.001, 0.01, lead + (K // gs, N)).astype(
        np.float32)).to(torch.bfloat16)
    z = torch.from_numpy(rng.integers(0, 16, lead + (K // gs, N)).astype(
        np.float32)).to(torch.bfloat16)
    return pack_s4_rows(codes).to(dev), s.to(dev), z.to(dev)


@pytest.mark.parametrize("M", [1, 8, 33, 64, 65, 128, 200, 770])
@pytest.mark.parametrize("K,N", [(256, 320), (384, 200), (4096, 4096)])
@pytest.mark.parametrize("gs,sz_bf16", [(64, False), (128, True)])
def test_k1_kernel_matches_plain(cuda, M, K, N, gs, sz_bf16):
    """Bit-equal to the plain version in the kernel's order (k1_plan: the
    streaming tile's K split up to M = 64, the groups in order above), and
    within rel 1e-5 of max |out| of the sequential group order. M = 64 /
    65 straddle the crossover, 770 is ragged at the admission tile's 128
    rows, N = 200 the column edge (8-byte copies), 4096 x 4096 a shape
    whose plan splits (gps 2 at gs 128)."""
    rng = np.random.default_rng(M + K + gs)
    w, s, z = _s4(rng, (2,), K, N, gs, cuda)
    if not sz_bf16:
        s, z = s.float(), z.float()
    x8, xs = tokenwise_quant(torch.randn((M, K), device=cuda))
    before = QM.quant_matmul_s4.launches
    out = QM.quant_matmul_s4(x8, xs, w, s, z, gs, li=1)
    gps = QM.k1_plan(M, K, N, gs)[1]
    ref = QM._qmm_s4_plain(x8, xs, w[1], s[1], z[1], gs, gps)
    seq = QM._qmm_s4_plain(x8, xs, w[1], s[1], z[1], gs)
    torch.cuda.synchronize()
    assert QM.quant_matmul_s4.launches == before + 1
    assert torch.equal(out, ref)
    assert (out - seq).abs().max().item() <= 1e-5 * seq.abs().max().item()
    assert torch.equal(out, QM.quant_matmul_s4(x8, xs, w, s, z, gs, li=1))


def test_k2_kernel_matches_plain(cuda):
    """GQA n_rep = 2: codes and scales bit-exact, out atol 2e-3 of the
    plain version and of the cluster-order oracle."""
    g = torch.Generator(device=cuda).manual_seed(0)
    L, B, S, H, Hkv, D = 2, 4, 64, 8, 4, 128
    k = torch.randint(-128, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                      generator=g, device=cuda)
    v = torch.randint(-128, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                      generator=g, device=cuda)
    ks = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.05
    vs = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.05
    q = torch.randn((B, H, D), generator=g, device=cuda)
    kn = torch.randn((B, Hkv, D), generator=g, device=cuda)
    vn = torch.randn((B, Hkv, D), generator=g, device=cuda)
    length = torch.tensor([0, 7, 40, 63], dtype=torch.int32, device=cuda)
    plain = [t.clone() for t in (k, v, ks, vs)]
    out = A.decode_attention_update(q, kn, vn, k, v, ks, vs, 1, length)
    ref = A._attn_update_plain(q, kn, vn, *plain, 1, length)
    C = A.k2_cluster(B, S, Hkv, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    oracle = A._attn_update_cluster_plain(
        q, kn, vn, *[t.clone() for t in plain], 1, length, C)
    for a, b in zip((k, v, ks, vs), plain):
        assert torch.equal(a, b)
    assert (out - ref).abs().max().item() <= 2e-3
    assert (out - oracle).abs().max().item() <= 2e-3


@pytest.mark.parametrize("H,Hkv,D,S", [(2, 2, 384, 64), (4, 2, 512, 64),
                                       (64, 1, 128, 300)])
def test_k2_wide_heads_match_plain(cuda, H, Hkv, D, S):
    """K2 at head_dim 384 and 512 and at 64 query heads per kv head (the
    reference's route admits them): codes and scales bit-exact, out atol
    2e-3."""
    g = torch.Generator(device=cuda).manual_seed(D + H)
    L, B = 2, 3
    k = torch.randint(-128, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                      generator=g, device=cuda)
    v = torch.randint(-128, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                      generator=g, device=cuda)
    ks = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.05
    vs = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.05
    q = torch.randn((B, H, D), generator=g, device=cuda)
    kn = torch.randn((B, Hkv, D), generator=g, device=cuda)
    vn = torch.randn((B, Hkv, D), generator=g, device=cuda)
    length = torch.tensor([0, 7, S - 1], dtype=torch.int32, device=cuda)
    plain = [t.clone() for t in (k, v, ks, vs)]
    before = A.decode_attention_update.launches
    out = A.decode_attention_update(q, kn, vn, k, v, ks, vs, 1, length)
    ref = A._attn_update_plain(q, kn, vn, *plain, 1, length)
    assert A.decode_attention_update.launches == before + 1
    for a, b in zip((k, v, ks, vs), plain):
        assert torch.equal(a, b)
    assert (out - ref).abs().max().item() <= 2e-3


@pytest.mark.parametrize("dim,F,gs", [(256, 384, 128), (1024, 4352, 64)])
@pytest.mark.parametrize("B", [1, 8, 20, 64])
def test_k3_kernel_matches_plain(cuda, B, dim, F, gs):
    """Bit-equal to the plain version, which takes every sum in the
    kernel's order (the norm's tree, s4_plan's K splits; at 1024 x 4352
    the plan splits W13 and W2 in runs of more than one group), and equal
    on a second launch; one launch of the kernel library a call."""
    from sparsebit_tpu_torch.ops import _kernels

    rng = np.random.default_rng(B + dim)
    w13, s13, z13 = _s4(rng, (2,), dim, 2 * F, gs, cuda)
    w2, s2, z2 = _s4(rng, (2,), F, dim, gs, cuda)
    nw = torch.from_numpy(rng.uniform(0.5, 1.5, (2, dim)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    x = torch.randn((B, dim), device=cuda).to(torch.bfloat16)
    calls = []
    real = _kernels.lib()

    class Lib:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(real, name)

    before = FF.ffn_block_fused.launches
    orig = _kernels.lib
    _kernels.lib = Lib
    try:
        out = FF.ffn_block_fused(x, w13, s13, z13, w2, s2, z2, nw, 1, gs,
                                 1e-6)
    finally:
        _kernels.lib = orig
    ref = FF._ffn_plain(x.float(), w13[1], s13[1], z13[1], w2[1], s2[1],
                        z2[1], nw[1], gs, 1e-6)
    assert calls == ["sbt_ffn_block"]
    assert FF.ffn_block_fused.launches == before + 1
    assert torch.equal(out, ref)
    assert torch.equal(out, FF.ffn_block_fused(x, w13, s13, z13, w2, s2, z2,
                                               nw, 1, gs, 1e-6))


@pytest.mark.parametrize("B,S,H,Hkv,D,lens", [
    (8, 2048, 32, 32, 128, [0, 1, 255, 1024, 1025, 1500, 2046, 2047]),
    (2, 64, 4, 4, 128, [0, 63]),           # one CTA a cluster
    (3, 512, 8, 1, 100, [511, 256, 2]),    # 4-byte copies
    (2, 256, 4, 2, 70, [255, 130])])       # 1-byte copies
def test_k2_cluster_matches_plain(cuda, B, S, H, Hkv, D, lens):
    """K2 over rows split across a cluster at S = 2048 (lengths at the
    ends and at the split boundary), with a single CTA, and at head dims
    whose rows take narrower copies: codes and scales bit-exact, out within
    2e-3 of the plain version and of the cluster-order oracle, and equal
    on a second launch."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    L = 2
    k = torch.randint(-128, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                      generator=g, device=cuda)
    v = torch.randint(-128, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                      generator=g, device=cuda)
    ks = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.05
    vs = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.05
    q = torch.randn((B, H, D), generator=g, device=cuda)
    kn = torch.randn((B, Hkv, D), generator=g, device=cuda)
    vn = torch.randn((B, Hkv, D), generator=g, device=cuda)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    plain = [t.clone() for t in (k, v, ks, vs)]
    again = [t.clone() for t in (k, v, ks, vs)]
    out = A.decode_attention_update(q, kn, vn, k, v, ks, vs, 1, length)
    ref = A._attn_update_plain(q, kn, vn, *plain, 1, length)
    C = A.k2_cluster(B, S, Hkv, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    oracle = A._attn_update_cluster_plain(
        q, kn, vn, *[t.clone() for t in again], 1, length, C)
    for a, b in zip((k, v, ks, vs), plain):
        assert torch.equal(a, b)
    assert (out - ref).abs().max().item() <= 2e-3
    assert (out - oracle).abs().max().item() <= 2e-3
    assert torch.equal(out, A.decode_attention_update(
        q, kn, vn, *again, 1, length))


@pytest.mark.parametrize("B", [1, 5, 8])
def test_k9_kernel_matches_plain(cuda, B):
    """rel 1e-3: bf16 products exact in f32, sums in another order."""
    x = torch.randn((B, 384), device=cuda)
    w = (torch.randn((384, 1000), device=cuda) * 0.05).to(torch.bfloat16)
    out = MV.bf16_matvec(x, w)
    ref = MV._bf16_matvec_plain(x, w)
    assert (out - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


@pytest.mark.parametrize("B", range(1, 9))
def test_k9_ragged_n_matches_plain(cuda, B):
    """N = 1002 (N % 8 != 0: the narrow-load path) and K = 4160 (ranges
    that do not divide K): rel 1e-3 of max |out|, and equal bits on a
    second call (the splits are added in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn((B, 4160), generator=g, device=cuda)
    w = (torch.randn((4160, 1002), generator=g, device=cuda) * 0.05).to(
        torch.bfloat16)
    out = MV.bf16_matvec(x, w)
    ref = MV._bf16_matvec_plain(x, w)
    assert (out - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()
    assert torch.equal(out, MV.bf16_matvec(x, w))


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_k9_unaligned_w_matches_plain(cuda, offset):
    """A contiguous W view whose pointer is not 16-byte aligned (2, 4 or 8
    bytes past it), N % 8 == 0: the kernel takes its narrow-load path and
    agrees with the plain version (rel 1e-3 of max |out|)."""
    K, N, B = 1024, 2048, 8
    flat = (torch.randn((K * N + 8,), device=cuda) * 0.05).to(torch.bfloat16)
    w = flat[offset:offset + K * N].view(K, N)
    assert w.is_contiguous() and w.data_ptr() % 16
    x = torch.randn((B, K), device=cuda)
    out = MV.bf16_matvec(x, w)
    ref = MV._bf16_matvec_plain(x, w)
    assert (out - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


def _k4_operands(dev, B, S, n_blocks=None, Hkv=4, D=128, seed=0, F=384,
                 H=4):
    """Tiny K4 operands (H query heads of D, Hkv kv heads, ffn F, gs 64,
    two layers) with a cache of S rows per batch row, or a pool of
    n_blocks blocks of 128 rows."""
    dim = H * D
    cfg = llama_tiny(dim=dim, n_heads=H, n_kv_heads=Hkv, ffn_dim=F,
                     max_seq_len=S)
    rng = np.random.default_rng(seed)
    ws = []
    for K, N in ((dim, dim + 2 * Hkv * D), (dim, dim), (dim, 2 * F),
                 (F, dim)):
        w, s, z = _s4(rng, (2,), K, N, 64, dev)
        ws += [w, s * 2, z]
    norms = [torch.from_numpy(1 + 0.1 * rng.standard_normal((2, dim))).to(
        dev, torch.bfloat16) for _ in range(2)]
    lead = (2, B, S) if n_blocks is None else (2, n_blocks, 128)
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(-127, 128, lead + (Hkv, D), dtype=torch.int8,
                      generator=g, device=dev)
    v = torch.randint(-127, 128, lead + (Hkv, D), dtype=torch.int8,
                      generator=g, device=dev)
    ks = (torch.rand(lead + (Hkv,), generator=g, device=dev) * 0.01).to(
        torch.bfloat16).float()
    vs = (torch.rand(lead + (Hkv,), generator=g, device=dev) * 0.01).to(
        torch.bfloat16).float()
    x = torch.randn((B, dim), generator=g, device=dev)
    pos = torch.from_numpy(rng.integers(0, S, B).astype(np.int32)).to(dev)
    pos[0] = min(130, S - 1)  # past the first 128-row block
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=dev) / D))
    ang = pos[:, None].float() * inv
    cos = torch.cat([torch.cos(ang)] * 2, 1)
    sin = torch.cat([torch.sin(ang)] * 2, 1)
    return cfg, x, pos, cos, sin, ws, norms, [k, v, ks, vs]


@pytest.mark.parametrize("B,paged,Hkv,D,F", [
    (1, False, 4, 128, 384), (8, False, 4, 128, 384),
    (8, True, 4, 128, 384),
    # B = 9..16 take the s4r tile's one m16 tile, B > 16 its 64-row
    # tiles; Hkv 2 puts two query heads on a kv head (GQA), Hkv 1 four;
    # D = 64 splits the value mix into 16 row groups; F = 320 gives W2 5
    # groups (an odd count for every split)
    (9, False, 4, 128, 384), (20, False, 2, 128, 384),
    (32, False, 4, 128, 384), (3, True, 2, 64, 384),
    (4, True, 1, 128, 384), (8, False, 4, 128, 320),
    (32, True, 2, 128, 320)])
def test_k4_kernel_matches_plain(cuda, B, paged, Hkv, D, F):
    """The megakernel against its plain version on the same card: output,
    KV codes and scales bit-equal (the plain version takes every float
    sum in the kernel's order, its s4r matmuls in the kernel's K-split
    order)."""
    S = 256
    bt = None
    n_blocks = None
    if paged:
        n_blocks = 2 * B + 3
        perm = np.random.default_rng(B).permutation(n_blocks)[:2 * B]
        bt = torch.from_numpy(perm.reshape(B, 2).astype(np.int32)).to(cuda)
    cfg, x, pos, cos, sin, ws, norms, cache = _k4_operands(
        cuda, B, S, n_blocks, Hkv, D, F=F)
    plain = [t.clone() for t in cache]
    before = LF.fused_decoder_layers.launches
    out, *_ = LF.fused_decoder_layers(x, pos, cos, sin, *ws, *norms, *cache,
                                      cfg, 64, bt=bt)
    if bt is None:
        bt = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    ref = LF._fused_layers_plain(
        x, pos, cos, sin, [tuple(ws[i:i + 3]) for i in range(0, 12, 3)],
        *norms, *plain, bt, bt.shape[1] * cache[0].shape[2], 64,
        cfg.rms_eps, 4, Hkv)
    torch.cuda.synchronize()
    assert LF.fused_decoder_layers.launches == before + 1
    for a, b in zip(cache, plain):
        assert torch.equal(a, b)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("wide", [False, True])
def test_k4_b1_row_equals_batched_row(cuda, wide):
    """Row 0 of a B = 8 launch equals the B = 1 launch of that row bit
    for bit (output and its cache row): the s4r plan reads no batch size.
    wide: dim 2048, ffn 2816, where the plan splits Wqkv, W13 and W2."""
    kw = dict(H=16, Hkv=4, F=2816) if wide else {}
    cfg, x, pos, cos, sin, ws, norms, cache = _k4_operands(cuda, 8, 256,
                                                           **kw)
    if wide:
        K_N = ((2048, 3072), (2048, 2048), (2048, 5632), (2816, 2048))
        assert sum(1 < gps < K // 64 for (gps, _), (K, _) in
                   zip(LF.s4_splits(K_N, 64), K_N)) >= 2
    one = [t[:, :1].clone() for t in cache]
    out8, *_ = LF.fused_decoder_layers(x, pos, cos, sin, *ws, *norms,
                                       *cache, cfg, 64)
    out1, *_ = LF.fused_decoder_layers(x[:1], pos[:1], cos[:1], sin[:1],
                                       *ws, *norms, *one, cfg, 64)
    torch.cuda.synchronize()
    assert torch.equal(out8[:1], out1)
    for a, b in zip(one, cache):
        assert torch.equal(a[:, 0], b[:, 0])


def _planes(rng, bits, K, N, G, dev):
    codes = rng.integers(0, 2 ** bits, (K, N)).astype(np.uint8)
    s = rng.uniform(0.001, 0.01, (G, N)).astype(np.float32)
    z = rng.integers(0, 2 ** bits, (G, N)).astype(np.float32)
    packed = {k: v.to(dev) for k, v in
              pack_columns(torch.from_numpy(codes), bits).items()}
    return packed, torch.from_numpy(s).to(dev), torch.from_numpy(z).to(dev)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("M,gs,sz_bf16", [
    (1, 128, False), (8, 64, True), (37, -1, False), (64, 128, True)])
def test_k6_k7_k8_kernels_match_plain(cuda, bits, a8, M, gs, sz_bf16):
    """K8 (f32 x) / K6 (int8 x) over the "w" planes, K7 over the 3-bit
    planes, against _qmm_planes_plain: rel 1e-4 of max |out| (f32 sums
    in another order; the int8 dots are exact)."""
    rng = np.random.default_rng(bits * 100 + M)
    K, N = 256, 1024
    G = K // gs if gs > 0 else 1
    packed, s, z = _planes(rng, bits, K, N, G, cuda)
    if sz_bf16:
        s, z = s.to(torch.bfloat16), z.to(torch.bfloat16)
    x = torch.randn((M, K), device=cuda)
    if a8:
        x = tokenwise_quant(x)[0]
    if bits == 3:
        fn = QM.quant_matmul_3bit
        out = fn(x, packed, s, z, gs, N, a8=a8)
    else:
        fn = QM.quant_matmul_w_a8 if a8 else QM.quant_matmul_w
        out = fn(x, packed["w"], s, z, bits, gs, N)
    ref = QM._qmm_planes_plain(x, packed, s, z, bits, gs, N)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_k7_reads_the_plane_concat(cuda):
    """The "pl" serving concat: low2 and high1 are column slices of one
    array with its own row stride."""
    rng = np.random.default_rng(7)
    K, N = 256, 1024
    packed, s, z = _planes(rng, 3, K, N, 2, cuda)
    pl = {"pl": torch.cat([packed["low2"], packed["high1"]], dim=1)}
    x = torch.randn((4, K), device=cuda)
    out = QM.quant_matmul_3bit(x, pl, s, z, 128, N)
    ref = QM._qmm_planes_plain(x, packed, s, z, 3, 128, N)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _planes_case(rng, bits, K, N, gs, dev, sz_bf16):
    """Random codes of a K x N weight (N the padded width) in the "w" or
    low2/high1 planes, f32 or bf16 qparams (gs <= 0: per channel)."""
    G = K // gs if gs > 0 else 1
    packed, s, z = _planes(rng, bits, K, N, G, dev)
    if sz_bf16:
        s, z = s.to(torch.bfloat16), z.to(torch.bfloat16)
    return packed, s, z


def _planes_call(x, packed, s, z, bits, gs, N, a8):
    if bits == 3:
        return QM.quant_matmul_3bit(x, packed, s, z, gs, N, a8=a8)
    fn = QM.quant_matmul_w_a8 if a8 else QM.quant_matmul_w
    return fn(x, packed["w"], s, z, bits, gs, N)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_k6_k7_k8_split_k_match_plain(cuda, bits, a8, M):
    """K split across blocks (K = 2048, 16 groups of 128, N = 1408 (3-bit:
    11 x 128 byte columns, as LLaMA's padded W13 is 22 x 128) so that the
    plan splits K): rel 1e-4 of max |out| against the plain version and
    against the split oracle (_qmm_planes_split_plain at the plan's
    groups a split: f32 x as x . (C - z) per group, partials added in
    split order), and equal bits on a second call."""
    rng = np.random.default_rng(bits * 10 + M)
    K, N, gs = 2048, 1408 if bits == 3 else 1024, 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gps, splits = QM.planes_plan(bits, M, K, N, gs, sms)[2:]
    assert splits > 1
    packed, s, z = _planes_case(rng, bits, K, N, gs, cuda, M == 8)
    x = torch.randn((M, K), device=cuda)
    if a8:
        x = tokenwise_quant(x)[0]
    out = _planes_call(x, packed, s, z, bits, gs, N, a8)
    again = _planes_call(x, packed, s, z, bits, gs, N, a8)
    ref = QM._qmm_planes_plain(x, packed, s, z, bits, gs, N)
    oracle = QM._qmm_planes_split_plain(x, packed, s, z, bits, gs, N, gps)
    torch.cuda.synchronize()
    tol = 1e-4 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol
    assert (out - oracle).abs().max().item() <= tol
    assert torch.equal(out, again)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("offset,pad", [(1, 0), (2, 0), (4, 0), (8, 0),
                                        (0, 1), (0, 4), (0, 8)])
def test_k6_k7_k8_unaligned_planes_match_plain(cuda, bits, offset, pad):
    """Weight rows whose base pointer (offset bytes past 16) or row stride
    (pad bytes past the packed width) is not 16-byte aligned: the same
    kernel with narrower copies (8 or 4 bytes, or byte loads). f32 and
    int8 x, M = 8: rel 1e-4 of max |out|."""
    rng = np.random.default_rng(bits + 7 * offset + pad)
    K, N, gs = 512, 1024, 128
    packed, s, z = _planes_case(rng, bits, K, N, gs, cuda, False)
    moved = {}
    for key, w in packed.items():
        flat = torch.zeros((K * (w.shape[1] + pad) + offset + 16,),
                           dtype=torch.uint8, device=cuda)
        view = flat[offset:offset + K * (w.shape[1] + pad)].view(
            K, w.shape[1] + pad)[:, :w.shape[1]]
        view.copy_(w)
        moved[key] = view
    assert all(t.data_ptr() % 16 or t.stride(0) % 16 for t in moved.values())
    for a8 in (False, True):
        x = torch.randn((8, K), device=cuda)
        if a8:
            x = tokenwise_quant(x)[0]
        out = _planes_call(x, moved, s, z, bits, gs, N, a8)
        ref = QM._qmm_planes_plain(x, packed, s, z, bits, gs, N)
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() <= \
            1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_k7_padded_plane_concat_matches_plain(cuda, a8, M):
    """K7 over the "pl" concat of a padded width (N 1000 -> 1024, the
    columns past 1000 computed and ignored by the caller), low2 and high1
    column slices with the concat's row stride, bf16 qparams, K split:
    rel 1e-4 of max |out| on the logical columns."""
    from sparsebit_tpu_torch.ops.packing import pallas_n_pad

    rng = np.random.default_rng(M + 3)
    K, gs = 2048, 128
    Np = 1000 + pallas_n_pad(1000, 3)
    packed, s, z = _planes_case(rng, 3, K, Np, gs, cuda, True)
    pl = {"pl": torch.cat([packed["low2"], packed["high1"]], dim=1)}
    x = torch.randn((M, K), device=cuda)
    if a8:
        x = tokenwise_quant(x)[0]
    out = QM.quant_matmul_3bit(x, pl, s, z, gs, Np, a8=a8)[:, :1000]
    ref = QM._qmm_planes_plain(x, packed, s, z, 3, gs, Np)[:, :1000]
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 128), (8, 2, 128), (8, 1, 256),
                                     (12, 1, 64), (4, 1, 384), (8, 1, 512)])
def test_k5_float_caches_match_plain(cuda, dtype, H, Hkv, D):
    """K5 over an f16 or f32 cache (an unquantized cache of an f16 or f32
    model), ragged lengths, a layer of a stack, head_dim up to 512 (4
    chunks a lane): atol 2e-4."""
    g = torch.Generator(device=cuda).manual_seed(6)
    L, B, S = 2, 4, 300
    k = torch.randn((L, B, S, Hkv, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((L, B, S, Hkv, D), generator=g, device=cuda).to(dtype)
    q = torch.randn((B, H, D), generator=g, device=cuda)
    length = torch.tensor([0, 31, 200, 299], dtype=torch.int32, device=cuda)
    before = A.decode_attention.launches
    out = A.decode_attention_stacked(q, k, v, None, None, 1, length)
    ref = A._decode_attn_plain(q, k[1], v[1], None, None, length)
    torch.cuda.synchronize()
    assert A.decode_attention.launches == before + 1
    assert (out - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 128), (8, 2, 128), (8, 1, 256)])
def test_k5_kernel_matches_plain(cuda, quant, H, Hkv, D):
    """Decode attention over an int8 or bf16 cache, ragged lengths and a
    layer of a stack: atol 2e-4 (the reference's oracle tolerance)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    L, B, S = 2, 4, 300
    if quant:
        k = torch.randint(-127, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                          generator=g, device=cuda)
        v = torch.randint(-127, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                          generator=g, device=cuda)
        ks = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.002
        vs = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.01
    else:
        k = torch.randn((L, B, S, Hkv, D), generator=g, device=cuda).to(
            torch.bfloat16)
        v = torch.randn((L, B, S, Hkv, D), generator=g, device=cuda).to(
            torch.bfloat16)
        ks = vs = None
    q = torch.randn((B, H, D), generator=g, device=cuda)
    length = torch.tensor([0, 31, 200, 299], dtype=torch.int32, device=cuda)
    before = A.decode_attention.launches
    out = A.decode_attention_stacked(q, k, v, ks, vs, 1, length)
    ref = A._decode_attn_plain(q, k[1], v[1], None if ks is None else ks[1],
                               None if vs is None else vs[1], length)
    torch.cuda.synchronize()
    assert A.decode_attention.launches == before + 1
    assert (out - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("H,Hkv,D", [(8, 1, 256), (4, 4, 32), (4, 4, 64),
                                     (16, 2, 128), (12, 1, 128), (8, 1, 384),
                                     (2, 2, 384), (2, 2, 512)])
def test_k5_split_edges_match_plain(cuda, quant, H, Hkv, D):
    """K5's flash-decoding splits at their edges: S = 700 (a ragged last
    split), lengths 0, 1, 300 and S - 1 (splits wholly past the length),
    query-head groups of 1-8 heads (n_rep 12: a group of 8 and one of 4),
    head_dim 384 and 512 (2 or 4 chunks a lane): atol 2e-4 against the
    plain version and the split oracle, and equal bits on a second
    call."""
    g = torch.Generator(device=cuda).manual_seed(D + H)
    L, B, S = 2, 4, 700
    if quant:
        k = torch.randint(-127, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                          generator=g, device=cuda)
        v = torch.randint(-127, 128, (L, B, S, Hkv, D), dtype=torch.int8,
                          generator=g, device=cuda)
        ks = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.002
        vs = torch.rand((L, B, S, Hkv), generator=g, device=cuda) * 0.01
    else:
        k = torch.randn((L, B, S, Hkv, D), generator=g, device=cuda).to(
            torch.bfloat16)
        v = torch.randn((L, B, S, Hkv, D), generator=g, device=cuda).to(
            torch.bfloat16)
        ks = vs = None
    q = torch.randn((B, H, D), generator=g, device=cuda)
    length = torch.tensor([0, 1, 300, S - 1], dtype=torch.int32, device=cuda)
    out = A.decode_attention_stacked(q, k, v, ks, vs, 1, length)
    again = A.decode_attention_stacked(q, k, v, ks, vs, 1, length)
    sc = (lambda t: None if t is None else t[1])
    ref = A._decode_attn_plain(q, k[1], v[1], sc(ks), sc(vs), length)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    R = A.rows_per_split(B, S, Hkv, H // Hkv, sms)
    oracle = A._decode_attn_split_plain(q, k[1], v[1], sc(ks), sc(vs),
                                        length, R)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2e-4
    assert (out - oracle).abs().max().item() <= 2e-4
    assert torch.equal(out, again)


def _to(obj, dev):
    """A params tree (tensors, dicts, lists, linears) on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to(v, dev) for v in obj]
    if hasattr(obj, "__dict__"):
        out = obj.__class__.__new__(obj.__class__)
        out.__dict__ = {k: _to(v, dev) for k, v in obj.__dict__.items()}
        return out
    return obj


def _decode_rows(params, cfg, prompt, toks=None):
    """prefill, then three decode_steps fed ``toks`` (or the greedy ones,
    returned): the logits of each, on the CPU."""
    from sparsebit_tpu_torch.llm import decode as D
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache

    dev = params["tok_embed"].device
    cache = init_kv_cache(cfg, prompt.shape[0], 16, device=dev)
    lg, cache = D.prefill(params, prompt.to(dev), cache, cfg)
    out, fed = [lg.cpu()], []
    for t in range(3):
        tok = (lg.argmax(-1).to(torch.int32) if toks is None
               else toks[t].to(dev))
        fed.append(tok.cpu())
        lg, cache = D.decode_step(params, tok, cache, cfg)
        out.append(lg.cpu())
    return out, fed


@pytest.mark.parametrize("impl", ["auto", "a8"])
def test_decode_step_on_the_card_matches_the_cpu(cuda, impl):
    """prefill and three decode_steps of a small unfused model with 3/4/8
    bit linears: on the card through K5-K8, on the CPU through the plain
    versions. Logits within atol 0.1, argmax equal where the top-2 margin
    exceeds 0.2 (bf16 activations may round differently when f32 sums are
    taken in another order)."""
    from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear

    cfg = llama_tiny(dim=512, n_heads=4, n_kv_heads=2, ffn_dim=1024)
    rng = np.random.default_rng(11)
    shapes = {"wq": (512, 512), "wk": (512, 256), "wv": (512, 256),
              "wo": (512, 512), "w1": (512, 1024), "w3": (512, 1024),
              "w2": (1024, 512)}

    def lin(i, K, N):
        bits = (3, 4, 8)[i % 3]
        codes = torch.from_numpy(rng.integers(0, 2 ** bits, (K, N)))
        s = torch.from_numpy(rng.uniform(0.002, 0.02, (K // 128, N)).astype(
            np.float32) * 16 / 2 ** bits)
        z = torch.full((K // 128, N), float(2 ** (bits - 1)))
        return QuantLinear.from_codes(codes, s, z, bits, 128, impl=impl)

    ones = torch.ones(512, dtype=torch.bfloat16)
    emb = torch.from_numpy(rng.standard_normal((cfg.vocab_size, 512)).astype(
        np.float32) * 0.02).to(torch.bfloat16)
    params = {"tok_embed": emb, "norm": ones,
              "lm_head": DenseLinear(emb.t().contiguous()),
              "layers": [dict({n: lin(i + li, *shapes[n])
                               for i, n in enumerate(shapes)},
                              attn_norm=ones, ffn_norm=ones)
                         for li in range(cfg.n_layers)]}
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    launches = {w: w.launches for w in (A.decode_attention, QM.quant_matmul_w,
                                        QM.quant_matmul_w_a8,
                                        QM.quant_matmul_3bit)}
    rows = {}
    toks = None  # the CPU's greedy tokens, fed to the card as well
    for dev in ("cpu", cuda):
        rows[str(dev)], toks = _decode_rows(_to(params, dev), cfg, prompt,
                                            toks)
    torch.cuda.synchronize()
    used = [w for w, n in launches.items() if w.launches > n]
    want = {A.decode_attention, QM.quant_matmul_3bit,
            QM.quant_matmul_w if impl == "auto" else QM.quant_matmul_w_a8}
    assert set(used) == want
    for a, b in zip(rows[str(cuda)], rows["cpu"]):
        assert (a - b).abs().max().item() <= 0.1
        top2 = torch.topk(b, 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 0.2
        assert torch.equal(a.argmax(-1)[decisive], b.argmax(-1)[decisive])


def _k4_plane_operands(dev, B, S, bits, n_blocks=None, seed=0, extra=None):
    """The tiny K4 operands with every linear in the true-width plane
    concat at ``bits`` (N padded as the JAX package pads it: Wqkv 1536 ->
    2048 at 3 bits, W13 768 -> 1024; or by ``extra`` columns) and bf16
    qparams."""
    from sparsebit_tpu_torch.ops.packing import (pack_planes_serving,
                                                 pallas_n_pad)

    cfg, x, pos, cos, sin, _, norms, cache = _k4_operands(dev, B, S,
                                                          n_blocks,
                                                          seed=seed)
    rng = np.random.default_rng(seed + 50)
    ws = []
    for K, N in ((512, 1536), (512, 512), (512, 768), (384, 512)):
        Np = N + (pallas_n_pad(N, bits) if extra is None else extra)
        codes = torch.from_numpy(rng.integers(0, 2 ** bits, (2, K, Np)).astype(
            np.uint8))
        s = torch.from_numpy(rng.uniform(0.002, 0.02, (2, K // 64, Np)).astype(
            np.float32)).to(torch.bfloat16)
        z = torch.from_numpy(rng.integers(0, 2 ** bits, (2, K // 64, Np)
                                          ).astype(np.float32)).to(
            torch.bfloat16)
        ws += [pack_planes_serving(codes, bits).to(dev), s.to(dev), z.to(dev)]
    return cfg, x, pos, cos, sin, ws, norms, cache


@pytest.mark.parametrize("bits", [3, 2])
@pytest.mark.parametrize("B,paged", [(1, False), (8, False), (8, True),
                                     (20, False)])
def test_k4_plane_mode_matches_plain(cuda, bits, B, paged):
    """K4's plane mode against its plain version on the same card: output,
    KV codes and scales bit for bit (every float sum in one order)."""
    S, bt, n_blocks = 256, None, None
    if paged:
        n_blocks = 2 * B + 3
        perm = np.random.default_rng(B).permutation(n_blocks)[:2 * B]
        bt = torch.from_numpy(perm.reshape(B, 2).astype(np.int32)).to(cuda)
    cfg, x, pos, cos, sin, ws, norms, cache = _k4_plane_operands(
        cuda, B, S, bits, n_blocks)
    plain = [t.clone() for t in cache]
    before = LF.fused_decoder_layers.launches
    out, *_ = LF.fused_decoder_layers(x, pos, cos, sin, *ws, *norms, *cache,
                                      cfg, 64, bt=bt, wbits=bits)
    if bt is None:
        bt = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    ref = LF._fused_layers_plain(
        x, pos, cos, sin, [tuple(ws[i:i + 3]) for i in range(0, 12, 3)],
        *norms, *plain, bt, bt.shape[1] * cache[0].shape[2], 64,
        cfg.rms_eps, 4, 4, wbits=bits)
    torch.cuda.synchronize()
    assert LF.fused_decoder_layers.launches == before + 1
    for a, b in zip(cache, plain):
        assert torch.equal(a, b)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("bits,extra", [(3, 8), (3, 32), (2, 4), (2, 16)])
def test_k4_plane_mode_narrow_copies_match_plain(cuda, bits, extra):
    """K4's plane mode over widths padded by ``extra`` columns only, so
    that a row's byte columns NP are odd (copies of single bytes) or a
    multiple of 4 but not of the tile's 8 or 16 (4-byte copies): output,
    KV codes and scales bit for bit against the plain version, B = 8."""
    B, S = 8, 256
    cfg, x, pos, cos, sin, ws, norms, cache = _k4_plane_operands(
        cuda, B, S, bits, extra=extra)
    plain = [t.clone() for t in cache]
    out, *_ = LF.fused_decoder_layers(x, pos, cos, sin, *ws, *norms, *cache,
                                      cfg, 64, wbits=bits)
    bt = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    ref = LF._fused_layers_plain(
        x, pos, cos, sin, [tuple(ws[i:i + 3]) for i in range(0, 12, 3)],
        *norms, *plain, bt, S, 64, cfg.rms_eps, 4, 4, wbits=bits)
    torch.cuda.synchronize()
    for a, b in zip(cache, plain):
        assert torch.equal(a, b)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("bits", [4, 3])
@pytest.mark.parametrize("B", [1, 8, 20])
def test_k4_k_padded_w2_matches_unpadded(cuda, bits, B):
    """K4 over a W2 K-padded as QuantLinear.with_k_pad pads it (F = 384
    rows to 512: code 0, zero 0, scale 1): output, KV codes and scales
    bit-equal to the unpadded launch and to the plain version (the kernel
    reads each layer's first F rows of the padded stack)."""
    S = 256
    if bits == 4:
        cfg, x, pos, cos, sin, ws, norms, cache = _k4_operands(cuda, B, S)
        fill = 0x88  # s4r stores code - 8: code 0 rows
    else:
        cfg, x, pos, cos, sin, ws, norms, cache = _k4_plane_operands(
            cuda, B, S, bits)
        fill = 0
    w2, s2, z2 = ws[9:12]
    rows = 64 if bits == 4 else 128  # 128 more logical rows, two groups
    wp = list(ws[:9]) + [
        torch.cat([w2, torch.full((2, rows, w2.shape[-1]), fill,
                                  dtype=torch.uint8, device=cuda)], 1),
        torch.cat([s2, torch.ones_like(s2[:, :2])], 1),
        torch.cat([z2, torch.zeros_like(z2[:, :2])], 1)]
    assert LF.fused_layer_supported(cfg, 64, B, f_pad=512, wbits=bits)
    runs = []
    for w in (ws, wp):
        c = [t.clone() for t in cache]
        out, *_ = LF.fused_decoder_layers(x, pos, cos, sin, *w, *norms, *c,
                                          cfg, 64, wbits=bits)
        runs.append((out, c))
    plain = [t.clone() for t in cache]
    bt = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    ref = LF._fused_layers_plain(
        x, pos, cos, sin, [tuple(wp[i:i + 3]) for i in range(0, 12, 3)],
        *norms, *plain, bt, S, 64, cfg.rms_eps, 4, cfg.n_kv_heads,
        wbits=bits, F=cfg.ffn_dim)
    torch.cuda.synchronize()
    (out, c), (outp, cp) = runs
    assert torch.equal(out, outp) and torch.equal(outp, ref)
    for a, b, r in zip(c, cp, plain):
        assert torch.equal(a, b) and torch.equal(b, r)


def test_decode_step_scanned_planes_on_the_card_matches_the_cpu(cuda):
    """An int3 model served as planes (prepare_params_host(sub4="planes")):
    prefill_scanned and three decode_step_scanned on the card (K4 in plane
    mode) and on the CPU (the plain versions), the CPU's greedy tokens fed
    to both: logits within atol 0.1, argmax equal where the top-2 margin
    exceeds 0.2."""
    from sparsebit_tpu_torch.llm import decode as D
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
    from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear

    cfg = llama_tiny(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=384)
    rng = np.random.default_rng(12)

    def lin(K, N):
        w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
        return QuantLinear.from_dense(torch.from_numpy(w), bits=3,
                                      groupsize=64)

    emb = torch.from_numpy(rng.standard_normal((cfg.vocab_size, 512)).astype(
        np.float32) * 0.02).to(torch.bfloat16)
    ones = torch.ones(512, dtype=torch.bfloat16)
    params = {"tok_embed": emb, "norm": ones,
              "lm_head": DenseLinear(emb.t().contiguous()),
              "layers": [{"wqkv": lin(512, 1536), "wo": lin(512, 512),
                          "w13": lin(512, 768), "w2": lin(384, 512),
                          "attn_norm": ones, "ffn_norm": ones}
                         for _ in range(cfg.n_layers)]}
    stacked = D.stack_layers(D.prepare_params_host(params, sub4="planes"))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    rows, toks = {}, None
    before = LF.fused_decoder_layers.launches
    for dev in ("cpu", cuda):
        p = _to(stacked, dev)
        cache = init_kv_cache(cfg, 2, 16, device=dev)
        lg, cache = D.prefill_scanned(p, prompt.to(dev), cache, cfg)
        out, fed = [lg.cpu()], []
        for t in range(3):
            tok = (lg.argmax(-1).to(torch.int32) if toks is None
                   else toks[t].to(dev))
            fed.append(tok.cpu())
            lg, cache = D.decode_step_scanned(p, tok, cache, cfg)
            out.append(lg.cpu())
        rows[str(dev)], toks = out, fed
    torch.cuda.synchronize()
    assert LF.fused_decoder_layers.launches == before + 3
    for a, b in zip(rows[str(cuda)], rows["cpu"]):
        assert (a - b).abs().max().item() <= 0.1
        top2 = torch.topk(b, 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 0.2
        assert torch.equal(a.argmax(-1)[decisive], b.argmax(-1)[decisive])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,D,layout", [
    (1, 8, 8, 512, 128, "bshd"), (2, 4, 4, 256, 128, "bhsd"),
    (1, 4, 4, 256, 64, "bshd"), (1, 4, 4, 256, 256, "bshd"),
    (2, 4, 4, 100, 128, "bshd"), (1, 4, 4, 2047, 128, "bhsd"),
    (1, 2, 2, 1, 64, "bhsd"), (1, 32, 8, 256, 128, "bshd"),
    (2, 4, 4, 127, 128, "bshd"), (1, 4, 2, 129, 128, "bhsd"),
    (2, 4, 4, 257, 64, "bshd"), (2, 4, 4, 63, 128, "bshd"),
    (1, 4, 2, 65, 128, "bhsd"), (1, 32, 8, 129, 128, "bshd"),
    (1, 32, 8, 2047, 128, "bshd"), (2, 4, 4, 127, 64, "bhsd"),
    (1, 4, 2, 65, 256, "bshd"), (1, 4, 4, 97, 256, "bhsd"),
    (2, 4, 4, 63, 256, "bshd"), (1, 4, 4, 127, 256, "bhsd"),
    (1, 4, 2, 129, 256, "bshd"), (2, 4, 4, 257, 256, "bhsd"),
    (1, 16, 4, 1024, 256, "bshd")])
def test_k10_kernel_matches_plain(cuda, dtype, B, H, Hkv, S, D, layout):
    """K10 against flash_attention_plain on the same operands: the
    7B-shaped head dims, ragged S (100, 2047, 1, and 127 / 129 / 257 around
    the Hopper kernel's 128-row q and key tiles; 63 / 65 / 127 / 129
    around the f32 kernel's 128-row q and 64-key tiles, 65 / 97 around its
    64-row and 32-key ones at head_dim 256; 63 / 65 / 127 / 129 / 257
    around the bf16 head_dim 256 kernel's 64-row q and key tiles), GQA
    32 -> 8 (also at S = 2047) and 16 -> 4 at head_dim 256, and both the
    JAX layout and the port's (B, S, H, D) activations transposed as
    views (read through strides, no copy); a second launch gives the same
    bits."""
    g = torch.Generator(device=cuda).manual_seed(S + D + H)

    def make(h):
        shape = (B, S, h, D) if layout == "bshd" else (B, h, S, D)
        t = torch.randn(shape, generator=g, device=cuda).to(dtype)
        return t.transpose(1, 2) if layout == "bshd" else t

    q, k, v = make(H), make(Hkv), make(Hkv)
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, sm_scale=D ** -0.5)
    ref = FA.flash_attention_plain(q, k, v, sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, H, S, D)
    assert out.stride() == q.stride()  # written in q's layout
    tol = FA.flash_tolerance(q, k, v, ref, sm_scale=D ** -0.5)
    assert ((out.float() - ref.float()).abs() <= tol).all()
    assert torch.equal(out, FA.flash_attention(q, k, v, sm_scale=D ** -0.5))


@pytest.mark.parametrize("B,H,Hkv,S,D", [(4, 32, 32, 512, 128),
                                         (2, 8, 2, 129, 64),
                                         (1, 4, 4, 257, 128),
                                         (4, 16, 16, 512, 256),
                                         (2, 8, 2, 129, 256)])
def test_k10_lse_instantiation_matches_plain(cuda, B, H, Hkv, S, D):
    """K10's kLse instantiation through flash_attention_fwd (the training
    forward) at the qlora path's B=4 S=512, at head_dim 256 (the
    statistics K11/K12 at hd 256 read) and ragged S around the 128- and
    64-row tiles: the output within flash_tolerance of the plain
    version's, each row's log-sum-exp within 2^-14 of it, one launch
    counted, and a second launch bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(B + S + D)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    scale = D ** -0.5
    before = FA.flash_attention.launches
    out, lse = FA.flash_attention_fwd(q, k, v, sm_scale=scale)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, sm_scale=scale,
                                            return_lse=True)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.stride() == q.stride()
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= 2.0 ** -14
    tol = FA.flash_tolerance(q, k, v, ref, sm_scale=scale)
    assert ((out.float() - ref.float()).abs() <= tol).all()
    out2, lse2 = FA.flash_attention_fwd(q, k, v, sm_scale=scale)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_k10_wrapper_raises_on_what_it_does_not_take(cuda):
    """head_dim 96, f16 and a strided last dimension raise on the card;
    nothing falls back to the plain version."""
    before = FA.flash_attention.launches
    q = torch.zeros((1, 4, 64, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q)
    h = torch.zeros((1, 4, 64, 128), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="bf16 or f32"):
        FA.flash_attention(h, h, h)
    w = torch.zeros((1, 4, 64, 256), dtype=torch.bfloat16,
                    device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="strides"):
        FA.flash_attention(w, w, w)
    assert FA.flash_attention.launches == before


def test_causal_attention_on_the_card_takes_k10(cuda):
    """llama.causal_attention on a CUDA query: K10 at a ragged S with kv
    heads not repeated, against the masked route on the same card (f32
    scores and probabilities: within two bf16 ulps of the largest output
    plus P's bf16 rounding, 2e-2)."""
    from sparsebit_tpu_torch.llm import llama as TL

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((2, 100, 4, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((2, 100, 2, 128), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    before = FA.flash_attention.launches
    out = TL.causal_attention(q, k, v)
    mask = torch.triu(torch.full((100, 100), -1e9, device=cuda),
                      diagonal=1)[None, None]
    ref = TL.attention_scores(q, TL.repeat_kv(k, 2), TL.repeat_kv(v, 2),
                              mask)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def _bwd_operands(cuda, dtype, B, H, Hkv, S, D, layout, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def make(h):
        shape = (B, S, h, D) if layout == "bshd" else (B, h, S, D)
        t = torch.randn(shape, generator=g, device=cuda).to(dtype)
        return t.transpose(1, 2) if layout == "bshd" else t

    return make(H), make(Hkv), make(Hkv), make(H)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,D,layout", [
    (1, 8, 8, 512, 128, "bshd"), (2, 4, 4, 256, 128, "bhsd"),
    (1, 4, 4, 256, 64, "bshd"), (1, 4, 4, 256, 256, "bshd"),
    (2, 4, 4, 100, 128, "bshd"), (1, 4, 4, 2047, 128, "bhsd"),
    (1, 2, 2, 1, 64, "bhsd"), (1, 32, 8, 256, 128, "bshd"),
    (1, 8, 2, 130, 256, "bshd"), (2, 4, 1, 77, 64, "bhsd"),
    (1, 16, 4, 1024, 128, "bshd"), (2, 4, 4, 320, 128, "bshd"),
    (1, 4, 4, 330, 128, "bhsd"), (2, 4, 4, 63, 128, "bshd"),
    (1, 4, 2, 65, 128, "bhsd"), (1, 32, 8, 129, 128, "bshd"),
    (2, 4, 4, 127, 64, "bshd"), (1, 4, 2, 65, 256, "bhsd"),
    (1, 8, 2, 97, 256, "bshd"), (1, 4, 4, 191, 128, "bshd"),
    (1, 8, 2, 193, 64, "bhsd"), (2, 4, 4, 33, 256, "bhsd"),
    (1, 4, 2, 95, 256, "bshd"), (2, 4, 4, 63, 256, "bshd"),
    (1, 4, 2, 127, 256, "bhsd"), (1, 8, 2, 129, 256, "bshd"),
    (1, 16, 4, 1024, 256, "bshd")])
def test_k11_k12_kernels_match_plain(cuda, dtype, B, H, Hkv, S, D, layout):
    """K10's log-sum-exp, K11 (dK, dV) and K12 (dQ) against their plain
    versions on the same operands (the kernels' lse and di given to both):
    ragged S (100, 2047, 130, 77, 1, and 320 / 330 against the Hopper
    kernels' 128-row q and 64-key tiles at D = 128; 63 / 65 / 127 / 129
    against the f32 kernels' 128-row q and 64-key tiles, 65 / 97 against
    their 32-row ones at D = 256; 63 / 65 / 127 / 129 / 191 / 193 against
    the f32 K12's 64-row q and key tiles, 33 / 65 / 95 / 97 against its
    32-row ones at D = 256; 63 / 65 / 127 / 129 against the bf16 D = 256
    kernels' 64-row q and 64-key tiles), GQA n_rep 1/2/4/8
    (n_rep 4 also at S = 1024, a long walk over a kv head's query heads,
    at D = 128 and 256),
    head_dim 64/128/256, f32, both layouts. Each element within its own
    bound (flash_bwd_tolerance); lse within 2^-14 (K10's m + log l against
    the plain version's); outputs in the operands' layouts; each wrapper
    counts one launch; a second call gives the same bits."""
    q, k, v, do = _bwd_operands(cuda, dtype, B, H, Hkv, S, D, layout,
                                S + D + H + Hkv)
    scale = D ** -0.5
    before = (FA.flash_attention.launches, FA.flash_attention_dkv.launches,
              FA.flash_attention_dq.launches)
    out, lse = FA.flash_attention_fwd(q, k, v, sm_scale=scale)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, sm_scale=scale,
                                            return_lse=True)
    di = FA.flash_di(out, do)
    dk, dv = FA.flash_attention_dkv(q, k, v, lse, do, di, sm_scale=scale)
    dq = FA.flash_attention_dq(q, k, v, lse, do, di, sm_scale=scale)
    pdk, pdv = FA.flash_bwd_dkv_plain(q, k, v, lse, do, di, sm_scale=scale)
    pdq = FA.flash_bwd_dq_plain(q, k, v, lse, do, di, sm_scale=scale)
    torch.cuda.synchronize()
    assert (FA.flash_attention.launches, FA.flash_attention_dkv.launches,
            FA.flash_attention_dq.launches) == tuple(n + 1 for n in before)
    assert (lse - ref_lse).abs().max().item() <= 2.0 ** -14
    tol = FA.flash_tolerance(q, k, v, ref, sm_scale=scale)
    assert ((out.float() - ref.float()).abs() <= tol).all()
    tols = FA.flash_bwd_tolerance(q, k, v, lse, do, di, pdq, pdk, pdv,
                                  sm_scale=scale)
    for got, want, t, like in ((dq, pdq, tols[0], q), (dk, pdk, tols[1], k),
                               (dv, pdv, tols[2], v)):
        assert got.dtype == dtype and got.shape == like.shape
        assert got.stride() == like.stride()
        assert ((got.float() - want.float()).abs() <= t).all()
    assert torch.equal(dq, FA.flash_attention_dq(q, k, v, lse, do, di,
                                                 sm_scale=scale))
    dk2, dv2 = FA.flash_attention_dkv(q, k, v, lse, do, di, sm_scale=scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_flash_attention_autograd_on_the_card(cuda):
    """flash_attention on operands that require a gradient: the backward
    is one K11 and one K12 launch, with the gradients the wrappers give
    on the same operands; a dO that is not contiguous (a strided slice)
    is copied, not refused. Without a gradient K10 runs as before."""
    q, k, v, do = _bwd_operands(cuda, torch.bfloat16, 2, 8, 2, 200, 128,
                                "bshd", 5)
    do = torch.cat([do, do], dim=-1)[..., ::2]  # last stride 2
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    before = (FA.flash_attention.launches, FA.flash_attention_dkv.launches,
              FA.flash_attention_dq.launches)
    out = FA.flash_attention(qr, kr, vr, sm_scale=0.125)
    out.backward(do)
    torch.cuda.synchronize()
    assert (FA.flash_attention.launches, FA.flash_attention_dkv.launches,
            FA.flash_attention_dq.launches) == tuple(n + 1 for n in before)
    o2, lse = FA.flash_attention_fwd(q, k, v, sm_scale=0.125)
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, o2, lse, do,
                                        sm_scale=0.125)
    assert torch.equal(out.detach(), o2)
    for a, b in ((qr.grad, dq), (kr.grad, dk), (vr.grad, dv)):
        assert torch.equal(a, b)
    with torch.no_grad():
        FA.flash_attention(qr, kr, vr, sm_scale=0.125)
    assert FA.flash_attention.launches == before[0] + 3
    assert FA.flash_attention_dkv.launches == before[1] + 2


def test_k11_k12_wrappers_raise_on_what_they_do_not_take(cuda):
    """head_dim 96 and f16 raise on the card; a dO of another shape too;
    nothing falls back to the plain version."""
    before = (FA.flash_attention_dkv.launches, FA.flash_attention_dq.launches)
    z = torch.zeros((1, 4, 64), device=cuda)
    for D, dt in ((96, torch.bfloat16), (128, torch.float16)):
        q = torch.zeros((1, 4, 64, D), dtype=dt, device=cuda)
        with pytest.raises(ValueError):
            FA.flash_attention_dkv(q, q, q, z, q, z)
        with pytest.raises(ValueError):
            FA.flash_attention_dq(q, q, q, z, q, z)
    q = torch.zeros((1, 4, 64, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        FA.flash_attention_dq(q, q, q, z, q[:, :, :32], z)
    assert (FA.flash_attention_dkv.launches,
            FA.flash_attention_dq.launches) == before


@pytest.mark.parametrize("M", [1, 16, 17])
@pytest.mark.parametrize("K,N", [(12, 20), (4100, 36), (4096, 4096)])
def test_int8_gemm_on_the_card_is_exact(cuda, M, K, N):
    """int8_gemm on the card at shapes torch._int_mm refuses as they are
    (M <= 16, K and N = 4 mod 8): the zero-padded product, sliced back,
    equals the CPU's exact product."""
    from sparsebit_tpu_torch.ops.int8_matmul import int8_gemm

    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
    out = int8_gemm(a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and out.dtype == torch.int32
    assert out.shape == (M, N)
    assert torch.equal(out.cpu(), int8_gemm(a, b))


@pytest.mark.parametrize("mode,B,S", [
    pytest.param("dense", 2, 65, id="dense"),
    pytest.param("int8", 2, 65, id="int8"),
    pytest.param("int8", 1, 9, id="int8-M8")])
def test_qlora_train_step_on_the_card_matches_the_cpu(cuda, mode, B, S):
    """One qlora_train_step of llama_tiny (head_dim 64, GQA 4 -> 2) over
    RTN INT4-g64 column-plane linears with r = 4 adapters on wq/wv (B
    nonzero), B = 2 x 65 tokens (and, int8, 1 x 9: M = 8 rows a linear,
    which torch._int_mm takes only padded), the dense or the int8
    backward: on the
    card through K10/K11/K12 (one each a layer) and the dense linears at
    M = 128, on the CPU through the masked route. The loss within 1e-3
    relative; the adapters' gradients within relative norm and cosine
    (0.05, 0.999) dense, (0.15, 0.99) int8 (chip_smoke.py's
    QLORA_GRAD_TOL: the int8 backward requantizes g per token, so a code
    moves where two correct orders round differently)."""
    from sparsebit_tpu_torch.llm import qlora as Q
    from sparsebit_tpu_torch.llm.llama import init_llama_params
    from sparsebit_tpu_torch.llm.quant import QuantLinear

    cfg = llama_tiny()
    dense = init_llama_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    params = dict(dense, layers=[
        {k: (QuantLinear.from_dense(v.w.float(), bits=4, groupsize=64)
             if hasattr(v, "w") else v) for k, v in layer.items()}
        for layer in dense["layers"]])
    params = Q.wrap_llama_lora(params, r=4, generator=torch.Generator()
                               .manual_seed(1))
    if mode == "int8":
        params = Q.prepare_train(params)
    rng = np.random.default_rng(12)
    lora0 = {k: {n: torch.from_numpy((rng.standard_normal(t.shape) * 0.05)
                                     .astype(np.float32))
                 for n, t in v.items()}
             for k, v in Q.extract_lora(params).items()}
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    before = [w.launches for w in (FA.flash_attention,
                                   FA.flash_attention_dkv,
                                   FA.flash_attention_dq)]
    res = {}
    for dev in ("cpu", cuda):
        lora = {k: {n: t.clone().to(dev) for n, t in v.items()}
                for k, v in lora0.items()}
        opt = Q.adamw(lora, 1e-3)
        _, loss = Q.qlora_train_step(lora, opt, _to(params, dev),
                                     tokens.to(dev), cfg)
        grads = torch.cat([lora[k][n].grad.reshape(-1).cpu() for k in
                           sorted(lora) for n in ("lora_A", "lora_B")])
        res[str(dev)] = (loss.item(), grads)
    torch.cuda.synchronize()
    after = [w.launches for w in (FA.flash_attention, FA.flash_attention_dkv,
                                  FA.flash_attention_dq)]
    assert [a - b for a, b in zip(after, before)] == [cfg.n_layers] * 3
    (lc, gc), (lg, gg) = res["cpu"], res[str(cuda)]
    assert abs(lg - lc) <= 1e-3 * abs(lc)
    rel_tol, cos_tol = {"dense": (0.05, 0.999), "int8": (0.15, 0.99)}[mode]
    assert ((gg - gc).norm() / gc.norm()).item() <= rel_tol
    assert (gg @ gc / (gg.norm() * gc.norm())).item() >= cos_tol


def test_streaming_llama_on_the_card_matches_resident(cuda):
    """StreamingLlama from pinned host memory on its copy stream (prefetch
    1 and 2) against the resident prefill / decode_step on the card: an
    f32 tiny model whose attention takes the plain masked route on both,
    within rtol/atol 1e-4 (tests/test_offload.py's oracle)."""
    from sparsebit_tpu_torch.llm import decode as D
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
    from sparsebit_tpu_torch.llm.llama import init_llama_params
    from sparsebit_tpu_torch.llm.offload import (StreamingLlama,
                                                 offload_llama_params)

    cfg = llama_tiny(dim=128, ffn_dim=256, n_layers=3, vocab_size=128,
                     max_seq_len=64, dtype="float32")
    params = init_llama_params(cfg, device=cuda)
    tokens = torch.randint(0, 128, (2, 6), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    cache = init_kv_cache(cfg, 2, 32, device=cuda)
    ref, cache = D.prefill(params, tokens, cache, cfg)
    nxt = ref.argmax(-1).to(torch.int32)
    ref_step, _ = D.decode_step(params, nxt, cache, cfg)
    host = offload_llama_params(params)
    assert host["layers"][0]["wq"].w.is_pinned()
    for prefetch in (1, 2):
        sl = StreamingLlama(host, cfg, prefetch)
        assert sl.copy_stream is not None
        c2 = init_kv_cache(cfg, 2, 32, device=cuda)
        got, c2 = sl.prefill(tokens, c2)
        step, _ = sl.decode_step(nxt, c2)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(step, ref_step, rtol=1e-4, atol=1e-4)


# ---- the graph regime on the card (no kernel: PyTorch calls) ---------------


def test_kl_device_on_the_card_matches_numpy_oracle(cuda):
    """The KL search on the card picks the numpy oracle's candidates, per
    tensor and per channel, at 512 and 2048 bins."""
    from sparsebit_tpu_torch.quantization.observers.kl_device import (
        kl_thresholds_device,
    )
    from sparsebit_tpu_torch.quantization.observers.kl_histogram import (
        kl_thresholds,
    )

    rng = np.random.RandomState(7)
    cases = [rng.randn(3, 4096), rng.laplace(size=(2, 4096)),
             np.concatenate([rng.randn(1, 4000), 20 * rng.randn(1, 96)], 1),
             np.maximum(rng.randn(64, 1024), 0), rng.randn(1, 200000)]
    for data in cases:
        data = data.astype(np.float32)
        for bit, bins in ((4, 512), (8, 2048)):
            want = kl_thresholds(data, bit, bins=bins)
            data_dev = torch.from_numpy(data).to(cuda)
            got = kl_thresholds_device(data_dev, bit, bins=bins)
            assert got.device == data_dev.device
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-6)


def _graph_outputs(graph, x):
    """Every node's output of a graph run on x."""
    from sparsebit_tpu_torch.nn.graph import Output, Placeholder

    env = {}

    def value(a):
        if hasattr(a, "node"):
            v = env[a.node.name]
            return v if a.index is None else v[a.index]
        return a

    with torch.no_grad():
        for n in graph.nodes:
            if isinstance(n.op, Placeholder):
                env[n.name] = x
            elif not isinstance(n.op, Output):
                env[n.name] = n.op.execute(*[value(a) for a in n.args],
                                           **n.kwargs)
    return env


def test_quant_model_w8a8_on_the_card_matches_the_cpu(cuda):
    """resnet18 (16 classes) at 8 x 64 x 64 x 3, weights made on the card
    and copied to the CPU, both calibrated (MinMax, w8a8) with cuDNN TF32
    off: every quantizer's scale within 1e-5 relative of the CPU's, zero
    points equal; then, with the card's qparams in both, every node on
    the card's inputs within 1e-4 of the card's output, relative to its
    largest (convolutions summed in other orders)."""
    import copy

    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = {"BACKEND": "virtual",
           "W": {"QSCHEME": "per-channel-symmetric",
                 "QUANTIZER": {"BIT": 8}},
           "A": {"QSCHEME": "per-tensor-affine", "QUANTIZER": {"BIT": 8},
                 "OBSERVER": {"LAYOUT": "NHWC"}}}
    model = create_model("resnet18", num_classes=16, device=cuda).eval()
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(8, 64, 64, 3)).astype(np.float32))
    qc = QuantModel(model, parse_qconfig(cfg), (x.to(cuda),))
    qh = QuantModel(cpu_model, parse_qconfig(cfg), (x,))
    for q, xx in ((qc, x.to(cuda)), (qh, x)):
        q.prepare_calibration()
        q(xx)
        q.calc_qparams()
        q.set_quant(True, True)
    for (name, op), (_, hop) in zip(qc.qmodules(), qh.qmodules()):
        for k in ("input_quantizer", "weight_quantizer"):
            a, b = getattr(op, k), getattr(hop, k)
            if a is None:
                continue
            np.testing.assert_allclose(a.scale.cpu().numpy(),
                                       b.scale.numpy(), rtol=1e-5,
                                       err_msg=name)
            assert torch.equal(a.zero_point.cpu(), b.zero_point), name
            b.scale, b.zero_point = a.scale.cpu(), a.zero_point.cpu()
    card = _graph_outputs(qc.graph, x.to(cuda))
    with torch.no_grad():
        for n in qh.graph.op_nodes:
            args = [(card[a.node.name] if a.index is None else
                     card[a.node.name][a.index]).cpu()
                    if hasattr(a, "node") else a for a in n.args]
            got = n.op.execute(*args, **n.kwargs)
            want = card[n.name].cpu()
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol, n.name
