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
from sparsebit_tpu_torch.ops import layer_fused as LF
from sparsebit_tpu_torch.ops import matvec as MV
from sparsebit_tpu_torch.ops import quant_matmul as QM
from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant
from sparsebit_tpu_torch.ops.packing import pack_s4_rows

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


@pytest.mark.parametrize("M", [1, 8, 33, 130])
@pytest.mark.parametrize("K,N", [(256, 320), (384, 200)])
def test_k1_kernel_matches_plain(cuda, M, K, N):
    """rel 1e-4 of max |out|: f32 group sums in another order. N = 200
    exercises the ragged column edge, M = 33/130 the row edge."""
    rng = np.random.default_rng(M + K)
    w, s, z = _s4(rng, (2,), K, N, 128, cuda)
    x8, xs = tokenwise_quant(torch.randn((M, K), device=cuda))
    before = QM.quant_matmul_s4.launches
    out = QM.quant_matmul_s4(x8, xs, w, s, z, 128, li=1)
    ref = QM._qmm_s4_plain(x8, xs, w[1], s[1], z[1], 128)
    assert QM.quant_matmul_s4.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_k2_kernel_matches_plain(cuda):
    """GQA n_rep = 2: codes and scales bit-exact, out atol 2e-3."""
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
    for a, b in zip((k, v, ks, vs), plain):
        assert torch.equal(a, b)
    assert (out - ref).abs().max().item() <= 2e-3


@pytest.mark.parametrize("B", [1, 8, 20])
def test_k3_kernel_matches_plain(cuda, B):
    """atol 2e-2 x max |out|: a requantized code may flip at a rounding
    boundary when f32 sums are taken in another order."""
    rng = np.random.default_rng(B)
    dim, F, gs = 256, 384, 128
    w13, s13, z13 = _s4(rng, (2,), dim, 2 * F, gs, cuda)
    w2, s2, z2 = _s4(rng, (2,), F, dim, gs, cuda)
    nw = torch.ones((2, dim), dtype=torch.bfloat16, device=cuda)
    x = torch.randn((B, dim), device=cuda).to(torch.bfloat16)
    out = FF.ffn_block_fused(x, w13, s13, z13, w2, s2, z2, nw, 1, gs, 1e-6)
    ref = FF._ffn_plain(x.float(), w13[1], s13[1], z13[1], w2[1], s2[1],
                        z2[1], nw[1], gs, 1e-6)
    assert (out - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("B", [1, 5, 8])
def test_k9_kernel_matches_plain(cuda, B):
    """rel 1e-3: bf16 products exact in f32, sums in another order."""
    x = torch.randn((B, 384), device=cuda)
    w = (torch.randn((384, 1000), device=cuda) * 0.05).to(torch.bfloat16)
    out = MV.bf16_matvec(x, w)
    ref = MV._bf16_matvec_plain(x, w)
    assert (out - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


def _k4_operands(dev, B, S, n_blocks=None, Hkv=4, D=128, seed=0):
    """Tiny K4 operands (4 query heads of D, Hkv kv heads, ffn 384, gs 64,
    two layers) with a cache of S rows per batch row, or a pool of
    n_blocks blocks of 128 rows."""
    dim = 4 * D
    cfg = llama_tiny(dim=dim, n_heads=4, n_kv_heads=Hkv, ffn_dim=384,
                     max_seq_len=S)
    rng = np.random.default_rng(seed)
    ws = []
    for K, N in ((dim, dim + 2 * Hkv * D), (dim, dim), (dim, 768),
                 (384, dim)):
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


@pytest.mark.parametrize("B,paged,Hkv,D", [
    (1, False, 4, 128), (8, False, 4, 128), (8, True, 4, 128),
    # B > 8 takes the 64-row tiles; Hkv 2 puts two query heads on a kv
    # head (GQA), Hkv 1 four; D = 64 splits the value mix into 16 row
    # groups
    (20, False, 2, 128), (3, True, 2, 64), (4, True, 1, 128)])
def test_k4_kernel_matches_plain(cuda, B, paged, Hkv, D):
    """The megakernel against its plain version on the same card: KV codes
    and scales exact, output within 1e-4 of max |out| (the plain version
    takes every float sum in the kernel's order; the margin is for an
    exp or division that rounds otherwise)."""
    S = 256
    bt = None
    n_blocks = None
    if paged:
        n_blocks = 2 * B + 3
        perm = np.random.default_rng(B).permutation(n_blocks)[:2 * B]
        bt = torch.from_numpy(perm.reshape(B, 2).astype(np.int32)).to(cuda)
    cfg, x, pos, cos, sin, ws, norms, cache = _k4_operands(
        cuda, B, S, n_blocks, Hkv, D)
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
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
