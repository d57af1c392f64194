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
from sparsebit_tpu_torch.ops import ffn_fused as FF
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
