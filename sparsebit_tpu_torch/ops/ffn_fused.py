"""Fused decode FFN block  x + W2(q8(silu(g) * u)),  [g, u] =
W13(q8(rmsnorm(x) * w))  (port of ``sparsebit_tpu/ops/ffn_fused.py``).

Kernel K3 (``csrc/ffn_fused.cu``) replaces ``_ffn_kernel``
(ffn_fused.py:45). The TPU kernel resolved the GLU row's int8
requantization, which needs the absmax over all F columns before W2
starts, with its sequential grid; on the card it is three launches of the
module's own kernels (norm + quant prologue, W13 + GLU + row absmax, W2
with requantization on load + residual). The plain version follows the
same sequence step by step.
"""

import torch

from sparsebit_tpu_torch.ops import _kernels
from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant
from sparsebit_tpu_torch.ops.quant_matmul import _qmm_s4_plain


def ffn_block_supported(dim, F, gs, B=1):
    """The port's gate: whole groups along both K dims, 64-row k steps
    (the W4A8 tile core), 4-aligned rows for the requantizing loads, and at
    most 64 rows."""
    return (gs > 0 and gs % 64 == 0 and B <= 64 and dim % gs == 0
            and F % gs == 0 and F % 4 == 0)


def _ffn_plain(xf, w13, s13, z13, w2, s2, z2, nw, gs, eps):
    F = w2.shape[0] * 2
    var = torch.mean(xf * xf, dim=1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps) * nw.to(torch.float32)
    xq, xs = tokenwise_quant(xn)
    h = _qmm_s4_plain(xq, xs, w13, s13, z13, gs)
    g, u = h[:, :F], h[:, F:]
    a = (g * torch.sigmoid(g)) * u
    aq, a_s = tokenwise_quant(a)
    return xf + _qmm_s4_plain(aq, a_s, w2, s2, z2, gs)


def ffn_block_fused(x, w13, s13, z13, w2, s2, z2, norm_w, li, gs, eps):
    """x (B, dim) float -> (B, dim) f32 = x + FFN(rmsnorm(x)).

    w13 (L, dim/2, 2F) s4r row pairs ([gate | up] columns) with s13/z13
    (L, dim/gs, 2F); w2 (L, F/2, dim) with s2/z2 (L, F/gs, dim); norm_w
    (L, dim); li int layer index. The norm is the kernel's own f32 formula
    ``xf * rsqrt(mean(xf^2) + eps) * w`` (no cast back to x's dtype).

    CPU tensors take the plain version; CUDA tensors launch K3."""
    xf = x.to(torch.float32)
    w13, s13, z13 = w13[li], s13[li], z13[li]
    w2, s2, z2 = w2[li], s2[li], z2[li]
    nw = norm_w[li]
    if x.device.type == "cpu":
        return _ffn_plain(xf, w13, s13, z13, w2, s2, z2, nw, gs, eps)
    B, dim = x.shape
    F = w2.shape[0] * 2
    z13, z2 = z13.to(s13.dtype), z2.to(s2.dtype)
    if (not ffn_block_supported(dim, F, gs, B) or s13.dtype != s2.dtype
            or s13.dtype not in (torch.float32, torch.bfloat16)
            or nw.dtype not in (torch.float32, torch.bfloat16)
            or w13.shape != (dim // 2, 2 * F) or w2.shape[1] != dim):
        raise ValueError("ffn_block_fused: unsupported operands")
    xf = xf.contiguous()
    _kernels.require_cuda("ffn_block_fused", xf, w13, s13, z13, w2, s2, z2,
                          nw)
    dev = x.device
    xq = torch.empty((B, dim), dtype=torch.int8, device=dev)
    xs = torch.empty((B,), dtype=torch.float32, device=dev)
    amax = torch.empty((B,), dtype=torch.float32, device=dev)
    act = torch.empty((B, F), dtype=torch.float32, device=dev)
    out = torch.empty((B, dim), dtype=torch.float32, device=dev)
    lib, st, p = _kernels.lib(), _kernels.stream(), _kernels.ptr
    sz_bf16 = int(s13.dtype == torch.bfloat16)
    _kernels.check(lib.sbt_ffn_prologue(
        p(xf), p(nw), p(xq), p(xs), p(amax), int(nw.dtype == torch.bfloat16),
        B, dim, eps, st), "sbt_ffn_prologue")
    _kernels.check(lib.sbt_ffn_w13_glu(
        p(xq), p(xs), p(w13), p(s13), p(z13), sz_bf16, p(act), p(amax),
        B, F, dim, gs, st), "sbt_ffn_w13_glu")
    _kernels.check(lib.sbt_ffn_w2_resid(
        p(act), p(amax), p(xf), p(w2), p(s2), p(z2), sz_bf16, p(out),
        B, dim, F, gs, st), "sbt_ffn_w2_resid")
    ffn_block_fused.launches += 1
    return out


ffn_block_fused.launches = 0
