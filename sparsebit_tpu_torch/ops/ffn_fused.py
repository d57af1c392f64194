"""Fused decode FFN block  x + W2(q8(silu(g) * u)),  [g, u] =
W13(q8(rmsnorm(x) * w))  (port of ``sparsebit_tpu/ops/ffn_fused.py``).

Kernel K3 (``csrc/ffn_fused.cu``) replaces ``_ffn_kernel``
(ffn_fused.py:45). The TPU kernel resolved the GLU's pairing of gate and
up columns and the row's int8 requantization, which needs the absmax over
all F columns before W2 starts, with its sequential grid. On the card K3
is one cooperative launch of a persistent grid that runs the FFN phases of
K4's layer loop (``csrc/ffn_phases.cuh``): the norm, W13 on the int8
tensor cores split along K at group boundaries (``s4_plan``), the GLU,
the requantized rows, W2 the same way and the residual, with a grid
barrier between each. ``_ffn_plain`` is its plain version and K4's plain
FFN half: it takes every float sum in the kernels' order, so that on the
card K3 and K4 equal it bit for bit.
"""

import torch

from sparsebit_tpu_torch.ops import _kernels
from sparsebit_tpu_torch.ops.attention import ordered_sum
from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant
from sparsebit_tpu_torch.ops.quant_matmul import _qmm_s4_plain, s4_plan


def ffn_block_supported(dim, F, gs, B=1):
    """The port's gate: whole groups along both K dims, 64-row k steps
    (the W4A8 tile core), 4-aligned rows for the requantizing loads, and at
    most 64 rows."""
    return (gs > 0 and gs % 64 == 0 and B <= 64 and dim % gs == 0
            and F % gs == 0 and F % 4 == 0)


def _norm_quant(xf, nw, eps):
    """f32 rms_norm(xf) * nw (``_norm_row``), then per-row int8 codes and
    scales (``_quant_rows``): var = sum(x^2) / dim in the kernels' order,
    xn = (x * (1 / sqrt(var + eps))) * nw."""
    var = ordered_sum(xf * xf) / xf.shape[-1]
    r = 1.0 / torch.sqrt(var + eps)
    return tokenwise_quant(xf * r[:, None] * nw.to(torch.float32))


def _qmm_s4_planned(x8, xs, w, s, z, gs):
    """The s4r matmul of K3 and K4 in their K-split order (s4_plan)."""
    return _qmm_s4_plain(x8, xs, w, s, z, gs,
                         s4_plan(x8.shape[1], w.shape[-1], gs))


def _ffn_plain(xf, w13, s13, z13, w2, s2, z2, nw, gs, eps, mm=None):
    """Plain version of K3 and of K4's FFN half: xf (B, dim) f32 plus
    W2(q8(silu(g) * u)), [g, u] = W13(q8(rms_norm(xf) * nw)), through the
    matmul step ``mm(x8, xs, w, s, z, gs)`` (default: s4r row pairs in the
    kernels' K-split order). W13's columns are [gate | up] of 2F, W2 has F
    = its groups x gs rows; columns past 2F and dim (padding) are
    ignored."""
    mm = mm or _qmm_s4_planned
    dim = xf.shape[1]
    F = s2.shape[0] * gs
    xq, xs = _norm_quant(xf, nw, eps)
    h = mm(xq, xs, w13, s13, z13, gs)
    g, u = h[:, :F], h[:, F:2 * F]
    a = g * (1.0 / (1.0 + torch.exp(-g))) * u
    aq, a_s = tokenwise_quant(a)
    return xf + mm(aq, a_s, w2, s2, z2, gs)[:, :dim]


_workspaces = {}


def _workspace(dev, B, dim, F, gs):
    """K3's scratch for one shape on the current stream, allocated once:
    the norm's int8 rows and scales, the GLU rows, their absmax and int8
    codes, and the K-split partials of the larger matmul. Launches on one
    stream run in order, so they may share it."""
    key = (str(dev), torch.cuda.current_stream(dev).cuda_stream, B, dim, F,
           gs)
    w = _workspaces.get(key)
    if w is None:
        f32 = dict(dtype=torch.float32, device=dev)
        n_part = max(-(-(K // gs) // s4_plan(K, N, gs)) * N
                     for K, N in ((dim, 2 * F), (F, dim)))
        w = (torch.empty((B, dim), dtype=torch.int8, device=dev),
             torch.empty((B,), **f32), torch.empty((B, F), **f32),
             torch.empty((B,), **f32),
             torch.empty((B, F), dtype=torch.int8, device=dev),
             torch.empty((n_part * B,), **f32))
        _workspaces[key] = w
    return w


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
            or w13.dtype != torch.uint8 or w2.dtype != torch.uint8
            or w13.shape != (dim // 2, 2 * F) or w2.shape[1] != dim
            or s13.shape != (dim // gs, 2 * F) or s2.shape != (F // gs, dim)):
        raise ValueError("ffn_block_fused: unsupported operands")
    xf = xf.contiguous()
    _kernels.require_cuda("ffn_block_fused", xf, w13, s13, z13, w2, s2, z2,
                          nw)
    xq, xs, act, amax, aq, part = _workspace(x.device, B, dim, F, gs)
    out = torch.empty((B, dim), dtype=torch.float32, device=x.device)
    p = _kernels.ptr
    _kernels.check(_kernels.lib().sbt_ffn_block(
        p(xf), p(nw), p(w13), p(s13), p(z13), p(w2), p(s2), p(z2), p(out),
        p(xq), p(xs), p(act), p(amax), p(aq), p(part),
        int(s13.dtype == torch.bfloat16), int(nw.dtype == torch.bfloat16),
        B, dim, F, gs, s4_plan(dim, 2 * F, gs), s4_plan(F, dim, gs), eps,
        _kernels.stream()), "sbt_ffn_block")
    ffn_block_fused.launches += 1
    return out


ffn_block_fused.launches = 0
