"""Group-factored matmuls over packed sub-byte weights (port of
``sparsebit_tpu/ops/quant_matmul.py``: ``dequant_weights``,
``quant_matmul``, ``quant_matmul_a8`` and ``quant_matmul_a8_stacked``).

Two kernel families:

- K1 (``csrc/quant_matmul.cu``) replaces ``_qmm_u4_kernel``
  (quant_matmul.py:443) and ``_qmm_u4_stacked_kernel`` (:693): int8
  activations times signed row-pair nibbles (``s4r``), for every M, a
  layer of a stack being a view (a pointer offset), on the int8 tensor
  cores: K split at group boundaries at M <= 64 (``s4_plan``), the groups
  in order above (``k1_plan``). Its plain version is ``_qmm_s4_plain``,
  in the kernel's split order.
- K6, K7 and K8 (``csrc/quant_matmul_planes.cu``) replace
  ``_qmm_a8_kernel`` (:844), ``_qmm3_kernel`` (:241) and ``_qmm_kernel``
  (:57): the column-plane fold container (``"w"`` at 2/4/8 bits, 3-bit
  ``low2`` + ``high1``) with f32 activations (K8, K7) or int8 ones (K6,
  K7 with ``a8``), at most 64 rows, as the reference's ``_supports_pallas``
  decides. Their plain version is ``_qmm_planes_plain``.

Every product is ``sum_g s_g * (x_g . C_g - sum(x_g) * z_g)`` with f32
epilogues over the groups in order. Shapes past the kernels' rule (more
than 64 rows, an irregular K) take the reference's dense route: the f32
weight dequantized and one matmul.

Gradients (QLoRA, the backbone frozen): ``quant_matmul`` and
``quant_matmul_a8bwd`` are ``torch.autograd.Function``s when x requires a
gradient, with the reference's backward rules (dx only: g @ dequant(W)^T
in f32, or the int8 product against ``prepare_a8_backward``'s weight);
``quant_matmul_a8`` has none, as in the reference.
"""

import functools

import torch

from sparsebit_tpu_torch.ops import _kernels
from sparsebit_tpu_torch.ops.int8_matmul import (
    INV_127,
    int8_dx,
    tokenwise_quant,
)
from sparsebit_tpu_torch.ops.packing import unpack_columns, unpack_s4_rows


def _expand_qparams(arr, K, gs):
    """(G, N) group params -> (K, N) rows."""
    if arr.shape[0] == K:
        return arr
    return torch.repeat_interleave(arr, gs, dim=0)[:K]


def dequant_weights(packed, scales, zeros, bits, N, gs):
    """Materialise the float weight matrix (K, N) in f32: the oracle."""
    codes = unpack_columns(packed, bits, N).to(torch.float32)
    K = codes.shape[0]
    gs_eff = gs if gs > 0 else K
    s = _expand_qparams(scales.to(torch.float32), K, gs_eff)
    z = _expand_qparams(zeros.to(torch.float32), K, gs_eff)
    return (codes - z) * s


def _qmm_s4_plain(x8, xs, w, scales, zeros, gs, gps=None):
    """Plain version of K1 and of K4's 4-bit matmuls: f32 (M, N) = xs *
    sum_g s_g * (x8_g @ (C_g - 8) - xsum_g * (z_g - 8)). Every group
    product is exact in f32 (|x8 * c| <= 128 * 8 and a group sum stays
    below 2^24). The groups are cut into K splits of ``gps`` groups (None:
    one split); each split adds its group terms in order from 0, and the
    splits' partials are added in split order, as the kernels do. gps = 1
    and one split give the same bits: the sequential sum of the groups."""
    K = x8.shape[1]
    G = K // gs
    gps = G if gps is None else gps
    codes = unpack_s4_rows(w).to(torch.float32) - 8.0  # stored nibbles
    x = x8.to(torch.float32)
    s = scales.to(torch.float32)
    z = zeros.to(torch.float32) - 8.0
    out = None
    for g0 in range(0, G, gps):
        acc = torch.zeros((x8.shape[0], w.shape[-1]), dtype=torch.float32,
                          device=x8.device)
        for g in range(g0, min(G, g0 + gps)):
            xg = x[:, g * gs:(g + 1) * gs]
            dot = xg @ codes[g * gs:(g + 1) * gs]
            xsum = xg.sum(dim=1, keepdim=True)
            acc = acc + (dot - xsum * z[g]) * s[g]
        out = acc if out is None else out + acc
    return out * xs.reshape(-1, 1)


# The s4r streaming tile's K split (csrc/quant_matmul.cu, K4's s4r phases
# in csrc/layer_fused.cu): the plan balances column tiles of S4_BN
# columns x K splits over S4_GRID blocks, two an SM of an H100's 132. Both
# are constants: the plan is a function of (K, N, gs) alone, never of the
# rows or of the card, so that B = 1 and batched decode agree row for row.
S4_BN = 256
S4_GRID = 264
K1_STREAM_MAX_M = 64  # K1 splits K up to here (decode), not above


@functools.lru_cache(maxsize=None)
def s4_plan(K, N, gs):
    """Groups a K split of the s4r streaming tile: of every gps in 1..G,
    the one with the fewest rounds of S4_GRID blocks x (gps + 1) groups of
    time (a split's ring fill counted as one group), ties to fewer splits.
    Splits cover the G = K / gs groups at group boundaries, the last one
    possibly shorter."""
    G = K // gs
    tiles = -(-N // S4_BN)
    best = None
    for gps in range(1, G + 1):
        splits = -(-G // gps)
        cost = (-(-tiles * splits // S4_GRID) * (gps + 1), splits)
        if best is None or cost < best[0]:
            best = (cost, gps)
    return best[1]


def k1_plan(M, K, N, gs):
    """K1's K split, from the shape alone: ("stream", gps) at M <=
    K1_STREAM_MAX_M (decode: few column tiles, so K is split to fill the
    card), else ("admit", G), the groups in order."""
    if M <= K1_STREAM_MAX_M:
        return "stream", s4_plan(K, N, gs)
    return "admit", K // gs


def quant_matmul_s4(x8, xs, w, scales, zeros, gs, li=None):
    """K1 wrapper. x8 (M, K) int8; xs (M, 1) or (M,) f32 per-token scales;
    w (K/2, N) uint8 signed row pairs (``s4r``) with scales/zeros (G, N)
    f32 or bf16, or their (L, ...) stacks with layer index ``li``.
    Returns xs-scaled f32 (M, N).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if li is not None:
        w, scales, zeros = w[li], scales[li], zeros[li]
    M, K = x8.shape
    N = w.shape[-1]
    gs = gs if gs > 0 else K
    gps = k1_plan(M, K, N, gs)[1] if K % gs == 0 else None
    if x8.device.type == "cpu":
        return _qmm_s4_plain(x8, xs, w, scales, zeros, gs, gps)
    zeros = zeros.to(scales.dtype)
    xs = xs.reshape(M).to(torch.float32).contiguous()
    x8 = x8.contiguous()
    if x8.data_ptr() % 16:  # the x rows stream in 16-byte copies
        x8 = x8.clone()
    _kernels.require_cuda("quant_matmul_s4", x8, xs, w, scales, zeros)
    if x8.dtype != torch.int8 or w.dtype != torch.uint8:
        raise TypeError("quant_matmul_s4: x8 int8 and w uint8 required")
    if scales.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("quant_matmul_s4: qparams must be f32 or bf16")
    if K % gs or gs % 64 or w.shape[0] * 2 != K or \
            scales.shape != (K // gs, N):
        raise ValueError(
            "quant_matmul_s4: unsupported shape K={} N={} gs={} w={} s={}"
            .format(K, N, gs, tuple(w.shape), tuple(scales.shape)))
    out = torch.empty((M, N), dtype=torch.float32, device=x8.device)
    splits = -(-(K // gs) // gps)
    part = (torch.empty((splits, M, N), dtype=torch.float32,
                        device=x8.device) if splits > 1 else out)
    err = _kernels.lib().sbt_qmm_s4(
        _kernels.ptr(x8), _kernels.ptr(xs), _kernels.ptr(w),
        _kernels.ptr(scales), _kernels.ptr(zeros),
        int(scales.dtype == torch.bfloat16), _kernels.ptr(out),
        M, N, K, gs, gps, _kernels.ptr(part), _kernels.stream())
    _kernels.check(err, "sbt_qmm_s4")
    quant_matmul_s4.launches += 1
    return out


quant_matmul_s4.launches = 0


# ---- column-plane kernels K6, K7, K8 ----------------------------------------

# The reference's tile rule (quant_matmul.py:100-138, 204-235). Its numbers
# are TPU VMEM budgets, kept only so that the port sends exactly the shapes
# the reference sends to a kernel; the CUDA kernels take any of them.
_TILE_CELL_BUDGET = 1_600_000


def _pick_tiles(K, NP, gs_eff, per_channel):
    if per_channel:
        K_BLK = 512
        while K % K_BLK != 0 and K_BLK > 8:
            K_BLK //= 2
        if K % K_BLK != 0:
            K_BLK = K
    else:
        K_BLK = gs_eff
    NT = NP
    cands = sorted({d for d in range(128, NP + 1, 128) if NP % d == 0}
                   | {NP}, reverse=True)
    for cand in cands:
        if K_BLK * cand <= _TILE_CELL_BUDGET:
            NT = cand
            break
    else:
        NT = 128 if NP % 128 == 0 else NP
    while (not per_channel and K_BLK < 512 and K % (K_BLK * 2) == 0
           and K_BLK * 2 * NT <= _TILE_CELL_BUDGET):
        K_BLK *= 2
    return K_BLK, NT


def _lane_ok(blk, dim):
    return blk == dim or blk % 128 == 0


def supports_planes(bits, K, N, gs, B=1):
    """The reference's ``_supports_pallas`` (quant_matmul.py:210-235): at
    most 64 rows, whole groups, and packed widths of 128-column
    multiples. Decided from shapes alone, never from the device."""
    gs_eff = gs if gs > 0 else K
    if K % gs_eff != 0 or B > 64:
        return False
    if bits == 3:
        return N % 8 == 0 and (N // 8) % 128 == 0 and _lane_ok(gs_eff, K)
    if bits not in (2, 4, 8):
        return False
    NP = N // (8 // bits if bits != 8 else 1)
    if NP % 128 != 0:
        return False
    K_BLK, NT = _pick_tiles(K, NP, gs_eff, gs <= 0)
    return _lane_ok(K_BLK, K) and _lane_ok(NT, NP)


def _planes3(packed, N):
    """(low2, high1) of a 3-bit container; the plane-concat ``"pl"``
    serving array holds them as column slices (quant_matmul.py:293-296)."""
    if "low2" not in packed and "pl" in packed:
        NP8 = N // 8
        return packed["pl"][..., :2 * NP8], packed["pl"][..., 2 * NP8:]
    return packed["low2"], packed["high1"]


def _qmm_planes_plain(x, packed, scales, zeros, bits, gs, N):
    """Plain version of K6/K7/K8: sum over the groups, in order, of
    (x_g @ C_g - sum(x_g) * z_g) * s_g in f32. Int8 x (K6, K7 a8) takes
    the integer dots exactly (f64 holds them; one rounding to f32, as the
    kernel's int32 -> f32), and 8-bit codes and zeros shift by -128 there,
    as in _qmm_a8_kernel. Returns f32 (M, N), unscaled."""
    a8 = x.dtype == torch.int8
    if bits == 3:
        lo, hi = _planes3(packed, N)
        packed = {"low2": lo, "high1": hi}
    codes = unpack_columns(packed, bits, N)
    K = codes.shape[0]
    gs_eff = gs if gs > 0 else K
    zshift = 128.0 if (a8 and bits == 8) else 0.0
    dt = torch.float64 if a8 else torch.float32
    c = codes.to(dt) - zshift
    xf = x.to(dt)
    s = scales.to(torch.float32)
    z = zeros.to(torch.float32) - zshift
    acc = torch.zeros((x.shape[0], N), dtype=torch.float32, device=x.device)
    for g in range(K // gs_eff):
        xg = xf[:, g * gs_eff:(g + 1) * gs_eff]
        dot = (xg @ c[g * gs_eff:(g + 1) * gs_eff]).to(torch.float32)
        xsum = xg.sum(dim=1, keepdim=True).to(torch.float32)
        acc = acc + (dot - xsum * z[g]) * s[g]
    return acc


def _qmm_planes_split_plain(x, packed, scales, zeros, bits, gs, N, gps):
    """K6/K7/K8's own algorithm on the CPU, their oracle: the groups cut
    into K splits of ``gps`` groups; in a split each group adds, in order,
    s_g * (x_g . (C_g - z_g)) in f32 for f32 x, or s_g * (dot_g - xsum_g *
    z_g) from the exact integer sums for int8 x (8-bit codes and zeros
    shifted by -128); the splits' partials are then added in split order.
    Same operands and result as _qmm_planes_plain."""
    a8 = x.dtype == torch.int8
    if bits == 3:
        lo, hi = _planes3(packed, N)
        packed = {"low2": lo, "high1": hi}
    codes = unpack_columns(packed, bits, N)
    K = codes.shape[0]
    gs_eff = gs if gs > 0 else K
    zshift = 128.0 if (a8 and bits == 8) else 0.0
    s = scales.to(torch.float32)
    z = zeros.to(torch.float32) - zshift
    G = K // gs_eff
    out = None
    for g0 in range(0, G, gps):
        acc = torch.zeros((x.shape[0], N), dtype=torch.float32,
                          device=x.device)
        for g in range(g0, min(G, g0 + gps)):
            rows = slice(g * gs_eff, (g + 1) * gs_eff)
            c = codes[rows]
            if a8:
                xg = x[:, rows].to(torch.float64)
                dot = (xg @ (c.to(torch.float64) - zshift)).to(torch.float32)
                xsum = xg.sum(dim=1, keepdim=True).to(torch.float32)
                acc = acc + (dot - xsum * z[g]) * s[g]
            else:
                cz = c.to(torch.float32) - z[g]
                acc = acc + (x[:, rows].to(torch.float32) @ cz) * s[g]
        out = acc if out is None else out + acc
    return out


PLANES_THREADS = 256  # block width of K6/K7/K8


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=None)
def planes_plan(bits, M, K, N, gs, sms):
    """K6/K7/K8's launch plan (``csrc/quant_matmul_planes.cu``): rows a
    thread MR (up to 8), byte columns a block CB (256 threads = CB byte
    columns x 256 / CB row groups of MR rows covering M), and gps groups a
    K split: splits enough that column tiles x splits reach two blocks an
    SM where the groups allow, and none longer than 512 rows.
    ``planes_plan_sweep.py`` timed the plans on an H100: with many rows
    (M = 64, 32 byte columns a block) 512-row splits were the fastest at
    2, 3 and 4 bits, and 8 rows a thread beat 4 at 3 bits (P * MR = 64
    accumulators) at M = 8 and 64. Returns (MR, CB, gps, splits)."""
    P = 8 if bits == 3 else (1 if bits == 8 else 8 // bits)
    gs_eff = gs if gs > 0 else K
    MR = min(_pow2_at_least(M), 8)
    RG = _pow2_at_least(-(-M // MR))
    CB = PLANES_THREADS // RG
    tiles = -(-(N // P) // CB)
    G = K // gs_eff
    want = min(G, max(1, -(-2 * sms // tiles)))
    gps = max(1, min(G // want, 512 // gs_eff))
    return MR, CB, gps, -(-G // gps)


def _planes_launch(name, x, w_lo, w_hi, scales, zeros, bits, gs, N):
    """Launch one column-plane kernel. w_lo is the ``"w"`` planes (or the
    3-bit low2) and w_hi the 3-bit high1; each may be a column slice of a
    larger row-major array (the ``"pl"`` concat), passed with its row
    stride."""
    M, K = x.shape
    gs_eff = gs if gs > 0 else K
    zeros = zeros.to(scales.dtype).contiguous()
    scales = scales.contiguous()
    x = x.contiguous()
    if x.data_ptr() % 16:  # the int8 tile is read as 4-byte words
        x = x.clone()
    _kernels.require_cuda(name, x, scales, zeros)
    for t in (w_lo, w_hi):
        if t is not None and (t.device != x.device or t.dtype != torch.uint8
                              or t.stride(-1) != 1):
            raise ValueError("{}: packed planes must be uint8 rows on {}"
                             .format(name, x.device))
    if x.dtype not in (torch.float32, torch.int8):
        raise TypeError("{}: x must be f32 or int8".format(name))
    if scales.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("{}: qparams must be f32 or bf16".format(name))
    G = 1 if gs <= 0 else K // gs
    if M > 64 or K % gs_eff or gs_eff % 32 or w_lo.shape[0] != K or \
            scales.shape != (G, N):
        raise ValueError(
            "{}: unsupported shape M={} K={} N={} gs={} s={}".format(
                name, M, K, N, gs, tuple(scales.shape)))
    hi = w_lo if w_hi is None else w_hi
    MR, CB, gps, splits = planes_plan(bits, M, K, N, gs_eff,
                                      _kernels.sm_count(x.device))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else out)
    err = _kernels.lib().sbt_qmm_planes(
        _kernels.ptr(x), int(x.dtype == torch.int8), _kernels.ptr(w_lo),
        w_lo.stride(0), _kernels.ptr(hi), hi.stride(0), bits,
        _kernels.ptr(scales), _kernels.ptr(zeros),
        int(scales.dtype == torch.bfloat16), _kernels.ptr(out), M, N, K,
        gs_eff, MR, CB, gps, _kernels.ptr(part), _kernels.stream())
    _kernels.check(err, "sbt_qmm_planes")
    return out


def quant_matmul_w(x, w, scales, zeros, bits, gs, N):
    """K8 wrapper (``_quant_matmul_pallas``): f32 x (M <= 64, K) times the
    ``"w"`` planes (K, N/p) at 2/4/8 bits; scales/zeros (G, N) f32 or bf16,
    (1, N) per channel when gs <= 0. Returns f32 (M, N).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return _qmm_planes_plain(x, {"w": w}, scales, zeros, bits, gs, N)
    out = _planes_launch("quant_matmul_w", x, w, None, scales, zeros, bits,
                         gs, N)
    quant_matmul_w.launches += 1
    return out


quant_matmul_w.launches = 0


def quant_matmul_w_a8(x8, w, scales, zeros, bits, gs, N):
    """K6 wrapper (``_quant_matmul_pallas_a8``): int8 x8 (M <= 64, K) times
    the ``"w"`` planes at 2/4/8 bits. Returns the UNSCALED f32 (M, N): the
    caller multiplies by the per-token activation scale."""
    if x8.device.type == "cpu":
        return _qmm_planes_plain(x8, {"w": w}, scales, zeros, bits, gs, N)
    out = _planes_launch("quant_matmul_w_a8", x8, w, None, scales, zeros,
                         bits, gs, N)
    quant_matmul_w_a8.launches += 1
    return out


quant_matmul_w_a8.launches = 0


def quant_matmul_3bit(x, packed, scales, zeros, gs, N, a8=False):
    """K7 wrapper (``_quant_matmul_pallas_3bit``): f32 x, or int8 x when
    ``a8`` (then unscaled), times 3-bit low2 + high1 planes (or the
    ``"pl"`` concat). N is the padded width, (N/8) % 128 == 0."""
    x = x if a8 else x.to(torch.float32)
    lo, hi = _planes3(packed, N)
    if x.device.type == "cpu":
        return _qmm_planes_plain(x, {"low2": lo, "high1": hi}, scales,
                                 zeros, 3, gs, N)
    out = _planes_launch("quant_matmul_3bit", x, lo, hi, scales, zeros, 3,
                         gs, N)
    quant_matmul_3bit.launches += 1
    return out


quant_matmul_3bit.launches = 0


def _dense(x, packed, scales, zeros, bits, gs, N):
    """The reference's dense route: f32 x @ the dequantized f32 weight."""
    W = dequant_weights(packed, scales, zeros, bits, N, gs)
    return x.to(torch.float32) @ W


def _qmm_fwd_impl(x, packed, scales, zeros, bits, groupsize, N, impl):
    """x (..., K) @ dequant(packed) -> f32 (..., N) (``_qmm_fwd_impl``,
    quant_matmul.py:1057-1081). impl "auto" takes K8/K7 where
    supports_planes holds, "pallas" always (a shape the kernel refuses
    raises), "xla" the dense route; containers without planes are dense."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    has_planes = bits == 3 or "w" in packed
    use_kernel = has_planes and (
        impl == "pallas"
        or (impl == "auto"
            and supports_planes(bits, K, N, groupsize, x2.shape[0])))
    if use_kernel and bits == 3:
        out = quant_matmul_3bit(x2, packed, scales, zeros, groupsize, N)
    elif use_kernel:
        out = quant_matmul_w(x2, packed["w"], scales, zeros, bits,
                             groupsize, N)
    else:
        out = _dense(x2, packed, scales, zeros, bits, groupsize, N)
    return out.reshape(lead + (N,))


class _QuantMatmul(torch.autograd.Function):
    """``quant_matmul``'s custom_vjp (quant_matmul.py:1046-1106): the
    backward is dx = g @ dequant(W)^T in f32, cast to x's dtype, and no
    weight gradients (the backbone is frozen). Only the packed weight is
    kept for the backward; the f32 W is dequantized there and freed."""

    @staticmethod
    def forward(ctx, x, packed, scales, zeros, bits, groupsize, N, impl):
        ctx.w = (packed, scales, zeros, bits, groupsize, N)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return _qmm_fwd_impl(x, packed, scales, zeros, bits, groupsize, N,
                             impl)

    @staticmethod
    def backward(ctx, g):
        packed, scales, zeros, bits, groupsize, N = ctx.w
        W = dequant_weights(packed, scales, zeros, bits, N, groupsize)
        dx = (g.reshape(-1, N).to(torch.float32) @ W.t()).reshape(
            ctx.x_shape).to(ctx.x_dtype)
        return dx, None, None, None, None, None, None, None


def quant_matmul(x, packed, scales, zeros, bits, groupsize, N, impl="auto"):
    """x (..., K) @ dequant(packed) -> f32 (..., N); differentiable in x
    (``_QuantMatmul``) when x requires a gradient; otherwise (serving)
    the forward alone, without the Function's host cost."""
    if x.requires_grad and torch.is_grad_enabled():
        return _QuantMatmul.apply(x, packed, scales, zeros, bits, groupsize,
                                  N, impl)
    return _qmm_fwd_impl(x, packed, scales, zeros, bits, groupsize, N, impl)


def prepare_a8_backward(packed, scales, zeros, bits, N, groupsize):
    """Per-input-channel int8 requantization of W^T for the backward
    product (quant_matmul.py:1112-1123), computed once at train-prep:
    (bwd_wq (N, K) int8 with codes clipped to [-127, 127] as written
    there, bwd_scale (1, K) f32)."""
    wt = dequant_weights(packed, scales, zeros, bits, N,
                         groupsize).t().contiguous()  # (N, K)
    absmax = wt.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) * INV_127
    q = torch.clamp(torch.round(wt / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


class _QuantMatmulA8Bwd(torch.autograd.Function):
    """``quant_matmul_a8bwd``'s custom_vjp (quant_matmul.py:1127-1166):
    quant_matmul's forward; dx = tokenwise-int8(g) @ bwd_wq rescaled by
    g's per-token scale and the weight's per-input-channel scale, on the
    int8 product (``int8_gemm``)."""

    @staticmethod
    def forward(ctx, x, packed, scales, zeros, bwd_wq, bwd_scale, bits,
                groupsize, N, impl):
        ctx.bwd = (bwd_wq, bwd_scale, N)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return _qmm_fwd_impl(x, packed, scales, zeros, bits, groupsize, N,
                             impl)

    @staticmethod
    def backward(ctx, g):
        bwd_wq, bwd_scale, N = ctx.bwd
        dx = int8_dx(g.reshape(-1, N), bwd_wq, bwd_scale, ctx.x_dtype)
        return (dx.reshape(ctx.x_shape),) + (None,) * 9


def quant_matmul_a8bwd(x, packed, scales, zeros, bwd_wq, bwd_scale, bits,
                       groupsize, N, impl="auto"):
    """quant_matmul whose backward runs on the int8 product (bwd_wq,
    bwd_scale from prepare_a8_backward)."""
    return _QuantMatmulA8Bwd.apply(x, packed, scales, zeros, bwd_wq,
                                   bwd_scale, bits, groupsize, N, impl)


def _a8_dispatch(xq, x_scale, packed, scales, zeros, bits, groupsize, N,
                 li=None):
    """Route of quant_matmul_a8 (quant_matmul.py:1006-1039): ``s4r`` to
    K1 (whole groups of a multiple of 64 rows), the plane containers to
    K6/K7 within supports_planes, the rest (more than 64 rows, irregular
    K) to the dense product x8 @ dequant(W), which equals the kernels'
    integer dots and epilogue up to f32 summation order. Returns
    xs-scaled f32 (M, N)."""
    K = xq.shape[1]
    gs_eff = groupsize if groupsize > 0 else K
    if "s4r" in packed and K % gs_eff == 0 and gs_eff % 64 == 0:
        return quant_matmul_s4(xq, x_scale, packed["s4r"], scales, zeros,
                               groupsize, li=li)
    if li is not None:
        packed = {k: v[li] for k, v in packed.items()}
        scales, zeros = scales[li], zeros[li]
    if (bits == 3 or "w" in packed) and supports_planes(
            bits, K, N, groupsize, xq.shape[0]):
        if bits == 3:
            out = quant_matmul_3bit(xq, packed, scales, zeros, groupsize, N,
                                    a8=True)
        else:
            out = quant_matmul_w_a8(xq, packed["w"], scales, zeros, bits,
                                    groupsize, N)
    else:
        out = _dense(xq, packed, scales, zeros, bits, groupsize, N)
    return out * x_scale


def quant_matmul_a8(x, packed, scales, zeros, bits, groupsize, N):
    """W4A8 matmul: per-token dynamic int8 activations x (..., K) times
    packed weights -> f32 (..., N)."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    xq, x_scale = tokenwise_quant(x.reshape(-1, K).to(torch.float32))
    out = _a8_dispatch(xq, x_scale, packed, scales, zeros, bits, groupsize,
                       N)
    return out.reshape(lead + (N,))


def quant_matmul_a8_stacked(x, packed, scales, zeros, li, bits, groupsize,
                            N):
    """Layer-indexed W4A8 matmul over stacked weights: packed leaves carry
    a leading layer axis and ``li`` (int) selects the layer — a view, so
    the kernel reads the stack in place."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    xq, x_scale = tokenwise_quant(x.reshape(-1, K).to(torch.float32))
    out = _a8_dispatch(xq, x_scale, packed, scales, zeros, bits, groupsize,
                       N, li=li)
    return out.reshape(lead + (N,))
