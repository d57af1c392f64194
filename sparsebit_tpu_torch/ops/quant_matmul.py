"""W4A8 group-factored matmul over packed 4-bit weights (port of
``sparsebit_tpu/ops/quant_matmul.py``: ``dequant_weights``,
``quant_matmul_a8`` and ``quant_matmul_a8_stacked``).

Kernel K1 (``csrc/quant_matmul.cu``) replaces both TPU kernels
``_qmm_u4_kernel`` (quant_matmul.py:443) and ``_qmm_u4_stacked_kernel``
(:693): one kernel covers every M from a decode step to an admission
prefill, and a layer of a stack is a view of the stacked tensors (a
pointer offset, no copy). Its plain version, ``_qmm_s4_plain``, repeats
the kernel's arithmetic with one exact f32 matmul per group.
"""

import torch

from sparsebit_tpu_torch.ops import _kernels
from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant
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


def _qmm_s4_plain(x8, xs, w, scales, zeros, gs):
    """Plain version of K1: f32 (M, N) = xs * sum_g s_g * (x8_g @ (C_g - 8)
    - xsum_g * (z_g - 8)). Every group product is exact in f32 (|x8 * c| <=
    128 * 8 and a group sum stays below 2^24); the groups are added in
    order, as the kernel does."""
    K = x8.shape[1]
    codes = unpack_s4_rows(w).to(torch.float32) - 8.0  # stored nibbles
    x = x8.to(torch.float32)
    s = scales.to(torch.float32)
    z = zeros.to(torch.float32) - 8.0
    acc = torch.zeros((x8.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x8.device)
    for g in range(K // gs):
        xg = x[:, g * gs:(g + 1) * gs]
        dot = xg @ codes[g * gs:(g + 1) * gs]
        xsum = xg.sum(dim=1, keepdim=True)
        acc = acc + (dot - xsum * z[g]) * s[g]
    return acc * xs.reshape(-1, 1)


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
    if x8.device.type == "cpu":
        return _qmm_s4_plain(x8, xs, w, scales, zeros, gs)
    zeros = zeros.to(scales.dtype)
    xs = xs.reshape(M).to(torch.float32).contiguous()
    x8 = x8.contiguous()
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
    err = _kernels.lib().sbt_qmm_s4(
        _kernels.ptr(x8), _kernels.ptr(xs), _kernels.ptr(w),
        _kernels.ptr(scales), _kernels.ptr(zeros),
        int(scales.dtype == torch.bfloat16), _kernels.ptr(out),
        M, N, K, gs, _kernels.stream())
    _kernels.check(err, "sbt_qmm_s4")
    quant_matmul_s4.launches += 1
    return out


quant_matmul_s4.launches = 0


def quant_matmul_a8(x, packed, scales, zeros, bits, groupsize, N):
    """W4A8 matmul: per-token dynamic int8 activations x (..., K) times
    packed weights -> f32 (..., N). The ``s4r`` serving container goes to
    K1; any other container is dequantized (CPU oracle only)."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    xq, x_scale = tokenwise_quant(x.reshape(-1, K).to(torch.float32))
    if "s4r" in packed:
        out = quant_matmul_s4(xq, x_scale, packed["s4r"], scales, zeros,
                              groupsize)
    else:
        out = _dense_a8(xq, x_scale, packed, scales, zeros, bits, groupsize,
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
    if "s4r" in packed:
        out = quant_matmul_s4(xq, x_scale, packed["s4r"], scales, zeros,
                              groupsize, li=li)
    else:
        out = _dense_a8(xq, x_scale, {k: v[li] for k, v in packed.items()},
                        scales[li], zeros[li], bits, groupsize, N)
    return out.reshape(lead + (N,))


def _dense_a8(xq, x_scale, packed, scales, zeros, bits, groupsize, N):
    """x8 @ dequant(W), exactly the kernel's integer dot and epilogue up to
    f32 summation order. CPU only: on the card every serving container is
    ``s4r`` and goes through K1."""
    if xq.device.type != "cpu":
        raise NotImplementedError(
            "W4A8 on CUDA needs the s4r container (QuantLinear.with_s4_rows)"
        )
    W = dequant_weights(packed, scales, zeros, bits, N, groupsize)
    return (xq.to(torch.float32) @ W) * x_scale
