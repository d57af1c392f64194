"""Per-token dynamic int8 activation quantization and the int8 matmul of
the QLoRA path (port of ``sparsebit_tpu/ops/int8_matmul.py``:
``tokenwise_quant``, ``int8_gemm``, ``int8_matmul_dynamic`` and
``requantize_per_input_channel``).

The reference leaves all of it to XLA: a fused reduction for the
quantization and an int8 dot with int32 accumulation. On the card the
quantization is a handful of elementwise PyTorch ops and ``int8_gemm`` is
``torch._int_mm`` over operands zero-padded to the shapes it takes; on the
CPU it is an exact integer product.
"""

import torch

INV_127 = 1.0 / 127.0  # applied as an f32 multiply, see tokenwise_quant


def tokenwise_quant(x, eps=1e-8):
    """Per-token (last-axis) symmetric int8 quantization.

    Returns (q int8 (..., K), scale f32 (..., 1)); round half to even, as
    ``jnp.round``. The scale is ``max(absmax, eps) * (1/127)``: XLA folds
    the reference's division by the constant 127 into that multiply, and
    the 1-ulp difference would move codes at exact .5 ties."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, eps) * INV_127
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def pad_for_int_mm(x2, wq):
    """(x2 (M, K), wq (K, N)) zero-padded to the shapes ``torch._int_mm``
    takes: rows of x2 up to M = 17 when M <= 16, columns of x2 and rows of
    wq up to the next multiple of 8 of K, columns of wq up to the next
    multiple of 8 of N. Zeros add nothing to an integer dot, so rows [0, M)
    and columns [0, N) of the padded product are the exact product. Both
    come back contiguous; an operand that needs no padding is not
    copied."""
    M, K = x2.shape
    N = wq.shape[1]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8

    def pad(t, rows, cols):
        if t.shape == (rows, cols):
            return t.contiguous()
        out = t.new_zeros((rows, cols))
        out[:t.shape[0], :t.shape[1]] = t
        return out

    return pad(x2, Mp, Kp), pad(wq, Kp, Np)


def int8_gemm(xq, wq):
    """int8 (..., K) x int8 (K, N) -> int32 (..., N) (int8_matmul.py:47),
    exact at any shape, as the reference's integer dot.

    CPU tensors take an exact product (f64 holds every sum: |127 * 128 *
    K| < 2^53). CUDA tensors go to ``torch._int_mm``, which needs more
    than 16 rows and K, N multiples of 8: the operands are zero-padded up
    to that (``pad_for_int_mm``) and the product sliced back."""
    lead = xq.shape[:-1]
    K = xq.shape[-1]
    x2 = xq.reshape(-1, K)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("int8_gemm: int8 operands required (got {}, {})"
                        .format(xq.dtype, wq.dtype))
    if wq.shape[0] != K:
        raise ValueError("int8_gemm: x {} and w {} do not match".format(
            tuple(xq.shape), tuple(wq.shape)))
    M, N = x2.shape[0], wq.shape[1]
    if xq.device.type == "cpu":
        out = (x2.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)
    else:
        out = torch._int_mm(*pad_for_int_mm(x2, wq))[:M, :N]
    return out.reshape(lead + (N,))


def int8_dx(g, bwd_wq, bwd_scale, dtype):
    """dx = tokenwise-int8(g) @ bwd_wq, rescaled by g's per-token scale and
    the weight's per-input-channel scale, in ``dtype`` (int8_matmul.py:77
    and quant_matmul.py:1152-1158)."""
    gq, g_scale = tokenwise_quant(g)
    return (int8_gemm(gq, bwd_wq).to(torch.float32) * g_scale
            * bwd_scale).to(dtype)


class _Int8MatmulDynamic(torch.autograd.Function):
    """The reference's custom_vjp (int8_matmul.py:56-93): dx on the int8
    path, no weight gradients."""

    @staticmethod
    def forward(ctx, x, wq, w_scale, bwd_wq, bwd_scale):
        ctx.x_dtype = x.dtype
        ctx.bwd = (bwd_wq, bwd_scale)
        xq, x_scale = tokenwise_quant(x)
        return int8_gemm(xq, wq).to(torch.float32) * x_scale * w_scale

    @staticmethod
    def backward(ctx, g):
        bwd_wq, bwd_scale = ctx.bwd
        return (int8_dx(g, bwd_wq, bwd_scale, ctx.x_dtype), None, None,
                None, None)


def int8_matmul_dynamic(x, wq, w_scale, bwd_wq, bwd_scale):
    """x (..., K) f32/bf16 @ int8 weights wq (K, N) -> (..., N) f32.

    w_scale: (1, N) or () symmetric per-output-channel weight scale.
    bwd_wq: (N, K) int8, the weight requantized per input channel for the
    backward product, with bwd_scale (1, K). The gradient reaches x only."""
    return _Int8MatmulDynamic.apply(x, wq, w_scale, bwd_wq, bwd_scale)


def requantize_per_input_channel(wq, w_scale):
    """(K, N) int8 + (1, N) scale -> the transposed (N, K) int8 weight and
    its (1, K) per-input-channel scale for the backward product
    (int8_matmul.py:96-104; codes clipped to [-128, 127] as written
    there)."""
    wt = (wq.to(torch.float32) * w_scale).t().contiguous()  # (N, K)
    absmax = wt.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) * INV_127
    q = torch.clamp(torch.round(wt / scale), -128, 127).to(torch.int8)
    return q, scale.to(torch.float32)
