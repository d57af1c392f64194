"""Per-token dynamic int8 activation quantization (port of
``sparsebit_tpu/ops/int8_matmul.py:tokenwise_quant``). It feeds every W4A8
matmul; on the card it is a handful of elementwise PyTorch ops, as it was
a fused XLA reduction on the TPU."""

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
