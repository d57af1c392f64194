"""Decode-batch bf16 matvec for the lm_head (port of
``sparsebit_tpu/ops/matvec.py``: ``bf16_matvec`` and ``use_matvec``).

Kernel K9 (``csrc/matvec.cu``) replaces ``_mv_kernel`` (matvec.py:21): it
streams the bf16 head once per call at B <= 8 rows. The plain version is
the same product with f32 accumulation.
"""

import torch

from sparsebit_tpu_torch.ops import _kernels


def matvec_supported(B, K, N):
    """The port's gate: at most 8 rows (x sits in shared memory) and an
    even N (two bf16 columns per lane)."""
    return 1 <= B <= 8 and N % 2 == 0 and K > 0


def _bf16_matvec_plain(x, w):
    """x cast to w's dtype, products and sums in f32."""
    return x.to(w.dtype).to(torch.float32) @ w.to(torch.float32)


def bf16_matvec(x, w):
    """x (B, K) any float dtype; w (K, N) bf16. Returns (B, N) f32: x is
    cast to bf16 first (matvec.py:72), products and sums are f32.

    CPU tensors take the plain version; CUDA tensors launch K9."""
    if x.device.type == "cpu":
        return _bf16_matvec_plain(x, w)
    B, K = x.shape
    N = w.shape[1]
    if w.dtype != torch.bfloat16 or not matvec_supported(B, K, N):
        raise ValueError("bf16_matvec: needs bf16 w, B <= 8, even N")
    xb = x.to(torch.bfloat16).contiguous()
    _kernels.require_cuda("bf16_matvec", xb, w)
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    err = _kernels.lib().sbt_bf16_matvec(
        _kernels.ptr(xb), _kernels.ptr(w), _kernels.ptr(out), B, K, N,
        _kernels.stream())
    _kernels.check(err, "sbt_bf16_matvec")
    bf16_matvec.launches += 1
    return out


bf16_matvec.launches = 0


def matvec(x, w):
    """bf16_matvec cast back to x's dtype: a drop-in for ``x @ w``."""
    return bf16_matvec(x, w).to(x.dtype)


def use_matvec(x, w, bias):
    """True when the decode-shape streamer takes this call: 2-D tiny-batch
    float x, bf16 w, no bias. Unlike the JAX gate it does not look at the
    backend: the wrapper itself runs the plain version on the CPU."""
    return (
        bias is None
        and x.dim() == 2
        and x.is_floating_point()
        and w.dtype == torch.bfloat16
        and matvec_supported(x.shape[0], *w.shape)
    )
