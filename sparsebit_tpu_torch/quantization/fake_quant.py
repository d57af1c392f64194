"""Fake quantization with straight-through-estimator gradients (port of
``sparsebit_tpu/quantization/fake_quant.py``; reference:
fake_quant_tensor.cu:50-314 and the STE autograd Function of
quantizers/quant_tensor.py:74-156 in the original system).

``fake_quant`` is one ``torch.autograd.Function`` for per-tensor,
per-channel and group-wise quantization: ``scale`` and ``zero_point`` may
have any shape that broadcasts against ``x``, and their gradients are
summed back to that shape (``_reduce_to_shape``). It is elementwise
PyTorch on either device, as the JAX package's is elementwise XLA with no
Pallas kernel (fake_quant.py:13-16).

Gradients (fake_quant_tensor.cu:97-167), vq = round(x/s) + zp:
  gx  = gy                         if qmin <= vq <= qmax else 0
  gs  = (round(x/s) - x/s) * gy    in range
        (qmax - zp) * gy           if vq > qmax
        (qmin - zp) * gy           if vq < qmin
  gzp = 0 in range, else -s * gy
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

import torch


def _reduce_to_shape(grad, shape):
    """Sum ``grad`` over the dimensions broadcast to reach it, so that it
    has ``shape``."""
    shape = tuple(shape)
    if tuple(grad.shape) == shape:
        return grad
    lead = grad.dim() - len(shape)
    dims = tuple(range(lead)) + tuple(
        i + lead for i, s in enumerate(shape)
        if s == 1 and grad.shape[i + lead] != 1)
    return grad.sum(dim=dims).reshape(shape) if dims else grad.reshape(shape)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, qmin, qmax):
        ctx.save_for_backward(x, scale, zero_point)
        ctx.qrange = (qmin, qmax)
        zp = torch.round(zero_point)
        xq = torch.clamp(torch.round(x / scale) + zp, qmin, qmax)
        return (xq - zp) * scale

    @staticmethod
    def backward(ctx, gy):
        x, scale, zero_point = ctx.saved_tensors
        qmin, qmax = ctx.qrange
        zp = torch.round(zero_point)
        xs = x / scale
        rounded = torch.round(xs)
        vq = rounded + zp
        in_range = (vq >= qmin) & (vq <= qmax)
        zero = torch.zeros((), dtype=gy.dtype, device=gy.device)
        gx = torch.where(in_range, gy, zero)
        gs_elem = torch.where(
            in_range, (rounded - xs) * gy,
            torch.where(vq > qmax, (qmax - zp) * gy, (qmin - zp) * gy))
        gzp_elem = torch.where(in_range, zero, -scale * gy)
        return (gx, _reduce_to_shape(gs_elem, scale.shape),
                _reduce_to_shape(gzp_elem, zero_point.shape), None, None)


def _as_tensor(v, like):
    return v if torch.is_tensor(v) else torch.as_tensor(
        v, dtype=like.dtype, device=like.device)


def fake_quant(x, scale, zero_point, qmin, qmax):
    """quantize -> clamp -> dequantize with STE gradients to x, scale and
    zero_point. scale / zero_point broadcast against x (e.g. (1, C, 1, 1)
    per channel in NCHW, (OC, 1) per out-channel weight, (OC, G, 1) group-
    wise); plain numbers are taken as 0-d tensors of x's dtype."""
    return _FakeQuant.apply(x, _as_tensor(scale, x),
                            _as_tensor(zero_point, x), qmin, qmax)


def grad_scale(x, ratio):
    """Identity forward (as the JAX package computes it: x * ratio plus a
    detached x * (1 - ratio)); the gradient is multiplied by ``ratio``
    (LSQ's gs_scaling, lsq.py:13-21 of the original)."""
    return x * ratio + (x * (1.0 - ratio)).detach()


def round_ste(x):
    """round() with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def floor_ste(x):
    """floor() with a straight-through gradient."""
    return x + (torch.floor(x) - x).detach()


def quantize(x, scale, zero_point, qmin, qmax, dtype=torch.int8):
    """Real quantization to integers (no dequantization)."""
    zp = torch.round(_as_tensor(zero_point, x))
    return torch.clamp(torch.round(x / scale) + zp, qmin, qmax).to(dtype)


def dequantize(q, scale, zero_point):
    scale = torch.as_tensor(scale)
    zp = torch.round(_as_tensor(zero_point, scale))
    return (q.to(scale.dtype) - zp) * scale
