"""Fused INT8 KV-row commit + decode attention (port of
``sparsebit_tpu/ops/attention.py:decode_attention_update``).

Kernel K2 (``csrc/attention.cu``) replaces ``_attn_update_kernel``
(attention.py:662). The cache layout is the port's own: k, v (L, B, S,
Hkv, D) int8 and ks, vs (L, B, S, Hkv) f32 scales, with no lane padding
of the scale stacks and no ``Hkv % 4`` gate (both were Mosaic tiling
rules). Where the JAX function returned updated cache arrays, this one
writes the new row into the caller's tensors in place.
"""

import torch

from sparsebit_tpu_torch.ops import _kernels
from sparsebit_tpu_torch.ops.int8_matmul import INV_127


def _inv_sqrt(D):
    """1/sqrt(D) rounded once to f32, as the reference's Python scalar."""
    return torch.tensor(1.0 / (D ** 0.5), dtype=torch.float32).item()


def quant_rows(x):
    """Per-head int8 quantization of new rows x (..., D) f32 -> (codes int8,
    scales f32 (...)): symmetric, scale = max(absmax, 1e-8) * (1/127)
    (int8_matmul.tokenwise_quant says why a multiply) rounded to bf16
    BEFORE the codes are taken (kv_cache.py:82)."""
    absmax = x.abs().amax(dim=-1)
    scale = (torch.clamp_min(absmax, 1e-8) * INV_127).to(
        torch.bfloat16).to(torch.float32)
    q = torch.clamp(torch.round(x / scale[..., None]), -128, 127)
    return q.to(torch.int8), scale


def _attn_update_plain(q, k_new, v_new, k, v, ks, vs, li, length):
    """Plain version of K2 with _group_attention's roundings: q and p*vs in
    bf16, products and sums in f32, rows s <= length[b] attend."""
    B, H, D = q.shape
    S, Hkv = k.shape[2], k.shape[3]
    n_rep = H // Hkv
    rows = torch.arange(B, device=q.device)
    pos = length.to(torch.long)
    kq, ksc = quant_rows(k_new.to(torch.float32))
    vq, vsc = quant_rows(v_new.to(torch.float32))
    k[li, rows, pos] = kq
    v[li, rows, pos] = vq
    ks[li, rows, pos] = ksc
    vs[li, rows, pos] = vsc

    def per_q_head(t):  # (B, S, Hkv, ...) -> (B, S, H, ...)
        return torch.repeat_interleave(t, n_rep, dim=2)

    K8 = per_q_head(k[li].to(torch.float32))
    V8 = per_q_head(v[li].to(torch.float32))
    ksq = per_q_head(ks[li]).transpose(1, 2)  # (B, H, S)
    vsq = per_q_head(vs[li]).transpose(1, 2)
    qb = q.to(torch.bfloat16).to(torch.float32)
    scores = torch.einsum("bhd,bshd->bhs", qb, K8)
    scores = scores * ksq * _inv_sqrt(D)
    valid = (torch.arange(S, device=q.device)[None, None, :]
             <= pos[:, None, None])
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True)
    p2 = (p * vsq).to(torch.bfloat16).to(torch.float32)
    out = torch.einsum("bhs,bshd->bhd", p2, V8)
    return out / denom


def decode_attention_update(q, k_new, v_new, k, v, ks, vs, li, length):
    """One launch per layer: per-head INT8 quantization of the new K/V rows,
    their commit IN PLACE at ``[li, b, length[b]]`` of the caller's cache
    stacks, and GQA decode attention over rows [0, length[b]].

    q (B, H, D) float; k_new/v_new (B, Hkv, D) float (post-rope); k/v
    (L, B, S, Hkv, D) int8; ks/vs (L, B, S, Hkv) f32; li int; length (B,)
    int32 with every entry < S. Returns out (B, H, D) f32.

    CPU tensors take the plain version; CUDA tensors launch K2."""
    if q.device.type == "cpu":
        return _attn_update_plain(q, k_new, v_new, k, v, ks, vs, li, length)
    B, H, D = q.shape
    L, Bc, S, Hkv, Dc = k.shape
    if (Bc, Dc) != (B, D) or H % Hkv or H // Hkv > 32 or D > 256 or \
            k.dtype != torch.int8 or ks.dtype != torch.float32 or \
            not 0 <= li < L:
        raise ValueError("decode_attention_update: unsupported operands")
    qf = q.to(torch.float32).contiguous()
    kf = k_new.to(torch.float32).contiguous()
    vf = v_new.to(torch.float32).contiguous()
    ln = length.to(torch.int32).contiguous()
    _kernels.require_cuda("decode_attention_update", qf, kf, vf, k, v, ks,
                          vs, ln)
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    err = _kernels.lib().sbt_attn_update(
        _kernels.ptr(qf), _kernels.ptr(kf), _kernels.ptr(vf),
        _kernels.ptr(k), _kernels.ptr(v), _kernels.ptr(ks), _kernels.ptr(vs),
        _kernels.ptr(ln), _kernels.ptr(out), li, B, S, Hkv, H, D,
        _inv_sqrt(D), _kernels.stream())
    _kernels.check(err, "sbt_attn_update")
    decode_attention_update.launches += 1
    return out


decode_attention_update.launches = 0
