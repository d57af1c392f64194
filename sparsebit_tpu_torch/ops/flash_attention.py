"""Flash attention forward (port of JAX's bundled
``jax/experimental/pallas/ops/tpu/flash_attention.py``, the kernel that
``sparsebit_tpu/llm/llama.py:155 causal_attention`` calls on the TPU).

Kernel K10 (``csrc/flash_attention.cu``) replaces
``_flash_attention_kernel_single_batch`` (flash_attention.py:342) and
``..._single_step`` (:484), launched from ``_flash_attention_impl``
(:758): causal softmax(q kᵀ · sm_scale) v with an online softmax over key
tiles, never holding the (S, S) scores. bf16 operands run on the tensor
cores, f32 ones on FFMA; scores and sums are f32 either way.

``flash_attention_plain`` is the same arithmetic in eager torch, in the
kernel's order: key tiles of the kernel's width (``block_k``), a running
max and sum, P rounded to V's dtype before PV, the accumulator rescaled by
exp(m_old - m_new) a tile and divided by l once at the end (a row with
l = 0 stays 0). The kernel skips causal tiles above the diagonal; here
such a tile is wholly masked, which adds exactly nothing (its P is 0 and
its rescale 1), so the two agree to the rounding of their dot products.

The backward kernels of the JAX module (dK/dV at :1121, dQ at :1456) are
reached only through ``jax.grad`` of the training loss; they come with
training.
"""

import torch

from sparsebit_tpu_torch.ops import _kernels

HEAD_DIMS = (64, 128, 256)  # the head dims K10 takes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # K10's operand types


def block_k(dtype):
    """Keys a tile of K10 (and of the plain version): 64 on the bf16
    tensor-core path, 32 on the f32 path."""
    return 64 if dtype == torch.bfloat16 else 32


def flash_attention_plain(q, k, v, *, sm_scale=1.0):
    """Causal. q (B, H, S, D), k/v (B, Hkv, S, D) with Hkv dividing H
    (query head h reads kv head h // (H // Hkv)). Returns (B, H, S, D) in
    q's dtype."""
    B, H, S, D = q.shape
    n_rep = H // k.shape[1]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=1)
        v = torch.repeat_interleave(v, n_rep, dim=1)
    qf = q.to(torch.float32)
    kf = k.to(torch.float32)
    bk = block_k(q.dtype)
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), float("-inf"), device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, D), device=q.device)
    for j0 in range(0, S, bk):
        j1 = min(j0 + bk, S)
        s = torch.matmul(qf, kf[:, :, j0:j1].transpose(-1, -2)) * sm_scale
        cols = torch.arange(j0, j1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        shift = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp(m - shift)
        p = torch.exp(s - shift[..., None])
        l = alpha * l + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).to(torch.float32),
                          v[:, :, j0:j1].to(torch.float32))
        acc = alpha[..., None] * acc + pv
        m = m_new
    inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    return (acc * inv[..., None]).to(q.dtype)


def flash_tolerance(q, k, v, ref, *, sm_scale=1.0):
    """Per-element bound on |K10 - ref|, ref = flash_attention_plain(q, k,
    v) on the same operands: (B, H, S, D) f32. The two round the same f32
    values, which differ in their last bits by the order of the dots and
    sums, so each element is held to its own scale:
      - the output's rounding, one ulp: eps |ref| (eps of the output's
        dtype, 2^-7 for bf16);
      - P rounded to V's dtype on the other side of a midpoint: a key's
        weight p_j / l moves by at most eps of itself, bounded by the row's
        largest weight max_j p_j / l and the kv head's largest |v|;
      - f32 sums in another order: 2^-17 of that largest |v|.
    A dropped or mis-rescaled key tile moves a late row by about the
    tile's share of its weights, far above the bound."""
    B, H, S, D = q.shape
    n_rep = H // k.shape[1]
    eps = torch.finfo(ref.dtype).eps
    vmax = v.float().abs().amax(dim=(2, 3)).repeat_interleave(n_rep, dim=1)
    cols = torch.arange(S, device=q.device)
    above = cols[None, :] > cols[:, None]
    pmax = torch.empty((B, H, S), device=q.device)
    for b in range(B):  # one batch row's (H, S, S) scores at a time
        kb = k[b].float().repeat_interleave(n_rep, dim=0)
        s = torch.matmul(q[b].float(), kb.transpose(-1, -2)) * sm_scale
        s.masked_fill_(above, float("-inf"))
        pmax[b] = torch.exp(s.amax(dim=-1) - torch.logsumexp(s, dim=-1))
        del s
    w = vmax[:, :, None, None]
    return eps * ref.float().abs() + (eps * pmax[..., None] + 2.0 ** -17) * w


def _strides(t):
    """(batch, head, row) element strides; a dimension of size 1 has
    none."""
    return [0 if t.shape[i] == 1 else t.stride(i) for i in range(3)]


def flash_check(q, k, v):
    """Raise unless K10 takes these operands: (B, H, S, D) q and
    (B, Hkv, S, D) k, v with Hkv dividing H, one dtype (bf16 or f32), D in
    HEAD_DIMS, on one CUDA device, the last dimension contiguous and every
    row 16-byte aligned."""
    B, H, S, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or \
            k.shape[2] != S or k.shape[3] != D or H % k.shape[1]:
        raise ValueError("flash_attention: q {} and k/v {}, {} do not "
                         "match".format(tuple(q.shape), tuple(k.shape),
                                        tuple(v.shape)))
    if D not in HEAD_DIMS:
        raise ValueError("flash_attention: head_dim {} not in {}".format(
            D, HEAD_DIMS))
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: needs bf16 or f32 q, k, v of one "
                         "dtype (got {}, {}, {})".format(q.dtype, k.dtype,
                                                          v.dtype))
    per = 16 // q.element_size()
    for t in (q, k, v):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(s % per for s in _strides(t)):
            raise ValueError("flash_attention: strides {} not taken (the "
                             "last dimension contiguous, rows 16-byte "
                             "aligned)".format(tuple(t.stride())))
    if any(t.device != q.device or t.device.type != "cuda"
           for t in (k, v)) or q.device.type != "cuda":
        raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                         "device (got {}, {}, {})".format(
                             q.device, k.device, v.device))


def flash_attention(q, k, v, *, sm_scale=1.0):
    """Causal softmax(q kᵀ · sm_scale) v in JAX's layout: q (B, H, S, D),
    k/v (B, Hkv, S, D) with Hkv dividing H. Returns (B, H, S, D) in q's
    dtype.

    CPU tensors take the plain version; CUDA tensors launch K10, which
    reads the operands through their strides (the port's (B, S, H, D)
    activations, transposed as views, are not copied) and raises on what
    it does not take (``flash_check``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale=sm_scale)
    flash_check(q, k, v)
    B, H, S, D = q.shape
    out = torch.empty_like(q)  # q's strides where q is dense
    err = _kernels.lib().sbt_flash_attention(
        _kernels.ptr(q), _kernels.ptr(k), _kernels.ptr(v), _kernels.ptr(out),
        _DTYPES[q.dtype], B, H, k.shape[1], S, D, float(sm_scale),
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        _kernels.stream())
    _kernels.check(err, "sbt_flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
