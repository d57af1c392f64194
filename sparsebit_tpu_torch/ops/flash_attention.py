"""Flash attention, forward and backward (port of JAX's bundled
``jax/experimental/pallas/ops/tpu/flash_attention.py``, the kernels that
``sparsebit_tpu/llm/llama.py:155 causal_attention`` calls on the TPU,
the backward ones through ``jax.grad`` of the training loss).

Kernel K10 (``csrc/flash_attention.cu``) replaces
``_flash_attention_kernel_single_batch`` (flash_attention.py:342) and
``..._single_step`` (:484), launched from ``_flash_attention_impl``
(:758): causal softmax(q kᵀ · sm_scale) v with an online softmax over key
tiles, never holding the (S, S) scores. bf16 operands run on the tensor
cores, f32 ones on FFMA (register-tiled as an SGEMM is: no tensor core
takes f32, and TF32 would change what the kernel computes); scores and
sums are f32 either way. For the
backward it also writes each row's log-sum-exp (the reference saves m
and l, :682/:789; P = exp(s - m) / l = exp(s - lse)) through a pointer
that is null on every serving and eval path.

K11 replaces ``_flash_attention_dkv_kernel`` (:796, launched at :1121):
dV = Pᵀ dO and dK = dSᵀ Q for a key tile, over the query tiles from the
diagonal down and, under GQA, over the kv head's query heads in order, so
each kv head's gradient is its query heads' sum. K12 replaces
``_flash_attention_dq_kernel`` (:1146, launched at :1456): dQ = dS K over
the key tiles up to the diagonal. Both compute P = exp(s · sm_scale -
lse) under the causal mask, dP = dO Vᵀ and dS = (dP - di) P · sm_scale
with di = sum(O · dO) (a torch op, as the reference's XLA one, :273), P
and dS rounded to the operands' dtype before their products, f32
accumulators. ``flash_attention`` is a ``torch.autograd.Function`` over
them when an operand requires a gradient.

The plain versions are the same arithmetic in eager torch, in the
kernels' order: ``flash_attention_plain`` takes key tiles of K10's width
(``fwd_block_k``), a running max and sum, P rounded to V's dtype before
PV, the accumulator rescaled a tile and divided by l once at the end (a
row with l = 0 stays 0). Where K10 runs on Hopper's wgmma (bf16,
``on_sm90``) it keeps the running max of the raw scores and forms P =
exp2(s · c - m · c), c = sm_scale log2 e, with 128-key tiles (64 at
head_dim 256); the FFMA kernel (f32) forms P = exp(s · sm_scale - m)
over the scaled scores with 64-key tiles (32 at head_dim 256). The
plain version repeats whichever its operands take, so that the two
shift P by the same running max and P's bf16 rounding differs only at a
midpoint. The kernel skips causal tiles above the
diagonal; here such a tile is wholly masked, which adds exactly nothing
(its P is 0 and its rescale 1), so the two agree to the rounding of
their dot products. ``flash_bwd_dkv_plain`` and ``flash_bwd_dq_plain``
(together ``flash_attention_bwd_plain``) walk K11's and K12's key tiles
(``block_k``) and round P and dS where the kernels do.
"""

import torch

from sparsebit_tpu_torch.ops import _kernels

HEAD_DIMS = (64, 128, 256)  # the head dims K10 takes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # K10's operand types


LOG2E = 1.4426950408889634  # K10's kLog2e, rounded to f32 there


def on_sm90(dtype):
    """Whether K10, K11 and K12 run on Hopper (wgmma, TMA) kernels for
    these operands: bf16, at every head_dim they take (the C side's
    fwd_on_sm90 and bwd_on_sm90); f32 runs the FFMA kernels. The
    backward's plain versions' tiles are ``block_k``."""
    return dtype == torch.bfloat16


def _f32_block_k(head_dim):
    """Keys a tile of the f32 K10, K11 and K12 (F32Fwd / F32Dkv / F32Dq):
    64, or 32 at head_dim 256, where two ring stages of wider tiles do not
    fit."""
    return 32 if head_dim > 128 else 64


def block_k(dtype, head_dim):
    """Keys a tile of K11's and K12's plain versions (``_bwd_tiles``): the
    f32 kernels' (``_f32_block_k``) on the f32 path, 64 for bf16 (K12's
    key tiles at every head_dim; K11's blocks are 64 or 128 keys, and each
    key's dK and dV rows are one product over all the queries, so the
    width orders nothing there)."""
    return _f32_block_k(head_dim) if dtype == torch.float32 else 64


def fwd_block_k(dtype, head_dim):
    """Keys a tile of K10 and of its plain version: on the Hopper kernels
    (``on_sm90``) 128, or 64 at head_dim 256 (flash_fwd_d256_kernel);
    ``_f32_block_k`` on the f32 one."""
    if dtype == torch.float32:
        return _f32_block_k(head_dim)
    return 128 if head_dim <= 128 else 64


def flash_attention_plain(q, k, v, *, sm_scale=1.0, return_lse=False):
    """Causal. q (B, H, S, D), k/v (B, Hkv, S, D) with Hkv dividing H
    (query head h reads kv head h // (H // Hkv)). Returns (B, H, S, D) in
    q's dtype and, with ``return_lse``, each row's f32 natural-log
    log-sum-exp of its scaled scores (B, H, S), as K10 writes it for the
    backward. In K10's order for these operands (``fwd_block_k``,
    ``on_sm90``: see the module's note)."""
    B, H, S, D = q.shape
    n_rep = H // k.shape[1]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=1)
        v = torch.repeat_interleave(v, n_rep, dim=1)
    qf = q.to(torch.float32)
    kf = k.to(torch.float32)
    sm90 = on_sm90(q.dtype)
    bk = fwd_block_k(q.dtype, D)
    # Hopper: raw scores, P = exp2(s c - m c); else scaled, P = exp(s - m).
    # c in f32 as the kernel forms it: f32(sm_scale) * f32(log2 e)
    c = torch.tensor(sm_scale, dtype=torch.float32,
                     device=q.device) * LOG2E
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), float("-inf"), device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, D), device=q.device)
    for j0 in range(0, S, bk):
        j1 = min(j0 + bk, S)
        s = torch.matmul(qf, kf[:, :, j0:j1].transpose(-1, -2))
        if not sm90:
            s = s * sm_scale
        cols = torch.arange(j0, j1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        shift = torch.where(m_new == float("-inf"), 0.0, m_new)
        if sm90:
            sc = shift * c
            alpha = torch.exp2(m * c - sc)
            p = torch.exp2(s * c - sc[..., None])
        else:
            alpha = torch.exp(m - shift)
            p = torch.exp(s - shift[..., None])
        l = alpha * l + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).to(torch.float32),
                          v[:, :, j0:j1].to(torch.float32))
        acc = alpha[..., None] * acc + pv
        m = m_new
    inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    out = (acc * inv[..., None]).to(q.dtype)
    if not return_lse:
        return out
    return out, (m * sm_scale if sm90 else m) + torch.log(l)


def flash_di(out, do):
    """di = sum_d O * dO in f32 (B, H, S): the backward's row term, a torch
    op as the reference's XLA reduction (flash_attention.py:273)."""
    return (out.to(torch.float32) * do.to(torch.float32)).sum(dim=-1)


def _bwd_tiles(q, k, v, lse, do, di, sm_scale, bk):
    """The backward's key tiles, ``bk`` keys wide: for each,
    (j0, j1, P, dS) in f32, P = exp(s · sm_scale - lse) under the causal
    mask and dS = (dP - di) P · sm_scale with dP = dO V_jᵀ, the
    reference's order of operations (flash_attention.py:890-914), over
    every query head (kv heads repeated)."""
    B, H, S, D = q.shape
    n_rep = H // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(n_rep, dim=1)
    vf = v.to(torch.float32).repeat_interleave(n_rep, dim=1)
    qf, dof = q.to(torch.float32), do.to(torch.float32)
    rows = torch.arange(S, device=q.device)[:, None]
    for j0 in range(0, S, bk):
        j1 = min(j0 + bk, S)
        s = torch.matmul(qf, kf[:, :, j0:j1].transpose(-1, -2)) * sm_scale
        cols = torch.arange(j0, j1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        p = torch.exp(s - lse[..., None])
        dp = torch.matmul(dof, vf[:, :, j0:j1].transpose(-1, -2))
        yield j0, j1, p, (dp - di[..., None]) * p * sm_scale


def _by_kv_head(t, Hkv):
    """(B, H, S, X) -> (B, Hkv, n_rep * S, X): a kv head's query heads'
    rows in head order, the order K11 sums them in."""
    B, H, S, X = t.shape
    return t.reshape(B, Hkv, (H // Hkv) * S, X)


def flash_bwd_dkv_plain(q, k, v, lse, do, di, *, sm_scale=1.0):
    """K11's plain version: (dK, dV) in k's dtype, (B, Hkv, S, D). A key
    tile at a time: dV_j = Pᵀ dO and dK_j = dSᵀ Q in f32 with P and dS
    rounded to dO's dtype first, summed over the kv head's query heads in
    head order (GQA)."""
    Hkv = k.shape[1]
    qg = _by_kv_head(q.to(torch.float32), Hkv)
    dog = _by_kv_head(do.to(torch.float32), Hkv)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    bk = block_k(q.dtype, q.shape[-1])
    for j0, j1, p, ds in _bwd_tiles(q, k, v, lse, do, di, sm_scale, bk):
        pr = _by_kv_head(p.to(do.dtype).to(torch.float32), Hkv)
        dsr = _by_kv_head(ds.to(do.dtype).to(torch.float32), Hkv)
        dv[:, :, j0:j1] = torch.matmul(pr.transpose(-1, -2), dog)
        dk[:, :, j0:j1] = torch.matmul(dsr.transpose(-1, -2), qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, lse, do, di, *, sm_scale=1.0):
    """K12's plain version: dQ in q's dtype, (B, H, S, D): the key tiles in
    order, dQ += dS K_j in f32 with dS rounded to K's dtype first."""
    n_rep = q.shape[1] // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(n_rep, dim=1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j0, j1, _, ds in _bwd_tiles(q, k, v, lse, do, di, sm_scale,
                                    block_k(q.dtype, q.shape[-1])):
        dq = dq + torch.matmul(ds.to(k.dtype).to(torch.float32),
                               kf[:, :, j0:j1])
    return dq.to(q.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, sm_scale=1.0):
    """The backward of causal flash attention in K11/K12's order and
    rounding points (the reference's _flash_attention_bwd,
    flash_attention.py:254-318, over the log-sum-exp instead of m and l):
    returns (dq, dk, dv), dk/dv summed over each kv head's query heads."""
    di = flash_di(out, do)
    dk, dv = flash_bwd_dkv_plain(q, k, v, lse, do, di, sm_scale=sm_scale)
    return flash_bwd_dq_plain(q, k, v, lse, do, di, sm_scale=sm_scale), \
        dk, dv


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


def flash_bwd_tolerance(q, k, v, lse, do, di, dq, dk, dv, *,
                        sm_scale=1.0):
    """Per-element bounds on |K12 - dq| and |K11 - (dk, dv)|, the
    references being the plain versions on the same operands (lse and di
    included): (tol_dq, tol_dk, tol_dv) in f32. Both round the same f32
    values at the same points; their dots and sums run in other orders:
      - the output's rounding, one ulp: eps |ref| (eps of the operands'
        dtype, 2^-7 for bf16);
      - P (for dV) or dS (for dK, dQ) rounded on the other side of a
        midpoint: one term of the sum moves by eps of itself. Two such
        flips anywhere in an element's sum are bounded by 2 eps times the
        root sum of squares of its terms (sqrt(sum_i (P_ij dO_id)^2) for
        dV), which is at least the sum of its two largest terms over
        sqrt(2);
      - f32 sums in another order, in the products and in dP before dS
        is formed: 2^-16 of the sum of the terms' magnitudes, with |dS|
        widened by sm_scale P (|dO| |V_j| + |di|), dP's own magnitudes.
    A dropped query tile, a dS without its di term or a skipped diagonal
    key tile moves its elements by a sum of random-signed terms a few
    times the root sum of squares, well above the bound."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    n_rep = H // Hkv
    eps = torch.finfo(q.dtype).eps
    f32 = torch.float32
    qa = q.to(f32).abs()
    doa = do.to(f32).abs()
    ka = k.to(f32).abs().repeat_interleave(n_rep, dim=1)
    va = v.to(f32).abs().repeat_interleave(n_rep, dim=1)
    qg, q2g = _by_kv_head(qa, Hkv), _by_kv_head(qa * qa, Hkv)
    dog, do2g = _by_kv_head(doa, Hkv), _by_kv_head(doa * doa, Hkv)
    sum_dv = torch.zeros(k.shape, dtype=f32, device=q.device)
    rss_dv = torch.zeros_like(sum_dv)
    sum_dk = torch.zeros_like(sum_dv)
    rss_dk = torch.zeros_like(sum_dv)
    sum_dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    rss_dq = torch.zeros_like(sum_dq)
    for j0, j1, p, ds in _bwd_tiles(q, k, v, lse, do, di, sm_scale,
                                    block_k(q.dtype, D)):
        kj, vj = ka[:, :, j0:j1], va[:, :, j0:j1]
        a = ds.abs() + sm_scale * p * (
            torch.matmul(doa, vj.transpose(-1, -2)) + di.abs()[..., None])
        pg, ag = _by_kv_head(p, Hkv), _by_kv_head(a, Hkv)
        sum_dv[:, :, j0:j1] = torch.matmul(pg.transpose(-1, -2), dog)
        rss_dv[:, :, j0:j1] = torch.matmul((pg * pg).transpose(-1, -2),
                                           do2g)
        sum_dk[:, :, j0:j1] = torch.matmul(ag.transpose(-1, -2), qg)
        ds2 = _by_kv_head(ds * ds, Hkv)
        rss_dk[:, :, j0:j1] = torch.matmul(ds2.transpose(-1, -2), q2g)
        sum_dq += torch.matmul(a, kj)
        rss_dq += torch.matmul(ds * ds, kj * kj)

    def bound(ref, rss, total):
        return (eps * ref.to(f32).abs() + 2 * eps * rss.sqrt()
                + 2.0 ** -16 * total)

    return (bound(dq, rss_dq, sum_dq), bound(dk, rss_dk, sum_dk),
            bound(dv, rss_dv, sum_dv))


def _strides(t):
    """(batch, head, row) element strides; a dimension of size 1 has
    none."""
    return [0 if t.shape[i] == 1 else t.stride(i) for i in range(3)]


def _strides_ok(t):
    """The last dimension contiguous and every row 16-byte aligned."""
    per = 16 // t.element_size()
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and \
        not any(s % per for s in _strides(t))


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
    for t in (q, k, v):
        if not _strides_ok(t):
            raise ValueError("flash_attention: strides {} not taken (the "
                             "last dimension contiguous, rows 16-byte "
                             "aligned)".format(tuple(t.stride())))
    if any(t.device != q.device or t.device.type != "cuda"
           for t in (k, v)) or q.device.type != "cuda":
        raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                         "device (got {}, {}, {})".format(
                             q.device, k.device, v.device))


def _k10(q, k, v, sm_scale, lse):
    """Launch K10, writing each row's log-sum-exp into ``lse`` unless it
    is None (the serving and eval paths pass None: a null pointer)."""
    flash_check(q, k, v)
    B, H, S, D = q.shape
    out = torch.empty_like(q)  # q's strides where q is dense
    err = _kernels.lib().sbt_flash_attention(
        _kernels.ptr(q), _kernels.ptr(k), _kernels.ptr(v), _kernels.ptr(out),
        None if lse is None else _kernels.ptr(lse), _DTYPES[q.dtype], B, H,
        k.shape[1], S, D, float(sm_scale), *_strides(q), *_strides(k),
        *_strides(v), *_strides(out), _kernels.stream())
    _kernels.check(err, "sbt_flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention_fwd(q, k, v, *, sm_scale=1.0):
    """K10 with the backward's statistics: (out, lse), lse (B, H, S) f32
    the log-sum-exp of each row's scaled scores. CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale=sm_scale,
                                     return_lse=True)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _k10(q, k, v, sm_scale, lse), lse


def _bwd_operands(q, k, v, do, lse, di):
    """The backward kernels' operands: q, k, v as K10 took them (checked
    again), dO in q's dtype and shape; any of them whose strides the
    kernels do not take is made contiguous (never a fallback to the plain
    version); lse and di (B, H, S) f32, contiguous."""
    if do.shape != q.shape:
        raise ValueError("flash_attention backward: dO {} is not q's shape "
                         "{}".format(tuple(do.shape), tuple(q.shape)))
    ts = [t if _strides_ok(t) else t.contiguous()
          for t in (q, k, v, do.to(q.dtype))]
    flash_check(*ts[:3])
    if ts[3].device != q.device:
        raise ValueError("flash_attention backward: dO on {}, q on {}"
                         .format(ts[3].device, q.device))
    stats = [t.to(device=q.device, dtype=torch.float32).contiguous()
             for t in (lse, di)]
    for t in stats:
        if t.shape != q.shape[:3]:
            raise ValueError("flash_attention backward: statistics {} are "
                             "not (B, H, S) {}".format(tuple(t.shape),
                                                       tuple(q.shape[:3])))
    return ts + stats


def flash_attention_dkv(q, k, v, lse, do, di, *, sm_scale=1.0):
    """K11 wrapper: (dK, dV) of causal flash attention, (B, Hkv, S, D) in
    k's dtype and strides, each kv head's gradients summed over its query
    heads. lse from flash_attention_fwd, di = flash_di(out, dO). CPU
    tensors take the plain version; CUDA tensors launch K11."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, lse, do, di, sm_scale=sm_scale)
    q, k, v, do, lse, di = _bwd_operands(q, k, v, do, lse, di)
    B, H, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _kernels.lib().sbt_flash_bwd_dkv(
        *map(_kernels.ptr, (q, k, v, do, lse, di, dk, dv)), _DTYPES[q.dtype],
        B, H, k.shape[1], S, D, float(sm_scale),
        *[s for t in (q, k, v, do, dk, dv) for s in _strides(t)],
        _kernels.stream())
    _kernels.check(err, "sbt_flash_bwd_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_dq(q, k, v, lse, do, di, *, sm_scale=1.0):
    """K12 wrapper: dQ of causal flash attention, (B, H, S, D) in q's
    dtype and strides. CPU tensors take the plain version; CUDA tensors
    launch K12."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, lse, do, di, sm_scale=sm_scale)
    q, k, v, do, lse, di = _bwd_operands(q, k, v, do, lse, di)
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    err = _kernels.lib().sbt_flash_bwd_dq(
        *map(_kernels.ptr, (q, k, v, do, lse, di, dq)), _DTYPES[q.dtype],
        B, H, k.shape[1], S, D, float(sm_scale),
        *[s for t in (q, k, v, do, dq) for s in _strides(t)],
        _kernels.stream())
    _kernels.check(err, "sbt_flash_bwd_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, *, sm_scale=1.0):
    """The backward of ``flash_attention`` (the reference's
    _flash_attention_bwd, flash_attention.py:254-318): di as a torch op,
    then K11 (dK, dV) and K12 (dQ). Returns (dq, dk, dv)."""
    do = do.to(q.dtype)
    di = flash_di(out, do)
    dk, dv = flash_attention_dkv(q, k, v, lse, do, di, sm_scale=sm_scale)
    return flash_attention_dq(q, k, v, lse, do, di, sm_scale=sm_scale), \
        dk, dv


class _FlashAttention(torch.autograd.Function):
    """K10 forward with the rows' log-sum-exp saved; the backward looks
    ``flash_attention_bwd`` up at call time."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, sm_scale=1.0):
    """Causal softmax(q kᵀ · sm_scale) v in JAX's layout: q (B, H, S, D),
    k/v (B, Hkv, S, D) with Hkv dividing H. Returns (B, H, S, D) in q's
    dtype.

    CPU tensors take the plain version; CUDA tensors launch K10, which
    reads the operands through their strides (the port's (B, S, H, D)
    activations, transposed as views, are not copied) and raises on what
    it does not take (``flash_check``). When an operand requires a
    gradient, the call is a ``torch.autograd.Function`` whose K10 also
    writes the rows' log-sum-exp and whose backward is K11 and K12;
    otherwise K10 runs without that output."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale=sm_scale)
    return _k10(q, k, v, sm_scale, None)


flash_attention.launches = 0
