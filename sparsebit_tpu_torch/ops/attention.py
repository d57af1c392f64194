"""Decode attention (port of ``sparsebit_tpu/ops/attention.py``:
``decode_attention``, ``decode_attention_stacked``,
``decode_attention_supported``, ``decode_attention_update`` and the plain
form of ``_flat_attention_rows_int8``).

Kernel K5 (``csrc/decode_attention.cu``) replaces ``_decode_attn_kernel``
(attention.py:499): f32 attention over an int8 or float (bf16, f16, f32)
cache for the
non-scanned ``decode_step``, as flash-decoding splits of the rows and a
merge in split order (``_decode_attn_split_plain`` is that algorithm on
the CPU).

Kernel K2 (``csrc/attention.cu``) replaces ``_attn_update_kernel``
(attention.py:662): the rows of each (batch row, kv head) split across
the CTAs of a thread-block cluster (``k2_cluster``), which take the
softmax's global max through distributed shared memory and add their
sums in rank order (``_attn_update_cluster_plain`` is that algorithm on
the CPU). The cache layout is the port's own: k, v (L, B, S, Hkv, D) int8
and ks, vs (L, B, S, Hkv) f32 scales, with no lane padding of the scale
stacks and no ``Hkv % 4`` gate (both were Mosaic tiling rules). Where the
JAX function returned updated cache arrays, this one writes the new row
into the caller's tensors in place.

``flat_attention_rows_int8`` is the int8 attention of the decode
megakernel (K4, ``ops/layer_fused.py``): per-(row, head) int8 q, exact
int32 scores, a 7-bit probability mix. Its float sums are taken in the
order of the kernel's 256-thread block reductions (``ordered_sum``), so
that the kernel and this version agree bit for bit on the card.
"""

import functools

import torch

from sparsebit_tpu_torch.ops import _kernels
from sparsebit_tpu_torch.ops.int8_matmul import INV_127


# The kernels' gates: K5 takes these cache dtypes (its C entry's kv_type is
# the index) and head_dim <= 512; K2 (int8 only) the same head_dim and at
# most K2_MAX_SCORES scores of a kv head's query heads, n_rep * (S + 1)
# (what one block's shared memory holds: the bound of a single-block
# design, kept by the cluster kernel, which holds only its CTA's rows'
# scores and takes query heads in passes).
K5_CACHE_DTYPES = (torch.int8, torch.bfloat16, torch.float16, torch.float32)
K5_MAX_HEAD_DIM = 512
K2_MAX_SCORES = (227 * 1024 - 2048) // 4
# K2's cluster: at most 8 CTAs (the portable cluster size), each holding
# at most K2_CTA_ROWS rows' scores (64 KB of f32 a query head).
K2_MAX_CLUSTER = 8
K2_CTA_ROWS = 16384


@functools.lru_cache(maxsize=None)
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


def _attn_update_weights(q, k_new, v_new, k, v, ks, vs, li, length):
    """K2's commit and softmax weights with _group_attention's roundings:
    the new rows' int8 codes and scales written in place at [li, b,
    length[b]], then q in bf16, f32 products and sums, rows s <= length[b]
    attend. Returns p = exp(s - max) (B, H, S), zero past length[b]; p2 =
    bf16(p * vs); and the f32 V codes per query head (B, S, H, D)."""
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
    p2 = (p * vsq).to(torch.bfloat16).to(torch.float32)
    return p, p2, V8


def _attn_update_plain(q, k_new, v_new, k, v, ks, vs, li, length):
    """Plain version of K2: sum_s bf16(p * vs) v / sum_s p over the
    weights of _attn_update_weights (which commits the new rows)."""
    p, p2, V8 = _attn_update_weights(q, k_new, v_new, k, v, ks, vs, li,
                                     length)
    out = torch.einsum("bhs,bshd->bhd", p2, V8)
    return out / p.sum(dim=-1, keepdim=True)


def k2_cluster(B, S, Hkv, sms):
    """K2's cluster size, the CTAs that split the rows [0, length[b]] of
    one (batch row, kv head): doubled from 1 while the grid (B * Hkv
    clusters) holds fewer than two CTAs an SM and each CTA keeps at least
    64 rows at full length (S), up to 8; then doubled until a CTA's rows,
    ceil(S / C), fit its scores (K2_CTA_ROWS)."""
    C = 1
    while C < K2_MAX_CLUSTER and B * Hkv * C < 2 * sms and S // (2 * C) >= 64:
        C *= 2
    while -(-S // C) > K2_CTA_ROWS:
        C *= 2
    return C


def _attn_update_cluster_plain(q, k_new, v_new, k, v, ks, vs, li, length,
                               cluster):
    """K2's algorithm on the CPU, its oracle: the weights of
    _attn_update_weights (one global max) with the rows [0, length[b]] of
    each (batch row, kv head) cut into ``cluster`` contiguous ranges of
    ceil((length[b] + 1) / cluster) rows (the CTAs, the last ones possibly
    short or empty): each range's sum of p and of bf16(p * vs) . v, the
    ranges' sums added in rank order, out = num / den."""
    p, p2, V8 = _attn_update_weights(q, k_new, v_new, k, v, ks, vs, li,
                                     length)
    B, H, S = p.shape
    n = length.to(torch.long)[:, None] + 1  # (B, 1) rows attended
    R = -(-n // cluster)  # rows a CTA
    s_idx = torch.arange(S, device=q.device)[None, :]
    num = torch.zeros((B, H, q.shape[-1]), device=q.device)
    den = torch.zeros((B, H, 1), device=q.device)
    for c in range(cluster):
        r0 = torch.minimum(c * R, n)
        mine = ((s_idx >= r0) & (s_idx < torch.minimum(r0 + R, n)))[:, None]
        den = den + torch.where(mine, p, torch.zeros_like(p)).sum(
            dim=-1, keepdim=True)
        num = num + torch.einsum(
            "bhs,bshd->bhd", torch.where(mine, p2, torch.zeros_like(p2)), V8)
    return num / den


def k2_check(q, k, ks, li):
    """K2's gate on shapes and dtypes, the wrapper's first step on the
    card: raises ValueError for operands the kernel does not take. q (B,
    H, D); k (L, B, S, Hkv, D) int8; ks (L, B, S, Hkv) f32."""
    B, H, D = q.shape
    L, Bc, S, Hkv, Dc = k.shape
    if (Bc, Dc) != (B, D) or H % Hkv or D > K5_MAX_HEAD_DIM or \
            H // Hkv * (S + 1) > K2_MAX_SCORES or \
            k.dtype != torch.int8 or ks.dtype != torch.float32 or \
            not 0 <= li < L:
        raise ValueError("decode_attention_update: unsupported operands q "
                         "{} k {} {} li {}".format(tuple(q.shape),
                                                   tuple(k.shape), k.dtype,
                                                   li))


def decode_attention_update(q, k_new, v_new, k, v, ks, vs, li, length):
    """One launch per layer: per-head INT8 quantization of the new K/V rows,
    their commit IN PLACE at ``[li, b, length[b]]`` of the caller's cache
    stacks, and GQA decode attention over rows [0, length[b]].

    q (B, H, D) float; k_new/v_new (B, Hkv, D) float (post-rope); k/v
    (L, B, S, Hkv, D) int8; ks/vs (L, B, S, Hkv) f32; li int; length (B,)
    int32 with every entry < S. Returns out (B, H, D) f32.

    CPU tensors take the plain version; CUDA tensors launch K2 (a cluster
    of ``k2_cluster`` CTAs a kv head and batch row)."""
    if q.device.type == "cpu":
        return _attn_update_plain(q, k_new, v_new, k, v, ks, vs, li, length)
    k2_check(q, k, ks, li)
    B, H, D = q.shape
    L, Bc, S, Hkv, Dc = k.shape
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
        _inv_sqrt(D), k2_cluster(B, S, Hkv, _kernels.sm_count(q.device)),
        _kernels.stream())
    _kernels.check(err, "sbt_attn_update")
    decode_attention_update.launches += 1
    return out


decode_attention_update.launches = 0


def decode_attention_supported(q_shape, quantized):
    """The reference's route rule (attention.py:860-875): one token per
    step, an int8 or float cache (K5 reads bf16, f16 and f32), head_dim a
    multiple of 128. The reference's ``Hkv % 4|8`` rule is a Mosaic DMA
    tiling limit (fault R3) that the CUDA kernels do not have. K5 and K2
    take head_dim up to 512 and any GQA ratio; past 512 their wrappers
    raise on the card, where the reference's kernel would run."""
    return quantized in (False, "int8") and q_shape[-1] % 128 == 0


def _decode_attn_plain(q, k, v, ks, vs, length):
    """Plain version of K5, ``_group_attention(f32_dots=True)``'s math
    (attention.py:46-96): scores = f32(q) . f32(k) * ks * D^-1/2 over rows
    s <= length[b], softmax, p * vs, then . f32(v) and / sum(p). A float
    cache has unit scales (ks, vs None). q (B, H, D); k, v (B, S, Hkv, D);
    ks, vs (B, S, Hkv). Returns (B, H, D) f32."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_rep = H // Hkv

    def per_q_head(t):  # (B, S, Hkv, ...) -> (B, S, H, ...)
        return torch.repeat_interleave(t, n_rep, dim=2)

    kf = per_q_head(k.to(torch.float32))
    vf = per_q_head(v.to(torch.float32))
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), kf)
    if ks is not None:
        scores = scores * per_q_head(ks).transpose(1, 2)
    scores = scores * _inv_sqrt(D)
    valid = (torch.arange(S, device=q.device)[None, None, :]
             <= length.to(torch.long)[:, None, None])
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * per_q_head(vs).transpose(1, 2)
    return torch.einsum("bhs,bshd->bhd", p, vf) / denom


def rows_per_split(B, S, Hkv, n_rep, sms):
    """K5's rows a block (a flash-decoding split): 256, halved down to 64
    until the grid (Hkv x query groups of up to 8 heads, B, splits) holds
    at least two blocks per SM."""
    blocks = B * Hkv * -(-n_rep // 8)
    R = 256
    while R > 64 and blocks * -(-S // R) < 2 * sms:
        R //= 2
    return R


def _decode_attn_split_plain(q, k, v, ks, vs, length, rows_per_split,
                             tile_rows=None):
    """K5's split algorithm on the CPU, its oracle: the rows cut into
    splits of ``rows_per_split``; each split yields (m, l, acc) by an
    online softmax over its rows in tiles of ``tile_rows`` (default: one
    tile): running max m, sum l rescaled by e^(m_old - m_new), accumulator
    of (p * vs) . v rescaled alike (the kernel's warps each run one over
    their passes of the split and merge in warp order the same way); the
    splits merge in split order, m = max m_j, l = sum e^(m_j - m) l_j, out
    = sum e^(m_j - m) acc_j / l. A split wholly past length[b] has m =
    -inf and weight 0. Same operands and result as _decode_attn_plain."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    tile_rows = tile_rows or rows_per_split

    def per_q_head(t):  # (B, S, Hkv, ...) -> (B, S, H, ...)
        return torch.repeat_interleave(t, n_rep, dim=2)

    kf = per_q_head(k.to(torch.float32))
    vf = per_q_head(v.to(torch.float32))
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), kf)
    if ks is not None:
        scores = scores * per_q_head(ks).transpose(1, 2)
    scores = scores * _inv_sqrt(D)
    vsq = None if vs is None else per_q_head(vs).transpose(1, 2)
    last = torch.clamp(length.to(torch.long), max=S - 1)[:, None, None]
    dev = q.device
    ms, ls, accs = [], [], []
    for s0 in range(0, S, rows_per_split):
        m = torch.full((B, H), float("-inf"), device=dev)
        l = torch.zeros((B, H), device=dev)
        acc = torch.zeros((B, H, D), device=dev)
        for t0 in range(s0, min(s0 + rows_per_split, S), tile_rows):
            rows = slice(t0, min(t0 + tile_rows, s0 + rows_per_split, S))
            valid = torch.arange(S, device=dev)[rows][None, None, :] <= last
            sc = torch.where(valid, scores[..., rows],
                             torch.full_like(scores[..., rows],
                                             float("-inf")))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            # a tile (hence a split) wholly past the length keeps m = -inf
            safe = torch.where(torch.isfinite(m_new), m_new,
                               torch.zeros_like(m_new))
            p = torch.where(valid, torch.exp(sc - safe[..., None]),
                            torch.zeros_like(sc))
            alpha = torch.where(torch.isfinite(m), torch.exp(m - safe),
                                torch.zeros_like(m))
            l = l * alpha + p.sum(dim=-1)
            if vsq is not None:
                p = p * vsq[..., rows]
            acc = acc * alpha[..., None] + torch.einsum(
                "bhs,bshd->bhd", p, vf[:, rows])
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m_all = torch.stack(ms).amax(dim=0)
    l_out = torch.zeros((B, H), device=dev)
    out = torch.zeros((B, H, D), device=dev)
    for m_j, l_j, acc_j in zip(ms, ls, accs):
        w = torch.where(torch.isfinite(m_j), torch.exp(m_j - m_all),
                        torch.zeros_like(m_j))
        l_out = l_out + w * l_j
        out = out + w[..., None] * acc_j
    return out / l_out[..., None]


def k5_check(q, k, v, li=None):
    """K5's gate on shapes and dtypes, the wrapper's first step on the
    card: raises ValueError for operands the kernel does not take. q (B,
    H, D); k, v (B, S, Hkv, D), or (L, B, S, Hkv, D) stacks with ``li``."""
    B, H, D = q.shape
    Bc, S, Hkv, Dc = k.shape[-4:]
    if (Bc, Dc) != (B, D) or v.shape != k.shape or v.dtype != k.dtype \
            or H % Hkv or D % 32 or D > K5_MAX_HEAD_DIM \
            or k.dim() != (4 if li is None else 5) \
            or (li is not None and not 0 <= li < k.shape[0]) \
            or k.dtype not in K5_CACHE_DTYPES:
        raise ValueError("decode_attention: unsupported operands q {} k {} "
                         "{} li {}".format(tuple(q.shape), tuple(k.shape),
                                           k.dtype, li))


def decode_attention(q, k, v, k_scale, v_scale, length, li=None):
    """K5 wrapper (attention.py:557-598): q (B, H, D) float; k/v (B, S,
    Hkv, D) int8 with k_scale/v_scale (B, S, Hkv) f32, or bf16, f16 or f32
    with scales None; length (B,) int32, rows [0, length[b]] attend (the
    current token's row is already in the cache). With ``li``, k/v (and the
    scales) are layer stacks (L, B, S, Hkv, D) and layer li is read in
    place. Returns (B, H, D) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (flash-decoding splits of ``rows_per_split`` rows, then their merge;
    ``_decode_attn_split_plain`` is its CPU oracle). The kernel copies
    cache rows 16 bytes at a time: k and v must be 16-byte aligned."""
    if q.device.type == "cpu":
        if li is not None:
            k, v = k[li], v[li]
            k_scale = None if k_scale is None else k_scale[li]
            v_scale = None if v_scale is None else v_scale[li]
        return _decode_attn_plain(q, k, v, k_scale, v_scale, length)
    k5_check(q, k, v, li)
    B, H, D = q.shape
    Bc, S, Hkv, Dc = k.shape[-4:]
    quant = k.dtype == torch.int8
    qf = q.to(torch.float32).contiguous()
    ln = length.to(torch.int32).contiguous()
    if quant:
        scales = (k_scale.to(torch.float32).contiguous(),
                  v_scale.to(torch.float32).contiguous())
    else:
        scales = (qf, qf)  # never read for a float cache
    _kernels.require_cuda("decode_attention", qf, k, v, *scales, ln)

    def at(t):  # layer li of a stack: a pointer offset, never a view
        if li is None or t is qf:
            return t.data_ptr()
        return t.data_ptr() + li * t.stride(0) * t.element_size()

    kp, vp = at(k), at(v)
    if (D * k.element_size()) % 16 or kp % 16 or vp % 16:
        raise ValueError("decode_attention: k and v rows must be 16-byte "
                         "aligned")
    R = rows_per_split(B, S, Hkv, H // Hkv, _kernels.sm_count(q.device))
    splits = -(-S // R)
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    # split partials: acc (B, H, splits, D), then (m, l) (B, H, splits, 2)
    part = torch.empty((B * H * splits * (D + 2),), dtype=torch.float32,
                       device=q.device)
    err = _kernels.lib().sbt_decode_attention(
        qf.data_ptr(), kp, vp, at(scales[0]), at(scales[1]), ln.data_ptr(),
        out.data_ptr(), K5_CACHE_DTYPES.index(k.dtype), B, S, Hkv, H, D,
        _inv_sqrt(D),
        part.data_ptr(), part.data_ptr() + 4 * B * H * splits * D, R,
        _kernels.stream())
    _kernels.check(err, "sbt_decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_stacked(q, k, v, k_scale, v_scale, li, length):
    """K5 over layer ``li`` of layer-stacked caches (attention.py:601-659):
    k/v (L, B, S, Hkv, D), scales (L, B, S, Hkv) or None. The layer is read
    in place (a pointer offset), never copied."""
    return decode_attention(q, k, v, k_scale, v_scale, length, li=li)


REDUCE_THREADS = 256  # block width of the K4 kernel's reductions


def ordered_sum(x):
    """Sum over the last axis in the order of a 256-thread block
    reduction: thread t adds elements t, t + 256, ... in turn, then the
    256 partials fold in a tree (t += t + w for w = 128, 64, ..., 1).
    The K4 kernel sums in exactly this order, so both agree bit for bit.
    Zeros pad the axis; adding 0.0 to the non-negative sums used here is
    exact."""
    n = x.shape[-1]
    pad = -n % REDUCE_THREADS
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    rows = x.reshape(x.shape[:-1] + (-1, REDUCE_THREADS))
    acc = torch.zeros(rows.shape[:-2] + (REDUCE_THREADS,), dtype=x.dtype,
                      device=x.device)
    for i in range(rows.shape[-2]):
        acc = acc + rows[..., i, :]
    w = REDUCE_THREADS // 2
    while w >= 1:
        acc = acc[..., :w] + acc[..., w:2 * w]
        w //= 2
    return acc[..., 0]


def quant_q_rows(q):
    """Per-(row, head) int8 query codes of the megakernel's attention
    (layer_fused.py:552-554): scale max(absmax, 1e-30) * (1/127), codes
    clipped to +-127. q (..., D) f32 -> (int8 (..., D), f32 (...))."""
    qs = torch.clamp_min(q.abs().amax(dim=-1), 1e-30) * INV_127
    q8 = torch.clamp(torch.round(q / qs[..., None]), -127, 127)
    return q8.to(torch.int8), qs


def flat_attention_rows_int8(q8, qsc, k, v, ks, vs, length):
    """Plain version of ``_flat_attention_rows_int8`` (attention.py:297)
    over slabs that already hold each row's new K/V at ``length[b]`` (the
    reference corrects that column from its fresh rows instead; its
    docstring shows the two are integer-exact).

    q8 (B, H, D) int8 and qsc (B, H) f32 (quant_q_rows); k, v (B, S, Hkv,
    D) int8 slabs; ks, vs (B, S, Hkv) f32 scales; length (B,) int. Rows
    s <= length[b] attend; query head j reads kv head j // (H / Hkv).

    scores = int32(q8 . k) * qsc * ks * D^-1/2; p = exp(s - max) over the
    valid rows; p2 = p * vs; psc = max(max p2, 1e-30) / 127; p8 =
    clip(round(p2 / psc), 0, 127); out = int32(p8 . v) * psc / sum(p).
    Returns (B, H, D) f32."""
    B, H, D = q8.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_rep = H // Hkv

    def per_q_head(t):  # (B, S, Hkv, ...) -> (B, S, H, ...)
        return torch.repeat_interleave(t, n_rep, dim=2)

    kf = per_q_head(k).to(torch.float32)
    # |q8 . k| <= 127 * 128 * D < 2^24: exact in f32 in any order
    si = torch.einsum("bhd,bshd->bhs", q8.to(torch.float32), kf)
    ksq = per_q_head(ks).transpose(1, 2)  # (B, H, S)
    vsq = per_q_head(vs).transpose(1, 2)
    valid = (torch.arange(S, device=q8.device)[None, None, :]
             <= length.to(torch.long)[:, None, None])
    scores = si * qsc[..., None] * ksq * _inv_sqrt(D)
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = ordered_sum(p)[..., None]
    p2 = p * torch.where(valid, vsq, torch.zeros_like(vsq))
    psc = torch.clamp_min(p2.amax(dim=-1, keepdim=True), 1e-30) * INV_127
    p8 = torch.clamp(torch.round(p2 / psc), 0, 127)
    # int32 value mix: sums reach 127 * 128 * S, past f32's exact range
    # at long contexts, so f64 (exact) and one rounding to f32
    vf = per_q_head(v).to(torch.float64)
    mix = torch.einsum("bhs,bshd->bhd", p8.to(torch.float64), vf)
    return mix.to(torch.float32) * psc / denom
