"""Decode megakernel: the whole decoder backbone for one token per row
(port of ``sparsebit_tpu/ops/layer_fused.py``: ``fused_layer_supported``,
``fused_decoder_layer`` and ``fused_decoder_layers``).

    x' = x + Wo(attn(rope(Wqkv(rms_norm(x))), cache))          (attn half)
    out = x' + W2(glu(W13(rms_norm(x'))))                      (ffn half)

Kernel K4 (``csrc/layer_fused.cu``) replaces ``_layer_kernel``
(layer_fused.py:213): one cooperative launch per decode step runs every
layer, with grid-wide barriers between the dependent phases of a layer.
It takes the weights in one of two containers (``wbits``): 4-bit signed
row pairs ``s4r`` (``_mm_step``), or the true-width 2/3-bit plane concat
``"pl"`` of ops/packing.pack_planes_serving (``_mm_step_planes``), whose
N may be padded past the logical width (the scales carry it).
Numerics are the TPU kernel's: x carried in f32 across layers, f32 rms
norm, per-row int8 quantization before Wqkv, Wo, W13 and W2 (the W4A8
matmul of ``ops/quant_matmul``), rotate-half rope with full-width cos/sin,
per-head int8 K/V rows with bf16-rounded scales, and the int8 attention of
``attention.flat_attention_rows_int8``.

The cache is the port's single layout for both engines: k, v (L, NB, blk,
Hkv, D) int8 and ks, vs (L, NB, blk, Hkv) f32 scales, where a contiguous
cache (L, B, S, Hkv, D) is the pool of B blocks of S rows with the block
table ``[[0], [1], ...]``. Row s of batch row b lives in block
``bt[b, s // blk]`` at ``s % blk``. The new row of each layer is written
in place at ``min(pos[b], S_cache - 1)`` before the attention reads it,
fresh scales included (the TPU kernel committed the scale rows outside).

``_fused_layers_plain`` is the plain version: the tests and the CPU route
run it; on the card it is only the kernel's yardstick. Its float sums are
taken in the kernel's order (``attention.ordered_sum``), so kernel and
plain version agree bit for bit on the card.
"""

import torch

from sparsebit_tpu_torch.ops import _kernels
from sparsebit_tpu_torch.ops.attention import (
    _inv_sqrt,
    flat_attention_rows_int8,
    quant_q_rows,
    quant_rows,
)
from sparsebit_tpu_torch.ops.ffn_fused import (
    _ffn_plain,
    _norm_quant,
    _qmm_s4_planned,
)
from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant
from sparsebit_tpu_torch.ops.packing import unpack_planes_serving
from sparsebit_tpu_torch.ops.quant_matmul import s4_plan

MAX_ROWS = 64  # B cap, as the reference (layer_fused.py:965)
MAX_REP = 8    # query heads per kv head held by one attention work item


def fused_layer_supported(cfg, gs, B=1, f_pad=None, wbits=4):
    """The port's limits for K4 (no Mosaic tiling rules, and no cache
    length limit): groups of whole 64-row steps, B <= 64, head_dim a power
    of two in [16, 256], at most 8 query heads per kv head. ``f_pad``, W2's
    input rows (default ffn_dim), may exceed ffn_dim by whole groups, as
    the reference allows (layer_fused.py:952-960): a W2 K-padded by
    QuantLinear.with_k_pad, whose pad rows are code 0, zero 0 and scale 1.
    Those groups fold to exactly 0 against the GLU row's zero padding, so
    K4 does not read them: it steps over them in the stack and keeps the
    unpadded model's K split, and a padded model decodes to the same bits.
    ``wbits`` 4 takes s4r row pairs, 2 or 3 the plane concat; the same
    limits hold for both (the reference's plane mode needs only whole
    groups)."""
    dim, F, D = cfg.dim, cfg.ffn_dim, cfg.head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    if wbits not in (2, 3, 4):
        return False
    if gs <= 0 or gs % 64 or not 1 <= B <= MAX_ROWS:
        return False
    f_pad = F if f_pad is None else f_pad
    if f_pad < F or f_pad % gs:
        return False
    if D < 16 or D > 256 or D & (D - 1):
        return False
    if Hq % Hkv or Hq // Hkv > MAX_REP:
        return False
    return all(K % gs == 0 and K % 64 == 0 for K in (dim, Hq * D, F))


def _rope_rows(rows, cos, sin):
    """Rotate-half rope on (B, H, D) rows with full-width (B, D) cos/sin:
    rows * cos + rot * sin, rot = [-x2, x1] (layer_fused.py:538-541)."""
    h = rows.shape[-1] // 2
    rot = torch.cat([-rows[..., h:], rows[..., :h]], dim=-1)
    return rows * cos[:, None, :] + rot * sin[:, None, :]


def _rows_of(bt, block, S):
    """(block ids, offsets) of logical rows [0, S) of every batch row:
    (B, S) each."""
    s = torch.arange(S, device=bt.device)
    return bt[:, s // block].to(torch.long), (s % block)[None, :].expand(
        bt.shape[0], S)


def _qmm_pl_plain(x8, xs, w, scales, zeros, gs, bits):
    """Plain version of K4's plane step (``_mm_step_planes``): f32 (M, N)
    = xs * sum_g s_g * (x8_g @ C_g - xsum_g * z_g) over the unsigned codes
    C of the plane concat w (K, 3N/8 or N/4), N = scales.shape[-1]; the
    groups in order, each product exact in f32, as the kernel."""
    K = x8.shape[1]
    codes = unpack_planes_serving(w, bits, scales.shape[-1]).to(
        torch.float32)
    x = x8.to(torch.float32)
    s = scales.to(torch.float32)
    z = zeros.to(torch.float32)
    acc = torch.zeros((x8.shape[0], codes.shape[-1]), dtype=torch.float32,
                      device=x8.device)
    for g in range(K // gs):
        xg = x[:, g * gs:(g + 1) * gs]
        dot = xg @ codes[g * gs:(g + 1) * gs]
        xsum = xg.sum(dim=1, keepdim=True)
        acc = acc + (dot - xsum * z[g]) * s[g]
    return acc * xs.reshape(-1, 1)


def _mm_plain(wbits):
    """K4's matmul step for one container: s4r row pairs in the kernel's
    K-split order (``s4_plan``), or planes."""
    if wbits == 4:
        return _qmm_s4_planned
    return lambda x8, xs, w, s, z, gs: _qmm_pl_plain(x8, xs, w, s, z, gs,
                                                     wbits)


def _fused_layers_plain(x, pos, cos, sin, ws, attn_norm, ffn_norm, k, v,
                        ks, vs, bt, s_act, gs, eps, Hq, Hkv, wbits=4, F=None):
    """Plain version of K4. ws = ((wq, sq, zq), (wo, so, zo), (w13, s13,
    z13), (w2, s2, z2)) layer stacks in the ``wbits`` container; the cache
    is updated in place. ``F`` (default: W2's rows) is the FFN width: a
    longer, K-padded W2 stack is read in its first F rows, as the kernel.
    Returns the post-backbone rows (B, dim) f32."""
    if F is not None:
        w2, s2, z2 = ws[3]
        rows, G = (F // 2 if wbits == 4 else F), F // gs
        ws = tuple(ws[:3]) + ((w2[:, :rows], s2[:, :G], z2[:, :G]),)
    B, dim = x.shape
    D = cos.shape[-1]
    HD, KVD = Hq * D, Hkv * D
    block = k.shape[2]
    S_cache = bt.shape[1] * block
    mm = _mm_plain(wbits)
    lw = torch.clamp(pos.to(torch.long), max=S_cache - 1)
    rows = torch.arange(B, device=x.device)
    blk_w = bt[rows, lw // block].to(torch.long)
    off_w = lw % block
    blk_r, off_r = _rows_of(bt, block, s_act)
    x = x.to(torch.float32)
    for li in range(attn_norm.shape[0]):
        (wq, sq, zq), (wo, so, zo), (w13, s13, z13), (w2, s2, z2) = (
            tuple(t[li] for t in w) for w in ws)
        xq, xs = _norm_quant(x, attn_norm[li], eps)
        qkv = mm(xq, xs, wq, sq, zq, gs)
        q = _rope_rows(qkv[:, :HD].reshape(B, Hq, D), cos, sin)
        kr = _rope_rows(qkv[:, HD:HD + KVD].reshape(B, Hkv, D), cos, sin)
        vr = qkv[:, HD + KVD:HD + 2 * KVD].reshape(B, Hkv, D)
        kq, ksc = quant_rows(kr)
        vq, vsc = quant_rows(vr)
        k[li, blk_w, off_w] = kq
        v[li, blk_w, off_w] = vq
        ks[li, blk_w, off_w] = ksc
        vs[li, blk_w, off_w] = vsc
        q8, qs = quant_q_rows(q)
        attn = flat_attention_rows_int8(
            q8, qs, k[li, blk_r, off_r], v[li, blk_r, off_r],
            ks[li, blk_r, off_r], vs[li, blk_r, off_r], pos)
        a8, a_s = tokenwise_quant(attn.reshape(B, HD))
        xmid = x + mm(a8, a_s, wo, so, zo, gs)[:, :dim]
        x = _ffn_plain(xmid, w13, s13, z13, w2, s2, z2, ffn_norm[li], gs,
                       eps, mm)
    return x


_workspaces = {}


def s4_splits(K_N, gs):
    """(gps, splits) of K4's four s4r matmuls (Wqkv, Wo, W13, W2) of
    logical (K, N): the streaming tile's K-split plan."""
    out = []
    for K, N in K_N:
        gps = s4_plan(K, N, gs)
        out.append((gps, -(-(K // gs) // gps)))
    return out


def _workspace(dev, B, dim, Nq, HD, F, Hq, S_cache, gs, planes):
    """Scratch of one launch shape on the current stream, allocated once
    and reused: int8 x codes, their scales, qkv, attention out and its
    row absmax, x after the attention half, the GLU row and its absmax,
    the attention scores (B, Hq, S_cache), in plane mode the [gate | up]
    rows (B, 2F) before the GLU, the int8 rows of Wo's and W2's inputs
    (B, max(HD, F)), and the split sums: in plane mode Wo's and W2's
    first half's sum and second half's group terms (1 + max(HD, F) / gs /
    2, B, dim), in s4r mode each matmul's K-split partials (splits, B,
    N). Launches on one stream run in order, so they may share it."""
    key = (str(dev), torch.cuda.current_stream(dev).cuda_stream, B, dim, Nq,
           HD, F, Hq, S_cache, gs, planes)
    w = _workspaces.get(key)
    if w is None:
        f32 = dict(dtype=torch.float32, device=dev)
        if planes:
            n_part = (1 + max(HD, F) // gs // 2) * B * dim
        else:
            K_N = ((dim, Nq), (HD, dim), (dim, 2 * F), (F, dim))
            n_part = max(sp * B * N for (_, sp), (_, N) in
                         zip(s4_splits(K_N, gs), K_N))
        w = (torch.empty((B, dim), dtype=torch.int8, device=dev),
             torch.empty((B,), **f32), torch.empty((B, Nq), **f32),
             torch.empty((B, HD), **f32), torch.empty((B,), **f32),
             torch.empty((B, dim), **f32), torch.empty((B, F), **f32),
             torch.empty((B,), **f32), torch.empty((B, Hq, S_cache), **f32),
             torch.empty((B, 2 * F) if planes else (1,), **f32),
             torch.empty((B, max(HD, F)), dtype=torch.int8, device=dev),
             torch.empty((n_part,), **f32))
        _workspaces[key] = w
    return w


def _weight_shapes_ok(ws, K_N, gs, wbits):
    """Every (w, s, z) stack of logical (K, N): s/z (L, K/gs, Ns) and w
    (L, K/2, Ns) s4r with Ns == N at 4 bits, or the plane concat (L, K,
    3Ns/8) / (L, K, Ns/4) with Ns >= N a multiple of 8 / 4."""
    for (w, s, z), (K, N) in zip(ws, K_N):
        Ns = s.shape[-1]
        if s.shape[1:] != (K // gs, Ns) or z.shape != s.shape:
            return False
        if wbits == 4:
            want = (K // 2, N) if Ns == N else None
        elif Ns < N or Ns % (8 if wbits == 3 else 4):
            want = None
        else:
            want = (K, 3 * Ns // 8 if wbits == 3 else Ns // 4)
        if w.shape[1:] != want:
            return False
    return True


def _launch(out, pos, cos, sin, ws, attn_norm, ffn_norm, k, v, ks, vs, bt,
            s_act, gs, eps, Hq, Hkv, F, wbits):
    B, dim = out.shape
    D = cos.shape[-1]
    L = attn_norm.shape[0]
    NB, block = k.shape[1], k.shape[2]
    Nq = (Hq + 2 * Hkv) * D
    HD = Hq * D
    S_cache = bt.shape[1] * block
    szt = ws[0][1].dtype
    flat = [t for w in ws for t in w]
    K_N = ((dim, Nq), (HD, dim), (dim, 2 * F), (F, dim))
    f2 = ws[3][1].shape[1] * gs  # W2's rows a layer, > F when K-padded
    if (B > MAX_ROWS or k.dtype != torch.int8 or ks.dtype != torch.float32
            or k.shape[0] < L or k.shape[3:] != (Hkv, D)
            or szt not in (torch.float32, torch.bfloat16)
            or any(w[0].dtype != torch.uint8 for w in ws)
            or any(t.dtype != szt for w in ws for t in w[1:])
            or attn_norm.dtype != ffn_norm.dtype
            or attn_norm.dtype not in (torch.float32, torch.bfloat16)
            or f2 < F
            or not _weight_shapes_ok(ws, K_N[:3] + ((f2, dim),), gs, wbits)):
        raise ValueError("fused_decoder_layers: unsupported operands")
    _kernels.require_cuda("fused_decoder_layers", out, pos, cos, sin,
                          attn_norm, ffn_norm, k, v, ks, vs, bt, *flat)
    scratch = _workspace(out.device, B, dim, Nq, HD, F, Hq, S_cache, gs,
                         wbits != 4)
    p = _kernels.ptr
    err = _kernels.lib().sbt_layers_fused(
        *[p(t) for t in flat], p(attn_norm), p(ffn_norm),
        p(k), p(v), p(ks), p(vs), p(bt), p(pos), p(cos), p(sin), p(out),
        *[p(t) for t in scratch],
        int(szt == torch.bfloat16), int(attn_norm.dtype == torch.bfloat16),
        L, B, dim, Hq, Hkv, D, F, gs, f2, wbits,
        *[w[1].shape[-1] for w in ws],
        *[gps for gps, _ in s4_splits(K_N, gs)], NB, block, bt.shape[1], s_act, eps, _inv_sqrt(D), _kernels.stream())
    _kernels.check(err, "sbt_layers_fused")
    fused_decoder_layers.launches += 1
    if wbits != 4:
        fused_decoder_layers.plane_launches += 1


def fused_decoder_layers(x, pos, cos, sin,
                         wq, sq, zq, wo, so, zo, w13, s13, z13, w2, s2, z2,
                         attn_norm, ffn_norm, k, v, ks, vs,
                         cfg, gs, bt=None, s_active=None, wbits=4,
                         li_cache=0):
    """The whole backbone for one token per row, in one launch.

    x (B, dim) float -> (out (B, dim) f32 after the last layer, before the
    final norm, and k, v, ks, vs, updated in place). pos (B,) int32: the
    row each token takes (== its attended length); cos/sin (B, D) f32
    full-width rope terms at pos. Weights are layer stacks (L, ...) with
    (L, K/gs, Ns) scales and zeros (one dtype, f32 or bf16) and
    attn_norm/ffn_norm (L, dim); w13 = [gate | up]. ``wbits`` 4: ``s4r``
    row pairs wq (L, dim/2, (Hq+2Hkv)D), wo (L, HqD/2, dim), w13 (L,
    dim/2, 2F), w2 (L, F_pad/2, dim), Ns the logical N; F_pad >= F is a
    W2 K-padded by QuantLinear.with_k_pad, of which K4 reads the first F
    rows a layer (fused_layer_supported). ``wbits`` 3 or 2: the
    plane concat (L, K, 3Ns/8) or (L, K, Ns/4) of each, Ns >= N the
    padded width (pallas_n_pad).

    Caches: contiguous k/v (Lc, B, S, Hkv, D) int8 with ks/vs (Lc, B, S,
    Hkv) f32 when ``bt`` is None, else pools (Lc, n_blocks, block, Hkv, D)
    / (Lc, n_blocks, block, Hkv) and the block table bt (B, n_chunks).
    Weight layer l reads and writes cache layer ``li_cache`` + l (a view:
    a mixed-precision stack runs as one launch per uniform segment).
    ``s_active``: rows [0, s_active) bound the attention (every active
    pos < s_active); default the whole cache.

    CPU tensors take the plain version; CUDA tensors launch K4 (counted
    in ``launches``, plane-mode launches also in ``plane_launches``)."""
    B = x.shape[0]
    D = cfg.head_dim
    L = attn_norm.shape[0]
    caches = (k, v, ks, vs)
    kv = [t[li_cache:li_cache + L] for t in caches]
    if bt is None:
        if k.shape[1] != B:
            raise ValueError("contiguous cache rows {} != batch {}".format(
                k.shape[1], B))
        bt = torch.arange(B, dtype=torch.int32, device=x.device)[:, None]
    S_cache = bt.shape[1] * k.shape[2]
    s_act = S_cache if s_active is None else min(int(s_active), S_cache)
    ws = ((wq, sq, zq), (wo, so, zo), (w13, s13, z13), (w2, s2, z2))
    cos = cos.to(torch.float32).contiguous()
    sin = sin.to(torch.float32).contiguous()
    if cos.shape != (B, D):
        raise ValueError("cos/sin must be (B, head_dim)")
    if x.device.type == "cpu":
        out = _fused_layers_plain(
            x, pos, cos, sin, ws, attn_norm, ffn_norm, *kv, bt, s_act, gs,
            cfg.rms_eps, cfg.n_heads, cfg.n_kv_heads, wbits, cfg.ffn_dim)
        return (out,) + caches
    out = x.to(torch.float32).clone().contiguous()
    _launch(out, pos.to(torch.int32).contiguous(), cos, sin, ws, attn_norm,
            ffn_norm, *kv, bt.to(torch.int32).contiguous(), s_act, gs,
            cfg.rms_eps, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, wbits)
    return (out,) + caches


fused_decoder_layers.launches = 0
fused_decoder_layers.plane_launches = 0  # of those, in plane mode


def fused_decoder_layer(x, pos, cos, sin, li,
                        wq, sq, zq, wo, so, zo, w13, s13, z13, w2, s2, z2,
                        attn_norm, ffn_norm, k, v, ks, vs, cfg, gs, bt=None,
                        s_active=None, wbits=4):
    """One decoder layer ``li`` of the stacks: fused_decoder_layers over
    one-layer views of the weights and the cache (no copies). Returns
    (out, k, v, ks, vs) with the whole cache stacks, updated in place."""
    sl = slice(li, li + 1)
    out, *_ = fused_decoder_layers(
        x, pos, cos, sin, wq[sl], sq[sl], zq[sl], wo[sl], so[sl], zo[sl],
        w13[sl], s13[sl], z13[sl], w2[sl], s2[sl], z2[sl], attn_norm[sl],
        ffn_norm[sl], k, v, ks, vs, cfg, gs, bt=bt, s_active=s_active,
        wbits=wbits, li_cache=li)
    return out, k, v, ks, vs
