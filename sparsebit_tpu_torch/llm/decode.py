"""Prefill, decode and generation (port of ``sparsebit_tpu/llm/decode.py``:
``prefill``, ``prefill_at``, ``decode_step``, ``prepare_params_for_decode``,
``decode_tokens``, ``decode_chunk``, ``sample_logits``, ``generate``,
``prepare_params_host``, ``stack_layers``, the scanned KVCache API
``prefill_scanned`` / ``decode_step_scanned`` / ``decode_tokens_scanned``
over ``_forward_scanned_kvs`` with its three branches,
``prefill_cold_scanned``, ``prepare_stacked_params_for_decode``,
``decode_tokens_scanned_kvs``, ``decode_chunk_scanned``,
``decode_chunk_paged`` and ``sample_logits_vec``).

The non-scanned decode (``decode_step`` and the loops over it) runs the
layers one by one over per-layer params, each linear through its own
``impl`` (K8/K7 for "auto", K1/K6/K7 for "a8"), and single-token attention
through K5 after the new row is committed (``_use_attn_kernel``, as
decode.py:30-70); other shapes, and an int4 cache (which the reference
attends on its XLA path only), take the reference's dense attention over
the dequantized cache.

PyTorch runs eagerly, so ``lax.scan`` over layers and tokens becomes a
Python loop; the packed weights stay layer-stacked and each kernel reads
its layer's slice in place. The KV cache is updated in place (the JAX
functions returned new caches; these return the same, mutated, objects).

A scanned step (``_forward_scanned_kvs``) takes one of three branches,
chosen as the reference chooses (``_scan_uses_layer_kernel``,
decode.py:333, and ``_scan_uses_update_kernel``, decode.py:290):
- the megakernel branch (decode.py:427-462): the whole backbone as ONE
  launch of K4 (ops/layer_fused), for a single-token step over an int8
  cache of fused-wqkv/w13 models in the 4-bit ``s4r`` container or the
  true-width 2/3-bit plane concat ``"pl"`` (prepare_params_host(sub4=
  "planes"));
- the unfused branch (decode.py:464-548), for models K4 does not take or
  with ``FORCE_LAYER_KERNEL = False``: per layer the stacked linears
  (K1, K6, K7), K2 (int8 row commit + attention) for a single-token step
  over an int8 cache, and K3 for an s4r FFN block
  (``_scan_uses_ffn_kernel``; ``FORCE_FFN_KERNEL = False`` runs that
  block on the stacked linears instead, as decode.py:300 lets the
  reference's callers A/B its fused FFN);
- the same per-layer walk with the plain attention in place of K2 for a
  prompt (S > 1), a bf16 or an int4 cache: the rows are quantized in the
  cache's mode and written, the layer's cache dequantized and attended
  under the mask.
The predicates do not look at the device: the CPU runs the route that
the card runs, with the kernels' plain versions. Admission runs K1 at
large M and K9 for the last-token lm_head; a cold admission
(``prefill_cold_scanned``) attends through K10 (llama.causal_attention),
which alone routes by the device, as the reference's ``_flash_ok`` does.
"""

import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.kv_cache import (
    KVCache,
    _quant_heads,
    cache_read,
    cache_update,
    init_kv_cache,
)
from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear
from sparsebit_tpu_torch.ops.attention import (
    decode_attention_stacked,
    decode_attention_supported,
    decode_attention_update,
)
from sparsebit_tpu_torch.ops.ffn_fused import (
    ffn_block_fused,
    ffn_block_supported,
)
from sparsebit_tpu_torch.ops.layer_fused import (
    fused_decoder_layers,
    fused_layer_supported,
)
from sparsebit_tpu_torch.ops.matvec import bf16_matvec, use_matvec


def _logits(head, x):
    """f32 logits of the lm_head for x (..., D). A bias-free dense head on
    at most 8 rows goes to K9 and keeps its f32 sums: under jit XLA folds
    the reference's cast of the bf16 dot to f32 into the dot itself, so
    its logits are never rounded to bf16 either. K9 has no backward: an x
    that takes a gradient goes through the head's own call."""
    x2 = x.reshape(-1, x.shape[-1])
    if (isinstance(head, DenseLinear) and not x.requires_grad
            and use_matvec(x2, head.w, head.bias)):
        return bf16_matvec(x2, head.w).reshape(x.shape[:-1] + (-1,))
    return head(x).to(torch.float32)


# The reference's switch (decode.py:27): None routes by the predicate,
# False forces the dense attention, True takes K5 wherever it is supported.
FORCE_ATTN_KERNEL = None


def _use_attn_kernel(S, quantized, cfg):
    """True when a step's attention runs as K5 (decode.py:30-39): one token
    per row and decode_attention_supported. Unlike the reference it does
    not ask the device, so the CPU takes the card's route."""
    ok = S == 1 and decode_attention_supported(
        (1, cfg.n_heads, cfg.head_dim), quantized)
    if FORCE_ATTN_KERNEL is not None:
        return FORCE_ATTN_KERNEL and ok
    return ok


def _layer_with_cache(layer, x, cfg, inv_freq, positions, mask, cache, li):
    """Decoder layer writing the cache and attending over it
    (decode.py:51-81): the new rows are committed first, then K5 over the
    layer's slab for a single-token step, else masked attention over the
    dequantized cache. positions (B, S)."""
    h_in = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    B, S, _ = x.shape
    q, k, v = L.qkv_proj(layer, h_in, cfg)
    q = L.apply_rope(q, positions, inv_freq)
    k = L.apply_rope(k, positions, inv_freq)
    cache_update(cache, li, k, v, positions[:, 0])
    if _use_attn_kernel(S, cache.quantized, cfg):
        out = decode_attention_stacked(
            q[:, 0], cache.k, cache.v, cache.k_scale, cache.v_scale, li,
            positions[:, 0])[:, None].to(x.dtype)
    else:
        k_all, v_all = cache_read(cache, li, x.dtype)
        n_rep = cfg.n_heads // cfg.n_kv_heads
        out = L.attention_scores(
            q, L.repeat_kv(k_all, n_rep), L.repeat_kv(v_all, n_rep), mask)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    x = x + layer["wo"](out)
    return x + L._ffn_block(
        layer, L.rms_norm(x, layer["ffn_norm"], cfg.rms_eps))


def _backbone_with_cache(params, tokens, positions, mask, cache, cfg):
    """Transformer body -> hidden (B, S, D) after the final norm; the cache
    is filled in place."""
    x = params["tok_embed"][tokens.long()]
    inv_freq = L.rope_frequencies(cfg, device=x.device)
    for li, layer in enumerate(params["layers"]):
        x = _layer_with_cache(layer, x, cfg, inv_freq, positions, mask,
                              cache, li)
    return L.rms_norm(x, params["norm"], cfg.rms_eps)


def _prompt_mask(S, S_max, device):
    causal = torch.triu(torch.full((S, S), -1e9, dtype=torch.float32,
                                   device=device), diagonal=1)
    return torch.nn.functional.pad(causal, (0, S_max - S),
                                   value=-1e9)[None, None]


def prefill(params, tokens, cache, cfg):
    """tokens (B, S_prompt) -> (last logits (B, V) f32, cache); the
    prompt fills rows [0, S) and cache.length grows by S
    (decode.py:120-134)."""
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    x = _backbone_with_cache(params, tokens, positions,
                             _prompt_mask(S, cache.k.shape[2], dev), cache,
                             cfg)
    logits = _logits(params["lm_head"], x[:, -1])
    cache.length = (cache.length + S).to(torch.int32)
    return logits, cache


def decode_step(params, tokens, cache, cfg):
    """tokens (B,) int32 -> (logits (B, V) f32, cache): one token per
    sequence at its own position cache.length[b] (decode.py:164-180)."""
    S_max = cache.k.shape[2]
    positions = cache.length[:, None]
    valid = (torch.arange(S_max, dtype=torch.int32,
                          device=tokens.device)[None, :] <= positions)
    mask = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, None]
    x = _backbone_with_cache(params, tokens[:, None], positions, mask, cache,
                             cfg)
    logits = _logits(params["lm_head"], x)
    cache.length = (cache.length + 1).to(torch.int32)
    return logits[:, 0], cache


def prefill_at(params, tokens, cache, cfg, last_idx, offset):
    """Bucketed-admission prefill: tokens (B, S_bucket) right-padded
    prompts, last_idx (B,) = true length - 1, offset (B,) = rows already in
    the cache (a reused prefix). Returns (logits (B, V) f32 at each row's
    last real token, cache) with cache.length = offset + last_idx + 1."""
    B, S = tokens.shape
    S_max = cache.k.shape[2]
    dev = tokens.device
    positions = offset[:, None] + torch.arange(
        S, dtype=torch.int32, device=dev)[None, :]
    col = torch.arange(S_max, dtype=torch.int32, device=dev)
    visible = col[None, None, :] <= positions[:, :, None]  # (B, S, S_max)
    mask = torch.where(visible, 0.0, -1e9).to(torch.float32)[:, None]
    x = _backbone_with_cache(params, tokens, positions, mask, cache, cfg)
    x_last = x[torch.arange(B, device=dev), last_idx.to(torch.long)]
    logits = _logits(params["lm_head"], x_last)
    cache.length = (offset + last_idx + 1).to(torch.int32)
    return logits, cache


def _stack_packed(leaves):
    """Stacked packed containers; a 2-bit ``"w"`` that is the ``"pl"``
    tensor itself (with_plane_serving) stays one tensor."""
    aliased = all("pl" in ln.packed and ln.packed.get("w") is ln.packed["pl"]
                  for ln in leaves)
    packed = {k: torch.stack([ln.packed[k] for ln in leaves])
              for k in leaves[0].packed if not (aliased and k == "w")}
    if aliased:
        packed["w"] = packed["pl"]
    return packed


def _stack(leaves):
    if isinstance(leaves[0], QuantLinear):
        first = leaves[0]
        return first._replace(
            packed=_stack_packed(leaves),
            scales=torch.stack([ln.scales for ln in leaves]),
            zeros=torch.stack([ln.zeros for ln in leaves]),
            bias=(None if first.bias is None
                  else torch.stack([ln.bias for ln in leaves])),
            perm=(None if first.perm is None
                  else torch.stack([ln.perm for ln in leaves])),
        )
    if isinstance(leaves[0], DenseLinear):
        return DenseLinear(
            torch.stack([ln.w for ln in leaves]),
            None if leaves[0].bias is None
            else torch.stack([ln.bias for ln in leaves]))
    return torch.stack(leaves)


def stack_layers(params):
    """Stack the per-layer dicts on a leading L axis (homogeneous layers:
    the same linear kinds, bits and containers in every layer)."""
    out = dict(params)
    layers = params["layers"]
    out["layers"] = {name: _stack([lyr[name] for lyr in layers])
                     for name in layers[0]}
    return out


def _scan_cache(cache):
    """The stacked (k, v, k_scale, v_scale) the scanned decode reads. The
    port's cache is stacked already, so these are the cache's own tensors
    (no copy, no scale padding)."""
    return cache.k, cache.v, cache.k_scale, cache.v_scale


class _StackedLinearView:
    """Callable view of a layer-stacked QuantLinear at layer ``li``."""

    def __init__(self, ql, li):
        self.ql = ql
        self.li = li

    def __call__(self, x):
        return self.ql.call_stacked(x, self.li)


def _stacked_layer_view(layers, li):
    view = {}
    for name, leaf in layers.items():
        if isinstance(leaf, QuantLinear):
            view[name] = _StackedLinearView(leaf, li)
        elif isinstance(leaf, DenseLinear):
            view[name] = DenseLinear(
                leaf.w[li], None if leaf.bias is None else leaf.bias[li])
        else:
            view[name] = leaf[li]
    return view


# The reference's switches (decode.py:300-303): None routes by the
# predicate, False forces the plain branch, True takes the kernel wherever
# it is supported. FORCE_LAYER_KERNEL: K4 against the unfused branch;
# FORCE_FFN_KERNEL: the unfused branch's FFN block on K3 against the
# stacked linears.
FORCE_FFN_KERNEL = None
FORCE_LAYER_KERNEL = None


def _u4_k_rows(lin):
    """Logical K (input rows) of the s4r serving array: row pairs store
    K/2 rows."""
    return lin.packed["s4r"].shape[-2] * 2


def _pl_serving(lin):
    """The true-width 2/3-bit plane concat of a QuantLinear
    (with_plane_serving), or None."""
    return lin.packed.get("pl")


def _layer_kernel_ok(layers, cfg, batch):
    """True when K4 can run these stacked layers: fused wqkv/wo/w13/w2
    QuantLinears with one groupsize and no act-order perm or bias, within
    fused_layer_supported, either all in the plane concat ``"pl"`` at one
    bit width (preferred, as decode.py:348-362: W2's K is its full row
    count, and padded N is fine) or all s4r without N padding."""
    lins = [layers.get(n) for n in ("wqkv", "wo", "w13", "w2")]
    if not all(isinstance(ln, QuantLinear) for ln in lins):
        return False
    gs = lins[0].groupsize
    for ln in lins:
        if ln.perm is not None or ln.bias is not None or ln.groupsize != gs:
            return False
    if lins[2].out_features != 2 * cfg.ffn_dim:
        return False
    if all(_pl_serving(ln) is not None for ln in lins):
        wb = lins[0].bits
        if any(ln.bits != wb for ln in lins):
            return False
        return fused_layer_supported(cfg, gs, batch,
                                     f_pad=lins[3].packed["pl"].shape[-2],
                                     wbits=wb)
    for ln in lins:
        if "s4r" not in ln.packed or ln.n_padded != ln.out_features:
            return False
    return fused_layer_supported(cfg, gs, batch, f_pad=_u4_k_rows(lins[3]))


def _scan_uses_layer_kernel(S, layers, quant_mode, cfg, batch):
    """True when a decode step runs the whole backbone as one K4 launch
    (decode.py:333-375): single-token steps over an int8 cache of a model
    _layer_kernel_ok takes, unless FORCE_LAYER_KERNEL says otherwise.
    Unlike the reference it does not ask the device, so the CPU takes the
    card's route."""
    if S != 1 or quant_mode != "int8":
        return False
    ok = _layer_kernel_ok(layers, cfg, batch)
    if FORCE_LAYER_KERNEL is not None:
        return FORCE_LAYER_KERNEL and ok
    return ok


def _scan_uses_update_kernel(S, quant_mode, cfg):
    """True when the unfused scanned step attends through K2
    (decode.py:290-296): one token per row over an int8 cache, where K5's
    shape rule holds."""
    return S == 1 and quant_mode == "int8" and _use_attn_kernel(
        1, quant_mode, cfg)


def _rope_cos_sin(cfg, pos):
    """Full-width rotate-half rope terms (B, D) at positions pos (B,)
    (decode.py:434-436)."""
    inv_freq = L.rope_frequencies(cfg, device=pos.device)
    angles = pos[:, None].to(torch.float32) * inv_freq
    return (torch.cat([torch.cos(angles)] * 2, dim=1),
            torch.cat([torch.sin(angles)] * 2, dim=1))


def _backbone_fused(layers, x, pos, k, v, ks, vs, cfg, bt=None,
                    s_active=None):
    """The decoder layers of one decode step as one K4 launch: x (B, dim)
    -> (B, dim) f32 before the final norm; the cache is written in place."""
    cos, sin = _rope_cos_sin(cfg, pos)
    w = [layers[n] for n in ("wqkv", "wo", "w13", "w2")]
    plane = _pl_serving(w[0]) is not None
    key = "pl" if plane else "s4r"
    wargs = [t for ln in w for t in (ln.packed[key], ln.scales, ln.zeros)]
    out, *_ = fused_decoder_layers(
        x.to(torch.float32), pos, cos, sin, *wargs, layers["attn_norm"],
        layers["ffn_norm"], k, v, ks, vs, cfg, w[0].groupsize, bt=bt,
        s_active=s_active, wbits=w[0].bits if plane else 4)
    return out


def _scan_uses_ffn_kernel(S, layers, cfg, batch):
    """True when the unfused branch's FFN block runs as K3 (decode.py:
    378-406): a single-token step over layer-stacked s4r QuantLinears
    without act-order perm, bias or N padding, w13 = [gate | up] of 2F,
    within ffn_block_supported, unless FORCE_FFN_KERNEL says otherwise
    (True: K3 wherever it is supported; False: the stacked linears).
    Unlike the reference it does not ask the device, so the CPU takes the
    card's route."""
    if S != 1:
        return False
    w13, w2 = layers.get("w13"), layers.get("w2")
    if not (isinstance(w13, QuantLinear) and isinstance(w2, QuantLinear)):
        return False
    if "s4r" not in w13.packed or "s4r" not in w2.packed:
        return False
    if w13.perm is not None or w2.perm is not None:
        return False
    if w13.bias is not None or w2.bias is not None:
        return False
    if w13.n_padded != w13.out_features or w2.n_padded != w2.out_features:
        return False
    gs = w13.groupsize
    if gs <= 0 or w2.groupsize != gs:
        return False
    F = w2.in_features
    if w13.out_features != 2 * F:
        return False
    ok = ffn_block_supported(cfg.dim, F, gs, batch)
    if FORCE_FFN_KERNEL is not None:
        return FORCE_FFN_KERNEL and ok
    return ok


def _positions_mask(positions, S_max):
    """(B, 1, S, S_max) additive mask: row s of batch row b sees cache
    rows [0, positions[b, s]]."""
    col = torch.arange(S_max, dtype=torch.int32, device=positions.device)
    visible = col[None, None, :] <= positions[:, :, None]
    return torch.where(visible, 0.0, -1e9).to(torch.float32)[:, None]


def _forward_scanned_kvs(params, tokens, positions, mask, kvs, quant_mode,
                         cfg, s_active=None):
    """One forward over stacked layers (decode.py:410-548): tokens (B, S),
    positions (B, S) the rows they take, kvs the stacked cache tensors
    (updated in place) of mode ``quant_mode`` ("int8", "int4" or False),
    ``mask`` the additive attention mask (None: each row sees the cache up
    to its position). Megakernel branch: one K4 launch for the backbone. Else per
    layer: the stacked linears, rope, then K2 (int8 row commit and
    attention) or the plain attention, K3 or the plain FFN block.
    ``s_active`` bounds K4's attention rows. Returns logits (B, 1, V) f32
    at the last position."""
    x = params["tok_embed"][tokens.long()]
    pos0 = positions[:, 0]
    layers = params["layers"]
    k, v, ks, vs = kvs
    B, S, _ = x.shape
    if _scan_uses_layer_kernel(S, layers, quant_mode, cfg, B):
        out = _backbone_fused(layers, x[:, 0], pos0, k, v, ks, vs, cfg,
                              s_active=s_active)
        x = L.rms_norm(out[:, None].to(x.dtype), params["norm"],
                       cfg.rms_eps)
        return _logits(params["lm_head"], x)
    inv_freq = L.rope_frequencies(cfg, device=x.device)
    use_update = _scan_uses_update_kernel(S, quant_mode, cfg)
    use_ffn_kernel = _scan_uses_ffn_kernel(S, layers, cfg, B)
    if not use_update:
        cache = KVCache(k, v, ks, vs, None, quant_mode)
        n_rep = cfg.n_heads // cfg.n_kv_heads
        if mask is None:
            mask = _positions_mask(positions, k.shape[2])
    for li in range(cfg.n_layers):
        layer = _stacked_layer_view(layers, li)
        h = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, kk, vv = L.qkv_proj(layer, h, cfg)
        q = L.apply_rope(q, positions, inv_freq)
        kk = L.apply_rope(kk, positions, inv_freq)
        if use_update:
            out = decode_attention_update(
                q[:, 0], kk[:, 0].to(torch.float32),
                vv[:, 0].to(torch.float32), k, v, ks, vs, li, pos0,
            )[:, None].to(x.dtype)
        else:
            cache_update(cache, li, kk, vv, pos0)
            k_all, v_all = cache_read(cache, li, x.dtype)
            out = L.attention_scores(q, L.repeat_kv(k_all, n_rep),
                                     L.repeat_kv(v_all, n_rep), mask)
        out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
        x = x + layer["wo"](out)
        if use_ffn_kernel:
            w13, w2 = layers["w13"], layers["w2"]
            x = ffn_block_fused(
                x[:, 0], w13.packed["s4r"], w13.scales, w13.zeros,
                w2.packed["s4r"], w2.scales, w2.zeros, layers["ffn_norm"],
                li, w13.groupsize, cfg.rms_eps,
            )[:, None].to(x.dtype)
        else:
            x = x + L._ffn_block(
                layer, L.rms_norm(x, layer["ffn_norm"], cfg.rms_eps))
    x = L.rms_norm(x[:, -1:], params["norm"], cfg.rms_eps)
    return _logits(params["lm_head"], x)


def _unscan_cache(cache, kvs):
    """The KVCache of the stacked tensors ``kvs`` (decode.py:236): the
    port's cache is stacked and updated in place, so they are its own."""
    cache.k, cache.v, cache.k_scale, cache.v_scale = kvs
    return cache


def _forward_with_cache_scanned(params, tokens, positions, mask, cache,
                                cfg):
    """KVCache wrapper of _forward_scanned_kvs (decode.py:551-568)."""
    kvs = _scan_cache(cache)
    logits = _forward_scanned_kvs(params, tokens, positions, mask, kvs,
                                  cache.quantized, cfg)
    return logits, _unscan_cache(cache, kvs)


def prefill_scanned(params_stacked, tokens, cache, cfg):
    """prefill over stacked layers (decode.py:571-586): tokens (B, S) fill
    rows [0, S) of an empty cache through the per-layer branch. Returns
    (last logits (B, V) f32, cache) with cache.length grown by S."""
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    logits, cache = _forward_with_cache_scanned(
        params_stacked, tokens, positions,
        _prompt_mask(S, cache.k.shape[2], dev), cache, cfg)
    cache.length = (cache.length + S).to(torch.int32)
    return logits[:, -1], cache


def decode_step_scanned(params_stacked, tokens, cache, cfg):
    """decode_step over stacked layers (decode.py:659-674): tokens (B,) at
    rows cache.length. Returns (logits (B, V) f32, cache)."""
    positions = cache.length[:, None]
    logits, cache = _forward_with_cache_scanned(
        params_stacked, tokens[:, None], positions,
        _positions_mask(positions, cache.k.shape[2]), cache, cfg)
    cache.length = (cache.length + 1).to(torch.int32)
    return logits[:, 0], cache


def prepare_stacked_params_for_decode(params_stacked):
    """with_u4 on every stacked QuantLinear (decode.py:768-783), so that a8
    linears of 2/3/4 bits take K1; plane-concat ``"pl"`` linears are left
    as they are (K4 reads them, and an s4r copy would double their
    bytes)."""

    def conv(lin):
        if isinstance(lin, QuantLinear) and _pl_serving(lin) is None:
            return lin.with_u4()
        return lin

    layers = dict(params_stacked["layers"])
    for name in L._LINEAR_NAMES:
        if name in layers:
            layers[name] = conv(layers[name])
    out = dict(params_stacked, layers=layers)
    if "lm_head" in out:
        out["lm_head"] = conv(out["lm_head"])
    return out


def decode_tokens_scanned_kvs(params_stacked, tok0, kvs, length, cfg,
                              n_tokens, quantized="int8", s_active=None):
    """Greedy multi-token decode over the stacked cache tensors ``kvs``
    (mode ``quantized``) with per-row ``length`` (decode.py:786-814).
    Returns (tokens (B, n), kvs, length)."""
    params_stacked = prepare_stacked_params_for_decode(params_stacked)
    tok, toks = tok0, []
    for _ in range(n_tokens):
        logits = _forward_scanned_kvs(params_stacked, tok[:, None],
                                      length[:, None], None, kvs, quantized,
                                      cfg, s_active=s_active)
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        toks.append(tok)
        length = length + 1
    return torch.stack(toks, dim=1), kvs, length


def decode_tokens_scanned(params_stacked, tok0, cache, cfg, n_tokens,
                          s_active=None):
    """Greedy-decode n_tokens over stacked layers and the KVCache
    (decode.py:817-861); ``s_active`` is K4's static context bucket
    (max(length) + n_tokens <= s_active). Returns (tokens (B, n_tokens),
    cache) with the lengths advanced."""
    toks, kvs, length = decode_tokens_scanned_kvs(
        params_stacked, tok0, _scan_cache(cache), cache.length, cfg,
        n_tokens, cache.quantized, s_active)
    cache = _unscan_cache(cache, kvs)
    cache.length = length
    return toks, cache


def decode_chunk_scanned(params_stacked, tok0, cache, temps, generator, cfg,
                         n_tokens, s_active=None):
    """The serving inner loop: n_tokens decode steps over stacked params
    with per-slot temperatures (temps (B,), <= 0 greedy) drawn from
    ``generator``; ``s_active`` is the megakernel's static context bucket
    (every active row stays below it through the chunk). Returns (tokens
    (B, n_tokens), cache)."""
    kvs = _scan_cache(cache)
    tok, length, toks = tok0, cache.length, []
    for _ in range(n_tokens):
        logits = _forward_scanned_kvs(params_stacked, tok[:, None],
                                      length[:, None], None, kvs,
                                      cache.quantized, cfg,
                                      s_active=s_active)
        tok = sample_logits_vec(logits[:, 0], temps, generator)
        toks.append(tok)
        length = length + 1
    cache.length = length
    return torch.stack(toks, dim=1), cache


def decode_chunk_paged(params_stacked, tok0, pcache, temps, generator, cfg,
                       n_tokens, s_active=None):
    """The serving inner loop against a paged cache (kv_cache.PagedKVCache):
    n_tokens decode steps, each the whole backbone as ONE K4 launch that
    reads and writes pool blocks through the block table. The table must
    already cover length + n_tokens rows of every slot. Returns (tokens
    (B, n_tokens), pcache) with the lengths advanced."""
    layers = params_stacked["layers"]
    tok, length, toks = tok0, pcache.length, []
    for _ in range(n_tokens):
        x = params_stacked["tok_embed"][tok.long()]  # (B, dim)
        out = _backbone_fused(layers, x, length, pcache.k, pcache.v,
                              pcache.k_scale, pcache.v_scale, cfg,
                              bt=pcache.block_table, s_active=s_active)
        h = L.rms_norm(out[:, None].to(x.dtype), params_stacked["norm"],
                       cfg.rms_eps)
        logits = _logits(params_stacked["lm_head"], h)[:, 0]
        tok = sample_logits_vec(logits, temps, generator)
        toks.append(tok)
        length = length + 1
    pcache.length = length
    return torch.stack(toks, dim=1), pcache


def prefill_cold_scanned(params_stacked, tokens, cache, cfg, last_idx):
    """Cold (offset-0) bucketed prefill over stacked layers, the paged
    engine's cold admission (decode.py:589-640): each row attends to its
    own causal prefix only, through L.causal_attention (K10 on the card:
    no (S, S) scores), so nothing of the cache is read; K/V rows [0, S)
    are quantized into the cache in its mode (int8 or int4), or written as
    they are in the cache's dtype when it is not quantized. Semantics of
    prefill_at(..., offset=0): logits (B, V) f32 at each row's last real
    token, cache.length = last_idx + 1."""
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    x = params_stacked["tok_embed"][tokens.long()]
    inv_freq = L.rope_frequencies(cfg, device=dev)
    layers = params_stacked["layers"]
    for li in range(cfg.n_layers):
        layer = _stacked_layer_view(layers, li)
        h = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, kk, vv = L.qkv_proj(layer, h, cfg)
        q = L.apply_rope(q, positions, inv_freq)
        kk = L.apply_rope(kk, positions, inv_freq)
        out = L.causal_attention(q, kk, vv)
        for buf, sbuf, new in ((cache.k, cache.k_scale, kk),
                               (cache.v, cache.v_scale, vv)):
            if not cache.quantized:
                buf[li, :, :S] = new.to(buf.dtype)
                continue
            q8, sc = _quant_heads(new, cache.quantized)
            buf[li, :, :S] = q8
            sbuf[li, :, :S] = sc
        x = x + layer["wo"](out.reshape(B, S, -1))
        x = x + L._ffn_block(
            layer, L.rms_norm(x, layer["ffn_norm"], cfg.rms_eps))
    x = L.rms_norm(x, params_stacked["norm"], cfg.rms_eps)
    x_last = x[torch.arange(B, device=dev), last_idx.to(torch.long)]
    logits = _logits(params_stacked["lm_head"], x_last)
    cache.length = (last_idx + 1).to(torch.int32)
    return logits, cache


def sample_logits_vec(logits, temps, generator=None):
    """(B, V) f32, (B,) temps -> (B,) int32: greedy where temps <= 0, else
    a draw from softmax(logits / temp) with ``generator``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator)[:, 0].to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)


def prepare_params_for_decode(params):
    """Every QuantLinear with its ``with_u4`` view (decode.py:864-875), so
    that a8 linears of 2/3/4 bits take K1."""
    return L.quantize_llama_params(
        params, lambda path, lin: (lin.with_u4()
                                   if isinstance(lin, QuantLinear) else lin),
        skip=())


def prepare_params_host(params, drop_fold=True, sz_dtype=torch.bfloat16,
                        head_bits=None, sub4="nibble"):
    """One-time serving layout of a quantized model (decode.py:677-765),
    per-layer or stacked: 4-bit linears to signed row pairs
    (with_s4_rows), 2/3-bit ones to the plane concat (``sub4="planes"``,
    true width, for K4's plane mode; every linear must then have one bit
    width) or to s4 nibbles re-tagged 4-bit (``sub4="nibble"``), 8-bit
    ones unchanged; qparams to ``sz_dtype``. ``head_bits`` quantizes a
    dense lm_head (round to nearest, per channel, symmetric:
    QuantLinear.from_dense)."""
    layers = params["layers"]
    if sub4 == "planes":
        lins = (layers.values() if isinstance(layers, dict)
                else (ln for lyr in layers for ln in lyr.values()))
        bit_set = {ln.bits for ln in lins if isinstance(ln, QuantLinear)}
        if len(bit_set) > 1:
            raise ValueError(
                "prepare_params_host(sub4='planes') needs uniform bit "
                "widths across layers, got {}; use sub4='nibble' for mixed "
                "checkpoints, or serve uniform-bit segments with "
                "fused_decoder_layers(li_cache=...)".format(sorted(bit_set)))

    def conv(lin):
        if not isinstance(lin, QuantLinear):
            return lin
        if lin.bits == 4:
            lin = lin.with_s4_rows(drop_fold=drop_fold)
        elif lin.bits in (2, 3):
            lin = (lin.with_plane_serving(drop_fold=drop_fold)
                   if sub4 == "planes" else lin.with_nibble_serving())
        else:
            lin = lin.with_u4_rows()
        if sz_dtype is not None:
            lin = lin.with_sz_dtype(sz_dtype)
        return lin

    out = dict(params)
    if isinstance(layers, dict):
        out["layers"] = {k: conv(v) for k, v in layers.items()}
    else:
        out["layers"] = [{k: conv(v) for k, v in lyr.items()}
                         for lyr in layers]
    head = out["lm_head"]
    if head_bits is not None and isinstance(head, DenseLinear):
        head = QuantLinear.from_dense(
            head.w.to(torch.float32), bits=head_bits, groupsize=-1, sym=True,
            bias=head.bias)
    out["lm_head"] = conv(head)
    return out


def decode_tokens(params, tok0, cache, cfg, n_tokens):
    """Greedy-decode n_tokens (decode.py:878-892). Returns (tokens (B,
    n_tokens), cache)."""
    params = prepare_params_for_decode(params)
    tok, toks = tok0, []
    for _ in range(n_tokens):
        logits, cache = decode_step(params, tok, cache, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def decode_chunk(params, tok0, cache, temps, generator, cfg, n_tokens):
    """The serving inner loop over per-layer params (decode.py:993-1011):
    n_tokens decode steps with per-slot temperatures (temps (B,), <= 0
    greedy) drawn from ``generator``. Returns (tokens (B, n_tokens),
    cache)."""
    params = prepare_params_for_decode(params)
    tok, toks = tok0, []
    for _ in range(n_tokens):
        logits, cache = decode_step(params, tok, cache, cfg)
        tok = sample_logits_vec(logits, temps, generator)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def filter_logits(logits, temperature=1.0, top_k=0, top_p=1.0):
    """The logits sample_logits draws from (decode.py:1029-1039): past the
    top_k largest and outside the top_p nucleus they are -inf, the rest
    divided by the temperature."""
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    scaled = logits / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    return scaled


def sample_logits(logits, generator=None, temperature=1.0, top_k=0,
                  top_p=1.0):
    """(B, V) -> (B,) int32 (decode.py:1026-1042); temperature <= 0 is
    greedy, else a draw from ``generator`` over filter_logits."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(params, prompt_tokens, cfg, max_new_tokens=32, temperature=0.0,
             top_k=0, top_p=1.0, kv_quantized=True, max_len=None,
             generator=None, eos_id=None, *, device=None):
    """Host generation loop (decode.py:1045-1080): prefill, then
    max_new_tokens sampled tokens, each fed to decode_step. A row that
    emitted ``eos_id`` repeats it, and the loop stops early once every row
    has. prompt_tokens (B, S); params must live on ``device`` (the card
    unless the caller names another). Returns (B, n) int32, n <=
    max_new_tokens."""
    device = resolve_device(device)
    if params["tok_embed"].device.type != device.type:
        raise ValueError("params live on {}, generate runs on {}".format(
            params["tok_embed"].device, device))
    tokens = torch.as_tensor(prompt_tokens, device=device).long()
    B, S = tokens.shape
    S_max = max_len or min(cfg.max_seq_len, S + max_new_tokens)
    cache = init_kv_cache(cfg, B, S_max, device=device,
                          quantized=kv_quantized)
    logits, cache = prefill(params, tokens, cache, cfg)
    outs = []
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    for _ in range(max_new_tokens):
        tok = sample_logits(logits, generator, temperature, top_k, top_p)
        if eos_id is not None:
            done = done | (tok == eos_id)
            tok = torch.where(done, eos_id, tok).to(torch.int32)
        outs.append(tok)
        logits, cache = decode_step(params, tok, cache, cfg)
        if eos_id is not None and bool(done.all()):
            break
    return torch.stack(outs, dim=1)
