"""Bucketed prefill and the scanned decode loop (port of
``sparsebit_tpu/llm/decode.py``: ``prefill_at``, ``stack_layers``, the
unfused branch of ``_forward_scanned_kvs`` (decode.py:464-548),
``decode_tokens_scanned_kvs``, ``decode_chunk_scanned`` and
``sample_logits_vec``).

PyTorch runs eagerly, so ``lax.scan`` over layers and tokens becomes a
Python loop; the packed weights stay layer-stacked and each kernel reads
its layer's slice in place. The KV cache is updated in place (the JAX
functions returned new caches; these return the same, mutated, objects).
Per decode layer the path runs K1 (wqkv, wo), K2 (int8 row commit +
attention) and K3 (the FFN block); admission runs K1 at large M and K9
for the last-token lm_head.
"""

import torch

from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.kv_cache import cache_read, cache_update
from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear
from sparsebit_tpu_torch.ops.attention import decode_attention_update
from sparsebit_tpu_torch.ops.ffn_fused import (
    ffn_block_fused,
    ffn_block_supported,
)
from sparsebit_tpu_torch.ops.matvec import bf16_matvec, use_matvec


def _logits(head, x):
    """f32 logits of the lm_head for x (..., D). A bias-free dense head on
    at most 8 rows goes to K9 and keeps its f32 sums: under jit XLA folds
    the reference's cast of the bf16 dot to f32 into the dot itself, so
    its logits are never rounded to bf16 either."""
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(head, DenseLinear) and use_matvec(x2, head.w, head.bias):
        return bf16_matvec(x2, head.w).reshape(x.shape[:-1] + (-1,))
    return head(x).to(torch.float32)


def _layer_with_cache(layer, x, cfg, inv_freq, positions, mask, cache, li):
    """Decoder layer writing the cache and attending over it (the XLA
    branch of decode.py:51-81: masked attention over the dequantized
    cache). positions (B, S)."""
    h_in = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    B, S, _ = x.shape
    q, k, v = L.qkv_proj(layer, h_in, cfg)
    q = L.apply_rope(q, positions, inv_freq)
    k = L.apply_rope(k, positions, inv_freq)
    cache_update(cache, li, k, v, positions[:, 0])
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


def _stack(leaves):
    if isinstance(leaves[0], QuantLinear):
        first = leaves[0]
        return first._replace(
            packed={k: torch.stack([ln.packed[k] for ln in leaves])
                    for k in first.packed},
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


def _scan_uses_ffn_kernel(S, layers, cfg, batch):
    """True when the FFN block runs as K3: layer-stacked s4r QuantLinears
    without act-order perm, bias or N padding, w13 = [gate | up] of 2F."""
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
    return ffn_block_supported(cfg.dim, F, gs, batch)


def _forward_scanned_kvs(params, tokens, positions, kvs, cfg):
    """One decode step over stacked layers: tokens (B, 1), positions (B, 1)
    = the rows the new tokens take, kvs the stacked cache tensors (updated
    in place). Per layer: K1 wqkv, rope, K2 (quantize + commit the new K/V
    row, attend), K1 wo, K3 FFN. Returns logits (B, 1, V) f32."""
    x = params["tok_embed"][tokens.long()]
    inv_freq = L.rope_frequencies(cfg, device=x.device)
    pos0 = positions[:, 0]
    layers = params["layers"]
    k, v, ks, vs = kvs
    B, S, _ = x.shape
    use_ffn_kernel = _scan_uses_ffn_kernel(S, layers, cfg, B)
    for li in range(cfg.n_layers):
        layer = _stacked_layer_view(layers, li)
        h = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, kk, vv = L.qkv_proj(layer, h, cfg)
        q = L.apply_rope(q, positions, inv_freq)
        kk = L.apply_rope(kk, positions, inv_freq)
        out = decode_attention_update(
            q[:, 0], kk[:, 0].to(torch.float32),
            vv[:, 0].to(torch.float32), k, v, ks, vs, li, pos0,
        )[:, None].to(x.dtype)
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
    x = L.rms_norm(x, params["norm"], cfg.rms_eps)
    return _logits(params["lm_head"], x)


def decode_tokens_scanned_kvs(params_stacked, tok0, kvs, length, cfg,
                              n_tokens):
    """Greedy multi-token decode over the stacked cache tensors ``kvs``
    with per-row ``length``. Returns (tokens (B, n), kvs, length)."""
    tok, toks = tok0, []
    for _ in range(n_tokens):
        logits = _forward_scanned_kvs(params_stacked, tok[:, None],
                                      length[:, None], kvs, cfg)
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        toks.append(tok)
        length = length + 1
    return torch.stack(toks, dim=1), kvs, length


def decode_chunk_scanned(params_stacked, tok0, cache, temps, generator, cfg,
                         n_tokens):
    """The serving inner loop: n_tokens decode steps over stacked params
    with per-slot temperatures (temps (B,), <= 0 greedy) drawn from
    ``generator``. Returns (tokens (B, n_tokens), cache)."""
    kvs = _scan_cache(cache)
    tok, length, toks = tok0, cache.length, []
    for _ in range(n_tokens):
        logits = _forward_scanned_kvs(params_stacked, tok[:, None],
                                      length[:, None], kvs, cfg)
        tok = sample_logits_vec(logits[:, 0], temps, generator)
        toks.append(tok)
        length = length + 1
    cache.length = length
    return torch.stack(toks, dim=1), cache


def sample_logits_vec(logits, temps, generator=None):
    """(B, V) f32, (B,) temps -> (B,) int32: greedy where temps <= 0, else
    a draw from softmax(logits / temp) with ``generator``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator)[:, 0].to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)
