"""INT8 KV cache (port of ``sparsebit_tpu/llm/kv_cache.py``: ``KVCache``,
``init_kv_cache``, ``_quant_heads``/``_dequant_heads``, ``cache_update``
and ``cache_read``).

The port keeps the cache LAYER-STACKED from the start: k, v (L, B, S,
n_kv, hd) int8 and k_scale, v_scale (L, B, S, n_kv) f32. ``cache.k[li]``
is then a view of one layer, as the JAX per-layer list entry was, and the
scanned decode reads the stacks with no restacking. Updates are in place.
Quantization: symmetric int8 per (token, head), scale = absmax * (1/127)
rounded to bf16 before the codes are taken (ops/attention.quant_rows). The int4 mode is not ported yet.
"""

from dataclasses import dataclass

import torch

from sparsebit_tpu_torch.ops.attention import quant_rows


@dataclass
class KVCache:
    k: torch.Tensor  # (L, B, S, n_kv, hd) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, B, S, n_kv) f32
    v_scale: torch.Tensor
    length: torch.Tensor  # (B,) int32 rows filled per sequence


def init_kv_cache(cfg, batch, max_len=None, device="cpu"):
    """Zeroed int8 cache of ``max_len`` (default cfg.max_seq_len) rows."""
    S = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:4], dtype=torch.float32, device=device),
        torch.zeros(shape[:4], dtype=torch.float32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _quant_heads(x):
    """(B, S, H, hd) -> int8 codes + (B, S, H) bf16-rounded f32 scales."""
    return quant_rows(x.to(torch.float32))


def _dequant_heads(q, scale, dtype):
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def cache_update(cache, layer_idx, k_new, v_new, positions):
    """Quantize k/v (B, S_new, n_kv, hd) and write them IN PLACE at rows
    ``positions[b]`` ... of layer ``layer_idx``. As the reference's
    dynamic_update_slice, a block that would run past S starts at
    S - S_new instead. Returns the layer's (k, v, k_scale, v_scale) views."""
    B, S_new = k_new.shape[:2]
    S = cache.k.shape[2]
    start = torch.clamp(positions.to(torch.long), max=S - S_new)
    rows = start[:, None] + torch.arange(S_new, device=start.device)[None]
    bidx = torch.arange(B, device=start.device)[:, None]
    kq, ks = _quant_heads(k_new)
    vq, vs = _quant_heads(v_new)
    li = layer_idx
    cache.k[li][bidx, rows] = kq
    cache.v[li][bidx, rows] = vq
    cache.k_scale[li][bidx, rows] = ks
    cache.v_scale[li][bidx, rows] = vs
    return (cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li])


def cache_read(cache, layer_idx, dtype):
    """Full dequantized K, V for a layer: (B, S, n_kv, hd) in ``dtype``."""
    return (
        _dequant_heads(cache.k[layer_idx], cache.k_scale[layer_idx], dtype),
        _dequant_heads(cache.v[layer_idx], cache.v_scale[layer_idx], dtype),
    )
