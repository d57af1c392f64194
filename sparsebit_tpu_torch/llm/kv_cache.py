"""INT8 or bf16 KV cache (port of ``sparsebit_tpu/llm/kv_cache.py``:
``KVCache``, ``init_kv_cache``, ``_quant_heads``/``_dequant_heads``,
``cache_update``, ``cache_read``, ``PagedKVCache``, ``init_paged_kv_cache``
and ``paged_write_rows``).

The port keeps the cache LAYER-STACKED from the start: k, v (L, B, S,
n_kv, hd) int8 and k_scale, v_scale (L, B, S, n_kv) f32. ``cache.k[li]``
is then a view of one layer, as the JAX per-layer list entry was, and the
scanned decode reads the stacks with no restacking. Updates are in place.
Quantization: symmetric int8 per (token, head), scale = absmax * (1/127)
rounded to bf16 before the codes are taken (ops/attention.quant_rows).
``quantized=False`` keeps k, v in the model's dtype with no scales (None);
the int4 mode is not ported yet.

Both engines use ONE layout. A paged pool is k, v (L, n_blocks, block,
n_kv, hd) int8 with k_scale, v_scale (L, n_blocks, block, n_kv) f32 (the
reference's pools are bf16 and transposed for Mosaic; the values are the
same, bf16-rounded); the contiguous cache is the pool of B blocks of S
rows. The decode megakernel (ops/layer_fused) reads either in place.
"""

from dataclasses import dataclass

import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.ops.attention import quant_rows


@dataclass
class KVCache:
    k: torch.Tensor  # (L, B, S, n_kv, hd) int8, or the model dtype
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, B, S, n_kv) f32, None when not quantized
    v_scale: torch.Tensor
    length: torch.Tensor  # (B,) int32 rows filled per sequence
    quantized: object = "int8"  # "int8" or False


def init_kv_cache(cfg, batch, max_len=None, quantized=True, *, device=None):
    """Zeroed cache of ``max_len`` (default cfg.max_seq_len) rows on
    ``device`` (the card unless the caller names another): quantized
    True/"int8" (int8 codes, f32 scales) or False (the model's dtype,
    cfg.torch_dtype). The positional order is the reference's."""
    device = resolve_device(device)
    S = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    if quantized is True:
        quantized = "int8"
    if quantized is False:
        return KVCache(
            torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            None, None,
            torch.zeros((batch,), dtype=torch.int32, device=device), False)
    if quantized != "int8":
        raise NotImplementedError(
            "KV cache mode {!r} is not ported".format(quantized))
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
    li = layer_idx
    if not cache.quantized:
        cache.k[li][bidx, rows] = k_new.to(cache.k.dtype)
        cache.v[li][bidx, rows] = v_new.to(cache.v.dtype)
        return cache.k[li], cache.v[li], None, None
    kq, ks = _quant_heads(k_new)
    vq, vs = _quant_heads(v_new)
    cache.k[li][bidx, rows] = kq
    cache.v[li][bidx, rows] = vq
    cache.k_scale[li][bidx, rows] = ks
    cache.v_scale[li][bidx, rows] = vs
    return (cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li])


def cache_read(cache, layer_idx, dtype):
    """Full dequantized K, V for a layer: (B, S, n_kv, hd) in ``dtype``."""
    if not cache.quantized:
        return cache.k[layer_idx].to(dtype), cache.v[layer_idx].to(dtype)
    return (
        _dequant_heads(cache.k[layer_idx], cache.k_scale[layer_idx], dtype),
        _dequant_heads(cache.v[layer_idx], cache.v_scale[layer_idx], dtype),
    )


@dataclass
class PagedKVCache:
    k: torch.Tensor  # (L, n_blocks, block, n_kv, hd) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, n_blocks, block, n_kv) f32
    v_scale: torch.Tensor
    block_table: torch.Tensor  # (B, max_chunks) int32 physical block ids
    length: torch.Tensor  # (B,) int32 rows filled per slot

    @property
    def block(self):
        return self.k.shape[2]


def init_paged_kv_cache(cfg, batch, n_blocks, block=128, max_chunks=None, *,
                        device=None):
    """Zeroed int8 pools of ``n_blocks`` blocks and an all-zeros block
    table on ``device`` (the card unless the caller names another);
    max_chunks defaults to ceil(max_seq_len / block)."""
    device = resolve_device(device)
    if max_chunks is None:
        max_chunks = -(-cfg.max_seq_len // block)
    shape = (cfg.n_layers, n_blocks, block, cfg.n_kv_heads, cfg.head_dim)
    return PagedKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:4], dtype=torch.float32, device=device),
        torch.zeros(shape[:4], dtype=torch.float32, device=device),
        torch.zeros((batch, max_chunks), dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def paged_write_rows(pcache, slot_blocks, rows_k, rows_v, rows_ks, rows_vs,
                     n_rows):
    """Write logical rows [0, n_rows) of one slot IN PLACE: row i lands
    at pool[slot_blocks[i // block], i % block].

    slot_blocks (max_chunks,) int; rows_k/v (L, >= n_rows, n_kv, hd) int8;
    rows_ks/vs (L, >= n_rows, n_kv) f32. Returns pcache."""
    dev = pcache.k.device
    logical = torch.arange(n_rows, device=dev)
    blk = slot_blocks.to(dev, torch.long)[logical // pcache.block]
    row = logical % pcache.block
    pcache.k[:, blk, row] = rows_k[:, :n_rows]
    pcache.v[:, blk, row] = rows_v[:, :n_rows]
    pcache.k_scale[:, blk, row] = rows_ks[:, :n_rows]
    pcache.v_scale[:, blk, row] = rows_vs[:, :n_rows]
    return pcache
