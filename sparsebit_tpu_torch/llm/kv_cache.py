"""INT8, INT4 or bf16 KV cache (port of ``sparsebit_tpu/llm/kv_cache.py``:
``KVCache``, ``init_kv_cache``, ``_quant_heads``/``_dequant_heads``,
``cache_update``, ``cache_read``, ``PagedKVCache``, ``init_paged_kv_cache``
and ``paged_write_rows``).

The port keeps the cache LAYER-STACKED from the start: k, v (L, B, S,
n_kv, hd) int8 and k_scale, v_scale (L, B, S, n_kv) f32. ``cache.k[li]``
is then a view of one layer, as the JAX per-layer list entry was, and the
scanned decode reads the stacks with no restacking. Updates are in place.
Quantization per (token, head), ``quantized``:
- "int8" (or True): symmetric int8, scale = absmax * (1/127) rounded to
  bf16 before the codes are taken (ops/attention.quant_rows);
- "int4": symmetric 4-bit codes + 8 in [1, 15], two a byte along head_dim
  (even lane in the low nibble): k, v (L, B, S, n_kv, hd/2) uint8 with f32
  scales absmax * (1/7). The reference's callers run ``absmax / 7.0``
  under jit, where XLA makes it that multiply. No kernel reads this mode:
  as in the reference, attention over it dequantizes the layer
  (``cache_read``) and runs the plain masked attention;
- False: k, v in the model's dtype with no scales (None).

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

INV_7 = 1.0 / 7.0  # the int4 scale's f32 multiply, as XLA runs /7 in jit


@dataclass
class KVCache:
    k: torch.Tensor  # (L, B, S, n_kv, hd) int8, (.., hd/2) uint8 or float
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, B, S, n_kv) f32, None when not quantized
    v_scale: torch.Tensor
    length: torch.Tensor  # (B,) int32 rows filled per sequence
    quantized: object = "int8"  # "int8", "int4" or False

    def clone(self):
        """A copy with its own tensors (caches are updated in place)."""
        return KVCache(*(None if t is None else t.clone() for t in (
            self.k, self.v, self.k_scale, self.v_scale, self.length)),
            self.quantized)


def init_kv_cache(cfg, batch, max_len=None, quantized=True, *, device=None):
    """Zeroed cache of ``max_len`` (default cfg.max_seq_len) rows on
    ``device`` (the card unless the caller names another): quantized
    True/"int8" (int8 codes, f32 scales), "int4" (uint8 code pairs along
    head_dim, f32 scales) or False (the model's dtype, cfg.torch_dtype).
    The positional order is the reference's."""
    device = resolve_device(device)
    S = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    if quantized is True:
        quantized = "int8"
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if quantized is False:
        return KVCache(
            torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            None, None, length, False)
    if quantized == "int4":
        if cfg.head_dim % 2:
            raise ValueError("int4 KV cache needs an even head_dim")
        code_shape, dtype = shape[:4] + (cfg.head_dim // 2,), torch.uint8
    elif quantized == "int8":
        code_shape, dtype = shape, torch.int8
    else:
        raise ValueError("KV cache mode {!r} is not one of True, 'int8', "
                         "'int4', False".format(quantized))
    return KVCache(
        torch.zeros(code_shape, dtype=dtype, device=device),
        torch.zeros(code_shape, dtype=dtype, device=device),
        torch.zeros(shape[:4], dtype=torch.float32, device=device),
        torch.zeros(shape[:4], dtype=torch.float32, device=device),
        length, quantized)


def _quant_heads(x, mode="int8"):
    """(B, S, H, hd) -> codes + (B, S, H) f32 scales (kv_cache.py:65-82).
    int8: int8 codes against bf16-rounded scales. int4: symmetric codes
    clip(round(x / s), -7, 7) + 8, s = max(absmax, 1e-8) * (1/7), packed
    two a byte (even lane low) into (B, S, H, hd/2) uint8."""
    x = x.to(torch.float32)
    if mode != "int4":
        return quant_rows(x)
    scale = torch.clamp_min(x.abs().amax(dim=-1), 1e-8) * INV_7
    q = (torch.clamp(torch.round(x / scale[..., None]), -7, 7)
         + 8).to(torch.uint8)
    return q[..., 0::2] | (q[..., 1::2] << 4), scale


def _dequant_heads(q, scale, dtype, mode="int8"):
    """Codes and scales -> (B, S, H, hd) in ``dtype`` (kv_cache.py:85-94)."""
    if mode == "int4":
        lo = (q & 0xF).to(torch.int32) - 8
        hi = (q >> 4).to(torch.int32) - 8
        q = torch.stack([lo, hi], dim=-1).reshape(q.shape[:-1] + (-1,))
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
    kq, ks = _quant_heads(k_new, cache.quantized)
    vq, vs = _quant_heads(v_new, cache.quantized)
    cache.k[li][bidx, rows] = kq
    cache.v[li][bidx, rows] = vq
    cache.k_scale[li][bidx, rows] = ks
    cache.v_scale[li][bidx, rows] = vs
    return (cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li])


def cache_read(cache, layer_idx, dtype):
    """Full dequantized K, V for a layer: (B, S, n_kv, hd) in ``dtype``."""
    if not cache.quantized:
        return cache.k[layer_idx].to(dtype), cache.v[layer_idx].to(dtype)
    mode = cache.quantized
    return (
        _dequant_heads(cache.k[layer_idx], cache.k_scale[layer_idx], dtype,
                       mode),
        _dequant_heads(cache.v[layer_idx], cache.v_scale[layer_idx], dtype,
                       mode),
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

    @property
    def n_blocks(self):
        return self.k.shape[1]


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
                     n_rows, offset=0):
    """Write ``n_rows`` rows of one slot IN PLACE from logical row
    ``offset`` on (kv_cache.py:205-232): row i of rows_* lands at logical
    row offset + i, pool[slot_blocks[(offset + i) // block], (offset + i)
    % block]; rows past n_rows are not written. As the reference, a
    logical block past the table takes the table's last entry.

    slot_blocks (max_chunks,) int; rows_k/v (L, >= n_rows, n_kv, hd) int8;
    rows_ks/vs (L, >= n_rows, n_kv) f32. Returns pcache."""
    dev = pcache.k.device
    n_rows, offset = int(n_rows), int(offset)
    logical = offset + torch.arange(n_rows, device=dev)
    chunk = torch.clamp(logical // pcache.block, max=slot_blocks.shape[0] - 1)
    blk = slot_blocks.to(dev, torch.long)[chunk]
    row = logical % pcache.block
    pcache.k[:, blk, row] = rows_k[:, :n_rows]
    pcache.v[:, blk, row] = rows_v[:, :n_rows]
    pcache.k_scale[:, blk, row] = rows_ks[:, :n_rows]
    pcache.v_scale[:, blk, row] = rows_vs[:, :n_rows]
    return pcache
