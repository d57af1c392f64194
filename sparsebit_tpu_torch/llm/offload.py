"""Host-offload weight streaming: models larger than the card's memory on
one card (port of ``sparsebit_tpu/llm/offload.py``: ``offload_llama_params``,
``_layer_step`` and ``StreamingLlama``).

The reference (single_device_mode of the original system) prefetches the
next decoder layer's packed weights host -> device on side streams while
the current layer computes. The JAX package gets the overlap from
``jax.device_put`` being asynchronous; here it is explicit:

- ``offload_llama_params`` moves every decoder layer to **pinned** host
  memory (page-locked, so a copy from it is a DMA the host need not wait
  for); embedding, final norm and head stay where they are;
- ``StreamingLlama`` copies each layer ``prefetch`` layers ahead of the
  compute stream, with ``non_blocking=True`` copies on a copy stream of
  its own, bracketed by two CUDA events;
- a layer's device buffers are allocated on the compute stream, so the
  caching allocator recycles them in compute order and from the one pool
  the rest of the program uses (buffers allocated on the copy stream
  would sit in a pool of their own, which memory cached by the compute
  stream cannot serve). The copy stream first waits for the work queued
  on the compute stream so far, since a recycled block may still be
  read by it; the compute stream waits for the copies' event before the
  layer runs, so no buffer is freed while a copy into it is in flight;
- the host tensors live as long as the StreamingLlama (it holds the
  offloaded layers), so no copy outlives its source;
- the KV cache, the embedding, the final norm and the head stay resident.

At most ``prefetch`` + 1 layers are on the card at once. With
``device="cpu"`` nothing is pinned and no stream is made: the layers are
read in place, which the CPU tests use. As in the reference, a layer
attends with the plain masked attention over its dequantized cache
(llama.attention_scores); its linears run their own kernels
(QuantLinear's impl).
"""

import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.convert import map_params
from sparsebit_tpu_torch.llm.decode import _prompt_mask
from sparsebit_tpu_torch.llm.kv_cache import cache_read, cache_update


def offload_llama_params(params, *, device=None):
    """Params whose decoder layers live in host memory, pinned when they
    are to be streamed to a CUDA ``device`` (the card unless the caller
    names another); embedding, norm and head are left as they are (they
    are needed every token and are comparatively small)."""
    pin = resolve_device(device).type == "cuda"

    def host(t):
        t = t.detach().to("cpu")
        return t.pin_memory() if pin else t

    out = dict(params)
    out["layers"] = [map_params(host, layer) for layer in params["layers"]]
    return out


def _layer_step(layer, x, rope_mask, cache, li, positions, cfg):
    """One decoder layer against layer ``li`` of the cache (offload.py:
    38-78): the new K/V rows are written in the cache's mode (in place),
    the layer's cache dequantized and attended under ``mask``. rope_mask =
    (inv_freq, mask). Returns x after the layer."""
    inv_freq, mask = rope_mask
    h = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    B, S, _ = x.shape
    q, k, v = L.qkv_proj(layer, h, cfg)
    q = L.apply_rope(q, positions, inv_freq)
    k = L.apply_rope(k, positions, inv_freq)
    cache_update(cache, li, k, v, positions[:, 0])
    k_all, v_all = cache_read(cache, li, x.dtype)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = L.attention_scores(
        q, L.repeat_kv(k_all, n_rep), L.repeat_kv(v_all, n_rep), mask
    ).reshape(B, S, cfg.n_heads * cfg.head_dim)
    x = x + layer["wo"](out)
    return x + L._ffn_block(
        layer, L.rms_norm(x, layer["ffn_norm"], cfg.rms_eps))


class StreamingLlama:
    """Prefill and decode with layer-wise weight streaming (offload.py:
    81-156). ``params_host`` from offload_llama_params; the resident part
    is moved to ``device`` (the card unless the caller names another)."""

    def __init__(self, params_host, cfg, prefetch=2, *, device=None):
        self.dev = resolve_device(device)
        self.cfg = cfg
        self.layers_host = params_host["layers"]
        self.resident = {k: map_params(lambda t: t.to(self.dev), v)
                         for k, v in params_host.items() if k != "layers"}
        self.prefetch = max(1, prefetch)
        self.inv_freq = L.rope_frequencies(cfg, device=self.dev)
        self.copy_stream = (torch.cuda.Stream(self.dev)
                            if self.dev.type == "cuda" else None)

    def _fetch(self, i):
        """Start layer i's copies to the device. Returns (layer, the events
        that open and close its copies on the copy stream; None off
        CUDA)."""
        host = self.layers_host[i]
        if self.copy_stream is None:
            return map_params(lambda t: t.to(self.dev), host), None, None
        pairs = []

        def alloc(t):
            d = torch.empty_like(t, device=self.dev)
            pairs.append((d, t))
            return d

        layer = map_params(alloc, host)
        queued = torch.cuda.Event()
        queued.record(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(queued)
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.copy_stream)
            for d, t in pairs:
                d.copy_(t, non_blocking=True)
            done = torch.cuda.Event(enable_timing=True)
            done.record(self.copy_stream)
        return layer, start, done

    def _run_layers(self, x, positions, mask, cache):
        n = len(self.layers_host)
        buf = {i: self._fetch(i) for i in range(min(self.prefetch, n))}
        for i in range(n):
            nxt = i + self.prefetch
            if nxt < n:
                buf[nxt] = self._fetch(nxt)  # async H2D, overlaps compute
            layer, _, done = buf.pop(i)
            if done is not None:
                torch.cuda.current_stream(self.dev).wait_event(done)
            x = _layer_step(layer, x, (self.inv_freq, mask), cache, i,
                            positions, self.cfg)
            del layer
        return x, cache

    def _refuse_int4(self, cache):
        if cache.quantized == "int4":
            raise ValueError(
                "StreamingLlama supports bf16/int8 caches (int4 pending)")

    def prefill(self, tokens, cache):
        """tokens (B, S) fill rows [0, S). Returns (last logits (B, V)
        f32, cache)."""
        self._refuse_int4(cache)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
        mask = _prompt_mask(S, cache.k.shape[2], tokens.device)
        x = self.resident["tok_embed"][tokens.long()]
        x, cache = self._run_layers(x, positions, mask, cache)
        x = L.rms_norm(x, self.resident["norm"], self.cfg.rms_eps)
        logits = self.resident["lm_head"](x).to(torch.float32)
        cache.length = (cache.length + S).to(torch.int32)
        return logits[:, -1], cache

    def decode_step(self, tokens, cache):
        """tokens (B,) at rows cache.length. Returns (logits (B, V) f32,
        cache)."""
        self._refuse_int4(cache)
        S_max = cache.k.shape[2]
        positions = cache.length[:, None]
        valid = torch.arange(S_max, dtype=torch.int32,
                             device=tokens.device)[None, :] <= positions
        mask = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, None]
        x = self.resident["tok_embed"][tokens[:, None].long()]
        x, cache = self._run_layers(x, positions, mask, cache)
        x = L.rms_norm(x, self.resident["norm"], self.cfg.rms_eps)
        logits = self.resident["lm_head"](x).to(torch.float32)
        cache.length = (cache.length + 1).to(torch.int32)
        return logits[:, 0], cache
