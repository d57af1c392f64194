"""Continuous-batching decode engines (port of
``sparsebit_tpu/llm/serving.py``: the fixed-slot ``DecodeEngine``
(serving.py:164-542), the tensor-sharded ``TPDecodeEngine`` (:545-632)
and the paged ``PagedDecodeEngine`` (:634-918)).

``DecodeEngine``:
- one fixed (max_batch, max_len) KV cache, layer-stacked: int8, int4
  (``kv_quantized="int4"``) or the model's float dtype
  (``kv_quantized=False``);
- admission: queued prompts grouped per length bucket and prefilled in one
  batched forward (decode.prefill_at) into a reused bucket-sized scratch
  cache, logits taken at each row's last real token, rows then copied into
  the slots;
- exact-prefix cache: admitted prompts' K/V rows are kept (LRU) and a
  prompt that extends a cached one prefills only its tail;
- decode runs in chunks of ``chunk`` tokens. As in the reference, a model
  that the decode megakernel takes (``_stacked_chunks``) decodes each
  token as one K4 launch over a static context bucket
  (``_context_bucket``, decode.decode_chunk_scanned); any other model
  takes decode.decode_chunk over the per-layer params (K1 for the nibble
  layers, K6 for 8-bit ones, K5 for the attention), as serving.py:308-321;
- slots free on EOS or max-tokens; chunk tokens past a request's budget
  are dropped.

``PagedDecodeEngine`` keeps the same admission and scheduling, over one
pool of KV blocks shared by all slots: a block allocator with refcounts,
full prefix blocks shared between requests, a reserved trash block for
idle slots, and every decode token as one K4 launch through the block
table (decode.decode_chunk_paged).

``TPDecodeEngine`` runs DecodeEngine's host logic on every rank of a
tensor-parallel group over the rank's weight and KV-head shards
(parallel/tp.py).

All three take the reference's positional parameters, then the keyword-only
``device=None`` (CUDA, raising without it) or ``device="cpu"`` (the
kernels' plain versions). ``DecodeEngine``'s ``kv_quantized`` picks the
slot cache: True/"int8"; "int4", packed code pairs with f32 scales; or
False for the model's float dtype. K4 reads int8 only, so an int4 or a
float slot cache decodes on decode_chunk: the linears on K1/K6, the
attention over a float cache on K5 and over an int4 cache by the plain
masked attention over the dequantized layer (the reference's XLA path).
Prefix entries keep the scales with the codes (serving.py:199-293, 392). Both take ``head_bits`` (serving.py:281-289): a
dense lm_head quantized per channel, symmetric, by round to nearest
(QuantLinear.from_dense, bf16 qparams; 8 bits halve its stream and take
K8 at decode). Params must already live on that device
(llm.convert.params_from_numpy). Sampling draws from the engine's own
seeded ``torch.Generator``.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm.decode import (
    _layer_kernel_ok,
    _scan_uses_layer_kernel,
    decode_chunk,
    decode_chunk_paged,
    decode_chunk_scanned,
    prefill_at,
    prefill_cold_scanned,
    sample_logits_vec,
    stack_layers,
)
from sparsebit_tpu_torch.llm.kv_cache import (
    init_kv_cache,
    init_paged_kv_cache,
    paged_write_rows,
)
from sparsebit_tpu_torch.llm.llama import quantize_llama_params
from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear
from sparsebit_tpu_torch.parallel.tp import (
    shard_kv_cache_tp,
    shard_llama_params_tp_packed,
    tp_decode_chunk,
    tp_group,
    tp_prefill_at,
)


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    generated: list = field(default_factory=list)
    done: bool = False


_KV_FIELDS = ("k", "v", "k_scale", "v_scale")  # scales None: a float cache


def _bucket(n, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048)):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _serving_layout(lin):
    """Serving container for one QuantLinear (serving.py:164-189): signed
    row pairs for bits <= 4 (2/3-bit codes ride s4 nibbles, re-tagged
    bits=4), the ``"w"`` planes kept at 8 bits, bf16 qparams, impl "a8"."""
    if lin.bits in (2, 3, 4):
        lin = lin.with_nibble_serving()
    return lin.with_sz_dtype(torch.bfloat16)._replace(impl="a8")


class DecodeEngine:
    def __init__(self, params, cfg, max_batch=8, max_len=None,
                 kv_quantized=True, eos_id=None, seed=0, chunk=8,
                 prefix_cache_size=8, head_bits=None, *, device=None):
        self.device = resolve_device(device)
        if params["tok_embed"].device.type != self.device.type:
            raise ValueError("params live on {}, engine device is {}".format(
                params["tok_embed"].device, self.device))
        self.cfg = cfg
        self.params = self._prepare_params(params, head_bits)
        # layers K4 can take are stacked for it; a model it refuses may mix
        # containers across layers and is served per layer
        self.params_stacked = None
        if all(_layer_kernel_ok(lyr, cfg, max_batch)
               for lyr in self.params["layers"]):
            self.params_stacked = stack_layers(self.params)
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq_len
        self.kv_quantized = kv_quantized
        self.eos_id = eos_id
        self.chunk = chunk
        self.cache = (None if getattr(self, "_skip_slot_cache", False)
                      else self._init_cache(max_batch, self.max_len))
        # decode chunks on the megakernel (one K4 launch per token) when
        # the model is one it takes: the reference's dispatch
        # (serving.py:239-251), without its device check
        self._stacked_chunks = (
            self.params_stacked is not None
            and kv_quantized in (True, "int8") and _scan_uses_layer_kernel(
                1, self.params_stacked["layers"], "int8", cfg, max_batch))
        self.slots = [None] * max_batch  # _Request or None
        self.queue = []
        self.next_tok = torch.zeros((max_batch,), dtype=torch.int32,
                                    device=self.device)
        self._rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._scratch = {}  # (n_rows, n_cols) -> KVCache reused by admits
        # prompt tuple -> {"len", "k", "v", "k_scale", "v_scale"}, stacked
        # (L, S_entry, ...) rows; insertion-ordered dict as LRU
        self._prefix_cache_size = prefix_cache_size
        self._pinned = set()  # prefix keys hit by the admission under way
        self._prefix = {}
        self.prefix_hits = 0

    # ---- backend hooks (overridden by TPDecodeEngine) -----------------------
    def _prepare_params(self, params, head_bits):
        """The serving layout of every QuantLinear (_serving_layout) and,
        with ``head_bits``, a dense lm_head quantized per channel."""
        out = quantize_llama_params(
            params,
            lambda path, lin: (_serving_layout(lin)
                               if isinstance(lin, QuantLinear) else lin),
            skip=(),
        )
        head = out["lm_head"]
        if head_bits is not None and isinstance(head, DenseLinear):
            out["lm_head"] = QuantLinear.from_dense(
                head.w.to(torch.float32), bits=head_bits, groupsize=-1,
                sym=True, bias=head.bias).with_sz_dtype()
        return out

    def _init_cache(self, n_rows, n_cols):
        return init_kv_cache(self.cfg, n_rows, n_cols, self.kv_quantized,
                             device=self.device)

    def _prefill_call(self, tokens, scratch, lasts, offsets):
        return prefill_at(self.params, tokens, scratch, self.cfg, lasts,
                          offsets)

    def _context_bucket(self, lengths_active, n, chunk_rows=128):
        """Static attention-row bucket of a decode chunk of n tokens: it
        covers every active slot's rows through the chunk, in multiples of
        chunk_rows. The cap is max_len rounded UP to chunk_rows (the
        reference caps at the raw max_len, fault R1); the kernel wrapper
        clamps it to the cache."""
        need = (max(lengths_active) if lengths_active else 0) + n
        cap = -(-self.max_len // chunk_rows) * chunk_rows
        return int(min(cap, -(-need // chunk_rows) * chunk_rows))

    def _decode_chunk_call(self, temps, n):
        if not self._stacked_chunks:
            return decode_chunk(self.params, self.next_tok, self.cache, temps,
                                self._gen, self.cfg, n)
        lengths = self.cache.length.cpu().numpy()
        act = [int(lengths[i]) for i, s in enumerate(self.slots)
               if s is not None]
        return decode_chunk_scanned(
            self.params_stacked, self.next_tok, self.cache, temps,
            self._gen, self.cfg, n, s_active=self._context_bucket(act, n))

    # ---- client API --------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens=64, temperature=0.0):
        self._rid += 1
        self.queue.append(_Request(self._rid,
                                   np.asarray(prompt_ids, np.int32),
                                   max_new_tokens, temperature))
        return self._rid

    @property
    def has_work(self):
        return bool(self.queue) or any(s is not None for s in self.slots)

    def run(self):
        """Drain everything; returns {rid: [tokens...]}."""
        results = {}
        while self.has_work:
            for rid, toks in self.step().items():
                results.setdefault(rid, []).extend(toks)
        return results

    # ---- engine internals --------------------------------------------------
    def _free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    def _get_scratch(self, n_rows, n_cols):
        """Reused scratch cache (stale rows are masked by length)."""
        s = self._scratch.pop((n_rows, n_cols), None)
        return s if s is not None else self._init_cache(n_rows, n_cols)

    def _prefix_hit(self, prompt):
        """Longest cached prompt that is a strict prefix of ``prompt``."""
        best = None
        for key in self._prefix:
            P = len(key)
            if P < len(prompt) and tuple(prompt[:P].tolist()) == key:
                if best is None or P > len(best):
                    best = key
        return best

    def _prefix_store(self, prompt, scratch, row, total_len):
        """Keep one admitted row's K/V (trimmed to the prompt's bucket)."""
        if self._prefix_cache_size <= 0:
            return
        key = tuple(prompt.tolist())
        self._prefix.pop(key, None)  # refresh the LRU position
        n = min(_bucket(total_len), scratch.k.shape[2])
        self._prefix[key] = {"len": total_len}
        for name in _KV_FIELDS:
            t = getattr(scratch, name)
            self._prefix[key][name] = (None if t is None
                                       else t[:, row, :n].clone())
        while len(self._prefix) > self._prefix_cache_size:
            key = self._oldest_unpinned()
            if key is None:
                break
            self._prefix.pop(key)

    def _seed_rows(self, scratch, entry, row):
        n = min(entry["k"].shape[1], scratch.k.shape[2])
        for name in _KV_FIELDS:
            if entry[name] is not None:
                getattr(scratch, name)[:, row, :n] = entry[name][:, :n]

    def _splice_group(self, scratch, slots, rows, lengths):
        """Copy the admitted scratch rows [0, min(S_scratch, S_max)) into
        the slots; rows past each admit's length are dead (masked)."""
        n = min(scratch.k.shape[2], self.cache.k.shape[2])
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        rw = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        c = self.cache
        for name in _KV_FIELDS:
            dst = getattr(c, name)
            if dst is not None:
                dst[:, sl, :n] = getattr(scratch, name)[:, rw, :n]
        c.length[sl] = torch.as_tensor(lengths, dtype=torch.int32,
                                       device=self.device)

    def _admit_shapes(self, prompt_len, P):
        """(tail_bucket, scratch_len) for a prompt with P cached rows; the
        scratch holds offset + tail_bucket rows so the tail never clamps
        onto the prefix."""
        Sb = _bucket(prompt_len - P)
        return Sb, _bucket(P + Sb)

    def _admit_group(self, admits, Sb, S_scratch):
        """One batched prefill for [(slot, req, prefix_key|None), ...]."""
        n = len(admits)
        tails, offsets, lasts = [], [], []
        for _, req, pkey in admits:
            P = len(pkey) if pkey else 0
            tails.append(req.prompt[P:])
            offsets.append(P)
            lasts.append(len(req.prompt) - P - 1)
        scratch = self._get_scratch(n, S_scratch)
        for row, (_, _, pkey) in enumerate(admits):
            if pkey:
                entry = self._prefix.pop(pkey)
                self._prefix[pkey] = entry  # LRU refresh
                self._seed_rows(scratch, entry, row)
        padded = np.zeros((n, Sb), np.int32)
        for row, t in enumerate(tails):
            padded[row, : len(t)] = t
        dev = self.device
        logits, scratch = self._prefill_call(
            torch.as_tensor(padded, device=dev).long(), scratch,
            torch.as_tensor(lasts, dtype=torch.int32, device=dev),
            torch.as_tensor(offsets, dtype=torch.int32, device=dev))
        self._scratch[(n, S_scratch)] = scratch  # keep warm for reuse
        temps = torch.as_tensor([r.temperature for _, r, _ in admits],
                                dtype=torch.float32, device=dev)
        first = sample_logits_vec(logits, temps, self._gen).cpu().numpy()
        slots_g, rows_g, lens_g = [], [], []
        for row, (slot, req, _) in enumerate(admits):
            total_len = offsets[row] + len(tails[row])
            slots_g.append(slot)
            rows_g.append(row)
            lens_g.append(total_len)
            self._prefix_store(req.prompt, scratch, row, total_len)
            self.slots[slot] = req
            self.next_tok[slot] = int(first[row])
            req.generated.append(int(first[row]))
        self._splice_group(scratch, slots_g, rows_g, lens_g)

    def _oldest_unpinned(self):
        """The least recently used prefix entry that no admission of the
        current round has hit, or None. An admission round resolves every
        hit before its first group stores new entries; evicting a hit
        entry meanwhile would lose it (the reference then fails with a
        KeyError, fault R6)."""
        return next((k for k in self._prefix if k not in self._pinned),
                    None)

    def _admit_all(self):
        """Admit as many queued prompts as there are free slots, grouped
        into batched prefills by (tail bucket, scratch length)."""
        emitted = {}
        free = self._free_slots()
        taking = []
        while self.queue and free:
            taking.append((free.pop(0), self.queue.pop(0)))
        groups = {}
        for slot, req in taking:
            pkey = self._prefix_hit(req.prompt)
            P = len(pkey) if pkey else 0
            Sb, S_scratch = self._admit_shapes(len(req.prompt), P)
            if pkey and S_scratch > self.max_len:
                pkey, P = None, 0  # reuse would overflow: admit cold
                Sb, S_scratch = self._admit_shapes(len(req.prompt), 0)
            if pkey:
                self.prefix_hits += 1
                self._pinned.add(pkey)
            groups.setdefault((Sb, S_scratch), []).append((slot, req, pkey))
        try:
            for (Sb, S_scratch), admits in groups.items():
                self._admit_group(admits, Sb, S_scratch)
                for slot, req, _ in admits:
                    emitted.setdefault(req.rid, []).append(
                        req.generated[-1])
                    self._maybe_finish(slot)
        finally:
            self._pinned.clear()
        return emitted

    def _slot_len(self, slot):
        return int(self.cache.length[slot])

    def step(self):
        """Admit queued prompts, then run ONE decode chunk for all slots.
        Returns {rid: [new tokens]}."""
        emitted = self._admit_all()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return emitted
        headroom = min(self.max_len - self._slot_len(i) for i in active)
        n = max(1, min(self.chunk, headroom))
        temps = torch.as_tensor(
            [s.temperature if s is not None else 0.0 for s in self.slots],
            dtype=torch.float32, device=self.device)
        toks = self._decode_chunk(temps, n)
        toks_np = toks.cpu().numpy()
        self.next_tok = toks[:, -1].contiguous()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            want = req.max_new_tokens - len(req.generated)
            take = toks_np[slot, : max(0, min(n, want))].tolist()
            if self.eos_id is not None and self.eos_id in take:
                take = take[: take.index(self.eos_id) + 1]
            req.generated.extend(take)
            emitted.setdefault(req.rid, []).extend(take)
            self._maybe_finish(slot)
        return emitted

    def _decode_chunk(self, temps, n):
        """One chunk for all slots; returns its tokens (B, n). Idle slots
        decode too (their tokens are dropped); they restart at row 0 so
        their dead rows never run past the cache (the reference lets them
        grow without bound, fault R4)."""
        idle = [i for i, s in enumerate(self.slots) if s is None]
        if idle:
            self.cache.length[idle] = 0
        toks, self.cache = self._decode_chunk_call(temps, n)
        return toks

    def _finished(self, slot):
        req = self.slots[slot]
        hit_eos = (self.eos_id is not None and bool(req.generated)
                   and req.generated[-1] == self.eos_id)
        hit_len = len(req.generated) >= req.max_new_tokens
        full = self._slot_len(slot) + 1 >= self.max_len
        return hit_eos or hit_len or full

    def _maybe_finish(self, slot):
        if self.slots[slot] is not None and self._finished(slot):
            self.slots[slot].done = True
            self.slots[slot] = None


class TPDecodeEngine(DecodeEngine):
    """Tensor-sharded continuous batching (serving.py:545-632; the
    reference's "LLaMA-13B INT4-g128 + INT8 KV-cache, tensor-sharded
    continuous batching" configuration): DecodeEngine's admission,
    prefix-cache and scheduling host logic, run by every rank of the
    mesh's "tp" axis in lockstep on the same requests, over

    - weights: the rank's Megatron column/row shards of the PACKED
      QuantLinears, split exactly (parallel/tp.shard_quantlinear: codes
      sliced, never requantized), each shard in the serving layout, so
      each linear is the one-device W4A8 matmul (K1) on its shard; a
      ``head_bits`` head is quantized before it is sharded;
    - KV cache and admission scratches: the rank's heads
      (parallel/tp.shard_kv_cache_tp);
    - admission: parallel/tp.tp_prefill_at (the vocab-sharded lm_head
      gathered at each row's last token);
    - decode: parallel/tp.tp_decode_chunk, two all_reduces a layer and one
      all_gather of the logits a step; every rank samples the same tokens
      from its own generator, seeded alike.

    Layers are unfused, so the megakernel route (params_stacked,
    _stacked_chunks) stays off. ``mesh`` is a DeviceMesh with a "tp" axis;
    the params, the same on every rank, live on the engine's device
    (keyword ``device``, the card unless the caller names another), and
    the rank's shards are cut there. Needs n_heads, n_kv_heads and vocab
    divisible by T."""

    def __init__(self, params, cfg, mesh, **kw):
        self.mesh = mesh
        super().__init__(params, cfg, **kw)

    def _prepare_params(self, params, head_bits):
        _, self.T, self.rank = tp_group(self.mesh)
        head = params["lm_head"]
        if head_bits is not None and isinstance(head, DenseLinear):
            params = dict(params, lm_head=QuantLinear.from_dense(
                head.w.to(torch.float32), bits=head_bits, groupsize=-1,
                sym=True, bias=head.bias))
        return shard_llama_params_tp_packed(
            params, self.cfg, self.T, conv=_serving_layout, rank=self.rank)

    def _init_cache(self, n_rows, n_cols):
        return shard_kv_cache_tp(super()._init_cache(n_rows, n_cols),
                                 self.rank, self.T)

    def _prefill_call(self, tokens, scratch, lasts, offsets):
        return tp_prefill_at(self.params, tokens, scratch, self.cfg, lasts,
                             offsets, self.mesh)

    def _decode_chunk_call(self, temps, n):
        return tp_decode_chunk(self.params, self.next_tok, self.cache, temps,
                               self._gen, self.cfg, self.mesh, n)


class PagedDecodeEngine(DecodeEngine):
    """Block-table (paged) variant of the engine: one physical pool of
    ``n_blocks`` blocks of ``block`` rows shared by all slots.

    - short requests hold only the blocks they use;
    - identical prompt prefixes share their full blocks (refcounted; only
      the partial tail block is prefilled again);
    - every decode token is one K4 launch that reads and writes the pool
      through the block table (decode.decode_chunk_paged);
    - the last block is a trash target: idle slots decode inside the
      batch with tables that point only there, so their rows never land
      in a block a live request owns.

    Needs a model the decode megakernel takes (fused wqkv/w13 4-bit
    QuantLinears, one groupsize). Cold admissions prefill with
    decode.prefill_cold_scanned, prefix hits with decode.prefill_at."""

    def __init__(self, params, cfg, max_batch=8, n_blocks=None, block=128,
                 eos_id=None, seed=0, chunk=8, prefix_cache_size=8,
                 max_len=None, head_bits=None, *, device=None):
        max_len = max_len or cfg.max_seq_len
        if n_blocks is None:
            n_blocks = max_batch * (-(-max_len // block))
        self._skip_slot_cache = True  # the pool replaces the slot cache
        super().__init__(params, cfg, max_batch=max_batch, max_len=max_len,
                         eos_id=eos_id, seed=seed, chunk=chunk,
                         prefix_cache_size=prefix_cache_size, device=device,
                         head_bits=head_bits)
        if self.params_stacked is None:
            raise ValueError(
                "PagedDecodeEngine needs a model the decode megakernel "
                "takes: fused wqkv/w13 4-bit s4r QuantLinears with one "
                "groupsize (ops/layer_fused.fused_layer_supported)")
        self.block = block
        self.max_chunks = -(-max_len // block)
        self.pcache = init_paged_kv_cache(cfg, max_batch, n_blocks, block,
                                          self.max_chunks,
                                          device=self.device)
        self._trash = n_blocks - 1
        self._free = list(range(n_blocks - 1))
        self._ref = [0] * n_blocks
        self._slot_blocks = [[] for _ in range(max_batch)]
        self._bt = np.full((max_batch, self.max_chunks), self._trash,
                           np.int32)
        self._len = np.zeros((max_batch,), np.int64)

    def _slot_len(self, slot):
        return int(self._len[slot])

    # ---- allocator ---------------------------------------------------------
    def _alloc_block(self):
        key = None if self._free else self._oldest_unpinned()
        while key is not None:
            self._prefix_evict(key)  # oldest first
            key = None if self._free else self._oldest_unpinned()
        if not self._free:
            raise RuntimeError("KV block pool exhausted")
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def _release_block(self, bid):
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)

    def _prefix_evict(self, key):
        for bid in self._prefix.pop(key)["blocks"]:
            self._release_block(bid)

    def _ensure_blocks(self, slot, n_rows):
        """Grow ``slot``'s table to cover n_rows logical rows."""
        blocks = self._slot_blocks[slot]
        while len(blocks) * self.block < n_rows:
            bid = self._alloc_block()
            self._bt[slot, len(blocks)] = bid
            blocks.append(bid)

    # ---- prefix cache over blocks ------------------------------------------
    def _prefix_store(self, prompt, scratch_unused, slot, total_len):
        """Keep the slot's FULL prompt blocks, keyed by the block-truncated
        prompt (so len(key) is the reusable offset); a hit prefills the
        partial tail block again rather than copying it."""
        if self._prefix_cache_size <= 0:
            return
        n_full = min(total_len, len(prompt)) // self.block
        if n_full == 0:
            return
        key = tuple(prompt[: n_full * self.block].tolist())
        if key in self._prefix:
            # release the old entry's references (the reference pops it
            # without releasing them, so its blocks never free: fault R5)
            self._prefix_evict(key)
        blocks = self._slot_blocks[slot][:n_full]
        for bid in blocks:
            self._ref[bid] += 1
        self._prefix[key] = {"len": n_full * self.block, "blocks": blocks}
        while len(self._prefix) > self._prefix_cache_size:
            key = self._oldest_unpinned()
            if key is None:
                break
            self._prefix_evict(key)

    def _seed_from_pool(self, scratch, bids, row):
        """Copy the shared prefix blocks ``bids`` into rows [0, P) of
        scratch row ``row``, so the tail prefill attends to them."""
        pc, P = self.pcache, len(bids) * self.block
        idx = torch.as_tensor(bids, dtype=torch.long, device=self.device)
        for src, dst in ((pc.k, scratch.k), (pc.v, scratch.v),
                         (pc.k_scale, scratch.k_scale),
                         (pc.v_scale, scratch.v_scale)):
            dst[:, row, :P] = src[:, idx].reshape(
                (src.shape[0], P) + src.shape[3:])

    def _scatter_row(self, scratch, row, slot, total_len):
        """Write rows [0, total_len) of scratch row ``row`` into the
        slot's pool blocks."""
        paged_write_rows(
            self.pcache, torch.as_tensor(self._bt[slot]),
            scratch.k[:, row], scratch.v[:, row], scratch.k_scale[:, row],
            scratch.v_scale[:, row], total_len)

    # ---- admission ---------------------------------------------------------
    def _prefill_call(self, tokens, scratch, lasts, offsets):
        if not bool(offsets.any()):
            return prefill_cold_scanned(self.params_stacked, tokens, scratch,
                                        self.cfg, lasts)
        return prefill_at(self.params, tokens, scratch, self.cfg, lasts,
                          offsets)

    def _admit_group(self, admits, Sb, S_scratch):
        """Batched tail prefill into the contiguous scratch, then the new
        rows go to freshly allocated pool blocks; prefix hits share the
        cached full blocks and seed the scratch from them."""
        n = len(admits)
        tails, offsets, lasts = [], [], []
        for _, req, pkey in admits:
            P = self._prefix[pkey]["len"] if pkey else 0
            tails.append(req.prompt[P:])
            offsets.append(P)
            lasts.append(len(req.prompt) - P - 1)
        scratch = self._get_scratch(n, S_scratch)
        for row, (_, _, pkey) in enumerate(admits):
            if pkey:
                entry = self._prefix.pop(pkey)
                self._prefix[pkey] = entry  # LRU refresh
                self._seed_from_pool(scratch, entry["blocks"], row)
        padded = np.zeros((n, Sb), np.int32)
        for row, t in enumerate(tails):
            padded[row, : len(t)] = t
        dev = self.device
        logits, scratch = self._prefill_call(
            torch.as_tensor(padded, device=dev).long(), scratch,
            torch.as_tensor(lasts, dtype=torch.int32, device=dev),
            torch.as_tensor(offsets, dtype=torch.int32, device=dev))
        self._scratch[(n, S_scratch)] = scratch
        temps = torch.as_tensor([r.temperature for _, r, _ in admits],
                                dtype=torch.float32, device=dev)
        first = sample_logits_vec(logits, temps, self._gen).cpu().numpy()
        for row, (slot, req, pkey) in enumerate(admits):
            total_len = offsets[row] + len(tails[row])
            self._slot_blocks[slot] = []
            self._bt[slot, :] = self._trash
            if pkey:
                for ci, bid in enumerate(self._prefix[pkey]["blocks"]):
                    self._ref[bid] += 1
                    self._bt[slot, ci] = bid
                    self._slot_blocks[slot].append(bid)
            self._ensure_blocks(slot, total_len)
            self._scatter_row(scratch, row, slot, total_len)
            self._len[slot] = total_len
            self._prefix_store(req.prompt, None, slot, total_len)
            self.slots[slot] = req
            self.next_tok[slot] = int(first[row])
            req.generated.append(int(first[row]))

    # ---- decode ------------------------------------------------------------
    def _decode_chunk(self, temps, n):
        """Pre-extend the active tables by the chunk's rows, then one
        decode_chunk_paged call. Idle slots restart at row 0 of their
        all-trash tables."""
        act = [i for i, s in enumerate(self.slots) if s is not None]
        for i in act:
            self._ensure_blocks(i, int(self._len[i]) + n)
        dev = self.device
        self.pcache.block_table = torch.as_tensor(self._bt, device=dev)
        self.pcache.length = torch.as_tensor(self._len, dtype=torch.int32,
                                             device=dev)
        s_act = min(self.max_chunks * self.block, self._context_bucket(
            [int(self._len[i]) for i in act], n, chunk_rows=self.block))
        toks, self.pcache = decode_chunk_paged(
            self.params_stacked, self.next_tok, self.pcache, temps,
            self._gen, self.cfg, n, s_active=s_act)
        for i in act:
            self._len[i] += n
        return toks

    def _maybe_finish(self, slot):
        if self.slots[slot] is None or not self._finished(slot):
            return
        self.slots[slot].done = True
        self.slots[slot] = None
        for bid in self._slot_blocks[slot]:
            self._release_block(bid)
        self._slot_blocks[slot] = []
        self._bt[slot, :] = self._trash
        self._len[slot] = 0
