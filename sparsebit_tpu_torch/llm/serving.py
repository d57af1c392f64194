"""Continuous-batching decode engine (port of the fixed-slot
``DecodeEngine`` of ``sparsebit_tpu/llm/serving.py:164-542``).

- one fixed (max_batch, max_len) INT8 KV cache, layer-stacked;
- admission: queued prompts grouped per length bucket and prefilled in one
  batched forward (decode.prefill_at) into a reused bucket-sized scratch
  cache, logits taken at each row's last real token, rows then copied into
  the slots;
- exact-prefix cache: admitted prompts' K/V rows are kept (LRU) and a
  prompt that extends a cached one prefills only its tail;
- decode runs in chunks of ``chunk`` tokens through
  decode.decode_chunk_scanned (K1, K2 and K3 per layer);
- slots free on EOS or max-tokens; chunk tokens past a request's budget
  are dropped.

``DecodeEngine(..., device=None)`` runs on CUDA and raises without it;
pass ``device="cpu"`` for the CPU (the kernels' plain versions). Params
must already live on that device (llm.convert.params_from_numpy).
Sampling draws from the engine's own seeded ``torch.Generator``.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm.decode import (
    decode_chunk_scanned,
    prefill_at,
    sample_logits_vec,
    stack_layers,
)
from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
from sparsebit_tpu_torch.llm.llama import quantize_llama_params
from sparsebit_tpu_torch.llm.quant import QuantLinear


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    generated: list = field(default_factory=list)
    done: bool = False


def _bucket(n, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048)):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _serving_layout(lin):
    """Serving container for one QuantLinear: signed row pairs (2/3-bit
    codes ride s4 nibbles, re-tagged bits=4) with bf16 qparams."""
    return lin.with_nibble_serving().with_sz_dtype(torch.bfloat16)


class DecodeEngine:
    def __init__(self, params, cfg, max_batch=8, max_len=None, eos_id=None,
                 seed=0, chunk=8, prefix_cache_size=8, device=None):
        self.device = resolve_device(device)
        if params["tok_embed"].device.type != self.device.type:
            raise ValueError("params live on {}, engine device is {}".format(
                params["tok_embed"].device, self.device))
        self.cfg = cfg
        self.params = quantize_llama_params(
            params,
            lambda path, lin: (_serving_layout(lin)
                               if isinstance(lin, QuantLinear) else lin),
            skip=(),
        )
        self.params_stacked = stack_layers(self.params)
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq_len
        self.eos_id = eos_id
        self.chunk = chunk
        self.cache = self._init_cache(max_batch, self.max_len)
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
        self._prefix = {}
        self.prefix_hits = 0

    def _init_cache(self, n_rows, n_cols):
        return init_kv_cache(self.cfg, n_rows, n_cols, device=self.device)

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
        self._prefix[key] = {
            "len": total_len,
            "k": scratch.k[:, row, :n].clone(),
            "v": scratch.v[:, row, :n].clone(),
            "k_scale": scratch.k_scale[:, row, :n].clone(),
            "v_scale": scratch.v_scale[:, row, :n].clone(),
        }
        while len(self._prefix) > self._prefix_cache_size:
            self._prefix.pop(next(iter(self._prefix)))

    def _seed_rows(self, scratch, entry, row):
        n = min(entry["k"].shape[1], scratch.k.shape[2])
        scratch.k[:, row, :n] = entry["k"][:, :n]
        scratch.v[:, row, :n] = entry["v"][:, :n]
        scratch.k_scale[:, row, :n] = entry["k_scale"][:, :n]
        scratch.v_scale[:, row, :n] = entry["v_scale"][:, :n]

    def _splice_group(self, scratch, slots, rows, lengths):
        """Copy the admitted scratch rows [0, min(S_scratch, S_max)) into
        the slots; rows past each admit's length are dead (masked)."""
        n = min(scratch.k.shape[2], self.cache.k.shape[2])
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        rw = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        c = self.cache
        c.k[:, sl, :n] = scratch.k[:, rw, :n]
        c.v[:, sl, :n] = scratch.v[:, rw, :n]
        c.k_scale[:, sl, :n] = scratch.k_scale[:, rw, :n]
        c.v_scale[:, sl, :n] = scratch.v_scale[:, rw, :n]
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
        logits, scratch = prefill_at(
            self.params, torch.as_tensor(padded, device=dev).long(), scratch,
            self.cfg, torch.as_tensor(lasts, dtype=torch.int32, device=dev),
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
            groups.setdefault((Sb, S_scratch), []).append((slot, req, pkey))
        for (Sb, S_scratch), admits in groups.items():
            self._admit_group(admits, Sb, S_scratch)
            for slot, req, _ in admits:
                emitted.setdefault(req.rid, []).append(req.generated[-1])
                self._maybe_finish(slot)
        return emitted

    def step(self):
        """Admit queued prompts, then run ONE decode chunk for all slots.
        Returns {rid: [new tokens]}."""
        emitted = self._admit_all()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return emitted
        lengths = self.cache.length.cpu().numpy()
        headroom = min(self.max_len - int(lengths[i]) for i in active)
        n = max(1, min(self.chunk, headroom))
        # idle slots decode too (their tokens are dropped); restart them at
        # row 0 so their dead rows never run past the cache (the reference
        # lets them grow without bound)
        idle = [i for i, s in enumerate(self.slots) if s is None]
        if idle:
            self.cache.length[idle] = 0
        temps = torch.as_tensor(
            [s.temperature if s is not None else 0.0 for s in self.slots],
            dtype=torch.float32, device=self.device)
        toks, self.cache = decode_chunk_scanned(
            self.params_stacked, self.next_tok, self.cache, temps, self._gen,
            self.cfg, n)
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

    def _maybe_finish(self, slot):
        req = self.slots[slot]
        if req is None:
            return
        hit_eos = (self.eos_id is not None and bool(req.generated)
                   and req.generated[-1] == self.eos_id)
        hit_len = len(req.generated) >= req.max_new_tokens
        full = int(self.cache.length[slot]) + 1 >= self.max_len
        if hit_eos or hit_len or full:
            req.done = True
            self.slots[slot] = None
