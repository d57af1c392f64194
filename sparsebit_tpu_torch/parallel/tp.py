"""Tensor parallelism for (quantized) LLaMA on torch.distributed (port of
``sparsebit_tpu/parallel/tp.py``: the sharding of linears, params and the
KV cache, the per-rank forward, decode and prefill bodies, and the public
``tp_*`` functions).

Megatron-style sharding, as the reference: wq/wk/wv, w1/w3 and lm_head
are column-parallel (each rank holds a contiguous block of output
columns, whole heads for attention), wo and w2 row-parallel (each rank's
product is a partial sum, added across ranks once per residual branch).
Quantized linears are split at pack time: a column split never cuts a
group, a row split lands on group boundaries ((K/T) % groupsize == 0 is
checked), so every rank's matmul is the one-device kernel (K1 for the
serving layout) on its own shard.

The programming model differs from the JAX package's. There one process
holds a mesh and ``shard_map`` runs the per-device body; here every rank
is a process that holds only its own shards and runs the per-rank body
itself, and the collectives are explicit: ``psum`` is
``dist.all_reduce``, ``all_gather(tiled=True)`` ``dist.all_gather`` and a
concatenation, ``pmax`` ``all_reduce(MAX)``. Each public function takes
the mesh (its "tp" and "dp" groups) where the reference takes its JAX
mesh. The sharding functions build the T shards on the params' device,
as the reference's stacked axis does; ``rank=`` builds one rank's alone,
the form the per-rank bodies run.
The serving bodies attend as the reference's do on a rank's heads: the
rows are committed to the cache (cache_update), the layer read back
dequantized (cache_read) and attended by the plain masked
``attention_scores``; no attention kernel runs on that route. The
full-sequence body (tp_llama_forward, tp_llama_loss and pp's tensor-
parallel stages) attends through ``llama.causal_attention``: K10, with
K11/K12 in its backward, on the card. Every collective is
differentiable (see the collectives section), so tp_llama_loss trains.
"""

import torch
import torch.distributed as dist

from sparsebit_tpu_torch.llm import decode as D
from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.kv_cache import KVCache, cache_read, cache_update
from sparsebit_tpu_torch.llm.qlora import LoraLinear
from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear
from sparsebit_tpu_torch.ops.packing import unpack_columns
from sparsebit_tpu_torch.parallel.mesh import dp_shard_batch


class TPLinear:
    """A linear's tensor-parallel shards: ``shards`` maps a tp rank to its
    DenseLinear / QuantLinear / LoraLinear shard (all T of them, or one
    when sharded with ``rank=``); ``kind`` is "col"
    (output columns split) or "row" (input rows split, summed across
    ranks after)."""

    def __init__(self, shards, kind, T):
        self.shards = shards
        self.kind = kind
        self.T = T

    def local(self):
        """The one shard this rank holds."""
        if len(self.shards) != 1:
            raise ValueError("TPLinear holds the shards of ranks {}: keep "
                             "one rank's with rank=".format(
                                 sorted(self.shards)))
        return next(iter(self.shards.values()))

    def map_shards(self, fn):
        """A TPLinear of fn(shard) for every shard held."""
        return TPLinear({t: fn(s) for t, s in self.shards.items()},
                        self.kind, self.T)


def _ranks(T, rank):
    return range(T) if rank is None else (rank,)


def shard_linear(lin, T, kind, bits=None, groupsize=-1, rank=None):
    """Split a DenseLinear (or a QuantLinear, dequantized) along columns
    or rows into T shards, each quantized and packed on its own when
    ``bits`` is set. A LoraLinear shards base and adapters together:
    column-parallel splits lora_B's columns (lora_A replicated),
    row-parallel lora_A's rows (lora_B replicated), so the summed partials
    give the full adapter output. ``rank``: build that rank's shard
    only."""
    if isinstance(lin, LoraLinear):
        return _shard_lora(lin, shard_linear(lin.base, T, kind, bits,
                                             groupsize, rank))

    w = lin.w if isinstance(lin, DenseLinear) else lin.dequantize()
    K, N = w.shape
    if kind == "col":
        if N % T:
            raise ValueError("column split of N={} over tp={}".format(N, T))
    else:
        if K % T:
            raise ValueError("row split of K={} over tp={}".format(K, T))
        gs_eff = groupsize if groupsize and groupsize > 0 else K
        if bits is not None and (K // T) % gs_eff:
            raise ValueError("row shard {} not aligned to groupsize "
                             "{}".format(K // T, gs_eff))
    shards = {}
    for t in _ranks(T, rank):
        if kind == "col":
            sl = slice(t * (N // T), (t + 1) * (N // T))
            ws = w[:, sl]
            bs = lin.bias[sl] if lin.bias is not None else None
        else:
            ws = w[t * (K // T): (t + 1) * (K // T), :]
            # the bias is added once after the sum: 1/T of it a shard
            bs = lin.bias / T if lin.bias is not None else None
        ws = ws.contiguous()
        if bits is None:
            shards[t] = DenseLinear(ws, bs)
        else:
            shards[t] = QuantLinear.from_dense(ws, bits=bits,
                                               groupsize=groupsize, bias=bs)
    return TPLinear(shards, kind, T)


def _shard_lora(lin, base_tp):
    """A LoraLinear's TPLinear over its base's shards ``base_tp``: lora_B's
    columns split for a column split (lora_A whole), lora_A's rows for a
    row split (lora_B whole)."""
    T, kind = base_tp.T, base_tp.kind
    shards = {}
    for t, base in base_tp.shards.items():
        if kind == "col":
            Nl = lin.lora_B.shape[1] // T
            a, b = lin.lora_A, lin.lora_B[:, t * Nl: (t + 1) * Nl]
        else:
            Kl = lin.lora_A.shape[0] // T
            a, b = lin.lora_A[t * Kl: (t + 1) * Kl, :], lin.lora_B
        shards[t] = LoraLinear(base, a.contiguous(), b.contiguous(),
                               lin.alpha, lin.dropout)
    return TPLinear(shards, kind, T)


def shard_quantlinear(lin, T, kind, conv=None, rank=None):
    """EXACT split of a packed QuantLinear: codes, scales and zeros are
    sliced, never requantized, so every shard dequantizes to the values of
    its block of the original. ``conv`` maps each shard (e.g. the serving
    layout). Column split: output columns (groups run along K, untouched).
    Row split: whole groups ((K/T) % groupsize == 0); per-channel qparams
    are shared by the row shards. ``rank``: build that rank's shard
    only."""
    codes = unpack_columns(lin.packed, lin.bits, lin.n_padded)
    N = lin.out_features
    codes = codes[:, :N]
    scales = lin.scales[:, :N].to(torch.float32)
    zeros = lin.zeros[:, :N].to(torch.float32)
    K = codes.shape[0]
    shards = {}
    if kind == "col":
        if N % T:
            raise ValueError("column split of N={} over tp={}".format(N, T))
        Nl = N // T
        for t in _ranks(T, rank):
            sl = slice(t * Nl, (t + 1) * Nl)
            b = lin.bias[sl] if lin.bias is not None else None
            shards[t] = QuantLinear.from_codes(
                codes[:, sl].contiguous(), scales[:, sl].contiguous(),
                zeros[:, sl].contiguous(), lin.bits, lin.groupsize, bias=b,
                perm=lin.perm, impl=lin.impl)
    else:
        if lin.perm is not None:
            raise ValueError("row-sharding an act-order (perm) QuantLinear "
                             "would permute input channels across shards")
        if K % T:
            raise ValueError("row split of K={} over tp={}".format(K, T))
        Kl = K // T
        if lin.groupsize > 0:
            if Kl % lin.groupsize:
                raise ValueError("row shard {} not aligned to groupsize "
                                 "{}".format(Kl, lin.groupsize))
            Gl = Kl // lin.groupsize
        for t in _ranks(T, rank):
            if lin.groupsize > 0:
                s = scales[t * Gl: (t + 1) * Gl]
                z = zeros[t * Gl: (t + 1) * Gl]
            else:
                s, z = scales, zeros
            # the bias is added once after the sum: 1/T of it a shard
            b = lin.bias / T if lin.bias is not None else None
            shards[t] = QuantLinear.from_codes(
                codes[t * Kl: (t + 1) * Kl].contiguous(), s.contiguous(),
                z.contiguous(), lin.bits, lin.groupsize, bias=b,
                impl=lin.impl)
    if conv is not None:
        shards = {t: conv(sh) for t, sh in shards.items()}
    return TPLinear(shards, kind, T)


_COL = ("wq", "wk", "wv", "w1", "w3")
_ROW = ("wo", "w2")


def _check_heads(cfg, T):
    if cfg.n_heads % T or cfg.n_kv_heads % T:
        raise ValueError("n_heads {} / n_kv_heads {} must divide tp={}".format(
            cfg.n_heads, cfg.n_kv_heads, T))


def _shard_layers(params, shard_any):
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        if "wq" not in layer:
            raise ValueError("TP sharding needs UNFUSED layers (wq/wk/wv, "
                             "w1/w3); got fused keys {}".format(sorted(layer)))
        new_layer = dict(layer)
        for name in _COL:
            new_layer[name] = shard_any(layer[name], "col")
        for name in _ROW:
            new_layer[name] = shard_any(layer[name], "row")
        out["layers"].append(new_layer)
    out["lm_head"] = shard_any(params["lm_head"], "col")
    return out


def shard_llama_params_tp(params, cfg, T, bits=None, groupsize=-1,
                          rank=None):
    """A (dense, or quantized and dequantized) LLaMA params tree with every
    linear TP-sharded by shard_linear (each shard quantized on its own when
    ``bits`` is set). n_heads and n_kv_heads must divide by T so column
    blocks hold whole heads."""
    _check_heads(cfg, T)
    return _shard_layers(params, lambda lin, kind: shard_linear(
        lin, T, kind, bits, groupsize, rank))


def shard_llama_params_tp_packed(params, cfg, T, conv=None, rank=None):
    """TP-shard an already QUANTIZED LLaMA params tree exactly
    (shard_quantlinear; DenseLinear leaves take plain splits): the serving
    engine's entry, GPTQ codes survive sharding bit for bit; a LoraLinear
    over a QuantLinear (QLoRA) keeps its base's exact shards and splits
    its adapters as shard_linear does. ``conv`` maps each QuantLinear
    shard (the serving layout)."""
    _check_heads(cfg, T)

    def shard_any(lin, kind):
        if isinstance(lin, LoraLinear) and isinstance(lin.base, QuantLinear):
            return _shard_lora(lin, shard_quantlinear(lin.base, T, kind,
                                                      conv=conv, rank=rank))
        if isinstance(lin, QuantLinear):
            return shard_quantlinear(lin, T, kind, conv=conv, rank=rank)
        return shard_linear(lin, T, kind, rank=rank)

    return _shard_layers(params, shard_any)


def shard_kv_cache_tp(cache, rank, T):
    """This rank's heads of a KVCache (the reference's ``_cache_specs``):
    the codes, and for a quantized cache the scales, on the head axis of
    the layer-stacked (L, B, S, n_kv, ...) tensors; the lengths whole."""
    n_kv = cache.k.shape[3]
    if n_kv % T:
        raise ValueError("{} kv heads over tp={}".format(n_kv, T))
    sl = slice(rank * (n_kv // T), (rank + 1) * (n_kv // T))

    def take(t):
        return None if t is None else t[:, :, :, sl].contiguous()

    return KVCache(take(cache.k), take(cache.v), take(cache.k_scale),
                   take(cache.v_scale), cache.length.clone(),
                   cache.quantized)


# ---- collectives ------------------------------------------------------------
#
# Each is differentiable, its backward chosen by how the ranks use the
# result (Megatron's pair; JAX's shard_map transposes its collectives by
# itself). The contract: after one step's backward, each rank holds its
# share of the gradient of the loss, so that summing over the axes that
# split the loss (mesh.sum_grads) gives every rank the unsharded model's
# gradient of each leaf, or of its shard.
#   _psum      sum; the gradient passes through: every rank repeats the
#              work after the sum alike (a row-parallel output, the
#              vocab-parallel softmax sums, a loss summed over ranks), so
#              each rank's summand takes the whole gradient once;
#   _copy_to   identity; the gradient is summed: a replicated tensor
#              enters rank-local work (column-parallel shards), each rank
#              contributing its own part of its gradient;
#   _gather_last  all_gather of blocks that every rank then uses alike;
#              the gradient of a rank's block is its slice;
#   _gather_shared  all_gather of blocks that each rank uses for work of
#              its own (sp's K/V); the gradient is reduce-scattered;
#   ppermute   JAX's ppermute; the gradient takes the reverse exchange.
#
# Transport. NCCL takes CUDA tensors in every operation. gloo takes them
# in its collectives (on the card, torch 2.11: all_reduce, all_gather,
# broadcast, reduce_scatter, all_to_all, each staged through host memory
# inside gloo), but its point-to-point operations hand the device pointer
# to gloo's TCP transport, which aborts the process. So _exchange copies
# a CUDA tensor to host memory and back itself on a gloo group: chosen by
# backend and device, never by catching a failure.


def tp_group(mesh):
    """(process group, T, this rank's index) of a mesh's "tp" axis."""
    g = mesh.get_group("tp")
    return g, dist.get_world_size(g), dist.get_rank(g)


def _all_reduce(x, g, op=dist.ReduceOp.SUM):
    """A contiguous copy of ``x`` reduced over ``g``."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=g)
    return y


def _all_gather(x, g, dim):
    """all_gather(tiled=True): the ranks' ``x`` concatenated on ``dim`` in
    rank order."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x, group=g)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x, g, dim):
    """This rank's block on ``dim`` of the sum of the ranks' ``x``."""
    n, r = dist.get_world_size(g), dist.get_rank(g)
    parts = [p.contiguous() for p in torch.chunk(x.detach(), n, dim=dim)]
    out = torch.empty_like(parts[r])
    dist.reduce_scatter(out, parts, group=g)
    return out


def _exchange(x, perm, g):
    """JAX's ppermute over ``g``: ``perm`` lists (source, destination)
    pairs of group ranks; this rank sends ``x`` to the destination it is
    the source of and returns what its source sent, zeros where it has
    none (dist.batch_isend_irecv)."""
    me = dist.get_rank(g)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    x = x.detach().contiguous()
    if dsts == [me] and srcs == [me]:
        return x.clone()
    staged = x.is_cuda and dist.get_backend(g) == "gloo"  # see above
    send = x.cpu() if staged else x
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(g, d), g)
           for d in dsts]
    ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(g, s), g)
            for s in srcs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not srcs:
        return torch.zeros_like(x)
    return recv.to(x.device) if staged else recv


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, gy):
        return gy, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce(gy, ctx.g), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.n, ctx.r = dist.get_world_size(g), dist.get_rank(g)
        return _all_gather(x, g, -1)

    @staticmethod
    def backward(ctx, gy):
        return torch.chunk(gy, ctx.n, dim=-1)[ctx.r], None


class _GatherShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        return _reduce_scatter(gy, ctx.g, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, g):
        ctx.perm, ctx.g = perm, g
        return _exchange(x, perm, g)

    @staticmethod
    def backward(ctx, gy):
        back = tuple((d, s) for s, d in ctx.perm)
        return _exchange(gy, back, ctx.g), None, None


_psum = _Psum.apply  # (x, g)
_copy_to = _CopyTo.apply  # (x, g)
_gather_last = _GatherLast.apply  # (x, g)
_gather_shared = _GatherShared.apply  # (x, g, dim)


def ppermute(x, perm, g):
    """Differentiable JAX ppermute over the group ``g`` (see _exchange);
    the backward sends the gradient along the reverse pairs, so every rank
    issues the same exchanges, in reverse order, in its backward."""
    return _PPermute.apply(x, tuple(perm), g)


def _shard(lin, g):
    """The rank's shard of a TPLinear. A LoRA shard's replicated factor
    (lora_A of a column split, lora_B of a row split) passes _copy_to:
    each rank's product holds only its part of that factor's
    gradient."""
    sh = lin.local()
    if not isinstance(sh, LoraLinear):
        return sh
    a, b = sh.lora_A, sh.lora_B
    if lin.kind == "col":
        a = _copy_to(a, g)
    else:
        b = _copy_to(b, g)
    return LoraLinear(sh.base, a, b, sh.alpha, sh.dropout)


# ---- per-rank bodies --------------------------------------------------------


def _local_heads(cfg, T):
    return cfg.n_heads // T, cfg.n_kv_heads // T


def _qkv(layer, h, cfg, T, positions, inv_freq, g):
    B, S, _ = h.shape
    hd = cfg.head_dim
    h_loc, kv_loc = _local_heads(cfg, T)
    q = _shard(layer["wq"], g)(h).reshape(B, S, h_loc, hd)
    k = _shard(layer["wk"], g)(h).reshape(B, S, kv_loc, hd)
    v = _shard(layer["wv"], g)(h).reshape(B, S, kv_loc, hd)
    return (L.apply_rope(q, positions, inv_freq),
            L.apply_rope(k, positions, inv_freq), v)


def _attend(q, k, v, mask, cfg, T):
    B, S = q.shape[:2]
    h_loc, kv_loc = _local_heads(cfg, T)
    n_rep = h_loc // kv_loc
    out = L.attention_scores(q, L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep),
                             mask)
    return out.reshape(B, S, h_loc * cfg.head_dim)


def _tp_attn(layer, x, cfg, inv_freq, positions, T, g):
    """The full-sequence (training) attention block over the rank's heads:
    llama.causal_attention, K10 forward and K11/K12 backward on the card,
    the masked attention_scores of the reference's _tp_attn elsewhere."""
    B, S, _ = x.shape
    q, k, v = _qkv(layer, _copy_to(x, g), cfg, T, positions, inv_freq, g)
    out = L.causal_attention(q, k, v).reshape(B, S, -1)
    return _psum(_shard(layer["wo"], g)(out), g)  # row-parallel partials


def _tp_ffn(layer, x, g):
    x = _copy_to(x, g)
    h = (torch.nn.functional.silu(_shard(layer["w1"], g)(x))
         * _shard(layer["w3"], g)(x))
    return _psum(_shard(layer["w2"], g)(h), g)


def _tp_forward_local(params, tokens, cfg, T, g):
    """Per rank: tokens (B, S) -> vocab-sharded f32 logits (B, S, V/T)."""
    B, S = tokens.shape
    dev = tokens.device
    x = params["tok_embed"][tokens.long()]
    inv_freq = L.rope_frequencies(cfg, device=dev)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    for layer in params["layers"]:
        h = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        x = x + _tp_attn(layer, h, cfg, inv_freq, positions, T, g)
        h = L.rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
        x = x + _tp_ffn(layer, h, g)
    x = L.rms_norm(x, params["norm"], cfg.rms_eps)
    return D._logits(_shard(params["lm_head"], g), _copy_to(x, g))


def _vocab_parallel_nll(logits_loc, targets, V_loc, g, r):
    """Cross-entropy over vocab-sharded logits (B, S, V/T) without
    gathering them: a max and a sum of exponentials across ranks, and the
    target's logit from the rank that owns it. The max only shifts the
    exponentials and takes no gradient (the reference's stop_gradient
    before pmax)."""
    m = _all_reduce(logits_loc.detach().amax(dim=-1), g, dist.ReduceOp.MAX)
    z = _psum(torch.exp(logits_loc - m[..., None]).sum(dim=-1), g)
    logz = m + torch.log(z)
    lo = r * V_loc
    owned = (targets >= lo) & (targets < lo + V_loc)
    idx = torch.clamp(targets - lo, 0, V_loc - 1).long()
    tgt = torch.gather(logits_loc, -1, idx[..., None])[..., 0]
    tgt = _psum(torch.where(owned, tgt, torch.zeros_like(tgt)), g)
    return logz - tgt  # (B, S)


def _cache_mask(positions, S_max):
    """(B, S) positions -> (B, 1, S, S_max) additive mask of the rows each
    query sees."""
    col = torch.arange(S_max, dtype=torch.int32, device=positions.device)
    visible = col[None, None, :] <= positions[:, :, None]
    return torch.where(visible, 0.0, -1e9).to(torch.float32)[:, None]


def _tp_layers_with_cache(params, x, positions, cache, cfg, T, g):
    """The decoder stack over the rank's heads: per layer the new rows are
    committed to the rank's cache, the layer read back and attended
    (reference tp.py:325-340, :451-466). Returns the final-norm hidden."""
    mask = _cache_mask(positions, cache.k.shape[2])
    inv_freq = L.rope_frequencies(cfg, device=x.device)
    for li, layer in enumerate(params["layers"]):
        h = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(layer, h, cfg, T, positions, inv_freq, g)
        cache_update(cache, li, k, v, positions[:, 0])
        k_all, v_all = cache_read(cache, li, x.dtype)
        out = _attend(q, k_all, v_all, mask, cfg, T)
        x = x + _psum(layer["wo"].local()(out), g)
        h2 = L.rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
        x = x + _tp_ffn(layer, h2, g)
    return L.rms_norm(x, params["norm"], cfg.rms_eps)


def _tp_decode_local(params, tokens, cache, cfg, T, g):
    """One decode step on a rank: tokens (B,) -> (vocab-sharded f32 logits
    (B, V/T), the rank's cache, updated in place)."""
    positions = cache.length[:, None]
    x = params["tok_embed"][tokens.long()[:, None]]
    x = _tp_layers_with_cache(params, x, positions, cache, cfg, T, g)
    logits = D._logits(params["lm_head"].local(), x)[:, 0]
    cache.length = (cache.length + 1).to(torch.int32)
    return logits, cache


def _tp_prefill_local(params, tokens, cache, last_idx, offset, cfg, T, g):
    """Bucketed-admission prefill on a rank (decode.prefill_at's
    semantics): FULL logits (B, V) at each row's last real token, the
    vocab gathered across ranks (admission batches are small)."""
    B, S = tokens.shape
    dev = tokens.device
    positions = offset[:, None] + torch.arange(
        S, dtype=torch.int32, device=dev)[None, :]
    x = params["tok_embed"][tokens.long()]
    x = _tp_layers_with_cache(params, x, positions, cache, cfg, T, g)
    x_last = x[torch.arange(B, device=dev), last_idx.to(torch.long)]
    logits = _gather_last(D._logits(params["lm_head"].local(), x_last), g)
    cache.length = (offset + last_idx + 1).to(torch.int32)
    return logits, cache


# ---- public functions -------------------------------------------------------


def tp_llama_forward(params_tp, tokens, cfg, mesh):
    """Full-vocab f32 logits of this rank's rows: tokens (B, S), the same
    global batch on every rank, sharded over the mesh's "dp" axis
    (dp_shard_batch); returns (B / dp, S, V), the vocab gathered over "tp"."""
    g, T, _ = tp_group(mesh)
    tokens = dp_shard_batch(mesh, tokens)
    return _gather_last(_tp_forward_local(params_tp, tokens, cfg, T, g), g)


def tp_llama_loss(params_tp, tokens, cfg, mesh):
    """Mean next-token NLL of the global batch with the vocab-parallel
    softmax (full logits never formed): every rank returns the same value.
    Differentiable in the rank's shards and in the replicated leaves: after
    ``backward()`` a rank's gradients are its dp replica's share, and
    ``mesh.sum_grads(tree, mesh, ("dp",))`` makes each the unsharded
    model's gradient of the leaf, or of the rank's shard of it."""
    g, T, r = tp_group(mesh)
    V_loc = cfg.vocab_size // T
    tokens = dp_shard_batch(mesh, tokens)
    logits = _tp_forward_local(params_tp, tokens[:, :-1], cfg, T, g)
    loss = _vocab_parallel_nll(logits, tokens[:, 1:], V_loc, g, r).mean()
    dp = mesh.get_group("dp")  # the mean over the dp-sharded batch
    return _psum(loss, dp) / dist.get_world_size(dp)


def tp_decode_step(params_tp, tokens, cache, cfg, mesh):
    """Tensor-parallel decode step over packed weight shards and the
    rank's head-sharded KV cache: tokens (B,) -> (vocab-sharded logits
    (B, V/T), cache). The batch is the same on every rank."""
    g, T, _ = tp_group(mesh)
    return _tp_decode_local(params_tp, tokens, cache, cfg, T, g)


def tp_prefill_at(params_tp, tokens, cache, cfg, last_idx, offset, mesh):
    """Tensor-parallel decode.prefill_at, the serving engine's admission
    forward: (full logits (B, V), the rank's head-sharded cache)."""
    g, T, _ = tp_group(mesh)
    return _tp_prefill_local(params_tp, tokens, cache, last_idx, offset,
                             cfg, T, g)


def tp_decode_chunk(params_tp, tok0, cache, temps, generator, cfg, mesh,
                    n_tokens):
    """The tensor-parallel serving inner loop: n_tokens decode steps, each
    step's logits gathered over the vocab and sampled per slot
    (decode.sample_logits_vec, temps (B,), <= 0 greedy) from
    ``generator``. Every rank holds the same gathered logits and a
    generator in the same state, so every rank draws the same tokens.
    Returns (tokens (B, n_tokens), cache)."""
    g, T, _ = tp_group(mesh)
    tok, toks = tok0, []
    for _ in range(n_tokens):
        logits_loc, cache = _tp_decode_local(params_tp, tok, cache, cfg, T,
                                             g)
        logits = _gather_last(logits_loc, g)
        tok = D.sample_logits_vec(logits, temps, generator)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache
