"""Sequence parallelism for LLaMA training on torch.distributed (port of
``sparsebit_tpu/parallel/sp.py``).

The sequence axis of the activations is split over a mesh axis: each rank
embeds, normalises, projects and scores only its S/n positions, so
activation memory falls as 1/n. Attention is the one op across
positions, two ways:

- ``sp_llama_loss`` (Megatron-SP): each layer's K/V rows are all-gathered
  over the axis and each rank attends its Q chunk to the full K/V under
  an offset causal mask;
- ``sp_llama_loss(ring=True)``: ring attention. K/V chunks rotate around
  the axis (``tp.ppermute``) while each rank folds every chunk into
  online-softmax accumulators (running max, denominator and value mix):
  the same function, one chunk of K/V resident at a time.

Both attend with plain tensor ops: neither the offset mask nor the ring is
K10's function, and the JAX package has no kernel there either.

Tokens are replicated over the axis: the next-token targets cross chunk
boundaries, so each rank slices its rows of the padded array and the last
global position has weight 0. The loss is the token mean over the whole
(B, S - 1) grid, summed over the axis (and over ``dp_axis`` when the mesh
has one, the batch split over it): equal to ``llama.llama_loss`` on one
device.

Gradients: the K/V all_gather's backward is a reduce-scatter, the ring's
exchange backward the reverse exchange, the loss's sum passes the gradient
through. After ``backward()`` each rank holds its share of every
(replicated) leaf's gradient; ``mesh.sum_grads(params, mesh, (axis,
dp_axis))`` gives every rank the whole.
"""

import torch

from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.parallel.multihost import local_batch_slice
from sparsebit_tpu_torch.parallel.tp import _gather_shared, _psum, ppermute


def _local_attention(q, k_full, v_full, offset, cfg):
    """Causal attention of a local Q chunk (B, S_loc, Hq, D) against the
    FULL K/V (B, S, Hkv, D): local row i is global position offset + i."""
    S_loc, S = q.shape[1], k_full.shape[1]
    dev = q.device
    n_rep = cfg.n_heads // cfg.n_kv_heads
    rows = offset + torch.arange(S_loc, dtype=torch.int32, device=dev)
    cols = torch.arange(S, dtype=torch.int32, device=dev)
    mask = torch.where(cols[None, :] <= rows[:, None], 0.0, -1e9).to(
        torch.float32)[None, None]  # (1, 1, S_loc, S)
    return L.attention_scores(q, L.repeat_kv(k_full, n_rep),
                              L.repeat_kv(v_full, n_rep), mask)


def _ring_attention(q, k_loc, v_loc, offset, cfg, g, n):
    """Exact causal ring attention: after j hops a rank holds the K/V chunk
    of rank (me + j) % n, whose columns start at that rank's offset. K and
    V travel as one tensor, so the ring is one chain of exchanges."""
    B, S_loc, Hq, D = q.shape
    dev = q.device
    n_rep = cfg.n_heads // cfg.n_kv_heads
    me = torch.distributed.get_rank(g)
    rows = offset + torch.arange(S_loc, dtype=torch.int32, device=dev)
    scale = float(D) ** -0.5
    perm = [(i, (i - 1) % n) for i in range(n)]

    m = torch.full((B, Hq, S_loc, 1), -1e30, dtype=torch.float32, device=dev)
    denom = torch.zeros((B, Hq, S_loc, 1), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Hq, S_loc, D), dtype=torch.float32, device=dev)
    kv = torch.stack([k_loc, v_loc])
    for j in range(n):
        col0 = ((me + j) % n) * S_loc
        cols = col0 + torch.arange(S_loc, dtype=torch.int32, device=dev)
        kj = L.repeat_kv(kv[0], n_rep)  # (B, S_loc, Hq, D)
        vj = L.repeat_kv(kv[1], n_rep)
        s_j = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                           kj.to(torch.float32)) * scale
        s_j = torch.where(cols[None, None, None, :] <= rows[None, None, :, None],
                          s_j, -1e30)
        m_new = torch.maximum(m, s_j.amax(dim=-1, keepdim=True))
        # rescale the old accumulators, fold the new chunk in
        alpha = torch.exp(m - m_new)
        p_j = torch.exp(s_j - m_new)
        denom = denom * alpha + p_j.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bkhd->bhqd", p_j,
                                     vj.to(torch.float32))
        m = m_new
        if j + 1 < n:
            kv = ppermute(kv, perm, g)
    out = o / torch.clamp(denom, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, S_loc, Hq, D)


def _sp_forward_local(params, tok_local, offset, cfg, g, n, ring):
    B, S_loc = tok_local.shape
    dev = tok_local.device
    x = params["tok_embed"][tok_local.long()]
    inv_freq = L.rope_frequencies(cfg, device=dev)
    positions = (offset + torch.arange(S_loc, dtype=torch.int32,
                                       device=dev))[None].expand(B, S_loc)
    for layer in params["layers"]:
        h = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k, v = L.qkv_proj(layer, h, cfg)
        q = L.apply_rope(q, positions, inv_freq)
        k = L.apply_rope(k, positions, inv_freq)
        if ring:
            out = _ring_attention(q, k, v, offset, cfg, g, n)
        else:
            # Megatron-SP: gather the (GQA-compressed) K/V rows
            out = _local_attention(q, _gather_shared(k, g, 1),
                                   _gather_shared(v, g, 1), offset, cfg)
        x = x + layer["wo"](out.reshape(B, S_loc, -1))
        x = x + L._ffn_block(layer, L.rms_norm(x, layer["ffn_norm"],
                                               cfg.rms_eps))
    return L.rms_norm(x, params["norm"], cfg.rms_eps)


def sp_llama_loss(params, tokens, cfg, mesh, axis="sp", dp_axis=None,
                  ring=False):
    """Sequence-parallel next-token loss, equal to llama.llama_loss: tokens
    (B, S), the same global batch on every rank; params replicated; the
    batch split over ``dp_axis`` when given (a (dp, sp) mesh). S % n_sp
    and B % n_dp must be 0 (ValueError otherwise: a remainder is never
    dropped). Every rank returns the same value."""
    g = mesh.get_group(axis)
    n = mesh[axis].size()
    if dp_axis is not None:
        tokens = tokens[local_batch_slice(tokens.shape[0], mesh, dp_axis)]
        n_dp = mesh[dp_axis].size()
    else:
        n_dp = 1
    B, S = tokens.shape
    if S % n:
        raise ValueError("{} positions over {} ranks of axis {!r}".format(
            S, n, axis))
    S_loc = S // n
    offset = mesh.get_local_rank(axis) * S_loc
    tok_local = tokens[:, offset:offset + S_loc]
    x = _sp_forward_local(params, tok_local, offset, cfg, g, n, ring)
    logits = params["lm_head"](x).to(torch.float32)  # (B, S_loc, V)
    # targets: global rows [offset + 1, offset + S_loc + 1); the final
    # global position has none (weight 0)
    tgt = torch.nn.functional.pad(tokens, (0, 1))[:, offset + 1:
                                                  offset + 1 + S_loc]
    pos = offset + torch.arange(S_loc, device=tokens.device)
    w = (pos < S - 1).to(torch.float32)[None, :]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    tot = _psum((nll * w).sum(), g)
    if dp_axis is not None:
        tot = _psum(tot, mesh.get_group(dp_axis))
    return tot / float((S - 1) * B * n_dp)
