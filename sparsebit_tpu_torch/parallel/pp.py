"""Pipeline parallelism: GPipe microbatch waves over a mesh's "pp" axis on
torch.distributed (port of ``sparsebit_tpu/parallel/pp.py``; reference:
torch.distributed.pipeline.sync.Pipe over an nn.Sequential LLaMA,
model_pp.py:173-191 and finetune_pp.py, pipelining a make_quant-ed
4-bit backbone under LoRA adapters).

- Stages are contiguous blocks of layers; each rank holds its stage's
  layers as a list (``stack_llama_stages(..., rank=)``; layouts are free)
  and any linear containers (DenseLinear, packed QuantLinear,
  LoraLinear over either, TPLinear shards for ``pp_tp_*``). The stage
  body is ``llama.decoder_layer`` with no mask, so attention is
  ``causal_attention``: K10 forward and K11/K12 backward on the card.
- The schedule is M + P - 1 waves: in wave t stage 0 embeds microbatch
  t, every stage whose microbatch is in flight runs its body under
  ``torch.utils.checkpoint`` (the reference's checkpoint='always', JAX's
  jax.checkpoint), the last stage banks microbatch t - (P - 1), and the
  activations ring-shift one stage (``tp.ppermute``, the edge P-1 -> 0
  included) after every wave but the last.
- The loss is taken on the last stage, summed over pp (the other stages
  add 0) and averaged over dp (the batch split over "dp").

The backward is autograd's through the waves: each exchange's backward
sends the gradient back along the ring, so every rank must run the same
exchanges in the same reverse order. The waves make that so: an idle
wave skips the body but not the exchange; stage 0 keeps the received
tensor in its graph (``where``, as the reference's ``jnp.where(stage_id ==
0, embedded, x_in)``); the first wave's input is a zero leaf that takes a
gradient, so every exchanged tensor does on every rank; and ``_Anchor``
ties the last wave's activation into every rank's loss, so that each
rank's backward reaches every exchange. After ``backward()`` each stage
leaf holds its dp replica's share and the replicated leaves (embed,
norm, head) are nonzero on one stage only: ``pp_sum_grads`` makes each
rank's gradient the unsharded model's. The packed backbone is frozen
under QLoRA: ``pp_qlora_train_step`` trains the adapters alone.
"""

import torch
from torch.utils.checkpoint import checkpoint

from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.qlora import LoraLinear
from sparsebit_tpu_torch.llm.quant import DenseLinear
from sparsebit_tpu_torch.parallel.mesh import dp_shard_batch, sum_grads
from sparsebit_tpu_torch.parallel.tp import (
    TPLinear,
    _copy_to,
    _psum,
    _shard,
    _tp_attn,
    _tp_ffn,
    _vocab_parallel_nll,
    ppermute,
    tp_group,
)


def stack_llama_stages(params, n_stages, rank=None):
    """{"embed", "stages", "norm", "head"}: ``stages`` maps a stage index
    to its contiguous block of layers (all n_stages of them, or stage
    ``rank``'s alone: the form a rank runs). Layers split evenly."""
    n_layers = len(params["layers"])
    if n_layers % n_stages:
        raise ValueError("{} layers over {} stages".format(n_layers, n_stages))
    per = n_layers // n_stages
    ranks = range(n_stages) if rank is None else (rank,)
    return {"embed": params["tok_embed"],
            "stages": {s: list(params["layers"][s * per:(s + 1) * per])
                       for s in ranks},
            "norm": params["norm"], "head": params["lm_head"]}


def densify_llama_params(params):
    """DenseLinear wrappers replaced by their raw (in, out) weights, the
    reference's slimming for float pipelines; the stage body re-wraps
    them."""
    def conv(x):
        return x.w if isinstance(x, DenseLinear) else x

    return {"tok_embed": params["tok_embed"], "norm": params["norm"],
            "lm_head": conv(params["lm_head"]),
            "layers": [{k: conv(v) for k, v in layer.items()}
                       for layer in params["layers"]]}


def _stage(params, sid):
    if sid not in params["stages"]:
        raise ValueError("this rank runs stage {}; params_pp holds stages {}"
                         .format(sid, sorted(params["stages"])))
    return params["stages"][sid]


def _stage_body(layers, x, cfg, positions):
    """The rank's block of decoder layers, mask None (causal_attention);
    raw weights (densify_llama_params) re-wrapped as DenseLinear."""
    inv_freq = L.rope_frequencies(cfg, device=x.device)
    for layer in layers:
        layer = {k: DenseLinear(v) if (k in L._LINEAR_NAMES
                                       and isinstance(v, torch.Tensor)) else v
                 for k, v in layer.items()}
        x, _ = L.decoder_layer(layer, x, cfg, inv_freq, positions, None)
    return x


def _stage_body_tp(layers, x, cfg, positions, T, g):
    """The tensor-parallel stage body: TPLinear shards, one psum over "tp"
    a residual branch (packed QuantLinear and LoraLinear shards alike)."""
    inv_freq = L.rope_frequencies(cfg, device=x.device)
    for layer in layers:
        h = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        x = x + _tp_attn(layer, h, cfg, inv_freq, positions, T, g)
        h = L.rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
        x = x + _tp_ffn(layer, h, g)
    return x


class _Anchor(torch.autograd.Function):
    """A zero that depends on ``x``, with a zero gradient: added to every
    rank's loss, it puts the pipeline's last activation, and through it
    every exchange of the schedule, in every rank's backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.like = (x.shape, x.dtype, x.device)
        return torch.zeros((), dtype=torch.float32, device=x.device)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return torch.zeros(shape, dtype=dtype, device=device)


def _pipeline(params, inputs, cfg, mesh, body):
    """The waves on this rank's stage. inputs (M, B/M, S) tokens. Returns
    (the last stage's final hidden states (B, S, D) in f32, microbatches in
    order, or None on another stage; the anchor term for the loss)."""
    g = mesh.get_group("pp")
    P, sid = mesh["pp"].size(), mesh.get_local_rank("pp")
    M, Bm, S = inputs.shape
    dev = inputs.device
    embed = params["embed"]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        Bm, S)
    ring = [(i, (i + 1) % P) for i in range(P)]
    keep = torch.ones((), dtype=torch.bool, device=dev)
    x_in = torch.zeros((Bm, S, cfg.dim), dtype=embed.dtype, device=dev,
                       requires_grad=torch.is_grad_enabled())
    outs = []
    n_waves = M + P - 1
    for t in range(n_waves):
        if sid == 0:  # inject microbatch t; x_in stays in the graph
            x = torch.where(keep, embed[inputs[min(t, M - 1)].long()], x_in)
        else:
            x = x_in
        if 0 <= t - sid < M:
            y = checkpoint(body, x, positions, use_reentrant=False)
        else:
            y = x * 0  # an idle wave: no body, the exchange all the same
        if sid == P - 1 and t >= P - 1:
            outs.append(y.to(torch.float32))
        if t + 1 < n_waves:
            x_in = ppermute(y, ring, g)
    hidden = torch.cat(outs) if outs else None
    return hidden, _Anchor.apply(y)


def _pp_loss(params, tokens, cfg, mesh, n_microbatches, body, nll_fn):
    """The mean next-token NLL over the pipeline (see the module doc).
    tokens (B, S + 1), the same global batch on every rank, B divisible by
    dp * n_microbatches."""
    M = n_microbatches
    toks = dp_shard_batch(mesh, tokens)
    B, S = toks.shape[0], toks.shape[1] - 1
    if B % M:
        raise ValueError("{} rows a dp rank over {} microbatches".format(B, M))
    inputs = toks[:, :-1].reshape(M, B // M, S)
    hidden, anchor = _pipeline(params, inputs, cfg, mesh, body)
    if hidden is None:
        local = torch.zeros((), dtype=torch.float32, device=toks.device)
    else:
        x = L.rms_norm(hidden, params["norm"], cfg.rms_eps)
        local = nll_fn(x, toks[:, 1:]).mean()
    loss = _psum(local + anchor, mesh.get_group("pp"))
    return _psum(loss, mesh.get_group("dp")) / mesh["dp"].size()


def _nll(head, x, targets):
    logits = (head(x) if callable(head) else torch.matmul(x, head)).to(
        torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


def pp_llama_loss(params_pp, tokens, cfg, mesh, n_microbatches):
    """Mean next-token NLL with GPipe microbatch pipelining on a (dp, pp)
    mesh. params_pp: stack_llama_stages (this rank's stage at least);
    tokens (B, S + 1)."""
    layers = _stage(params_pp, mesh.get_local_rank("pp"))
    return _pp_loss(
        params_pp, tokens, cfg, mesh, n_microbatches,
        lambda x, pos: _stage_body(layers, x, cfg, pos),
        lambda x, tgt: _nll(params_pp["head"], x, tgt))


def pp_tp_llama_loss(params_pp, tokens, cfg, mesh, n_microbatches):
    """Mean next-token NLL on a dp x tp x pp mesh: batch over dp, heads,
    FFN and vocab over tp, depth over pp. params_pp:
    ``stack_llama_stages(shard_llama_params_tp(params, cfg, T, ...,
    rank=tp_rank), P, rank=pp_rank)``. The loss is vocab-parallel (full
    logits never formed)."""
    g, T, r = tp_group(mesh)
    layers = _stage(params_pp, mesh.get_local_rank("pp"))
    head = params_pp["head"]

    def nll(x, tgt):
        logits = _shard(head, g)(_copy_to(x, g)).to(torch.float32)
        return _vocab_parallel_nll(logits, tgt, cfg.vocab_size // T, g, r)

    return _pp_loss(
        params_pp, tokens, cfg, mesh, n_microbatches,
        lambda x, pos: _stage_body_tp(layers, x, cfg, pos, T, g), nll)


def pp_sum_grads(params_pp, mesh):
    """After the backward of a pp loss: the stage leaves' gradients summed
    over dp, the replicated leaves' (embed, used on stage 0; norm and
    head, on the last) over pp and dp. Each rank then holds the unsharded
    model's gradient of every leaf it holds, or of its shard."""
    sum_grads(params_pp["stages"], mesh, ("dp",))
    sum_grads([params_pp[k] for k in ("embed", "norm", "head")], mesh,
              ("pp", "dp"))
    return params_pp


# ---- QLoRA over a pipelined quantized backbone (finetune_pp parity) ---------


def pp_extract_lora(params_pp):
    """{(stage, layer in the stage, name): {"lora_A", "lora_B"}}: the
    adapters of the stages held (the same tensors, not copies), the form
    ``qlora.lora_parameters`` and ``qlora.adamw`` take. A TPLinear's
    adapters are the rank's shard's."""
    out = {}
    for s, layers in params_pp["stages"].items():
        for i, layer in enumerate(layers):
            for name, lin in layer.items():
                if isinstance(lin, TPLinear):
                    lin = lin.local()
                if isinstance(lin, LoraLinear):
                    out[(s, i, name)] = {"lora_A": lin.lora_A,
                                         "lora_B": lin.lora_B}
    return out


def _with_lora(lin, ad):
    if isinstance(lin, TPLinear):  # holding the rank's shard
        (t, sh), = lin.shards.items()
        return TPLinear({t: _with_lora(sh, ad)}, lin.kind, lin.T)
    return LoraLinear(lin.base, ad["lora_A"], ad["lora_B"], lin.alpha,
                      lin.dropout)


def pp_merge_lora(params_pp, lora):
    """params_pp with the adapters of ``lora`` swapped in."""
    stages = {}
    for s, layers in params_pp["stages"].items():
        stages[s] = [{name: (_with_lora(lin, lora[(s, i, name)])
                             if (s, i, name) in lora else lin)
                      for name, lin in layer.items()}
                     for i, layer in enumerate(layers)]
    return dict(params_pp, stages=stages)


def pp_qlora_loss(lora, params_pp, tokens, cfg, mesh, n_microbatches):
    """The pipelined causal-LM loss as a function of the adapters: the
    packed backbone is a frozen operand (finetune_pp.py trains LoRA over a
    make_quant backbone through Pipe)."""
    return pp_llama_loss(pp_merge_lora(params_pp, lora), tokens, cfg, mesh,
                         n_microbatches)


def pp_tp_qlora_loss(lora, params_pp, tokens, cfg, mesh, n_microbatches):
    """The dp x tp x pp QLoRA loss: adapters differentiable, the packed
    TP-sharded backbone frozen."""
    return pp_tp_llama_loss(pp_merge_lora(params_pp, lora), tokens, cfg,
                            mesh, n_microbatches)


def pp_qlora_train_step(lora, optimizer, params_pp, tokens, cfg, mesh,
                        n_microbatches):
    """One optimiser step on the adapters through the pipelined model: the
    loss, its backward, the adapters' gradients summed over dp, and
    ``optimizer.step()`` (built over ``qlora.lora_parameters(lora)``, e.g.
    ``qlora.adamw``), which updates them in place. No opt_state: a
    torch.optim optimiser holds its own. Returns (lora, the loss)."""
    optimizer.zero_grad(set_to_none=True)
    loss = pp_qlora_loss(lora, params_pp, tokens, cfg, mesh, n_microbatches)
    loss.backward()
    sum_grads(lora, mesh, ("dp",))
    optimizer.step()
    return lora, loss.detach()
