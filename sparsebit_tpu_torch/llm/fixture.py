"""Accuracy fixture: a deterministically trained tiny LLaMA on a synthetic
Markov corpus (port of ``sparsebit_tpu/llm/fixture.py``), so that
perplexity claims are testable without any dataset or checkpoint.

It runs the harness a real checkpoint runs (the reference's
convert.py:176-259 llama_eval): init -> train -> GPTQ convert -> packed
QuantLinear -> windowed perplexity. The tests hold its relative claims
(quantized perplexity close to float; GPTQ no worse than round to
nearest); ``examples/llm/accuracy_fixture_torch.py`` records the absolute
numbers.

The corpus is the JAX package's numpy draw, bit for bit. Training is
``torch.optim.Adam`` (its defaults give optax.adam's update) from weights
drawn by a CPU ``torch.Generator`` seeded ``seed`` and windows drawn by one
seeded ``seed + 1``, so a run on the card starts from the same weights and
windows as one on the CPU; the JAX package draws both from its own PRNG,
so the two packages train different models.

The long-context int8-attention record (the port's counterpart of
``experiments/exp36_int8attn_longctx.py``) has its pieces here too:
``markov_stream`` (exp36's stream, bit for bit), ``train_on_stream``
(exp36's Adam loop at seqlen 2047), ``quantize_rtn_serving`` and
``decode_routes``: the same prefilled int8 cache decoded by
``decode_step`` (attention in f32 over the int8 codes: K5 on the card) and
by ``decode_step_scanned`` (K4's 7-bit probability mix).
``examples/llm/int8attn_longctx_torch.py`` records it.
"""

import math

import numpy as np
import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.convert import quantize_llama_gptq
from sparsebit_tpu_torch.llm.decode import (
    decode_step,
    decode_step_scanned,
    prepare_params_host,
    stack_layers,
)
from sparsebit_tpu_torch.llm.eval import perplexity
from sparsebit_tpu_torch.llm.quant import QuantLinear


def make_markov_corpus(n_tokens, vocab_size, order=1, seed=0, alpha=0.3):
    """Synthetic corpus from a sparse random Markov chain: real sequential
    structure (learnable, ppl floor << vocab_size) with a fixed seed."""
    rng = np.random.default_rng(seed)
    # sparse transition matrix: each state strongly prefers ~4 successors
    n_next = 4
    succ = rng.integers(0, vocab_size, size=(vocab_size, n_next))
    probs = rng.dirichlet(np.full(n_next, alpha), size=vocab_size)
    toks = np.empty(n_tokens, np.int64)
    s = int(rng.integers(vocab_size))
    for i in range(n_tokens):
        toks[i] = s
        j = rng.choice(n_next, p=probs[s])
        s = int(succ[s, j])
    return toks.astype(np.int32)


def fixture_config():
    return L.llama_tiny(
        vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
        ffn_dim=256, max_seq_len=128, dtype="float32",
    )


def _leaves(params):
    """Every weight tensor of a dense params tree, in a fixed order."""
    out = [params["tok_embed"], params["norm"]]
    lins = [params["lm_head"]]
    for layer in params["layers"]:
        for name in sorted(layer):
            if name in L._LINEAR_NAMES:
                lins.append(layer[name])
            else:
                out.append(layer[name])
    for lin in lins:
        out.append(lin.w)
        if lin.bias is not None:
            out.append(lin.bias)
    return out


def _adam_train(params, cfg, batches, lr, on_step=None):
    """torch.optim.Adam(lr) (optax.adam's update at its defaults) on the
    next-token loss of each token batch, ``params`` trained in place;
    ``on_step(i, loss)`` after each step. Returns the losses (tensors)."""
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr)
    losses = []
    try:
        for i, toks in enumerate(batches):
            loss = L.llama_loss(params, toks, cfg)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if on_step is not None:
                on_step(i, loss)
    finally:
        opt.zero_grad(set_to_none=True)
        for t in leaves:
            t.requires_grad_(False)
    return losses


def train_tiny_llama(cfg, corpus, steps=200, batch=8, seqlen=64, lr=3e-3,
                     seed=0, verbose=False, *, params=None, device=None):
    """Adam on the next-token loss; deterministic given the seeds. Starts
    from ``params`` (trained in place) or from init_llama_params drawn by
    a CPU generator seeded ``seed``, on ``device`` (default the card)."""
    dev = resolve_device(device)
    if params is None:
        params = L.init_llama_params(
            cfg, torch.Generator().manual_seed(seed), device=dev)
    n_windows = len(corpus) // (seqlen + 1)
    windows = torch.as_tensor(
        corpus[: n_windows * (seqlen + 1)].reshape(n_windows, seqlen + 1),
        device=dev).long()
    gen = torch.Generator().manual_seed(seed + 1)
    batches = (windows[torch.randint(0, n_windows, (batch,),
                                     generator=gen).to(dev)]
               for _ in range(steps))

    def report(i, loss):
        if (i + 1) % 50 == 0:
            print("train step {}: loss {:.4f}".format(i + 1, loss.item()))

    _adam_train(params, cfg, batches, lr, report if verbose else None)
    return params


def fixture_eval_tokens(corpus, n_eval=4096):
    """Held-out tail of the corpus for the ppl windows."""
    return corpus[-n_eval:]


def run_fixture(steps=200, n_tokens=40_000, gptq_bits=(4,), groupsize=32,
                seqlen=64, verbose=False, *, device=None):
    """Full harness: train -> float ppl -> RTN ppl -> GPTQ ppl, on
    ``device`` (default the card). Returns the dict of results (the
    accuracy artifact), with the JAX package's keys."""
    dev = resolve_device(device)
    cfg = fixture_config()
    corpus = make_markov_corpus(n_tokens, cfg.vocab_size, seed=0)
    train_toks = corpus[:-8192]
    eval_toks = fixture_eval_tokens(corpus, 4096)
    params = train_tiny_llama(cfg, train_toks, steps=steps, seqlen=seqlen,
                              verbose=verbose, device=dev)

    results = {
        "config": "tiny-llama d{} L{} vocab{}".format(
            cfg.dim, cfg.n_layers, cfg.vocab_size),
        "corpus": "markov(seed=0, n={})".format(n_tokens),
        "train_steps": steps,
        "groupsize": groupsize,
        "seqlen": seqlen,
    }
    results["ppl_float"] = perplexity(params, eval_toks, cfg, seqlen=seqlen,
                                      device=dev)
    if verbose:
        print("float ppl:", results["ppl_float"])

    # GPTQ quality tracks calibration coverage; 48 windows keep the
    # Hessian well conditioned at this scale (fixture.py:115-117)
    n_calib = 48
    calib = train_toks[: n_calib * (seqlen + 1)].reshape(
        n_calib, seqlen + 1)[:, :seqlen]
    for bits in gptq_bits:
        rtn = L.quantize_llama_params(
            params, lambda path, lin: QuantLinear.from_dense(
                lin.w.to(torch.float32), bits=bits, groupsize=groupsize))
        results["ppl_rtn_int{}".format(bits)] = perplexity(
            rtn, eval_toks, cfg, seqlen=seqlen, device=dev)
        qp, _ = quantize_llama_gptq(
            params, calib, cfg, candidate_bits=(bits,), groupsize=groupsize,
            verbose=False, device=dev)
        results["ppl_gptq_int{}".format(bits)] = perplexity(
            qp, eval_toks, cfg, seqlen=seqlen, device=dev)
        if verbose:
            print("int{}: rtn ppl {:.4f}, gptq ppl {:.4f}".format(
                bits, results["ppl_rtn_int{}".format(bits)],
                results["ppl_gptq_int{}".format(bits)]))
    return results


# ---- the long-context int8-attention record (exp36) -------------------------


def markov_stream(n, vocab, walk_seed=1, chain_seed=1234, sharpness=8.0):
    """exp36's token stream (exp36_int8attn_longctx.py:68-83), bit for
    bit: a walk seeded ``walk_seed`` over a bigram chain of peaked
    Dirichlet rows seeded ``chain_seed``. The chain is shared between the
    training stream and a held-out walk."""
    rng_c = np.random.RandomState(chain_seed)
    T = rng_c.dirichlet(np.full(vocab, 1.0 / sharpness), size=vocab)
    Tc = np.cumsum(T, axis=1)
    rng = np.random.RandomState(walk_seed)
    u = rng.random_sample(n)
    out = np.zeros(n, np.int32)
    t = rng.randint(vocab)
    for i in range(n):
        out[i] = t
        t = int(np.searchsorted(Tc[t], u[i]))
        t = min(t, vocab - 1)
    return out


def longctx_config(**kw):
    """exp36's model: an f32 llama at head_dim 128 (dim 512, 4 heads and 4
    kv heads, ffn 384, 2 layers) over 2048 positions and 256 tokens."""
    d = dict(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=384,
             max_seq_len=2048, vocab_size=256, dtype="float32")
    d.update(kw)
    return L.llama_tiny(**d)


def init_longctx_params(cfg, seed=0, *, device=None):
    """Fused (wqkv, w13) f32 weights drawn by a CPU generator seeded
    ``seed``, on ``device`` (default the card). exp36 draws them from
    jax.random, which torch cannot repeat: the record is the port's."""
    return L.fuse_llama_params(L.init_llama_params(
        cfg, torch.Generator().manual_seed(seed),
        device=resolve_device(device)))


def train_on_stream(params, cfg, stream, steps=250, seqlen=2047, batch=4,
                    lr=1e-3, window_seed=7, on_step=None):
    """exp36's training (exp36:35-65) of ``params`` in place: Adam(lr)
    over llama_loss, each step's ``batch`` windows of seqlen + 1 tokens
    starting where np.random.RandomState(window_seed) draws them over the
    whole stream. On the card llama_loss runs K10 with its lse output and
    K11/K12 (f32 at head_dim 128). Returns the step losses."""
    dev = params["tok_embed"].device
    rng = np.random.RandomState(window_seed)
    n_win = len(stream) - seqlen - 1

    def batches():
        for _ in range(steps):
            idx = rng.randint(0, n_win, size=batch)
            yield torch.from_numpy(np.stack(
                [stream[j:j + seqlen + 1] for j in idx])).to(dev).long()

    losses = _adam_train(params, cfg, batches(), lr, on_step)
    return torch.stack(losses).tolist() if losses else []


def quantize_rtn_serving(params, bits=4, groupsize=64):
    """exp36's weights: every decoder linear round-to-nearest
    (QuantLinear.from_dense), the f32 head kept, in the serving layout
    (prepare_params_host). Returns (per-layer params, stack_layers of
    them)."""
    q = L.quantize_llama_params(params, lambda path, lin: (
        QuantLinear.from_dense(lin.w.to(torch.float32), bits=bits,
                               groupsize=groupsize)))
    sparams = prepare_params_host(q)
    return sparams, stack_layers(sparams)


def decode_fed(step_fn, params, cache, cfg, tokens):
    """One ``step_fn(params, tok, cache, cfg)`` a token of ``tokens`` (n,)
    int32 at batch 1 (teacher forcing): logits (n, V) f32."""
    rows = []
    for i in range(tokens.shape[0]):
        logits, cache = step_fn(params, tokens[i:i + 1], cache, cfg)
        rows.append(logits[0])
    return torch.stack(rows)


def decode_routes(sparams, stacked, cache, cfg, feed=None, tok0=None,
                  n=None):
    """exp36's two routes from one prefilled int8 cache at batch 1: route
    A ``decode_step`` over ``cache`` (attention in f32 over the int8
    codes), route B ``decode_step_scanned`` over a clone of it (on the
    card K4, whose value mix takes 7-bit probabilities). Teacher-forced
    on ``feed`` (n,), or greedy on route A's argmax from ``tok0`` (1,) for
    ``n`` steps, route B fed the same tokens (exp36's ``main``). Returns
    (logits A (n, V), logits B (n, V), the tokens fed (n,))."""
    twin = cache.clone()
    if feed is None:
        rows, tok, fed = [], tok0, []
        for _ in range(n):
            fed.append(tok)
            logits, cache = decode_step(sparams, tok, cache, cfg)
            rows.append(logits[0])
            tok = logits.argmax(-1).to(torch.int32)
        feed, logits_a = torch.cat(fed), torch.stack(rows)
    else:
        logits_a = decode_fed(decode_step, sparams, cache, cfg, feed)
    logits_b = decode_fed(decode_step_scanned, stacked, twin, cfg, feed)
    return logits_a, logits_b, feed


def route_summary(logits_a, logits_b, targets=None):
    """exp36's figures of the two routes' logits (n, V): greedy agreement
    and, against ``targets`` (n,), each route's mean NLL and perplexity
    (``main_trained``); without targets, the logit differences and the
    agreement where route A's top-2 margin exceeds twice the step's
    largest difference (``main``)."""
    a, b = logits_a.double().cpu(), logits_b.double().cpu()
    n = a.shape[0]
    out = {"greedy_agree": "{}/{}".format(
        int((a.argmax(-1) == b.argmax(-1)).sum()), n)}
    if targets is not None:
        t = targets.long().cpu()[:, None]
        for key, x in (("f32", a), ("int8", b)):
            nll = -torch.log_softmax(x, -1).gather(-1, t)[:, 0]
            out["nll_" + key] = float(nll.mean())
            out["ppl_" + key] = math.exp(out["nll_" + key])
        out["rel_ppl_increase"] = out["ppl_int8"] / out["ppl_f32"] - 1.0
        return out
    d = (a - b).abs()
    top2 = torch.topk(a, 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * d.amax(-1)
    same = a.argmax(-1) == b.argmax(-1)
    out.update(logit_mae_mean=float(d.mean(-1).mean()),
               logit_maxdiff_mean=float(d.amax(-1).mean()),
               logit_maxdiff_max=float(d.max()),
               decisive_agree="{}/{}".format(int(same[decisive].sum()),
                                             int(decisive.sum())),
               logit_scale_ref=float(a[-1].abs().mean()))
    return out
