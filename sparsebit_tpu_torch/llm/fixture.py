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
"""

import numpy as np
import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.convert import quantize_llama_gptq
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


def train_tiny_llama(cfg, corpus, steps=200, batch=8, seqlen=64, lr=3e-3,
                     seed=0, verbose=False, *, params=None, device=None):
    """Adam on the next-token loss; deterministic given the seeds. Starts
    from ``params`` (trained in place) or from init_llama_params drawn by
    a CPU generator seeded ``seed``, on ``device`` (default the card)."""
    dev = resolve_device(device)
    if params is None:
        params = L.init_llama_params(
            cfg, torch.Generator().manual_seed(seed), device=dev)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr)

    n_windows = len(corpus) // (seqlen + 1)
    windows = torch.as_tensor(
        corpus[: n_windows * (seqlen + 1)].reshape(n_windows, seqlen + 1),
        device=dev).long()
    gen = torch.Generator().manual_seed(seed + 1)
    for i in range(steps):
        idx = torch.randint(0, n_windows, (batch,), generator=gen)
        loss = L.llama_loss(params, windows[idx.to(dev)], cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if verbose and (i + 1) % 50 == 0:
            print("train step {}: loss {:.4f}".format(i + 1, loss.item()))
    opt.zero_grad(set_to_none=True)
    for t in leaves:
        t.requires_grad_(False)
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
