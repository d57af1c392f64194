"""Int8 attention at long context: what K4's 7-bit probability mix costs.

Usage:
    python examples/llm/int8attn_longctx_torch.py            # untrained
    python examples/llm/int8attn_longctx_torch.py --trained [--write]
    python examples/llm/int8attn_longctx_torch.py --trained --device cpu \\
        --steps 2 --ctx 48 --decode-steps 4

The PyTorch/CUDA port's counterpart of
experiments/exp36_int8attn_longctx.py, in both of its modes, on --device
(default the card; no fallback). One int8 KV cache is prefilled with
--ctx tokens, cloned, and decoded two ways from the same codes: route A,
``decode_step`` (attention in f32 over the int8 cache: K5 on the card),
and route B, ``decode_step_scanned`` at batch 1 (the decode megakernel
K4, whose value mix quantizes the scale-folded probabilities to 7 bits).

- default (exp36 ``main``): an untrained model (vocab 512), a seeded
  random prompt, --decode-steps (64) greedy steps on route A's argmax with
  route B fed the same tokens: logit differences and greedy agreement.
  Flat attention is exp36's adversarial case for the 7-bit mix.
- ``--trained`` (exp36 ``main_trained``): the model trained --steps (250)
  Adam steps at seqlen 2047 (SEQLEN), batch 4, on a 1M-token (STREAM)
  Markov stream (on the card: K10 with its lse output, K11/K12, f32 at
  head_dim 128), RTN int4-g64, then --decode-steps (128) teacher-forced steps of a held-out
  walk: each route's perplexity of the true next token, the relative
  increase, greedy agreement. ``--write`` merges the record under
  ``int8_attn_longctx`` into accuracy/ACCURACY_torch.json (--out), with
  the device it ran on.

The weights come from a torch.Generator seeded SEED (exp36 draws them from
jax.random.PRNGKey(0)), so the figures are the port's own, not the JAX
package's.
"""

import argparse
import json
import os
import sys

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
)

CTX, TRAINED_STEPS, UNTRAINED_STEPS = 1900, 128, 64
SEQLEN = 2047  # training windows of SEQLEN + 1 tokens
STREAM = 1_000_000  # at 40k the d512 model memorised the training walk
SEED = 0
EVAL_WALK_SEED = 4321


def _route_b_is_k4(stacked, cfg):
    """Route B must be the megakernel: the predicate that picks K4 holds
    for this model at batch 1, and on the card K4's count moved."""
    from sparsebit_tpu_torch.llm import decode as D

    if not D._scan_uses_layer_kernel(1, stacked["layers"], "int8", cfg, 1):
        raise RuntimeError("decode_step_scanned would not take K4 here")
    return D.fused_decoder_layers.launches


def _config(args, **kw):
    """exp36's model over 2048 positions, or more where --ctx and
    --decode-steps need them, and the cache's rows: those positions
    rounded up to 128."""
    from sparsebit_tpu_torch.llm import fixture as F

    rows = -(-(args.ctx + args.decode_steps) // 128) * 128
    return F.longctx_config(max_seq_len=max(2048, rows), **kw), rows


def _routes(sparams, stacked, cfg, rows, prompt, device, **kw):
    """Prefill ``prompt`` (1, S) into one int8 cache of ``rows`` rows,
    then decode_routes; checks route B ran K4 on the card."""
    import torch

    from sparsebit_tpu_torch.llm import decode as D
    from sparsebit_tpu_torch.llm.fixture import decode_routes
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache

    before = _route_b_is_k4(stacked, cfg)
    cache = init_kv_cache(cfg, 1, rows, True, device=device)
    logits, cache = D.prefill(sparams, prompt, cache, cfg)
    if kw.get("feed") is None:
        kw["tok0"] = logits.argmax(-1).to(torch.int32)
    out = decode_routes(sparams, stacked, cache, cfg, **kw)
    launched = D.fused_decoder_layers.launches - before
    if device.type == "cuda" and launched != out[1].shape[0]:
        raise RuntimeError("route B launched K4 {} times in {} steps".format(
            launched, out[1].shape[0]))
    return out


def main_trained(args, device):
    import torch

    from sparsebit_tpu_torch import device_line
    from sparsebit_tpu_torch.llm import fixture as F

    cfg, rows = _config(args)
    stream = F.markov_stream(STREAM, cfg.vocab_size)
    params = F.init_longctx_params(cfg, SEED, device=device)
    losses = F.train_on_stream(params, cfg, stream, steps=args.steps,
                               seqlen=SEQLEN)
    print("trained: final train loss %.4f" % losses[-1])
    sparams, stacked = F.quantize_rtn_serving(params, bits=4, groupsize=64)
    ev = F.markov_stream(args.ctx + args.decode_steps + 2, cfg.vocab_size,
                         walk_seed=EVAL_WALK_SEED)
    ev_t = torch.from_numpy(ev).to(device)
    feed = ev_t[args.ctx:args.ctx + args.decode_steps]
    la, lb, _ = _routes(sparams, stacked, cfg, rows, ev_t[None, :args.ctx],
                        device, feed=feed)
    s = F.route_summary(la, lb, ev_t[args.ctx + 1:
                                     args.ctx + 1 + args.decode_steps])
    span = "%d..%d" % (args.ctx, args.ctx + args.decode_steps)
    print(json.dumps({"mode": "TRAINED markov model, ctx ~" + span,
                      "ppl_f32_attn": s["ppl_f32"],
                      "ppl_int8_attn": s["ppl_int8"],
                      "greedy_agree": s["greedy_agree"]}))
    return {
        "config": ("tiny-llama d{} h{}/kv{} trained on a {}-token Markov "
                   "chain at seqlen {}, RTN int4-g64 weights, INT8 KV"
                   .format(cfg.dim, cfg.n_heads, cfg.n_kv_heads, STREAM,
                           SEQLEN)),
        "context_positions": span + " (teacher-forced)",
        "ppl_f32_attention": s["ppl_f32"],
        "ppl_int8_attention": s["ppl_int8"],
        "rel_ppl_increase": s["rel_ppl_increase"],
        "greedy_agree": s["greedy_agree"],
        "train_steps": args.steps,
        "final_train_loss": losses[-1],
        "train_losses_first_last": [losses[0], losses[-1]],
        "seed": SEED,
        "routes": ("A: decode_step (f32 attention over the int8 cache, K5); "
                   "B: decode_step_scanned at batch 1 (K4)"),
        "source": "examples/llm/int8attn_longctx_torch.py --trained",
        "device": device_line(device),
    }


def main_untrained(args, device):
    import torch

    from sparsebit_tpu_torch.llm import fixture as F

    cfg, rows = _config(args, vocab_size=512)
    params = F.init_longctx_params(cfg, SEED, device=device)
    sparams, stacked = F.quantize_rtn_serving(params, bits=4, groupsize=64)
    gen = torch.Generator().manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, args.ctx),
                           generator=gen).to(torch.int32).to(device)
    la, lb, _ = _routes(sparams, stacked, cfg, rows, prompt, device,
                        n=args.decode_steps)
    out = dict(context="positions ~%d..%d" % (args.ctx,
                                              args.ctx + args.decode_steps),
               **F.route_summary(la, lb))
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trained", action="store_true")
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--ctx", type=int, default=CTX)
    ap.add_argument("--decode-steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--write", action="store_true",
                    help="--trained: merge the record into --out")
    ap.add_argument(
        "--out",
        default=os.path.join(os.path.dirname(__file__), "..", "..",
                             "accuracy", "ACCURACY_torch.json"),
    )
    args = ap.parse_args(argv)
    if args.decode_steps is None:
        args.decode_steps = TRAINED_STEPS if args.trained else UNTRAINED_STEPS

    import torch

    from sparsebit_tpu_torch import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if not args.trained:
        return main_untrained(args, device)
    rec = main_trained(args, device)
    if args.write:
        out = os.path.abspath(args.out)
        existing = {}
        if os.path.exists(out):
            with open(out) as f:
                existing = json.load(f)
        existing["int8_attn_longctx"] = rec
        with open(out, "w") as f:
            json.dump(existing, f, indent=2)
        print("wrote", out)
    return rec


if __name__ == "__main__":
    main()
