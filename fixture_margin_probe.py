#!/usr/bin/env python3
"""How far the accuracy fixture's GPTQ-vs-RTN claim sits from its noise.

tests/test_fixture.py holds, for the fixture's trained tiny LLaMA,
int4 GPTQ ppl <= RTN ppl x 1.002. This script measures the margin
GPTQ / RTN - 1 (int4, g32, the fixture's 48 calibration windows and
4096 held-out tokens) over models that differ only in how they were
trained:

    # CPU, one thread: the margin for training seeds A..B-1, in the
    # port and in the JAX package (each trains its own model)
    JAX_PLATFORMS=cpu python fixture_margin_probe.py --seeds 0 20

    # on the card: train the port's fixture model (seed 0) twice, report
    # whether the two runs are bit-equal, save the weights
    python fixture_margin_probe.py --save fixture_card.pt

    # CPU: float / RTN / GPTQ ppl of saved weights in the port and in the
    # JAX package (the weights carried across)
    JAX_PLATFORMS=cpu python fixture_margin_probe.py \
        --weights fixture_card.pt

The JAX package is imported only by the CPU modes.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEQLEN = 64


def _data():
    from sparsebit_tpu_torch.llm import fixture as F

    corpus = F.make_markov_corpus(40_000, 256, seed=0)
    train = corpus[:-8192]
    calib = train[: 48 * (SEQLEN + 1)].reshape(48, SEQLEN + 1)[:, :SEQLEN]
    return train, F.fixture_eval_tokens(corpus, 4096), calib


def port_ppls(params, device):
    """(float, RTN int4, GPTQ int4) perplexity of the port's params."""
    from sparsebit_tpu_torch.llm import fixture as F
    from sparsebit_tpu_torch.llm import llama as L
    from sparsebit_tpu_torch.llm.quant import QuantLinear

    _, ev, calib = _data()
    cfg = F.fixture_config()
    rtn = L.quantize_llama_params(
        params, lambda p, lin: QuantLinear.from_dense(
            lin.w.to(torch.float32), bits=4, groupsize=32))
    gptq, _ = F.quantize_llama_gptq(params, calib, cfg, candidate_bits=(4,),
                                    groupsize=32, verbose=False,
                                    device=device)
    return tuple(F.perplexity(p, ev, cfg, seqlen=SEQLEN, device=device)
                 for p in (params, rtn, gptq))


def jax_ppls(params):
    """The same three perplexities in the JAX package."""
    import jax.numpy as jnp

    from sparsebit_tpu.llm import fixture as JF
    from sparsebit_tpu.llm import llama as JL
    from sparsebit_tpu.llm.convert import quantize_llama_gptq
    from sparsebit_tpu.llm.eval import perplexity
    from sparsebit_tpu.llm.quant import QuantLinear

    _, ev, calib = _data()
    cfg = JF.fixture_config()
    rtn = JL.quantize_llama_params(
        params, lambda p, lin: QuantLinear.from_dense(
            lin.w.astype(jnp.float32), bits=4, groupsize=32))
    gptq, _ = quantize_llama_gptq(params, jnp.asarray(calib), cfg,
                                  candidate_bits=(4,), groupsize=32,
                                  verbose=False)
    return tuple(perplexity(p, ev, cfg, seqlen=SEQLEN)
                 for p in (params, rtn, gptq))


def to_jax(params):
    """The port's dense params as the JAX package's."""
    import jax.numpy as jnp

    from sparsebit_tpu.llm.quant import DenseLinear

    if hasattr(params, "w"):
        return DenseLinear(jnp.asarray(params.w.cpu().numpy()))
    if isinstance(params, dict):
        return {k: to_jax(v) for k, v in params.items()}
    if isinstance(params, list):
        return [to_jax(v) for v in params]
    return jnp.asarray(params.cpu().numpy())


def report(tag, ppls):
    f, r, g = ppls
    print("{}: float {:.6f} RTN {:.6f} GPTQ {:.6f}  GPTQ/RTN - 1 = "
          "{:+.4%}{}".format(tag, f, r, g, g / r - 1,
                             "  (misses x 1.002)" if g > 1.002 * r
                             else ""), flush=True)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs=2, metavar=("A", "B"))
    ap.add_argument("--save", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from sparsebit_tpu_torch.llm import fixture as F

    train, _, _ = _data()
    cfg = F.fixture_config()
    if args.save:
        runs = [F.train_tiny_llama(cfg, train, steps=200,
                                   device=args.device) for _ in range(2)]
        a, b = (F._leaves(p) for p in runs)
        print("two trainings on {}: bit-equal {}".format(
            args.device, all(torch.equal(x, y) for x, y in zip(a, b))))
        report("port on {}".format(args.device),
               port_ppls(runs[0], args.device))
        torch.save([t.cpu() for t in a], args.save)
        return 0
    torch.set_num_threads(1)
    if args.weights:
        params = F.L.init_llama_params(cfg, device="cpu")
        for dst, src in zip(F._leaves(params), torch.load(args.weights)):
            dst.copy_(src)
        report("port on the CPU, saved weights", port_ppls(params, "cpu"))
        report("JAX on the CPU, saved weights", jax_ppls(to_jax(params)))
        return 0
    from sparsebit_tpu.llm import fixture as JF

    for seed in range(*args.seeds):
        params = F.train_tiny_llama(cfg, train, steps=200, seed=seed,
                                    device="cpu")
        report("port seed {}".format(seed), port_ppls(params, "cpu"))
        report("JAX seed {}".format(seed), jax_ppls(JF.train_tiny_llama(
            JF.fixture_config(), train, steps=200, seed=seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
