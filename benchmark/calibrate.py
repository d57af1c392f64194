"""Readings that set the limits of a cell's check, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 [--control] [--fault half|loss|unchanged] \
        [--score-sd X]

For each seed, one short run of the cell (set-up, a window of
``--seconds``, the drain) and the numbers its check compares, then:

- ``--control``: the same numbers for the reference put in the
  program's place, on the same inputs. Serving: int4 activations and
  int4 K/V (the control), int4 K/V alone, and the fault of a cache that
  the served tokens' K/V never reach, each position's first choice read
  under the reference. Training: the backbone's forward product on fp8
  operands (the control), and on TF32 and bf16 operands, which the
  configuration allows;
- ``--fault half`` (training): the program's step with its loss taken
  over the first half of the batch only; ``--fault loss``: the step's
  loss altered by 1 % where it is produced; ``--fault unchanged``: no
  optimiser step;
- ``--score-sd``: the configuration's ``score_sd`` replaced (weights
  whose attention scores spread more or less).

One JSON line a seed. A state left unchanged reads 1 by the training
numbers' measure and needs no run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def half_batch_step(lora, optimizer, params, tokens, cfg):
    from sparsebit_tpu_torch.llm import qlora as Q

    return Q.qlora_train_step(lora, optimizer, params,
                              tokens[: tokens.shape[0] // 2], cfg)


def altered_loss_step(lora, optimizer, params, tokens, cfg):
    from sparsebit_tpu_torch.llm import qlora as Q

    lora, loss = Q.qlora_train_step(lora, optimizer, params, tokens, cfg)
    return lora, loss * 1.01


def unchanged_state_step(lora, optimizer, params, tokens, cfg):
    """The loss and its gradients, and no optimiser step."""
    from sparsebit_tpu_torch.llm import qlora as Q

    optimizer.zero_grad(set_to_none=True)
    loss = Q.qlora_loss_fn(lora, params, tokens, cfg)
    loss.backward()
    return lora, loss.detach()


FAULTS = {"half": half_batch_step, "loss": altered_loss_step,
          "unchanged": unchanged_state_step}


SERVE_CONTROLS = {"control": {"act_bits": 4, "kv_bits": 4},
                  "kv4": {"kv_bits": 4}, "frozen_cache": {"frozen": True}}
TRAIN_CONTROLS = ("fp8", "tf32", "bf16")


def readings(ctx, control):
    """One run of ctx's cell and the numbers its check compares: the
    program's, and with ``control`` the controls' and the planted
    reference faults'."""
    from benchmark.lib import harness as H
    from benchmark.lib import serve, train

    line = {"seed": ctx.seed}
    if ctx.traffic["loop"] == "serve":
        reqs = serve.sample(serve.run(ctx), ctx.traffic["check_sample"],
                            ctx.seed)
        H._free()
        gap, ref = serve.reference_gaps(ctx, reqs)
        line.update(program={"served_logit_gap": gap},
                    tokens=sum(len(r.tokens) for r in reqs))
        if control:
            for name, kw in SERVE_CONTROLS.items():
                cgap, _ = serve.reference_gaps(ctx, reqs, against=ref, **kw)
                line[name] = {"served_logit_gap": cgap}
    else:
        batches, lora0, losses, first, after = train.run(ctx)
        H._free()
        r = train.reference(ctx, batches, lora0)
        line["program"] = H.train_gaps(losses, first, after, lora0, *r)
        if control:
            for mode in TRAIN_CONTROLS:
                c = train.reference(ctx, batches, lora0, forward=mode)
                line["control_" + mode] = H.train_gaps(c[0], c[1], c[2],
                                                       lora0, *r)
    line["setup_s"] = ctx.setup_s
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None, choices=sorted(FAULTS))
    ap.add_argument("--score-sd", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib import harness as H
    from benchmark.reference.decoder import no_tf32

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    no_tf32()
    man = H.Manifest(ROOT)
    cell = man.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        faults = {"train_step": FAULTS[args.fault]} if args.fault else {}
        mc = man.config(cell["config"])
        if args.score_sd is not None:
            mc["score_sd"] = args.score_sd
        ctx = H.Run(args.workload, mc,
                    man.traffic(cell["traffic"]), man.limits(args.workload),
                    seed, args.seconds, False, torch.device("cuda"),
                    time.perf_counter(), faults)
        line = readings(ctx, args.control)
        line.update(fault=args.fault, score_sd=mc.get("score_sd", 1.0))
        print(json.dumps(line), flush=True)
        del ctx
        H._free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
