"""Unstructured pruning of a BERT QA model (SQuAD regime) on the PyTorch
port (the port of ``main.py`` beside it; reference:
examples/unstructured_prune/SQuAD/main.py): span-extraction start / end
heads, encoder linears masked elementwise, embeddings and the QA head
kept dense through SPECIFIC.

--data takes a pre-tokenized npz (input_ids (N, L), start (N), end
(N)); without it a synthetic span-recovery task drives the flow (the
answer span is bracketed by a marker token the encoder must find). The
iterative magnitude schedule raises the mask ratio every --ratio-steps
finetune steps and recomputes the masks from the current weights; the
nodes SPECIFIC keeps at ratio 0 stay dense (the JAX CLI raises every
sparser, qa_outputs included: reference fault R12). The finetune is
``torch.optim.AdamW(lr, weight_decay=1e-4)`` (optax.adamw's default
decay) over the model's parameters; the masks are buffers outside it and
stay exactly {0, 1} (the JAX CLI decays its masks: reference fault R11).
One card; runs on the card unless --device names another device.

    python main_torch.py --sconfig sconfig.yaml [--data squad_tok.npz]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as TF  # noqa: E402

from sparsebit_tpu_torch import SparseModel, parse_sconfig  # noqa: E402
from sparsebit_tpu_torch import resolve_device  # noqa: E402
from sparsebit_tpu_torch.models import create_model  # noqa: E402
from sparsebit_tpu_torch.nn import load_jax_state_dict  # noqa: E402


def synth_span_data(n, seqlen=48, vocab=1024, seed=0, mark=7):
    """Synthetic extractive QA: a random token stream whose answer span is
    bracketed by ``mark`` tokens; the start / end labels point inside the
    brackets (main.py's generator, the same arrays)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(8, vocab, size=(n, seqlen), dtype=np.int64)
    starts = rng.integers(1, seqlen - 6, size=n)
    lens = rng.integers(1, 4, size=n)
    ends = np.minimum(starts + lens, seqlen - 2)
    for i in range(n):
        x[i, starts[i] - 1] = mark
        x[i, ends[i] + 1] = mark
    return x.astype(np.int32), starts.astype(np.int64), ends.astype(np.int64)


def span_loss(smodel, xb, sb, eb):
    start_logits, end_logits = smodel(xb)
    return 0.5 * (TF.cross_entropy(start_logits, sb)
                  + TF.cross_entropy(end_logits, eb))


def set_ratio(smodel, ratio):
    """The schedule's ratio on every sparser SPECIFIC did not set to 0."""
    for _, op in smodel.smodules():
        if op.sparser is not None and op.sparser.ratio > 0.0:
            op.sparser.ratio = ratio


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sconfig", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "sconfig.yaml"))
    ap.add_argument("--data", default=None,
                    help="npz with input_ids (N,L), start (N), end (N)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ratio-steps", type=int, default=20,
                    help="re-ratchet the mask every this many steps")
    ap.add_argument("--ratios", default="0.2,0.35,0.5",
                    help="iterative magnitude schedule (final = sconfig RATIO)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = create_model("bert_qa_tiny", device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()

    if args.data:
        z = np.load(args.data)
        x, ys, ye = (z["input_ids"].astype(np.int32),
                     z["start"].astype(np.int64), z["end"].astype(np.int64))
    else:
        print("[warn] no --data; synthetic span-recovery task (flow demo)")
        x, ys, ye = synth_span_data(4 * args.batch)

    def batch(j):
        return tuple(torch.from_numpy(a[j:j + args.batch]).to(device)
                     for a in (x, ys, ye))

    cfg = parse_sconfig(args.sconfig)
    smodel = SparseModel(model, cfg, (batch(0)[0],))
    smodel.train()

    ratios = [float(r) for r in args.ratios.split(",")]
    ri = -1
    sparsity = []
    loss = torch.tensor(float("nan"))
    for i in range(args.steps):
        if i % args.ratio_steps == 0 and ri + 1 < len(ratios):
            # iterative magnitude schedule: raise the ratio and recompute
            # the masks from the finetuned magnitudes; a fresh optimizer,
            # as main.py re-initialises its state
            ri += 1
            set_ratio(smodel, ratios[ri])
            smodel.calc_params()
            opt = torch.optim.AdamW(model.parameters(), lr=args.lr,
                                    weight_decay=1e-4)
            sparsity.append(smodel.sparsity())
            print("step {}: mask ratio -> {} (global sparsity {:.3f})".format(
                i, ratios[ri], sparsity[-1]))
        j = (i * args.batch) % (len(x) - args.batch + 1)
        loss = span_loss(smodel, *batch(j))
        opt.zero_grad()
        loss.backward()
        opt.step()
    print("done: final loss {:.4f}, sparsity {:.3f}".format(
        loss.item(), smodel.sparsity()))

    # exact-match on the tail batch (the reference reports SQuAD EM/F1)
    smodel.eval()
    with torch.no_grad():
        sl, el = smodel(torch.from_numpy(x[-args.batch:]).to(device))
    em = float(np.mean(
        (sl.argmax(-1).cpu().numpy() == ys[-args.batch:])
        & (el.argmax(-1).cpu().numpy() == ye[-args.batch:])))
    print("span exact-match on eval tail: {:.3f}".format(em))
    return {"loss": loss.item(), "sparsity": sparsity, "em": em,
            "smodel": smodel}


if __name__ == "__main__":
    main()
