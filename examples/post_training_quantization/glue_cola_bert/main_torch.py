"""PTQ BERT on GLUE/CoLA-style classification on the PyTorch port (the
port of ``main.py`` beside it; reference: examples/post_training_
quantization/GLUE/CoLA/main.py, its postquant mode; finetuning is any
standard loop): percentile activation observers, LayerNorm and softmax
left in float (qconfig.yaml).

--ckpt loads an npz of the JAX package's ``full_state_dict`` layout.
Runs on the card unless --device names another device.

    python main_torch.py --data cola_tokens.npz [--ckpt bert.npz]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sparsebit_tpu_torch import QuantModel, parse_qconfig  # noqa: E402
from sparsebit_tpu_torch import resolve_device  # noqa: E402
from sparsebit_tpu_torch.models import create_model  # noqa: E402
from sparsebit_tpu_torch.nn import load_jax_state_dict  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="bert_base",
                    choices=["bert_base", "bert_tiny"])
    ap.add_argument("--qconfig", default=os.path.join(HERE, "qconfig.yaml"))
    ap.add_argument("--data", default=None,
                    help="npz: input_ids (N,S) int, label (N)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--calib-batches", type=int, default=8)
    ap.add_argument("--eval-samples", type=int, default=256)
    ap.add_argument("--seqlen", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = create_model(args.model, device=device)
    vocab = model.embeddings.word_embeddings.num_embeddings
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()
    if args.data:
        z = np.load(args.data)
        ids, labels = z["input_ids"].astype(np.int32), z["label"]
    else:
        print("[warn] no --data; random tokens (flow demo)")
        rng = np.random.default_rng(0)
        ids = rng.integers(0, vocab, size=(
            args.calib_batches * args.batch + args.eval_samples,
            args.seqlen)).astype(np.int32)
        labels = rng.integers(0, 2, size=(len(ids),))

    def tokens(lo, hi):
        return torch.from_numpy(ids[lo:hi]).to(device)

    qmodel = QuantModel(model, parse_qconfig(args.qconfig),
                        (tokens(0, args.batch),))
    qmodel.prepare_calibration()
    for i in range(args.calib_batches):
        qmodel(tokens(i * args.batch, (i + 1) * args.batch))
    qmodel.calc_qparams()
    qmodel.set_quant(w_quant=True, a_quant=True)

    lo = len(ids) - args.eval_samples
    correct = 0
    with torch.no_grad():
        for i in range(lo, len(ids), args.batch):
            logits = qmodel(tokens(i, i + args.batch))
            correct += int((logits.argmax(-1).cpu() == torch.from_numpy(
                np.asarray(labels[i:i + args.batch]))).sum())
    acc = correct / args.eval_samples
    print("int8 acc: {:.4f}".format(acc))
    return {"int8_acc": acc}


if __name__ == "__main__":
    main()
