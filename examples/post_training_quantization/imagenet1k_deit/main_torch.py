"""PTQ on the PyTorch port: DeiT / ViT on ImageNet-1k (the port of
``main.py`` beside it; reference: examples/post_training_quantization/
imagenet1k/deit/main.py): NLC layout, MSE observers, LayerNorm and
softmax left in float (qconfig.yaml).

Flow: QuantModel -> calibrate --calib-batches -> calc_qparams ->
fake-quant eval on the last --eval-samples images -> the five layers of
largest quantization error (``QuantModel.get_quantization_error``).
--ckpt loads an npz of the JAX package's ``full_state_dict`` layout.
Runs on the card unless --device names another device.

    python main_torch.py --model deit_small [--data val.npz]
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
    ap.add_argument("--model", default="deit_tiny",
                    choices=["deit_tiny", "deit_small", "deit_base"])
    ap.add_argument("--qconfig", default=os.path.join(HERE, "qconfig.yaml"))
    ap.add_argument("--data", default=None, help="npz x (N,224,224,3), y (N)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--calib-batches", type=int, default=8)
    ap.add_argument("--eval-samples", type=int, default=256)
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = create_model(args.model, img_size=args.img, device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()
    if args.data:
        z = np.load(args.data)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int64)
    else:
        print("[warn] no --data; random tensors (flow demo)")
        x = np.random.default_rng(0).normal(
            size=(args.calib_batches * args.batch + args.eval_samples,
                  args.img, args.img, 3)).astype(np.float32)
        y = np.zeros(len(x), np.int64)

    def images(lo, hi):
        return torch.from_numpy(x[lo:hi]).to(device)

    qmodel = QuantModel(model, parse_qconfig(args.qconfig),
                        (images(0, args.batch),))
    qmodel.prepare_calibration()
    for i in range(args.calib_batches):
        qmodel(images(i * args.batch, (i + 1) * args.batch))
    qmodel.calc_qparams()
    qmodel.set_quant(w_quant=True, a_quant=True)

    lo = len(x) - args.eval_samples
    correct = 0
    with torch.no_grad():
        for i in range(lo, len(x), args.batch):
            logits = qmodel(images(i, i + args.batch))
            correct += int((logits.argmax(-1).cpu() == torch.from_numpy(
                y[i:i + args.batch])).sum())
    top1 = correct / args.eval_samples
    print("int8 top-1: {:.4f}".format(top1))

    err = qmodel.get_quantization_error(images(lo, lo + args.batch))
    worst = sorted(err.items(), key=lambda kv: -kv[1])[:5]
    print("worst-5 layers by quant error:", worst)
    return {"int8_top1": top1, "worst": worst}


if __name__ == "__main__":
    main()
