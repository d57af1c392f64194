"""PTQ basecase on the PyTorch port: ImageNet-1k CNNs (the port of
``main.py`` beside it; reference:
examples/post_training_quantization/imagenet1k/basecase/main.py:152-229).

Flow: build the model -> QuantModel -> prepare_calibration -> forward the
calibration batches -> calc_qparams -> set_quant -> evaluate, on any of
the reference's basecase CNNs (resnet18/34/50, mobilenet_v2,
efficientnet_lite0, regnetx_600mf). --export
writes a ``torch.export`` program of the fake-quant model and the
quant-metadata sidecar (``QuantModel.export``).

Data: --data points at an npz with arrays x (N, 224, 224, 3 float,
normalized, NHWC) and y (N int). Without it, seeded random tensors drive
the flow end to end. --ckpt loads an npz of the JAX package's
``full_state_dict`` layout (the file main.py loads), transposed on load.
The qconfig is a yaml file (PyYAML reads it). Runs on the card unless
--device names another device.

    python main_torch.py --model resnet18 [--data val.npz] [--ckpt r18.npz]
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

MODELS = ("resnet18", "resnet34", "resnet50", "mobilenet_v2",
          "efficientnet_lite0", "regnetx_600mf")


def load_data(path, n_calib, n_eval, size=224):
    if path:
        z = np.load(path)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int64)
    else:
        print("[warn] no --data given; using random tensors (flow demo)")
        rng = np.random.default_rng(0)
        x = rng.normal(size=(n_calib + n_eval, size, size, 3)).astype(
            np.float32)
        y = rng.integers(0, 1000, size=(n_calib + n_eval,))
    return ((x[:n_calib], y[:n_calib]),
            (x[n_calib:n_calib + n_eval], y[n_calib:]))


@torch.no_grad()
def accuracy(model_fn, x, y, device, batch=64):
    correct = 0
    for i in range(0, len(x), batch):
        logits = model_fn(torch.from_numpy(x[i:i + batch]).to(device))
        correct += int((logits.argmax(-1).cpu()
                        == torch.from_numpy(y[i:i + batch])).sum())
    return correct / len(x)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet18", choices=MODELS)
    ap.add_argument("--qconfig", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "qconfig.yaml"))
    ap.add_argument("--data", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="npz full_state_dict of the float model")
    ap.add_argument("--calib-batches", type=int, default=16)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval-samples", type=int, default=2048)
    ap.add_argument("--export", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = create_model(args.model, device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()
    (cx, _), (ex, ey) = load_data(args.data, args.calib_batches * args.batch,
                                  args.eval_samples)
    cfg = parse_qconfig(args.qconfig)
    qmodel = QuantModel(model, cfg,
                        (torch.from_numpy(cx[:args.batch]).to(device),))
    qmodel.prepare_calibration()
    for i in range(0, len(cx), args.batch):
        qmodel(torch.from_numpy(cx[i:i + args.batch]).to(device))
    qmodel.calc_qparams()

    results = {}
    if args.ckpt or args.data:
        qmodel.set_quant(w_quant=False, a_quant=False)
        results["float_acc"] = accuracy(qmodel, ex, ey, device, args.batch)
        print("float acc: {:.4f}".format(results["float_acc"]))
    qmodel.set_quant(w_quant=True, a_quant=True)
    results["int8_acc"] = accuracy(qmodel, ex, ey, device, args.batch)
    print("int8 acc: {:.4f}".format(results["int8_acc"]))
    if args.export:
        qmodel.export(args.export,
                      torch.from_numpy(ex[:args.batch]).to(device))
        print("exported to", args.export)
    return results


if __name__ == "__main__":
    main()
