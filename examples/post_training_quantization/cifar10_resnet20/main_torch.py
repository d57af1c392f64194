"""PTQ on the PyTorch port: resnet20 / CIFAR-10 (the port of ``main.py``
beside it; reference: examples/post_training_quantization/cifar10/
basecase/main.py).

Flow: QuantModel -> calibrate -> calc_qparams -> fake-quant eval, and
with --export a ``torch.export`` program plus the quant-metadata sidecar
(``QuantModel.export``). --ckpt loads an npz of the JAX package's
``full_state_dict`` layout. Runs on the card unless --device names
another device.

    python main_torch.py [--data cifar_test.npz] [--export out/]
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


def load_data(path, n_calib, n_eval):
    if path:
        z = np.load(path)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int64)
    else:
        print("[warn] no --data given; using random tensors (flow demo)")
        rng = np.random.default_rng(0)
        x = rng.normal(size=(n_calib + n_eval, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=(n_calib + n_eval,))
    return ((x[:n_calib], y[:n_calib]),
            (x[n_calib:n_calib + n_eval], y[n_calib:n_calib + n_eval]))


@torch.no_grad()
def accuracy(model_fn, x, y, device, batch=128):
    correct = 0
    for i in range(0, len(x), batch):
        logits = model_fn(torch.from_numpy(x[i:i + batch]).to(device))
        correct += int((logits.argmax(-1).cpu()
                        == torch.from_numpy(y[i:i + batch])).sum())
    return correct / len(x)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qconfig", default=os.path.join(HERE, "qconfig.yaml"))
    ap.add_argument("--data", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="npz full_state_dict of the float model")
    ap.add_argument("--calib-batches", type=int, default=16)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--eval-samples", type=int, default=2048)
    ap.add_argument("--export", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = create_model("resnet20", device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()
    (cx, _), (ex, ey) = load_data(args.data, args.calib_batches * args.batch,
                                  args.eval_samples)
    qmodel = QuantModel(model, parse_qconfig(args.qconfig),
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
