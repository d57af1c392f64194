"""Unstructured (elementwise) L1 pruning of the cifar resnet20 on the
PyTorch port (the port of ``main.py`` beside it; reference:
examples/unstructured_prune/cifar10/main.py, whose DDP training loop
around SparseModel is out of this demo's scope: it drives the
SparseModel flow on seeded tensors and reports the mask sparsity).
--ratio overrides SPARSER.RATIO; --export writes a ``torch.export``
program of the masked model. Runs on the card unless --device names
another device.

    python main_torch.py --sconfig sconfig.yaml [--ratio 0.7] [--export out]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sparsebit_tpu_torch import SparseModel, parse_sconfig  # noqa: E402
from sparsebit_tpu_torch import resolve_device  # noqa: E402
from sparsebit_tpu_torch.models import create_model  # noqa: E402
from sparsebit_tpu_torch.nn import load_jax_state_dict  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sconfig", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "sconfig.yaml"))
    ap.add_argument("--ratio", type=float, default=None,
                    help="override SPARSER.RATIO")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--export", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = create_model("resnet20", device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()

    cfg = parse_sconfig(args.sconfig)
    if args.ratio is not None:
        cfg.defrost()
        cfg.SPARSER.RATIO = args.ratio
        cfg.freeze()

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 32, 32, 3)).astype(np.float32)).to(device)
    smodel = SparseModel(model, cfg, (x,))
    smodel.calc_params()
    with torch.no_grad():
        out = smodel(x)
    print("output {}, global sparsity {:.3f} (requested {})".format(
        tuple(out.shape), smodel.sparsity(), cfg.SPARSER.RATIO))
    if args.export:
        smodel.export(args.export, x)
        print("exported to", args.export)
    return {"sparsity": smodel.sparsity(), "smodel": smodel}


if __name__ == "__main__":
    main()
