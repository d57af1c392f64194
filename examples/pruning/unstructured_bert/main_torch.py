"""Unstructured pruning of the BERT encoder on the PyTorch port (the port
of ``main.py`` beside it; reference:
examples/unstructured_prune/{GLUE/bert,SQuAD}/main.py): the zoo
BertModel's encoder linears masked elementwise at RATIO, the embeddings
and the task head kept dense through SPECIFIC. Runs on the card unless
--device names another device.

    python main_torch.py --sconfig sconfig.yaml [--ratio 0.7]
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
from sparsebit_tpu_torch.models.bert import BertModel  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sconfig", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "sconfig.yaml"))
    ap.add_argument("--ratio", type=float, default=None)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = BertModel(
        vocab_size=1024, dim=args.dim, depth=args.depth, num_heads=2,
        ffn_dim=4 * args.dim, num_classes=2,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device).eval()

    cfg = parse_sconfig(args.sconfig)
    if args.ratio is not None:
        cfg.defrost()
        cfg.SPARSER.RATIO = args.ratio
        cfg.freeze()

    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1024, size=(4, 32)).astype(np.int32)).to(device)
    smodel = SparseModel(model, cfg, (ids,))
    smodel.calc_params()
    with torch.no_grad():
        out = smodel(ids)
    print("logits {}, encoder sparsity {:.3f} (requested {})".format(
        tuple(out.shape), smodel.sparsity(), cfg.SPARSER.RATIO))
    return {"sparsity": smodel.sparsity(), "smodel": smodel}


if __name__ == "__main__":
    main()
