"""Structured (channel) pruning of resnet18 at ImageNet scale with a
masked finetune, on the PyTorch port (the port of ``main.py`` beside it;
reference: examples/structured_prune/imagenet1k/).

Flow: SparseModel -> calc_params (the stem conv and the classifier dense
through SPECIFIC) -> a masked finetune, ``torch.optim.SGD(lr,
momentum=0.9)`` over the model's parameters: the masks are buffers
outside the optimizer and the masked weights take no gradient through
the product, so nothing is frozen by hand. Data parallelism as the JAX
CLI's: under ``torchrun`` (its variables set) each rank, one a card,
finetunes on its rows of every global batch (``--batch`` is the global
batch), BatchNorm takes its statistics over the global batch
(``nn.data_parallel``), as under the JAX CLI's jit, and the
gradients are averaged over the ranks before each step; every rank
computes the masks on the same data and rank 0's parameters are
broadcast before the finetune. Without torchrun it runs on one rank.
Runs on the card unless --device names another device. --data takes an
npz with x (N, H, W, 3) and y (N); without it, seeded random tensors
drive the flow.

    python main_torch.py --sconfig sconfig.yaml [--data imagenet.npz] [--finetune-steps 100]
    python -m torch.distributed.run --nproc_per_node 8 main_torch.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as TF  # noqa: E402

from sparsebit_tpu_torch import SparseModel, parse_sconfig  # noqa: E402
from sparsebit_tpu_torch import resolve_device  # noqa: E402
from sparsebit_tpu_torch.models import create_model  # noqa: E402
from sparsebit_tpu_torch.nn import load_jax_state_dict  # noqa: E402
from sparsebit_tpu_torch.nn import data_parallel  # noqa: E402
from sparsebit_tpu_torch.parallel.mesh import (  # noqa: E402
    data_parallel_mesh,
    dp_shard_batch,
    replicate,
    sum_grads,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sconfig", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "sconfig.yaml"))
    ap.add_argument("--data", default=None, help="npz with x (N,H,W,3), y (N)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--finetune-steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--export", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = data_parallel_mesh(device)
    n_dp = 1 if mesh is None else mesh["dp"].size()
    if args.batch % n_dp:
        raise SystemExit("--batch {} does not split over {} data-parallel "
                         "ranks: give a multiple of {}".format(
                             args.batch, n_dp, n_dp))

    model = create_model("resnet18", device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()

    if args.data:
        z = np.load(args.data)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int64)
    else:
        print("[warn] no --data; random tensors (flow demo)")
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2 * args.batch, args.img, args.img, 3)).astype(
            np.float32)
        y = rng.integers(0, 1000, size=(2 * args.batch,))

    def batch(j):
        return (torch.from_numpy(x[j:j + args.batch]).to(device),
                torch.from_numpy(y[j:j + args.batch]).to(device))

    cfg = parse_sconfig(args.sconfig)
    smodel = SparseModel(model, cfg, (batch(0)[0],))
    smodel.calc_params()
    print("global sparsity after calc_params: {:.3f}".format(
        smodel.sparsity()))

    # ---- masked finetune, data parallel under torchrun -----------------------
    params = list(model.parameters())
    group = None if mesh is None else mesh.get_group("dp")
    if mesh is not None:
        replicate(mesh, params)
    opt = torch.optim.SGD(params, lr=args.lr, momentum=0.9)
    smodel.train()
    loss = torch.tensor(float("nan"))
    try:
        for i in range(args.finetune_steps):
            j = (i * args.batch) % (len(x) - args.batch + 1)
            xb, yb = batch(j)
            if mesh is not None:
                xb, yb = dp_shard_batch(mesh, xb), dp_shard_batch(mesh, yb)
            with data_parallel(group, smodel):
                loss = TF.cross_entropy(smodel(xb), yb)
            opt.zero_grad()
            loss.backward()
            if mesh is not None:
                sum_grads(params, mesh, mean=True)
            opt.step()
        loss = loss.detach()
        if mesh is not None:  # the global batch's mean
            dist.all_reduce(loss, group=mesh.get_group("dp"))
            loss /= n_dp
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    print("finetune done ({} steps), last loss {:.4f}".format(
        args.finetune_steps, loss.item()))
    smodel.eval()
    if args.export:
        smodel.export(args.export, batch(0)[0])
        print("exported to", args.export)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return {"sparsity": smodel.sparsity(), "loss": loss.item(),
            "smodel": smodel, "state": state}


if __name__ == "__main__":
    main()
