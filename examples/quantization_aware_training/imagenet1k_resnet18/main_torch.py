"""QAT on the PyTorch port: resnet18 / ImageNet with LSQ, LSQ+, PACT or
DoReFa (the port of ``main.py`` beside it; reference:
examples/quantization_aware_training/imagenet1k/basecase/main.py:233-255).

Flow: QuantModel -> 8-bit head and tail (each yaml's SPECIFIC section;
the reference overrides them in code, main.py:236-239) -> calibrate 4
batches -> init_QAT -> a torch.optim training loop over
``QuantModel.trainable_params()`` (``tools/qat.py``). Pick the quantizer
with --qconfig qconfig_{lsq,lsq_plus,pact,dorefa}.yaml. The yamls are
read without PyYAML where it is missing (``utils/config.load_yaml``).

Data parallelism as the JAX CLI's: under ``torchrun`` (its variables
set) each rank, one a card, trains on its rows of every global batch
(``--batch`` is the global batch), BatchNorm takes its statistics over
the global batch and LSQ's gradient scale counts its elements
(``nn.data_parallel``), as under the JAX CLI's jit, and the
gradients are averaged over the ranks before each step.
Every rank calibrates on the same whole batches, as the JAX CLI does, and
rank 0's trainables are broadcast before training. Without torchrun it
runs on one rank. Runs on the card unless --device names another device.

    python main_torch.py --qconfig qconfig_lsq.yaml [--data train.npz]
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

from sparsebit_tpu_torch import QuantModel, parse_qconfig  # noqa: E402
from sparsebit_tpu_torch import resolve_device  # noqa: E402
from sparsebit_tpu_torch.models import create_model  # noqa: E402
from sparsebit_tpu_torch.parallel.mesh import (  # noqa: E402
    data_parallel_mesh,
    dp_shard_batch,
    replicate,
)
from sparsebit_tpu_torch.quantization.tools.qat import (  # noqa: E402
    commit_qat_params,
    cross_entropy,
    init_qat_state,
    make_qat_step,
)

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qconfig", default=os.path.join(HERE, "qconfig_lsq.yaml"))
    ap.add_argument("--data", default=None, help="npz with x (N,H,W,3), y (N)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = data_parallel_mesh(device)
    n_dp = 1 if mesh is None else mesh["dp"].size()
    if args.batch % n_dp:
        raise SystemExit("the global batch must divide the dp axis")
    print("ranks: {} (dp={})".format(n_dp, n_dp))

    if args.data:
        z = np.load(args.data)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int64)
    else:
        print("[warn] no --data; random tensors (flow demo)")
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2 * args.batch, args.img, args.img, 3)).astype(
            np.float32)
        y = rng.integers(0, args.num_classes, size=(2 * args.batch,))

    def batch(i):
        return (torch.from_numpy(x[i:i + args.batch]).to(device),
                torch.from_numpy(y[i:i + args.batch]).to(device))

    model = create_model("resnet18", num_classes=args.num_classes,
                         device=device).eval()
    qmodel = QuantModel(model, parse_qconfig(args.qconfig), (batch(0)[0],))

    # calibrate, then QAT init (learnable scales and clips from the stats)
    qmodel.prepare_calibration()
    for i in range(0, min(len(x), 4 * args.batch), args.batch):
        qmodel(batch(i)[0])
    qmodel.init_QAT()

    trainable, opt = init_qat_state(
        qmodel, lambda ps: torch.optim.Adam(ps, lr=args.lr))
    if mesh is not None:
        replicate(mesh, trainable)
    step = make_qat_step(qmodel, cross_entropy, opt, mesh)
    qmodel.train()
    try:
        for epoch in range(args.epochs):
            for i in range(0, len(x) - args.batch + 1, args.batch):
                xb, yb = batch(i)
                if mesh is not None:
                    xb, yb = dp_shard_batch(mesh, xb), dp_shard_batch(mesh, yb)
                trainable, loss = step(trainable, xb, yb)
            if mesh is not None:  # the global batch's mean
                dist.all_reduce(loss, group=mesh.get_group("dp"))
                loss /= n_dp
            print("epoch {} loss {:.4f}".format(epoch, loss.item()))
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    commit_qat_params(qmodel, trainable)
    qmodel.eval()
    state = {"{}.{}".format(n, k): v.detach().cpu()
             for n, p in qmodel.trainable_params().items()
             for k, v in p.items()}
    return {"loss": loss.item(), "state": state}


if __name__ == "__main__":
    main()
