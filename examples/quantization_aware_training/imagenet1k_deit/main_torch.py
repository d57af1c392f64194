"""QAT for DeiT / ViT on the PyTorch port: 4-bit LSQ, or LSQ+ on the
post-GELU inputs (the port of ``main.py`` beside it; reference:
examples/quantization_aware_training/imagenet1k/deit/main.py).

Flow: the port's ViT zoo -> QuantModel -> 8-bit patch embedding and head
(each yaml's SPECIFIC section; the reference overrides them in code,
main.py:578-581) -> calibrate ~256 images -> init_QAT -> an AdamW loop
(optax.adamw's betas and eps, weight decay 0.05) with label-smoothing
cross entropy (timm's LabelSmoothingCrossEntropy, the reference's
criterion at deit/main.py:619). LSQ trains end to end through the
quantized attention path: QMatmul(q, k^T) and QMatmul(softmax, v).

Data parallelism as the JAX CLI's: under ``torchrun`` (its variables
set) each rank, one a card, trains on its rows of every global batch
(``--batch`` is the global batch), LSQ's gradient scale counts the global
batch's elements (``nn.data_parallel``), as under the JAX
CLI's jit, and the gradients are averaged over the ranks before each
step; every rank calibrates on the same whole batches and rank 0's
trainables are broadcast before training. Without torchrun it runs on
one rank. --ckpt loads an npz of the JAX package's ``full_state_dict``
layout. Runs on the card unless --device names another device.

    python main_torch.py --model deit_small --qconfig qconfig_lsq.yaml
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

from sparsebit_tpu_torch import QuantModel, parse_qconfig  # noqa: E402
from sparsebit_tpu_torch import resolve_device  # noqa: E402
from sparsebit_tpu_torch.models import create_model  # noqa: E402
from sparsebit_tpu_torch.nn import load_jax_state_dict  # noqa: E402
from sparsebit_tpu_torch.parallel.mesh import (  # noqa: E402
    data_parallel_mesh,
    dp_shard_batch,
    replicate,
)
from sparsebit_tpu_torch.quantization.tools.qat import (  # noqa: E402
    commit_qat_params,
    init_qat_state,
    make_qat_step,
)

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deit_tiny",
                    choices=["deit_tiny", "deit_small", "deit_base"])
    ap.add_argument("--qconfig", default=os.path.join(HERE, "qconfig_lsq.yaml"))
    ap.add_argument("--data", default=None, help="npz with x (N,H,W,3), y (N)")
    ap.add_argument("--ckpt", default=None, help="float checkpoint (npz)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--smoothing", type=float, default=0.1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = data_parallel_mesh(device)
    n_dp = 1 if mesh is None else mesh["dp"].size()
    if args.batch % n_dp:
        raise SystemExit("the global batch must divide the dp axis")

    if args.data:
        z = np.load(args.data)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int64)
    else:
        print("[warn] no --data; random tensors (flow demo)")
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2 * args.batch, args.img, args.img, 3)).astype(
            np.float32)
        y = rng.integers(0, 1000, size=(2 * args.batch,))

    def batch(i):
        return (torch.from_numpy(x[i:i + args.batch]).to(device),
                torch.from_numpy(y[i:i + args.batch]).to(device))

    model = create_model(args.model, img_size=args.img, device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()
    # the traced graph keeps the batch size of its example (the attention's
    # reshapes), so it is traced at a rank's rows and every rank calibrates
    # on all of each global batch in pieces of that size
    rows = args.batch // n_dp
    qmodel = QuantModel(model, parse_qconfig(args.qconfig),
                        (batch(0)[0][:rows],))

    # calibrate ~256 images (the reference's calib_size), then QAT init
    qmodel.prepare_calibration()
    for i in range(0, min(len(x), 256), args.batch):
        xb = batch(i)[0]
        for r in range(0, args.batch, rows):
            qmodel(xb[r:r + rows])
    qmodel.init_QAT()

    def loss_fn(logits, yy):
        return TF.cross_entropy(logits, yy, label_smoothing=args.smoothing)

    trainable, opt = init_qat_state(qmodel, lambda ps: torch.optim.AdamW(
        ps, lr=args.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05))
    if mesh is not None:
        replicate(mesh, trainable)
    step = make_qat_step(qmodel, loss_fn, opt, mesh)
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

    # eval (quantizers on) on the tail of the data
    xb, yb = batch(len(x) - args.batch)
    with torch.no_grad():
        hits = torch.cat([qmodel(xb[r:r + rows]).argmax(-1) == yb[r:r + rows]
                          for r in range(0, args.batch, rows)])
    top1 = float(hits.float().mean())
    print("QAT top-1 on eval tail: {:.4f}".format(top1))
    state = {"{}.{}".format(n, k): v.detach().cpu()
             for n, p in qmodel.trainable_params().items()
             for k, v in p.items()}
    return {"loss": loss.item(), "top1": top1, "state": state}


if __name__ == "__main__":
    main()
