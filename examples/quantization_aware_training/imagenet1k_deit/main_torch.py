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

One card: data parallelism on the port waits for its ``parallel/``
package (ROADMAP.md, queue 1). --ckpt loads an npz of the JAX
package's ``full_state_dict`` layout. Runs on the card unless --device
names another device.

    python main_torch.py --model deit_small --qconfig qconfig_lsq.yaml
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as TF  # noqa: E402

from sparsebit_tpu_torch import QuantModel, parse_qconfig  # noqa: E402
from sparsebit_tpu_torch import resolve_device  # noqa: E402
from sparsebit_tpu_torch.models import create_model  # noqa: E402
from sparsebit_tpu_torch.nn import load_jax_state_dict  # noqa: E402
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
    qmodel = QuantModel(model, parse_qconfig(args.qconfig), (batch(0)[0],))

    # calibrate ~256 images (the reference's calib_size), then QAT init
    qmodel.prepare_calibration()
    for i in range(0, min(len(x), 256), args.batch):
        qmodel(batch(i)[0])
    qmodel.init_QAT()

    def loss_fn(logits, yy):
        return TF.cross_entropy(logits, yy, label_smoothing=args.smoothing)

    trainable, opt = init_qat_state(qmodel, lambda ps: torch.optim.AdamW(
        ps, lr=args.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05))
    step = make_qat_step(qmodel, loss_fn, opt)
    qmodel.train()
    for epoch in range(args.epochs):
        for i in range(0, len(x) - args.batch + 1, args.batch):
            trainable, loss = step(trainable, *batch(i))
        print("epoch {} loss {:.4f}".format(epoch, loss.item()))
    commit_qat_params(qmodel, trainable)
    qmodel.eval()

    # eval (quantizers on) on the tail of the data
    xb, yb = batch(len(x) - args.batch)
    with torch.no_grad():
        top1 = float((qmodel(xb).argmax(-1) == yb).float().mean())
    print("QAT top-1 on eval tail: {:.4f}".format(top1))
    return {"loss": loss.item(), "top1": top1}


if __name__ == "__main__":
    main()
