"""BEVDet-lite QAT on the PyTorch port (the port of ``main.py`` beside it;
reference: examples/quantization_aware_training/nuscenes/bevdet,
dist_qat_train.sh -> tools/qat_train with BEVDetTraced and
qconfig_r50_lsq_*).

Flow: QuantModel -> calibration forwards -> init_QAT (LSQ scales become
learnable) -> a torch.optim Adam loop (``tools/qat.py``) on a
CenterPoint-style loss (heatmap focal + box L1 on positives). The
lift-splat view transform is an unquantized leaf (``models/bevdet.py``). Pass --data an npz with imgs
(N, n_cams, H, W, 3), heatmap (N, Hb, Wb, C), boxes (N, Hb, Wb, 8) to
train on real targets; without it the flow runs on random tensors. One
card; runs on the card unless --device names another device.

    python main_torch.py [--qconfig qconfig_lsq_8w8f.yaml] [--data bev.npz]
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
from sparsebit_tpu_torch.quantization.tools.qat import (  # noqa: E402
    commit_qat_params,
    init_qat_state,
    make_qat_step,
)

HERE = os.path.dirname(os.path.abspath(__file__))
N_CAMS = 4


def centerpoint_loss(outputs, targets):
    """Heatmap focal (alpha=2, beta=4 penalty-reduced) + L1 on positives
    (CenterPoint; the reference delegates to pts_bbox_head.loss)."""
    hm_pred, box_pred = outputs
    hm_t, box_t = targets
    p = torch.sigmoid(hm_pred.float())
    pos = (hm_t >= 0.999).float()
    neg_w = torch.pow(1.0 - hm_t, 4.0)
    eps = 1e-6
    pos_loss = -torch.log(p + eps) * torch.pow(1 - p, 2.0) * pos
    neg_loss = -torch.log(1 - p + eps) * torch.pow(p, 2.0) * neg_w * (1 - pos)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    hm_loss = (pos_loss.sum() + neg_loss.sum()) / n_pos
    cell_pos = (hm_t.amax(-1, keepdim=True) >= 0.999).float()
    l1 = torch.abs(box_pred.float() - box_t) * cell_pos
    box_loss = l1.sum() / torch.clamp(cell_pos.sum() * 8.0, min=1.0)
    return hm_loss + 0.25 * box_loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qconfig",
                    default=os.path.join(HERE, "qconfig_lsq_4w4f.yaml"))
    ap.add_argument("--data", default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    num_classes, bev_hw = 10, (32, 32)
    if args.data:
        z = np.load(args.data)
        imgs, hm_t, box_t = z["imgs"], z["heatmap"], z["boxes"]
    else:
        print("[warn] no --data; random tensors (flow demo)")
        rng = np.random.default_rng(0)
        n = 8
        imgs = rng.normal(size=(n, N_CAMS, 64, 96, 3)).astype(np.float32)
        hm_t = (rng.random((n,) + bev_hw + (num_classes,)) > 0.98).astype(
            np.float32)
        box_t = rng.normal(size=(n,) + bev_hw + (8,)).astype(np.float32)

    def batch(i):
        # (B * n_cams, H, W, 3), qbevdet.py:33-40
        xb = torch.from_numpy(imgs[i:i + args.batch]).to(device)
        xb = xb.reshape((-1,) + xb.shape[2:])
        tb = (torch.from_numpy(hm_t[i:i + args.batch]).to(device),
              torch.from_numpy(box_t[i:i + args.batch]).to(device))
        return xb, tb

    model = create_model("bevdet_lite", n_cams=N_CAMS,
                         num_classes=num_classes, device=device).eval()
    xb0 = batch(0)[0]
    qmodel = QuantModel(model, parse_qconfig(args.qconfig), (xb0,))

    # calibration forwards, then init_QAT, which computes the qparams
    # (LSQ takes its scales from the observers). main.py calls
    # calc_qparams first, after which init_QAT's own calc_qparams finds
    # no calibration and asserts (fault R14).
    qmodel.prepare_calibration()
    qmodel(xb0)
    qmodel.init_QAT()

    trainable, opt = init_qat_state(
        qmodel, lambda ps: torch.optim.Adam(ps, lr=args.lr))
    step = make_qat_step(qmodel, centerpoint_loss, opt)
    qmodel.train()
    losses = []
    for epoch in range(args.epochs):
        for i in range(0, len(imgs), args.batch):
            trainable, loss = step(trainable, *batch(i))
            losses.append(loss.item())
        print("epoch {} loss {:.4f}".format(epoch, losses[-1]))
    commit_qat_params(qmodel, trainable)
    qmodel.eval()
    return {"losses": losses, "qmodel": qmodel}


if __name__ == "__main__":
    main()
