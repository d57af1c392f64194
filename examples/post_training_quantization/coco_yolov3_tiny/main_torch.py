"""Detection PTQ on the PyTorch port (the port of ``main.py`` beside it;
reference: examples/post_training_quantization/coco2017/yolo_series/
main.py, YOLOv3/v4 over Darknet). Quantizes the detector graph (MSE
observers, BatchNorm folded into the convs: qconfig.yaml); box decode,
NMS and mAP are downstream of the quantized network.

Models: yolov3 (Darknet-53 + FPN, the reference's yolo_series scale),
yolov4 (CSPDarknet + SPP, Mish), yolov5s (C3 / SPPF + PAN, SiLU),
yolov3_darknet21 / yolov4_small / yolov5n (shallow variants),
yolov3_tiny. --data is an npz with x (N, H, W, 3) float; without it
seeded random tensors drive the flow. --ckpt loads an npz of the JAX
package's ``full_state_dict`` layout, transposed on load. Runs on the
card unless --device names another device.

    python main_torch.py --model yolov3 [--data imgs.npz] [--ckpt yolo.npz]
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
MODELS = ("yolov3", "yolov3_darknet21", "yolov3_tiny", "yolov4",
          "yolov4_small", "yolov5s", "yolov5n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolov3_tiny", choices=MODELS)
    ap.add_argument("--qconfig", default=os.path.join(HERE, "qconfig.yaml"))
    ap.add_argument("--data", default=None, help="npz x (N,H,W,3) float")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--imgsize", type=int, default=416)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calib-batches", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = create_model(args.model, device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()

    if args.data:
        x = np.load(args.data)["x"].astype(np.float32)
    else:
        print("[warn] no --data; random tensors (flow demo)")
        x = np.random.default_rng(0).normal(
            size=(args.calib_batches * args.batch, args.imgsize,
                  args.imgsize, 3)).astype(np.float32)

    def batch(i):
        return torch.from_numpy(x[i * args.batch:(i + 1) * args.batch]).to(
            device)

    qmodel = QuantModel(model, parse_qconfig(args.qconfig), (batch(0),))
    qmodel.prepare_calibration()
    for i in range(args.calib_batches):
        qmodel(batch(i))
    qmodel.calc_qparams()
    qmodel.set_quant(True, True)
    with torch.no_grad():
        preds = qmodel(batch(0))
    shapes = [tuple(p.shape) for p in preds]
    print("quantized prediction maps:", shapes)
    err = qmodel.get_quantization_error(batch(0))
    mean_err = float(np.mean([float(e) for e in err.values()]))
    print("mean per-layer quant error:", mean_err)
    return {"shapes": shapes, "mean_error": mean_err, "errors": err}


if __name__ == "__main__":
    main()
