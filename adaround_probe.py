#!/usr/bin/env python3
"""AdaRound's hard rounding against rounding to nearest at ResNet-18
width, by step budget, on the layers that chip_smoke.py's graphcalib path
reconstructs (resnet18 with chip_smoke's seeded weights, one batch of 16
seeded 224 x 224 images, W4 per-channel-symmetric).

    # on the card: capture each layer's calibration inputs and float
    # outputs through the port's layerwise calibration, reconstruct the
    # layer at each budget, print the reconstruction loss (|.|^2 summed
    # over a sample, averaged over samples) of the rectified-sigmoid
    # weight, the hard-rounded weight and the weight rounded to nearest;
    # --pixel-sum also runs each layer under the JAX package's objective
    # (below); --save keeps one layer for the CPU run
    python adaround_probe.py --steps 5000 20000 --pixel-sum 5000 \
        --save chiprun_out/adaround_layer.npz

    # on the CPU: the saved layer reconstructed by the JAX package's
    # reconstruct_qlayer and by the port's under the JAX package's
    # objective, at the same budget
    JAX_PLATFORMS=cpu python adaround_probe.py \
        --layer chiprun_out/adaround_layer.npz --steps 5000

The port's reconstruction loss is the reference's ``lp_loss``,
``sum(1).mean()`` on NCHW: channels summed, samples and pixels averaged.
The JAX package sums the pixels too, a loss H x W times larger against
the same round loss (reference fault R10). Adam's step does not change
when the loss is scaled (but for its eps), so ``round_loss_weight = 1e-3
/ (H x W)`` runs the JAX package's objective on the port (--pixel-sum).

The JAX package is imported only by the CPU mode.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ROUND_LOSS_WEIGHT = 1e-3  # reconstruct_qlayer's default


def _qconfig_dict():
    import copy

    import chip_smoke
    from sparsebit_tpu_torch.utils.config import load_yaml

    d = copy.deepcopy(load_yaml(chip_smoke.BASECASE_QCONFIG))
    d["W"]["QUANTIZER"] = {"TYPE": "adaround", "BIT": 4}
    return d


def _pixels(outputs):
    return int(np.prod(outputs.shape[1:-1]))


def card(steps, pixel_steps, save, save_layer, only):
    import chip_smoke as S
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.quantization.quantizers import adaround

    torch.backends.cudnn.allow_tf32 = False
    model = create_model("resnet18", seed=S.SEED, device="cuda").eval()
    x = S._images(torch.Generator(device="cuda").manual_seed(S.SEED + 32),
                  S.CALIB_BATCH)
    d = _qconfig_dict()
    w4 = dict(d, W=dict(d["W"], QUANTIZER={"TYPE": "uniform", "BIT": 4}))
    qmodel = QuantModel(model, parse_qconfig(w4), (x,))
    for name in S.ADAROUND_LAYERS:
        qmodel.get_qmodule(name).build_quantizer(parse_qconfig(d))
    layers = S.capture_adaround_layers(qmodel, x)
    orig = adaround.reconstruct_qlayer
    rows = []
    for name, (op, inputs, outputs, _) in layers.items():
        if only and name not in only:
            continue
        runs = [(n, "port", ROUND_LOSS_WEIGHT) for n in steps] + [
            (n, "pixel-sum", ROUND_LOSS_WEIGHT / _pixels(outputs))
            for n in pixel_steps]
        for n, kind, rlw in runs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            orig(op, inputs, outputs, max_steps=n, round_loss_weight=rlw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            soft, hard, near = S.adaround_losses(op, inputs, outputs)
            rows.append(dict(layer=name, steps=n, loss=kind,
                             round_loss_weight=rlw, s_per_step=secs / n,
                             soft=soft, hard=hard, nearest=near,
                             hard_below_nearest=hard < near))
            print(json.dumps(rows[-1]), flush=True)
            if save and name == save_layer and kind == "port" \
                    and n == steps[0]:
                _save(save, op, inputs, outputs, n, soft, hard, near)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "adaround_probe.json"), "w") as f:
        json.dump(rows, f, indent=1)


def _save(path, op, inputs, outputs, n, soft, hard, near):
    m, wq = op.module, op.weight_quantizer
    assert m.dilation == (1, 1) and m.groups == 1
    np.savez(path, weight=op.get_weight().detach().cpu().numpy(),
             bias=(np.zeros(0, np.float32) if m.bias is None
                   else m.bias.detach().cpu().numpy()),
             stride=np.array(m.stride), padding=np.array(m.padding),
             scale=wq.scale.cpu().numpy(),
             inputs=inputs.cpu().numpy(), outputs=outputs.cpu().numpy(),
             v=wq.v.cpu().numpy(), steps=n,
             losses=np.array([soft, hard, near]))
    print("saved {} ({} steps)".format(path, n), flush=True)


def cpu(layer, steps):
    """The saved layer reconstructed by the JAX package and by the port on
    the CPU at ``steps``; the card's numbers from the file beside them."""
    import jax.numpy as jnp

    import sparsebit_tpu.nn as jnn
    import sparsebit_tpu_torch.nn as tnn
    from sparsebit_tpu import parse_qconfig as j_parse
    from sparsebit_tpu.quantization.modules.conv import QConv2d as JQConv2d
    from sparsebit_tpu.quantization.quantizers.adaround import (
        reconstruct_qlayer as j_reconstruct,
    )
    from sparsebit_tpu_torch import parse_qconfig as t_parse
    from sparsebit_tpu_torch.quantization.modules.conv import (
        QConv2d as TQConv2d,
    )
    from sparsebit_tpu_torch.quantization.quantizers.adaround import (
        reconstruct_qlayer as t_reconstruct,
    )

    d = dict(np.load(layer))
    w, b = d["weight"], d["bias"]
    cout, cin, kh, _ = w.shape
    args = (cin, cout, kh, tuple(d["stride"]), tuple(d["padding"]), 1, 1,
            b.size > 0)
    sd = {"weight": w.transpose(2, 3, 1, 0)}
    if b.size:
        sd["bias"] = b
    cfg = _qconfig_dict()
    out = {"card": dict(steps=int(d["steps"]), soft=float(d["losses"][0]),
                        hard=float(d["losses"][1]),
                        nearest=float(d["losses"][2]))}

    jconv = jnn.Conv2d(*args)
    jconv.load_state_dict(sd)
    jop = JQConv2d(jconv, j_parse(cfg))
    jop.build_quantizer(j_parse(cfg))
    jwq = jop.weight_quantizer
    jwq.update_observer(jconv.weight)
    jwq.calc_qparams()
    js = np.asarray(jwq.scale).reshape(-1)
    x, y = jnp.asarray(d["inputs"]), jnp.asarray(d["outputs"])
    t = time.perf_counter()
    j_reconstruct(jop, x, y, max_steps=steps)
    jsecs = time.perf_counter() - t

    def jloss(wt):
        diff = jop.module.execute(x, params={"weight": wt}) - y
        return float((diff ** 2).sum() / diff.shape[0])

    jw = jconv.weight
    jwq.train(True)
    jsoft = jloss(jwq(jw))
    jwq.train(False)
    jhard = jloss(jwq(jw))
    qmin, qmax = jwq.qdesc.qrange
    jzp = jwq.zero_point
    jnear = jloss((jnp.clip(jnp.round(jw / jwq.scale) + jzp, qmin, qmax)
                   - jzp) * jwq.scale)
    out["jax"] = dict(steps=steps, soft=jsoft, hard=jhard, nearest=jnear,
                      s_per_step=jsecs / steps,
                      scale_max_rel_err_vs_card=float(np.max(np.abs(
                          js - d["scale"].reshape(-1)) / d["scale"].reshape(
                              -1))))

    import chip_smoke as S

    tconv = tnn.Conv2d(*args)
    tnn.load_jax_state_dict(tconv, sd)
    top = TQConv2d(tconv, t_parse(cfg))
    top.build_quantizer(t_parse(cfg))
    top.weight_quantizer.update_observer(tconv.weight.detach())
    top.weight_quantizer.calc_qparams()
    tx, ty = torch.from_numpy(d["inputs"]), torch.from_numpy(d["outputs"])
    t = time.perf_counter()
    t_reconstruct(top, tx, ty, max_steps=steps,
                  round_loss_weight=ROUND_LOSS_WEIGHT / _pixels(d["outputs"]))
    tsecs = time.perf_counter() - t
    soft, hard, near = S.adaround_losses(top, tx, ty)
    tv = top.weight_quantizer.v.numpy()
    jv = np.asarray(jwq.v).transpose(3, 2, 0, 1)
    out["port_cpu"] = dict(steps=steps, soft=soft, hard=hard, nearest=near,
                           s_per_step=tsecs / steps,
                           v_max_abs_diff_vs_jax=float(np.abs(tv - jv).max()),
                           signs_differ_vs_jax=int(((tv >= 0) != (jv >= 0))
                                                   .sum()))
    if int(d["steps"]) == steps:
        cv = d["v"]
        out["port_cpu"]["signs_differ_vs_card"] = int(
            ((tv >= 0) != (cv >= 0)).sum())
        out["jax"]["signs_differ_vs_card"] = int(((jv >= 0) != (cv >= 0))
                                                 .sum())
    print(json.dumps(out, indent=1), flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, nargs="*", default=[5000, 20000])
    ap.add_argument("--pixel-sum", type=int, nargs="*", default=[])
    ap.add_argument("--save", default=None,
                    help="card: write --save-layer's first run to this npz")
    ap.add_argument("--save-layer", default="layer1.0.conv1")
    ap.add_argument("--layers", nargs="*", default=[],
                    help="card: only these of chip_smoke's AdaRound layers")
    ap.add_argument("--layer", default=None,
                    help="CPU: an npz written by --save")
    args = ap.parse_args(argv)
    if args.layer:
        torch.set_num_threads(os.cpu_count())
        cpu(args.layer, args.steps[0])
        return 0
    if not torch.cuda.is_available():
        print("the card mode needs CUDA", file=sys.stderr)
        return 2
    card(args.steps, args.pixel_sum, args.save, args.save_layer,
         args.layers)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
