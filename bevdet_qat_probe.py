#!/usr/bin/env python3
"""One LSQ QAT step of BEVDet-lite on the card and on the CPU, node by
node: where the two devices' forward and gradients part.

    python3 bevdet_qat_probe.py [--yaml qconfig_lsq_4w4f.yaml ...]

For each yaml of examples/quantization_aware_training/nuscenes_bevdet
(default: both), bevdet_lite at 32 x 48, 4 cameras, one scene, seeded
weights, images and CenterPoint targets: calibration, init_QAT, then one
training-mode forward of the QuantModel's graph with every node's output
kept, the CLI's centerpoint_loss and its backward. Prints the loss on
each device, then for every node the relative L2 difference of its
output and of its output's gradient (card against CPU), and the
relative L2 difference of all gradients between two runs on the card.
Needs a GPU; compares with the port's own CPU run (no JAX).
"""

import argparse
import copy
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(HERE, "examples", "quantization_aware_training",
                       "nuscenes_bevdet")


def step(device, yaml_path, model, x, targets, loss_fn):
    """(loss, {node: output}, {node: output gradient}) of one training
    forward and backward on ``device``, all on the CPU."""
    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.nn.graph import Output, Placeholder, SymbolicTensor
    from sparsebit_tpu_torch.quantization.tools.qat import merge_params

    q = QuantModel(copy.deepcopy(model).to(device), parse_qconfig(yaml_path),
                   (x.to(device),))
    q.prepare_calibration()
    q(x.to(device))
    q.init_QAT()
    q.train()
    params = merge_params(q.params(), q.trainable_params())
    env = {}

    def value(a):
        if isinstance(a, SymbolicTensor):
            v = env[a.node.name]
            return v if a.index is None else v[a.index]
        return a

    for n in q.graph.nodes:
        if isinstance(n.op, Placeholder):
            env[n.name] = x.to(device)
            continue
        args = [value(a) for a in n.args]
        if isinstance(n.op, Output):
            out = tuple(args)
            break
        y = n.op.execute(*args, params=params.get(n.name), training=True,
                         **n.kwargs)
        if y.requires_grad:
            y.retain_grad()
        env[n.name] = y
    loss = loss_fn(out, tuple(t.to(device) for t in targets))
    loss.backward()
    outs = {k: v.detach().cpu() for k, v in env.items()}
    grads = {k: v.grad.cpu() for k, v in env.items() if v.grad is not None}
    return loss.item(), outs, grads


def rel(a, b):
    return float((a - b).norm() / (b.norm() + 1e-30))


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--yaml", nargs="+", default=["qconfig_lsq_8w8f.yaml",
                                                   "qconfig_lsq_4w4f.yaml"])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bevdet_qat_probe.py needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sparsebit_tpu_torch import device_line
    from sparsebit_tpu_torch.models import create_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "bevdet_cli", os.path.join(EXAMPLE, "main_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    print(device_line("cuda"))
    for name in args.yaml:
        g = torch.Generator().manual_seed(101)
        model = create_model("bevdet_lite", img_hw=(32, 48), seed=0,
                             device="cpu").eval()
        x = torch.randn((4, 32, 48, 3), generator=g)
        targets = ((torch.rand((1, 32, 32, 10), generator=g) > 0.98).float(),
                   torch.randn((1, 32, 32, 8), generator=g))
        path = os.path.join(EXAMPLE, name)
        card = step("cuda", path, model, x, targets, cli.centerpoint_loss)
        again = step("cuda", path, model, x, targets, cli.centerpoint_loss)
        host = step("cpu", path, model, x, targets, cli.centerpoint_loss)
        keys = list(host[2])
        flat = [torch.cat([r[2][k].reshape(-1) for k in keys])
                for r in (card, again, host)]
        print("{}: loss card {:.7f} CPU {:.7f}; output gradients, card vs "
              "CPU {:.3e}, card vs card {:.3e}".format(
                  name, card[0], host[0], rel(flat[0], flat[2]),
                  rel(flat[0], flat[1])))
        print("  {:<24} {:>10} {:>10}".format("node", "output", "gradient"))
        for k, v in host[1].items():
            grad = rel(card[2][k], host[2][k]) if k in host[2] else 0.0
            print("  {:<24} {:10.3e} {:10.3e}".format(
                k, rel(card[1][k], v), grad))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
