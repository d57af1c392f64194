"""Record the graph regime's accuracy fixtures on the PyTorch port into
accuracy/ACCURACY_torch.json (the port of ``record_fixture.py`` beside
it): "cnn_ptq", "vit_ptq", "bert_ptq" and "vit_qat", each with the device
it ran on (on the card: its name and power limit, as nvidia-smi reports
them), merged with the file's other records. Each fixture runs at the
settings of the JAX package's artifact (accuracy/ACCURACY.json): 300
float steps for the PTQ fixtures, 150 float and 800 QAT steps for
vit_qat. Runs on the card unless --device names another device.

    python examples/post_training_quantization/record_fixture_torch.py \\
        [--which vit bert vit_qat] [--out chiprun_out/ACCURACY_torch.json]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..")))

from sparsebit_tpu_torch import device_line, resolve_device  # noqa: E402

KEYS = {"cnn": "cnn_ptq", "vit": "vit_ptq", "bert": "bert_ptq",
        "vit_qat": "vit_qat"}


def record(which, device, steps=None, qat_steps=800, verbose=True):
    """{record key: result} of the fixtures in ``which``; ``steps``
    overrides every fixture's float steps."""
    from sparsebit_tpu_torch.quantization.tools import fixture

    runners = {
        "cnn": lambda: fixture.run_cnn_fixture(
            steps=steps or 300, verbose=verbose, device=device),
        "vit": lambda: fixture.run_vit_fixture(
            steps=steps or 300, verbose=verbose, device=device),
        "bert": lambda: fixture.run_bert_fixture(
            steps=steps or 300, verbose=verbose, device=device),
        "vit_qat": lambda: fixture.run_vit_qat_fixture(
            steps=steps or 150, qat_steps=qat_steps, verbose=verbose,
            device=device),
    }
    line = device_line(device)
    return {KEYS[k]: dict(runners[k](), device=line) for k in which}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", nargs="+", default=["vit", "bert", "vit_qat"],
                    choices=sorted(KEYS))
    ap.add_argument("--steps", type=int, default=None,
                    help="float steps of every fixture (default: the "
                         "artifact's)")
    ap.add_argument("--qat-steps", type=int, default=800)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..", "accuracy",
        "ACCURACY_torch.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = record(args.which, device, args.steps, args.qat_steps)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    existing = {}
    if os.path.exists(out):
        with open(out) as f:
            existing = json.load(f)
    existing.update(results)
    with open(out, "w") as f:
        json.dump(existing, f, indent=2)
    print("wrote", out)
    return results


if __name__ == "__main__":
    main()
