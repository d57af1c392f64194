"""Record the port's accuracy fixture numbers to accuracy/ACCURACY_torch.json.

Usage:
    python examples/llm/accuracy_fixture_torch.py [--steps 200] [--bits 4 3]

The PyTorch/CUDA port's counterpart of examples/llm/accuracy_fixture.py:
a deterministically trained tiny LLaMA evaluated through the pipeline a
real checkpoint uses (GPTQ convert -> packed QuantLinear -> windowed ppl),
on --device (default cuda). The result goes under the key ``llm_gptq``
with the device it ran on (on the card: its name and power limit, as
nvidia-smi reports them).
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(
    0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
)


def device_line(device):
    """The card's name and power limit, or the device type off the card."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--bits", type=int, nargs="+", default=[4, 3])
    ap.add_argument("--groupsize", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument(
        "--out",
        default=os.path.join(os.path.dirname(__file__), "..", "..",
                             "accuracy", "ACCURACY_torch.json"),
    )
    args = ap.parse_args(argv)

    import torch

    from sparsebit_tpu_torch.llm.fixture import run_fixture

    dev = torch.device(args.device)
    results = run_fixture(steps=args.steps, gptq_bits=tuple(args.bits),
                          groupsize=args.groupsize, verbose=True, device=dev)
    results["device"] = device_line(dev)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    existing = {}
    if os.path.exists(out):
        with open(out) as f:
            existing = json.load(f)
    existing["llm_gptq"] = results
    with open(out, "w") as f:
        json.dump(existing, f, indent=2)
    print("wrote", out)
    return results


if __name__ == "__main__":
    main()
