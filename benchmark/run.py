"""The benchmark of the PyTorch and CUDA port (``sparsebit_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. One process is one run of one cell of
``BENCHMARK.json``: it makes the cell's weights and traffic from the
seed on the card, warms up, measures for ``--seconds``, checks what the
timed path produced against the plain reference under
``benchmark/reference/``, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``, then ``checks``, each compared number with
its limit, which also end standard error. It needs as many CUDA devices
as the cell asks for and exits 2 without them; it exits 3 if JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsebit_tpu")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.lib.harness import Manifest, Run, execute

    man = Manifest(ROOT)
    cell = man.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("needs {} CUDA device(s); found {}".format(
            cell["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    from benchmark.reference.decoder import no_tf32

    no_tf32()
    ctx = Run(args.workload, man.config(cell["config"]),
              man.traffic(cell["traffic"]), man.limits(args.workload),
              args.seed, args.seconds, bool(args.trace),
              torch.device("cuda"), T_START)
    result = execute(man, ctx)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    bad = forbidden_modules()
    if bad:
        print("loaded in this process: " + ", ".join(bad), file=sys.stderr)
        return 3
    print("card: {}; setup_s {:.3f}; window_s {:.3f}".format(
        card_line(), ctx.setup_s, ctx.window_s), file=sys.stderr)
    print("not reported in this run: " + json.dumps(ctx.other_metrics),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print("check {} {!r} limit {!r}".format(name, c["value"],
                                                c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
