#!/usr/bin/env python3
"""K10's device time at chip_smoke.py phase 2's shapes, for two or more
trees of this repository, in turns on one card.

    python3 k10_ab.py ROOT_A ROOT_B [ROOT_C ...]

Each ROOT is a directory that holds ``sparsebit_tpu_torch/`` (a checkout,
or a commit unpacked by ``git archive``). Each tree runs in a process of
its own, in the order given (so parent, change, change, parent compares
two versions within one call), builds its kernels from its own ``csrc/``
and times ``flash_attention`` without a gradient (the serving and eval
paths' call) on the same seeded operands: device ms per launch from 20
launches replayed from one CUDA graph, three replays, the median. Prints
one JSON line per tree, then the card's name and power limit. Needs CUDA.
"""

import json
import subprocess
import sys

CASES = [("bf16", 1, 2048, 32, 32, 128), ("bf16", 8, 512, 32, 32, 128),
         ("bf16", 1, 1024, 64, 64, 64), ("bf16", 1, 1024, 16, 16, 256),
         ("bf16", 1, 2047, 32, 32, 128), ("bf16", 1, 100, 32, 32, 128),
         ("f32", 1, 512, 32, 32, 128), ("bf16", 1, 2048, 32, 8, 128)]


def child(root):
    """Time the tree at ``root``; print its JSON line."""
    sys.path.insert(0, root)
    import torch
    from sparsebit_tpu_torch.ops import _kernels
    from sparsebit_tpu_torch.ops import flash_attention as FA

    _kernels.lib()
    dev = torch.device("cuda")
    out = {"root": root, "ms": {}}
    for kind, B, S, H, Hkv, D in CASES:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        g = torch.Generator(device=dev).manual_seed(S + H + Hkv + D)
        q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(
            dt).transpose(1, 2) for h in (H, Hkv, Hkv))
        with torch.no_grad():
            for _ in range(3):
                FA.flash_attention(q, k, v, sm_scale=D ** -0.5)
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                FA.flash_attention(q, k, v, sm_scale=D ** -0.5)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                for _ in range(20):
                    FA.flash_attention(q, k, v, sm_scale=D ** -0.5)
        times = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            graph.replay()
            a.record()
            graph.replay()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 20)
        tag = "{} B={} S={} H={} Hkv={} hd={}".format(kind, B, S, H, Hkv, D)
        out["ms"][tag] = sorted(times)[1]
    print(json.dumps(out), flush=True)


def main(roots):
    import torch

    if not torch.cuda.is_available():
        print("k10_ab.py needs a CUDA device", file=sys.stderr)
        return 2
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        rc = subprocess.run([sys.executable, __file__, "--child", root],
                            timeout=900).returncode
        if rc != 0:
            print("tree {} failed with {}".format(root, rc), file=sys.stderr)
            return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
