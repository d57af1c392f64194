#!/usr/bin/env python3
"""Flash attention's device time at chip_smoke.py phase 2's shapes, for two
or more trees of this repository, in turns on one card.

    python3 k10_ab.py [--bwd] ROOT_A ROOT_B [ROOT_C ...]

Each ROOT is a directory that holds ``sparsebit_tpu_torch/`` (a checkout,
or a commit unpacked by ``git archive``). Each tree runs in a process of
its own, in the order given (so parent, change, change, parent compares
two versions within one call), builds its kernels from its own ``csrc/``
and times, on the same seeded operands:
  - K10: ``flash_attention`` without a gradient (the serving and eval
    paths' call) at k10_checks' 8 shapes;
  - with ``--bwd``, also K11 (``flash_attention_dkv``) and K12
    (``flash_attention_dq``) at k11_k12_checks' 8 shapes, over the tree's
    own K10 log-sum-exp.
Device ms per launch from 20 launches replayed from one CUDA graph, three
replays, the median. Prints one JSON line per tree, then the card's name
and power limit. Needs CUDA.
"""

import json
import subprocess
import sys

CASES = [("bf16", 1, 2048, 32, 32, 128), ("bf16", 8, 512, 32, 32, 128),
         ("bf16", 1, 1024, 64, 64, 64), ("bf16", 1, 1024, 16, 16, 256),
         ("bf16", 1, 2047, 32, 32, 128), ("bf16", 1, 100, 32, 32, 128),
         ("f32", 1, 512, 32, 32, 128), ("bf16", 1, 2048, 32, 8, 128)]
BWD_CASES = [("bf16", 4, 512, 32, 32, 128)] + CASES[:1] + CASES[2:]


def graph_ms(fn):
    """Median device ms per call over three replays of 20 captured calls."""
    import torch

    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(20):
            fn()
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
    return sorted(times)[1]


def operands(kind, B, S, H, Hkv, D, n):
    """n seeded (B, H or Hkv, S, D) operands in the port's (B, S, H, D)
    layout, transposed as views: q, k, v (and dO)."""
    import torch

    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(S + H + Hkv + D)
    return [torch.randn((B, S, h, D), generator=g, device="cuda").to(
        dt).transpose(1, 2) for h in (H, Hkv, Hkv, H)[:n]]


def tag(kind, B, S, H, Hkv, D):
    return "{} B={} S={} H={} Hkv={} hd={}".format(kind, B, S, H, Hkv, D)


def child(root, bwd):
    """Time the tree at ``root``; print its JSON line."""
    sys.path.insert(0, root)
    import torch
    from sparsebit_tpu_torch.ops import _kernels
    from sparsebit_tpu_torch.ops import flash_attention as FA

    _kernels.lib()
    out = {"root": root, "ms": {}}
    with torch.no_grad():
        for case in CASES:
            q, k, v = operands(*case, 3)
            scale = case[-1] ** -0.5
            out["ms"][tag(*case)] = graph_ms(
                lambda: FA.flash_attention(q, k, v, sm_scale=scale))
        if bwd:
            out["k11_ms"], out["k12_ms"] = {}, {}
            for case in BWD_CASES:
                q, k, v, do = operands(*case, 4)
                scale = case[-1] ** -0.5
                o, lse = FA.flash_attention_fwd(q, k, v, sm_scale=scale)
                di = FA.flash_di(o, do)
                out["k11_ms"][tag(*case)] = graph_ms(
                    lambda: FA.flash_attention_dkv(q, k, v, lse, do, di,
                                                   sm_scale=scale))
                out["k12_ms"][tag(*case)] = graph_ms(
                    lambda: FA.flash_attention_dq(q, k, v, lse, do, di,
                                                  sm_scale=scale))
    print(json.dumps(out), flush=True)


def main(args):
    import torch

    if not torch.cuda.is_available():
        print("k10_ab.py needs a CUDA device", file=sys.stderr)
        return 2
    bwd = "--bwd" in args
    roots = [a for a in args if a != "--bwd"]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        cmd = [sys.executable, __file__, "--child", root] + (
            ["--bwd"] if bwd else [])
        rc = subprocess.run(cmd, timeout=900).returncode
        if rc != 0:
            print("tree {} failed with {}".format(root, rc), file=sys.stderr)
            return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2], "--bwd" in sys.argv[3:])
    else:
        sys.exit(main(sys.argv[1:]))
