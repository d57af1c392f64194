#!/usr/bin/env python3
"""Flash attention's device time at chip_smoke.py phase 2's shapes, for two
or more trees of this repository, in turns on one card.

    python3 k10_ab.py [--bwd] ROOT_A ROOT_B [ROOT_C ...]
    python3 k10_ab.py --ptxas ROOT
    python3 k10_ab.py --probe ROOT

Each ROOT is a directory that holds ``sparsebit_tpu_torch/`` (a checkout,
or a commit unpacked by ``git archive``). Each tree runs in a process of
its own, in the order given (so parent, change, change, parent compares
two versions within one call), builds its kernels from its own ``csrc/``
and times, on the same seeded operands:
  - K10: ``flash_attention`` without a gradient (the serving and eval
    paths' call) at k10_checks' first 8 shapes and at B=4 S=512, and
    ``flash_attention_fwd`` (the kLse instantiation, the training forward)
    at B=4 S=512, k10_checks' ninth shape;
  - with ``--bwd``, also K11 (``flash_attention_dkv``) and K12
    (``flash_attention_dq``) at k11_k12_checks' 8 shapes, over the tree's
    own K10 log-sum-exp.
Device ms per launch from 20 launches replayed from one CUDA graph, three
replays, the median. Prints one JSON line per tree, then the card's name
and power limit. Needs CUDA.

With ``--ptxas``, compiles ROOT's ``csrc/flash_attention.cu`` with the
library's own nvcc flags plus ``-Xptxas -v`` (once as built, once with
``-DSBT_FLASH_FWD_D256_PROBE``, which adds the Hopper forward at
head_dim 256) and prints ptxas's lines for every flash kernel: registers,
spills, and any warning (C7510 / C7520: a wgmma serialised). Needs nvcc.

With ``--probe``, times ROOT beside copies of it whose Hopper forward
(``flash_fwd_sm90_kernel``) leaves work out, to show where its time goes
(their outputs are wrong; only their times mean anything): no softmax (P
is the raw scores), no wgmma products, neither, neither softmax nor K/V
copies (the products alone), and no K/V copies (the ring's barriers
still complete). The copies are written under
``.chip_scratch/k10_probe/`` of the working directory.
"""

import json
import subprocess
import sys

CASES = [("bf16", 1, 2048, 32, 32, 128), ("bf16", 8, 512, 32, 32, 128),
         ("bf16", 1, 1024, 64, 64, 64), ("bf16", 1, 1024, 16, 16, 256),
         ("bf16", 1, 2047, 32, 32, 128), ("bf16", 1, 100, 32, 32, 128),
         ("f32", 1, 512, 32, 32, 128), ("bf16", 1, 2048, 32, 8, 128),
         ("bf16", 4, 512, 32, 32, 128), ("bf16 lse", 4, 512, 32, 32, 128)]
BWD_CASES = [("bf16", 4, 512, 32, 32, 128)] + CASES[:1] + CASES[2:8]


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

    dt = torch.bfloat16 if kind.startswith("bf16") else torch.float32
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
            fwd = (FA.flash_attention_fwd if case[0].endswith(" lse")
                   else FA.flash_attention)
            out["ms"][tag(*case)] = graph_ms(
                lambda: fwd(q, k, v, sm_scale=scale))
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


def ptxas(root):
    """ptxas's registers, spills and warnings for ROOT's flash kernels."""
    import tempfile

    sys.path.insert(0, root)
    from sparsebit_tpu_torch.ops import _kernels

    src = _kernels.CSRC / "flash_attention.cu"
    for extra in ([], ["-DSBT_FLASH_FWD_D256_PROBE"]):
        with tempfile.TemporaryDirectory() as tmp:
            res = subprocess.run(
                [_kernels._nvcc(), *_kernels.ARCH_FLAGS,
                 *_kernels.NVCC_FLAGS, "-Xptxas", "-v", *extra, "-I",
                 str(_kernels.CSRC), "-c", str(src), "-o", tmp + "/f.o"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=600)
        print("nvcc {} -> {}".format(" ".join(extra) or "(as built)",
                                     res.returncode), flush=True)
        name = None
        for line in res.stdout.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
            elif "warning" in line or "error" in line:
                print(line, flush=True)
            elif name and "flash" in name and ("Used" in line or
                                                "spill" in line):
                print("{}: {}".format(name, line.strip()), flush=True)
        if res.returncode != 0:
            return 1
    return 0


PROBE_SOFTMAX = (
    "// rows g and g + 8 of the warp's 16: max across the quad's lanes",
    "for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n")
PROBE_GEMMS = ("sm::wgmma_ss_n128(sc, dqw + sm::step_k<64>(kk),",
               "sm::wgmma_rs<D>(o, pa[kk], dvt + sm::step_mn(kk));")
PROBE_COPIES = ("sm::tma_load_4d(sk + s * KVT", "sm::tma_load_4d(sv + s * KVT")


def probe_sources(text):
    """{name: flash_attention.cu} for the --probe variants of ``text``."""
    def once(t, a):
        if t.count(a) != 1:
            raise SystemExit("--probe: {!r} not found once".format(a[:50]))

    def no_softmax(t):  # from the comment's line to the O rescale's end
        a, b = PROBE_SOFTMAX
        once(t, a)
        once(t, b)
        return t[:t.rindex("\n", 0, t.index(a)) + 1] + \
            t[t.index(b) + len(b):]

    def no_gemms(t):
        for a in PROBE_GEMMS:
            once(t, a)
            t = t.replace(a, "if (0) " + a)
        return t

    def no_copies(t):
        for bar in ("k_full", "v_full"):
            a = "sm::mbar_arrive_tx({} + s, KVT);".format(bar)
            once(t, a)
            t = t.replace(a, "sm::mbar_arrive({} + s);".format(bar))
        for a in PROBE_COPIES:
            once(t, a)
            t = t.replace(a, "if (0) " + a)
        return t

    return {"no_softmax": no_softmax(text), "no_gemms": no_gemms(text),
            "copies_only": no_gemms(no_softmax(text)),
            "gemms_only": no_copies(no_softmax(text)),
            "no_copies": no_copies(text)}


def probe(root):
    """Copies of ROOT's package with probe_sources' kernels; their roots."""
    import shutil
    from pathlib import Path

    pkg = Path(root) / "sparsebit_tpu_torch"
    text = (pkg / "csrc" / "flash_attention.cu").read_text()
    roots = []
    for name, src in probe_sources(text).items():
        dst = Path(".chip_scratch") / "k10_probe" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(pkg, dst / "sparsebit_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        (dst / "sparsebit_tpu_torch" / "csrc" / "flash_attention.cu"
         ).write_text(src)
        roots.append(str(dst))
    return roots


def main(args):
    import torch

    if "--probe" in args:
        roots = [a for a in args if a != "--probe"]
        if len(roots) != 1:
            return 2
        args = roots + probe(roots[0])
    if "--ptxas" in args:
        roots = [a for a in args if a != "--ptxas"]
        return ptxas(roots[0]) if len(roots) == 1 else 2
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
