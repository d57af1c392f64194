#!/usr/bin/env python3
"""Flash attention's device time (or, with --k2k3, that of the unfused
route's K2 and K3) at chip_smoke.py phase 2's shapes, for two or more
trees of this repository, in turns on one card.

    python3 k10_ab.py [--bwd] ROOT_A ROOT_B [ROOT_C ...]
    python3 k10_ab.py --k2k3 ROOT_A ROOT_B [ROOT_C ...]
    python3 k10_ab.py --ptxas ROOT
    python3 k10_ab.py --probe ROOT

Each ROOT is a directory that holds ``sparsebit_tpu_torch/`` (a checkout,
or a commit unpacked by ``git archive``). Each tree runs in a process of
its own, in the order given (so parent, change, change, parent compares
two versions within one call), builds its kernels from its own ``csrc/``
and times, on the same seeded operands:
  - K10: ``flash_attention`` without a gradient (the serving and eval
    paths' call) at k10_checks' first 8 shapes, at B=4 S=512, at the
    f32 GPTQ propagation's B=1 S=2048 H=32 and at bf16 head_dim 256
    B=1 S=2048 H=16 (also Hkv=4), and ``flash_attention_fwd`` (the kLse
    instantiation, the training forward) at B=4 S=512, at the
    long-context record's f32 B=4 S=2047 H=4 and at bf16 head_dim 256
    B=4 S=512 H=16;
  - with ``--bwd``, also K11 (``flash_attention_dkv``) and K12
    (``flash_attention_dq``) at k11_k12_checks' first 8 shapes, at the
    two f32 shapes above, at f32 S=1024 head_dim 64 (H=64) and 256
    (H=16) and at bf16 head_dim 256 H=16 B=1 S=2048 (also Hkv=4), B=4
    S=512 and S=2047, over the tree's own K10 log-sum-exp.
With ``--k2k3`` it times the decode kernels of the unfused scanned route
instead, at chip_smoke.py phase 2's shapes (K2_CASES, K3_ROWS): K2
(``decode_attention_update``) over 8 cache layers cycled, K3
(``ffn_block_fused``) at LLaMA-7B widths over 4 layers of random INT4-g128
weights cycled, so that both stream from HBM as in decode; and K4, whose
FFN phases K3 shares, at phase 2's K4 and K4p shapes (32 layers at
LLaMA-7B widths, S = 512; s4r B = 1/8/32, planes at 3 and 2 bits B =
1/8), eager ms over 10 launches as phase 2 times it, the median of three.
Device ms per launch from 20 launches replayed from one CUDA graph, three
replays, the median. Prints one JSON line per tree, then the card's name
and power limit. Needs CUDA.

With ``--ptxas``, compiles ROOT's ``csrc/flash_attention.cu`` with the
library's own nvcc flags plus ``-Xptxas -v`` and prints ptxas's lines for
every flash kernel: registers, spills, and any warning (C7510 / C7520: a
wgmma serialised). Needs nvcc.

With ``--probe``, times ROOT beside copies of it whose Hopper forward
(``flash_fwd_sm90_kernel``; with a ``d256_`` name the head_dim 256 one,
``flash_fwd_d256_kernel``) leaves work out, to show where its time goes
(their outputs are wrong; only their times mean anything): no softmax (P
is the raw scores), no wgmma products, neither, neither softmax nor K/V
copies (the products alone), and no K/V copies (the ring's barriers
still complete); the head_dim 256 one only without its wgmma products
and without its K/V copies. The copies are written under
``.chip_scratch/k10_probe/`` of the working directory.
"""

import json
import subprocess
import sys

CASES = [("bf16", 1, 2048, 32, 32, 128), ("bf16", 8, 512, 32, 32, 128),
         ("bf16", 1, 1024, 64, 64, 64), ("bf16", 1, 1024, 16, 16, 256),
         ("bf16", 1, 2047, 32, 32, 128), ("bf16", 1, 100, 32, 32, 128),
         ("f32", 1, 512, 32, 32, 128), ("bf16", 1, 2048, 32, 8, 128),
         ("bf16", 4, 512, 32, 32, 128), ("bf16 lse", 4, 512, 32, 32, 128),
         ("f32 lse", 4, 2047, 4, 4, 128), ("f32", 1, 2048, 32, 32, 128),
         ("bf16", 1, 2048, 16, 16, 256), ("bf16", 1, 2048, 16, 4, 256),
         ("bf16 lse", 4, 512, 16, 16, 256)]
BWD_CASES = [("bf16", 4, 512, 32, 32, 128)] + CASES[:1] + CASES[2:8] + [
    ("f32", 4, 2047, 4, 4, 128), ("f32", 1, 2048, 32, 32, 128),
    ("f32", 1, 1024, 64, 64, 64), ("f32", 1, 1024, 16, 16, 256),
    ("bf16", 1, 2048, 16, 16, 256), ("bf16", 1, 2048, 16, 4, 256),
    ("bf16", 4, 512, 16, 16, 256), ("bf16", 1, 2047, 16, 16, 256)]


# K2: (B, S, H, Hkv, D, lengths); K3: rows at LLaMA-7B widths
K2_CASES = [(8, 512, 32, 32, 128, [0, 17, 100, 255, 300, 411, 480, 511]),
            (8, 2048, 32, 32, 128, [(b + 1) * 256 - 1 for b in range(8)]),
            (8, 512, 64, 1, 128, [0, 17, 100, 255, 300, 411, 480, 511])]
K3_ROWS = (1, 8, 64)


def eager_ms(fn, n=10):
    """Median over three runs of CUDA events around n eager calls, over
    n (chip_smoke.cuda_ms's method)."""
    import torch

    fn(0)
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for i in range(n):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[1]


def graph_ms(fn):
    """Median device ms per call over three replays of 20 captured calls;
    fn(i) is the i-th call."""
    import torch

    for i in range(3):
        fn(i)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for i in range(20):
            fn(i)
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
                lambda i: fwd(q, k, v, sm_scale=scale))
        if bwd:
            out["k11_ms"], out["k12_ms"] = {}, {}
            for case in BWD_CASES:
                q, k, v, do = operands(*case, 4)
                scale = case[-1] ** -0.5
                o, lse = FA.flash_attention_fwd(q, k, v, sm_scale=scale)
                di = FA.flash_di(o, do)
                out["k11_ms"][tag(*case)] = graph_ms(
                    lambda i: FA.flash_attention_dkv(q, k, v, lse, do, di,
                                                     sm_scale=scale))
                out["k12_ms"][tag(*case)] = graph_ms(
                    lambda i: FA.flash_attention_dq(q, k, v, lse, do, di,
                                                    sm_scale=scale))
    print(json.dumps(out), flush=True)


def child_k2k3(root):
    """Time K2 and K3 of the tree at ``root``; print its JSON line."""
    sys.path.insert(0, root)
    import torch
    from sparsebit_tpu_torch.ops import _kernels
    from sparsebit_tpu_torch.ops import attention as A
    from sparsebit_tpu_torch.ops import ffn_fused as FF

    _kernels.lib()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"root": root, "k2_ms": {}, "k3_ms": {}}
    Lc = 8
    for B, S, H, Hkv, D, lens in K2_CASES:
        kv = [torch.randint(-128, 128, (Lc, B, S, Hkv, D), dtype=torch.int8,
                            generator=g, device=dev) for _ in range(2)]
        sc = [torch.empty((Lc, B, S, Hkv), device=dev).uniform_(
            0.001, 0.05, generator=g) for _ in range(2)]
        q = torch.randn((B, H, D), generator=g, device=dev)
        kn = torch.randn((B, Hkv, D), generator=g, device=dev)
        vn = torch.randn((B, Hkv, D), generator=g, device=dev)
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        out["k2_ms"]["B={} S={} H={} Hkv={} D={}".format(
            B, S, H, Hkv, D)] = graph_ms(
                lambda i: A.decode_attention_update(
                    q, kn, vn, *kv, *sc, i % Lc, length))
        del kv, sc
    dim, F, gs, L = 4096, 11008, 128, 4

    def s4(K, N):
        w = torch.randint(0, 256, (L, K // 2, N), dtype=torch.uint8,
                          generator=g, device=dev)
        s = torch.empty((L, K // gs, N), device=dev).uniform_(
            0.001, 0.01, generator=g).to(torch.bfloat16)
        return w, s, torch.full_like(s, 8.0)

    ws = s4(dim, 2 * F) + s4(F, dim)
    nw = torch.ones((L, dim), dtype=torch.bfloat16, device=dev)
    for B in K3_ROWS:
        x = torch.randn((B, dim), generator=g, device=dev).to(torch.bfloat16)
        out["k3_ms"]["B={} dim={} F={}".format(B, dim, F)] = graph_ms(
            lambda i: FF.ffn_block_fused(x, *ws, nw, i % L, gs, 1e-6))
    del ws
    out["k4_ms"] = k4_eager_ms(g)
    print(json.dumps(out), flush=True)


def k4_eager_ms(g):
    """{case: eager ms} of K4 at chip_smoke.py phase 2's shapes: 32 layers
    of random weights at LLaMA-7B widths (s4r, or the 3/2-bit plane concat
    at the padded widths), bf16 qparams and norms, an int8 cache of S =
    512 rows."""
    import torch
    from sparsebit_tpu_torch.llm.decode import _rope_cos_sin
    from sparsebit_tpu_torch.llm.llama import llama_7b
    from sparsebit_tpu_torch.ops import layer_fused as LF
    from sparsebit_tpu_torch.ops.packing import pallas_n_pad

    dev = torch.device("cuda")
    cfg = llama_7b()
    L, S, gs, D, Hkv = cfg.n_layers, 512, 128, cfg.head_dim, cfg.n_kv_heads
    K_N = [(cfg.dim, (cfg.n_heads + 2 * Hkv) * D), (cfg.n_heads * D, cfg.dim),
           (cfg.dim, 2 * cfg.ffn_dim), (cfg.ffn_dim, cfg.dim)]
    norms = [torch.ones((L, cfg.dim), dtype=torch.bfloat16, device=dev)] * 2
    pos8 = [0, 17, 100, 255, 300, 411, 480, 511]
    pos32 = torch.randint(0, S, (32,), generator=torch.Generator().manual_seed(
        4)).tolist()
    out = {}
    for bits, rows in ((4, ((1, [300]), (8, pos8), (32, pos32))),
                       (3, ((1, [300]), (8, pos8))),
                       (2, ((1, [300]), (8, pos8)))):
        wargs = []
        for K, N in K_N:
            Ns = N if bits == 4 else N + pallas_n_pad(N, bits)
            width = {4: N, 3: 3 * Ns // 8, 2: Ns // 4}[bits]
            wargs += [torch.randint(0, 256, (L, K // 2 if bits == 4 else K,
                                             width), dtype=torch.uint8,
                                    generator=g, device=dev),
                      torch.empty((L, K // gs, Ns), device=dev).uniform_(
                          0.001, 0.01, generator=g).to(torch.bfloat16),
                      torch.full((L, K // gs, Ns), 8.0 if bits == 4 else
                                 float(2 ** (bits - 1)), dtype=torch.bfloat16,
                                 device=dev)]
        for B, pos_l in rows:
            cache = [torch.randint(-128, 128, (L, B, S, Hkv, D),
                                   dtype=torch.int8, generator=g, device=dev)
                     for _ in range(2)]
            cache += [torch.empty((L, B, S, Hkv), device=dev).uniform_(
                0.001, 0.05, generator=g).to(torch.bfloat16).float()
                for _ in range(2)]
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            cos, sin = _rope_cos_sin(cfg, pos)
            x = torch.randn((B, cfg.dim), generator=g, device=dev).to(
                torch.bfloat16).float()
            out["K4{} B={}".format("" if bits == 4 else "p {}-bit".format(
                bits), B)] = eager_ms(
                lambda i: LF.fused_decoder_layers(
                    x, pos, cos, sin, *wargs, *norms, *cache, cfg, gs,
                    wbits=bits))
            del cache
        del wargs
        torch.cuda.empty_cache()
    return out


def ptxas(root):
    """ptxas's registers, spills and warnings for ROOT's flash kernels."""
    import tempfile

    sys.path.insert(0, root)
    from sparsebit_tpu_torch.ops import _kernels

    src = _kernels.CSRC / "flash_attention.cu"
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS,
             "-Xptxas", "-v", "-I", str(_kernels.CSRC), "-c", str(src),
             "-o", tmp + "/f.o"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=600)
    print("nvcc -> {}".format(res.returncode), flush=True)
    name = None
    for line in res.stdout.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "warning" in line or "error" in line:
            print(line, flush=True)
        elif name and "flash" in name and ("Used" in line or
                                            "spill" in line):
            print("{}: {}".format(name, line.strip()), flush=True)
    return 0 if res.returncode == 0 else 1


# What each --probe variant takes out, for the Hopper forward at D = 64/128
# (flash_fwd_sm90_kernel) and, with a "d256_" name, at D = 256
# (flash_fwd_d256_kernel): the softmax (from the first string's line to the
# end of the second; the D = 256 kernel hands its rescale over, so it has
# no such variant), the wgmma products, and the K/V copies (each tile's
# expect-tx arrive made a plain arrive, and the copies).
PROBES = {
    "": {"softmax": (
        "// rows g and g + 8 of the warp's 16: max across the quad's lanes",
        "for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n"),
        "gemms": ("sm::wgmma_ss_n128(sc, dqw + sm::step_k<64>(kk),",
                  "sm::wgmma_rs<D>(o, pa[kk], dvt + sm::step_mn(kk));"),
        "arrives": ("sm::mbar_arrive_tx(k_full + s, KVT);",
                    "sm::mbar_arrive_tx(v_full + s, KVT);"),
        "copies": ("sm::tma_load_4d(sk + s * KVT",
                   "sm::tma_load_4d(sv + s * KVT")},
    "d256_": {"softmax": None,
              "gemms": ("sm::wgmma_ss_n64(sc, dq + sm::step_k<64>(kk),",
                        "sm::wgmma_rs<128>(o, pa[kk], dv + sm::step_mn(kk));",
                        "sm::wgmma_ss_n128_mn(o, dp + sm::step_k<64>(kk),"),
              "arrives": ("sm::mbar_arrive_tx(k_full + s, TL);",
                          "sm::mbar_arrive_tx(v_full + v, TL);"),
              "copies": ("sm::tma_load_4d(sk + s * TL",
                         "sm::tma_load_4d(sv + v * TL")},
}


def probe_sources(text):
    """{name: flash_attention.cu} for the --probe variants of ``text``."""
    def once(t, a):
        if t.count(a) != 1:
            raise SystemExit("--probe: {!r} not found once".format(a[:50]))

    def no_softmax(t, p):  # from the comment's line to the O rescale's end
        a, b = p["softmax"]
        once(t, a)
        once(t, b)
        return t[:t.rindex("\n", 0, t.index(a)) + 1] + \
            t[t.index(b) + len(b):]

    def no_gemms(t, p):
        for a in p["gemms"]:
            once(t, a)
            t = t.replace(a, "if (0) " + a)
        return t

    def no_copies(t, p):
        for a in p["arrives"]:  # sm::mbar_arrive_tx(bar, bytes);
            once(t, a)
            bar = a[a.index("(") + 1:a.rindex(",")]
            t = t.replace(a, "sm::mbar_arrive({});".format(bar))
        for a in p["copies"]:
            once(t, a)
            t = t.replace(a, "if (0) " + a)
        return t

    out = {}
    for pre, p in PROBES.items():
        out.update({pre + "no_gemms": no_gemms(text, p),
                    pre + "no_copies": no_copies(text, p)})
        if p["softmax"]:
            out.update({
                pre + "no_softmax": no_softmax(text, p),
                pre + "copies_only": no_gemms(no_softmax(text, p), p),
                pre + "gemms_only": no_copies(no_softmax(text, p), p)})
    return out


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
    flags = [a for a in args if a in ("--bwd", "--k2k3")]
    roots = [a for a in args if a not in flags]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        cmd = [sys.executable, __file__, "--child", root] + flags
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
        if "--k2k3" in sys.argv[3:]:
            child_k2k3(sys.argv[2])
        else:
            child(sys.argv[2], "--bwd" in sys.argv[3:])
    else:
        sys.exit(main(sys.argv[1:]))
