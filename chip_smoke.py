#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (every failure is recorded and the script exits 1 at the end):
  1. card name and power limit (nvidia-smi); build the CUDA kernels from
     sparsebit_tpu_torch/csrc and print the build time;
  2. hold each kernel against its plain PyTorch version on the card at
     LLaMA-7B INT4-g128 shapes: max error against its tolerance, kernel ms
     (CUDA events, weights cycled over layers so that they come from HBM as
     they do in decode), plain ms, the HBM/peak bound and, where one
     PyTorch call computes the same function, that call's ms;
  3. a small LLaMA on the card against the same weights on the CPU:
     admission logits and teacher-forced decode logits agree;
  4. serve llama_7b()-shaped random INT4-g128 weights with
     DecodeEngine(max_batch=8, max_len=512, chunk=8, device="cuda"):
     8 requests x 32 tokens over several admission buckets; every request
     gets 32 tokens, every logit row is finite and every kernel launched.
It prints one JSON line of per-kernel numbers, the card's name and power
limit, and last {"ok": true, "device": {...}}. It exits non-zero without
CUDA or without the repository beside it.
"""

import json
import os
import subprocess
import sys
import time

H100_HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
SEED = 0

failures = []


def fail(msg):
    failures.append(msg)
    print("FAIL: " + msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def cuda_ms(fn, iters, warmup=2):
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / H100_HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def build_random_params(cfg, device, gs=128):
    """Random INT4-g128 weights in the port's serving layout, made on the
    card from a seeded generator: s4r bytes, bf16 scales U(0.001, 0.01),
    zeros 8, a tied bf16 head, no K padding."""
    import torch
    from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear

    g = torch.Generator(device=device).manual_seed(SEED)
    hd = cfg.head_dim

    def qlin(K, N):
        rows = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8,
                             generator=g, device=device)
        s = torch.empty((K // gs, N), device=device).uniform_(
            0.001, 0.01, generator=g).to(torch.bfloat16)
        z = torch.full((K // gs, N), 8.0, dtype=torch.bfloat16,
                       device=device)
        return QuantLinear({"s4r": rows}, s, z, 4, gs, N)

    ones = torch.ones(cfg.dim, dtype=torch.bfloat16, device=device)
    layers = [{
        "attn_norm": ones, "ffn_norm": ones,
        "wqkv": qlin(cfg.dim, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
        "wo": qlin(cfg.n_heads * hd, cfg.dim),
        "w13": qlin(cfg.dim, 2 * cfg.ffn_dim),
        "w2": qlin(cfg.ffn_dim, cfg.dim),
    } for _ in range(cfg.n_layers)]
    emb = (torch.randn((cfg.vocab_size, cfg.dim), generator=g,
                       device=device) * 0.02).to(torch.bfloat16)
    return {"tok_embed": emb, "layers": layers, "norm": ones,
            "lm_head": DenseLinear(emb.t().contiguous())}


def kernel_checks(stacked, cfg, results):
    """Phase 2: every kernel against its plain version at 7B shapes."""
    import torch
    from sparsebit_tpu_torch.ops import attention as A
    from sparsebit_tpu_torch.ops import ffn_fused as FF
    from sparsebit_tpu_torch.ops import matvec as MV
    from sparsebit_tpu_torch.ops import quant_matmul as QM
    from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    layers = stacked["layers"]
    Lx = cfg.n_layers

    def record(name, kernel, src, replaces, err, tol, ms, plain_ms,
               bnd, lib_ms, shape):
        ok = err <= tol
        print("{:<4} {:<34} err {:.3e} tol {:.3e} {} | {:.4f} ms "
              "plain {:.4f} ms bound {:.4f} ms ({}) lib {}".format(
                  kernel, shape, err, tol, "ok" if ok else "BAD", ms,
                  plain_ms, bnd[0], bnd[1],
                  "-" if lib_ms is None else "{:.4f} ms".format(lib_ms)),
              flush=True)
        if not ok:
            fail("{} {} error {:.3e} > {:.3e}".format(kernel, shape, err,
                                                      tol))
        if name:
            results.append({
                "name": name, "kernel": kernel, "route": "cuda",
                "source": src, "replaces": replaces, "shape": shape,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
            })

    # K1 at M in {1, 8, 64, 512} on the four 7B matmuls
    k1_src = "sparsebit_tpu_torch/csrc/quant_matmul.cu"
    # decode reads a layer of the stack (K1s); admission one linear (K1)
    k1_rep = {8: "sparsebit_tpu/ops/quant_matmul.py:693",
              512: "sparsebit_tpu/ops/quant_matmul.py:443"}
    for wname in ("wqkv", "wo", "w13", "w2"):
        ql = layers[wname]
        w, s, z = ql.packed["s4r"], ql.scales, ql.zeros
        K, N = w.shape[1] * 2, w.shape[2]
        G = K // ql.groupsize
        for M in (1, 8, 64, 512):
            x = torch.randn((M, K), generator=g, device=dev)
            x8, xs = tokenwise_quant(x)
            out = QM.quant_matmul_s4(x8, xs, w, s, z, ql.groupsize, li=0)
            ref = QM._qmm_s4_plain(x8, xs, w[0], s[0], z[0], ql.groupsize)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item()
            ms = cuda_ms(lambda i: QM.quant_matmul_s4(
                x8, xs, w, s, z, ql.groupsize, li=i % Lx), 20)
            pms = cuda_ms(lambda i: QM._qmm_s4_plain(
                x8, xs, w[i % Lx], s[i % Lx], z[i % Lx], ql.groupsize), 3, 1)
            nbytes = M * K + 4 * M + K * N // 2 + 2 * G * N * 2 + 4 * M * N
            bnd = bound_ms(nbytes, 2 * M * K * N, "int8")
            name = ("K1 {} M={}".format(wname, M)
                    if (M == 8 and wname in ("wqkv", "wo"))
                    or (M == 512 and wname == "w13") else None)
            record(name, "K1", k1_src, k1_rep.get(M), err, tol, ms, pms, bnd,
                   None,
                   "{} {}x{}->{} ".format(wname, M, K, N))

    # K2 at B=8, S=512, Hkv=H=32, D=128, mixed lengths, 8 cache layers
    B, S, H, Hkv, D, Lc = 8, 512, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8
    kc = torch.randint(-128, 128, (Lc, B, S, Hkv, D), dtype=torch.int8,
                       generator=g, device=dev)
    vc = torch.randint(-128, 128, (Lc, B, S, Hkv, D), dtype=torch.int8,
                       generator=g, device=dev)
    ksc = torch.empty((Lc, B, S, Hkv), device=dev).uniform_(
        0.001, 0.05, generator=g)
    vsc = torch.empty((Lc, B, S, Hkv), device=dev).uniform_(
        0.001, 0.05, generator=g)
    length = torch.tensor([0, 17, 100, 255, 300, 411, 480, 511],
                          dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=g, device=dev)
    kn = torch.randn((B, Hkv, D), generator=g, device=dev)
    vn = torch.randn((B, Hkv, D), generator=g, device=dev)
    caches = [t.clone() for t in (kc, vc, ksc, vsc)]
    out = A.decode_attention_update(q, kn, vn, kc, vc, ksc, vsc, 3, length)
    ref = A._attn_update_plain(q, kn, vn, *caches, 3, length)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip((kc, vc, ksc, vsc), caches))
    if not exact:
        fail("K2 cache codes/scales differ from the plain version")
    err = (out - ref).abs().max().item()
    ms = cuda_ms(lambda i: A.decode_attention_update(
        q, kn, vn, kc, vc, ksc, vsc, i % Lc, length), 50)
    pms = cuda_ms(lambda i: A._attn_update_plain(
        q, kn, vn, kc, vc, ksc, vsc, i % Lc, length), 3, 1)
    rows = int(length.sum().item()) + B  # rows [0, len_b] per batch row
    nbytes = (rows * Hkv * (2 * D + 8) + 4 * B * H * D * 2
              + 4 * 2 * B * Hkv * D)
    bnd = bound_ms(nbytes, 4 * rows * (H // Hkv) * Hkv * D, "f32")
    record("K2 B=8 S=512", "K2", "sparsebit_tpu_torch/csrc/attention.cu",
           "sparsebit_tpu/ops/attention.py:662", err, 2e-3, ms, pms, bnd,
           None, "B={} S={} H={} D={} codes {}".format(
               B, S, H, D, "exact" if exact else "DIFFER"))
    del kc, vc, ksc, vsc, caches

    # K3 at B in {1, 8}
    w13, w2 = layers["w13"], layers["w2"]
    F = cfg.ffn_dim
    gs = w13.groupsize
    args = (w13.packed["s4r"], w13.scales, w13.zeros, w2.packed["s4r"],
            w2.scales, w2.zeros, layers["ffn_norm"])
    for Bf in (1, 8):
        x = torch.randn((Bf, cfg.dim), generator=g, device=dev).to(
            torch.bfloat16)
        out = FF.ffn_block_fused(x, *args, 0, gs, cfg.rms_eps)
        lw = [a[0] for a in args]
        ref = FF._ffn_plain(x.float(), *lw[:6], lw[6], gs, cfg.rms_eps)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item()
        ms = cuda_ms(lambda i: FF.ffn_block_fused(
            x, *args, i % Lx, gs, cfg.rms_eps), 20)
        pms = cuda_ms(lambda i: FF._ffn_plain(
            x.float(), *[a[i % Lx] for a in args], gs, cfg.rms_eps), 3, 1)
        G1, G2 = cfg.dim // gs, F // gs
        nbytes = (cfg.dim * F + F * cfg.dim // 2 + 2 * 2 * (
            G1 * 2 * F + G2 * cfg.dim) + 2 * cfg.dim
            + 2 * Bf * cfg.dim + 4 * Bf * cfg.dim)
        bnd = bound_ms(nbytes, 2 * Bf * (cfg.dim * 2 * F + F * cfg.dim),
                       "int8")
        record("K3 B={}".format(Bf) if Bf == 8 else None, "K3",
               "sparsebit_tpu_torch/csrc/ffn_fused.cu",
               "sparsebit_tpu/ops/ffn_fused.py:45", err, tol, ms, pms, bnd,
               None, "B={} dim={} F={}".format(Bf, cfg.dim, F))

    # K9 at B in {1, 8}, 4096 -> 32000
    W = stacked["lm_head"].w
    for Bm in (1, 8):
        x = torch.randn((Bm, cfg.dim), generator=g, device=dev).to(
            torch.bfloat16)
        out = MV.bf16_matvec(x, W)
        ref = MV._bf16_matvec_plain(x, W)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-3 * ref.abs().max().item()
        ms = cuda_ms(lambda i: MV.bf16_matvec(x, W), 20)
        pms = cuda_ms(lambda i: MV._bf16_matvec_plain(x, W), 5, 1)
        lms = cuda_ms(lambda i: torch.matmul(x, W), 20)
        nbytes = 2 * cfg.dim * W.shape[1] + 2 * Bm * cfg.dim \
            + 4 * Bm * W.shape[1]
        bnd = bound_ms(nbytes, 2 * Bm * cfg.dim * W.shape[1], "bf16")
        record("K9 B={}".format(Bm) if Bm == 8 else None, "K9",
               "sparsebit_tpu_torch/csrc/matvec.cu",
               "sparsebit_tpu/ops/matvec.py:21", err, tol, ms, pms, bnd, lms,
               "B={} {}->{}".format(Bm, cfg.dim, W.shape[1]))


def small_model_check():
    """Phase 3: a small LLaMA served on the card agrees with the same
    weights run by the plain versions on the CPU (admission logits and
    four teacher-forced decode steps) within atol 0.1, with equal argmax
    wherever the top-2 margin exceeds 2 * atol: the discipline of the
    reference's own fused-vs-unfused test (tests/test_ffn_fused.py), since
    bf16 activations and int8 requantization may round differently when
    f32 sums are taken in another order."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm import llama as L
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
    from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear

    cfg = L.llama_tiny(dim=512, n_heads=4, n_kv_heads=4, ffn_dim=512)
    p_gpu = build_random_params(cfg, torch.device("cuda"))
    tensors = {}

    def to_cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.cpu()
        if isinstance(obj, dict):
            return {k: to_cpu(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [to_cpu(v) for v in obj]
        if isinstance(obj, (QuantLinear, DenseLinear)):
            out = obj.__class__.__new__(obj.__class__)
            out.__dict__ = {k: to_cpu(v) for k, v in obj.__dict__.items()}
            return out
        return obj

    p_cpu = to_cpu(p_gpu)
    gen = torch.Generator().manual_seed(SEED + 2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    last = torch.tensor([20, 31], dtype=torch.int32)
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = init_kv_cache(cfg, 2, 64, device=dev)
        lg, cache = Dm.prefill_at(
            params, prompts.to(dev), cache, cfg, last.to(dev),
            torch.zeros(2, dtype=torch.int32, device=dev))
        tensors[dev] = [lg.float().cpu()]
        tensors[dev + "_cache"] = cache
        tensors[dev + "_stacked"] = Dm.stack_layers(params)
    tok = tensors["cpu"][0].argmax(-1).to(torch.int32)
    for _ in range(4):
        outs = {}
        for dev in ("cuda", "cpu"):
            c = tensors[dev + "_cache"]
            lg = Dm._forward_scanned_kvs(
                tensors[dev + "_stacked"], tok.to(dev)[:, None],
                c.length[:, None], Dm._scan_cache(c), cfg)
            c.length = c.length + 1
            outs[dev] = lg[:, 0].float().cpu()
            tensors[dev].append(outs[dev])
        tok = outs["cpu"].argmax(-1).to(torch.int32)
    ATOL = 0.1
    err = max((a - b).abs().max().item()
              for a, b in zip(tensors["cuda"], tensors["cpu"]))
    argmax_ok = True
    for a, b in zip(tensors["cuda"], tensors["cpu"]):
        top2 = torch.topk(b, 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 2 * ATOL
        argmax_ok &= torch.equal(a.argmax(-1)[decisive],
                                 b.argmax(-1)[decisive])
    finite = all(torch.isfinite(t).all().item() for t in tensors["cuda"])
    print("small model cuda vs cpu: 5 logit steps, max err {:.3e} (atol "
          "{}), decisive argmax equal {}, finite {}".format(
              err, ATOL, argmax_ok, finite), flush=True)
    if err > ATOL or not argmax_ok or not finite:
        fail("small model cuda vs cpu logits err {:.3e}".format(err))


def serve_7b(params, cfg):
    """Phase 4: the engine on 7B widths; returns the launch counts."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm import serving as Sv
    from sparsebit_tpu_torch.ops import attention, ffn_fused, matvec
    from sparsebit_tpu_torch.ops import quant_matmul

    wrappers = {"K1": quant_matmul.quant_matmul_s4,
                "K2": attention.decode_attention_update,
                "K3": ffn_fused.ffn_block_fused,
                "K9": matvec.bf16_matvec}
    t0 = time.perf_counter()
    eng = Sv.DecodeEngine(params, cfg, max_batch=8, max_len=512, chunk=8,
                          device="cuda")
    torch.cuda.synchronize()
    print("engine set-up {:.1f} s".format(time.perf_counter() - t0))
    finite = []
    orig_sample = Dm.sample_logits_vec

    def sample_checked(logits, temps, generator=None):
        finite.append(torch.isfinite(logits).all())
        return orig_sample(logits, temps, generator)

    chunk_s = []
    orig_chunk = Sv.decode_chunk_scanned

    def chunk_timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_chunk(*a, **kw)
        torch.cuda.synchronize()
        chunk_s.append((time.perf_counter() - t, a[-1]))
        return out

    Dm.sample_logits_vec = Sv.sample_logits_vec = sample_checked
    Sv.decode_chunk_scanned = chunk_timed
    gen = torch.Generator().manual_seed(SEED + 3)
    lens = [16, 40, 60, 100, 130, 170, 200, 25]
    for n in lens:
        eng.add_request(torch.randint(0, cfg.vocab_size, (n,),
                                      generator=gen).tolist(),
                        max_new_tokens=32)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = eng.run()
        torch.cuda.synchronize()
    finally:
        Dm.sample_logits_vec = Sv.sample_logits_vec = orig_sample
        Sv.decode_chunk_scanned = orig_chunk
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    n_tok = sum(len(v) for v in res.values())
    if len(res) != len(lens) or any(len(v) != 32 for v in res.values()):
        fail("engine returned {} requests with lengths {}".format(
            len(res), [len(v) for v in res.values()]))
    if not all(bool(f.item()) for f in finite):
        fail("non-finite logits in the engine run")
    for k, n in launches.items():
        if n <= 0:
            fail("{} was not launched on the main path".format(k))
    dec_s = sum(t for t, _ in chunk_s)
    steps = sum(n for _, n in chunk_s)
    print("engine: {} requests, {} tokens, prompts {} (buckets {}), "
          "run {:.3f} s".format(len(res), n_tok, lens,
                                sorted({Sv._bucket(n) for n in lens}),
                                wall), flush=True)
    print("engine decode: {} chunks, {} steps at B=8, {:.3f} ms/step, "
          "{:.1f} tok/s (8 slots)".format(
              len(chunk_s), steps, 1e3 * dec_s / steps,
              8 * steps / dec_s), flush=True)
    print("engine launches: {}".format(launches), flush=True)
    return launches, {"requests": len(res), "tokens": n_tok,
                      "run_s": wall, "decode_ms_per_step": 1e3 * dec_s / steps,
                      "decode_tok_s": 8 * steps / dec_s,
                      "prompt_lens": lens}


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "sparsebit_tpu_torch")):
        print("sparsebit_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from sparsebit_tpu_torch.llm.llama import llama_7b
    from sparsebit_tpu_torch.ops import _kernels

    card = card_line()
    print("card: {}".format(card), flush=True)
    t0 = time.perf_counter()
    _kernels.lib()
    print("kernel build + load {:.1f} s".format(time.perf_counter() - t0),
          flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    cfg = llama_7b()
    params = build_random_params(cfg, torch.device("cuda"))
    from sparsebit_tpu_torch.llm.decode import stack_layers

    results = []
    t0 = time.perf_counter()
    kernel_checks(stack_layers(params), cfg, results)
    torch.cuda.empty_cache()
    print("kernel checks {:.1f} s".format(time.perf_counter() - t0))
    small_model_check()
    launches, engine = serve_7b(params, cfg)
    for r in results:
        r["launches"] = launches[r["kernel"]]
    print(json.dumps({"kernels": results, "engine": engine,
                      "card": card}), flush=True)
    print(card, flush=True)
    if failures:
        print("{} failure(s)".format(len(failures)), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
