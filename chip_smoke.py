#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ab ROOT]

Phases (every failure is recorded and the script exits 1 at the end):
  1. card name and power limit (nvidia-smi); build the CUDA kernels from
     sparsebit_tpu_torch/csrc (one nvcc per source, all started together,
     and one more for a copy of K4 built with -DSBT_PHASE_TRACE, whose
     phase times and grid-barrier probe phase 2 prints) and print the
     build time;
  2. hold each kernel against its plain PyTorch version on the card at
     LLaMA-7B shapes: max error against its tolerance, kernel ms (CUDA
     events, weights or caches cycled over copies so that they come from
     HBM as they do in decode), plain ms, the HBM/peak bound and, where one
     PyTorch call computes the same function, that call's ms. K1-K4 and K9
     at INT4-g128 serving shapes (K1 on the four fused linears at M = 1,
     8, 16, 32, 64, 128, 512 and 768, bit-equal to the plain version in
     its plan's order, eager and graph-replay ms, with torch._int_mm at
     M = 512 timed as context only; K2 at B=8 S=512 and S=2048 and at 64
     query heads a kv head, KV codes and scales exact, out within 2e-3 of
     the plain version and of the cluster-order oracle, two planted faults
     past the first split caught; K3 at B = 1, 8 and 64 bit-equal, a
     planted W2 fault caught; K2 and K3 also in graph-replay ms; with
     --ab ROOT, ROOT's K2, K3 (device) and K4 (eager) ms beside this
     tree's, timed in turns by k10_ab.py --k2k3 ROOT . . ROOT (ROOT: the
     parent commit unpacked by git archive); K4: all 32 layers at B = 1, 8, 32 and
     B = 8 paged, output, KV codes and scales exact, its phase trace at
     B = 1, 8 and 32; K4's plane mode, "K4p",
     at 3 and 2 bits, B = 1 and 8, output, codes and scales equal to the
     plain version's); K8, K6 (2/4/8 bits) and
     K7 (3 bits, f32 and int8 x) at the 7B unfused shapes, B = 1/8/64; K5
     at S = 2048, B = 1/8/32, int8 and bf16 caches, and one GQA case; K10
     (flash causal attention) against flash_attention_plain, bf16 H=32
     hd=128 at B=1 S=2048 and B=8 S=512, hd 64 and 256 at S=1024, ragged
     S = 2047 and 100, f32 at S=512, Hkv=8, and B=4 S=512 both without
     and with the log-sum-exp output (the training forward), each element
     within its own bound (flash_tolerance), which must reject planted
     key-tile faults at S = 2048, a second launch bit-equal, with SDPA
     (is_causal) timed beside it as a yardstick; K11
     (dK, dV) and K12 (dQ), the flash backward, against their plain
     versions at the same shapes with B=4 S=512 (the qlora path's) in
     place of B=8 S=512, over K10's own log-sum-exp (itself within 2^-14
     of the plain version's), each element within its own bound
     (flash_bwd_tolerance), which must reject planted faults at B=4
     S=512 (a skipped query tile, dS without di, a skipped diagonal
     tile), dQ, dK and dV bit-equal across two launches, with SDPA's
     backward timed beside them (device ms from a graph replay, or the
     profiler where a capture fails);
  3. a small LLaMA on the card against the same weights on the CPU:
     admission logits and teacher-forced decode logits agree;
  4. the paths, one at a time, every kernel count set to 0 before a path
     and read after it:
     generate   decode.generate at llama_7b() widths and 32 layers over
                random GPTQ INT4-g128 weights in the layout
                load_quant_checkpoint returns (unfused projections,
                column planes, f32 qparams, impl "auto", bf16 head, int8
                KV): B = 1 x 64 greedy tokens, B = 8 x 32, one sampled
                run and one over a bf16 cache; prefill s, wall ms per
                decode step and the kernels' device ms per step. One
                decode_step's logits on the kernels equal the plain
                versions' on the card;
     mixed      a 2/3/4/8-bit model at 7B widths, depth 4, written by
                save_quant_checkpoint and read by load_quant_checkpoint,
                then generate with impl "auto" (K7, K8) and "a8" (K6, K7);
     chunk      DecodeEngine on a 4/8-bit model K4 refuses (depth 4):
                decode_chunk with K1, K6 and K5, no K4;
     main       DecodeEngine(max_batch=8, max_len=512, chunk=8) on K4 (8
                requests x 32 tokens; wall ms/step beside K4's device
                ms/step; the admission: host s around the prefill_at
                groups, K1's device ms inside them, K1's launches by
                shape);
     unfused    decode_chunk_scanned with FORCE_LAYER_KERNEL = False
                (K1/K2/K3) at a reduced depth, K2's and K3's device ms a
                step beside the wall ms/step, and the same requests on
                the K4 route (where the tokens agree);
     paged      PagedDecodeEngine(block=128) against the fixed-slot engine
                on 10 requests with a shared 256-token prefix, tokens
                equal;
     paged_cold PagedDecodeEngine(block=128) on its own admissions: 4
                requests of 1000-2000 tokens x 16 new tokens, every
                admission cold (prefill_cold_scanned: K10, K1, K9), decode
                on K4; admission s (with K1's and K10's device ms inside)
                and tok/s;
     prefill    prefill_cold_scanned (K10) at 32 layers, B=1 S=2048 and
                B=8 S=512, against the same call on the masked route and
                against prefill_at (masked scores over the int8 cache):
                wall s, K10's and K1's device ms, K10 launches (32 a
                call), peak memory of each; K10 held to its plain version
                on every layer's operands, logits agree, layer 0's KV
                codes equal;
     planes     a uniform INT3-g128 model at llama_7b() widths and 32
                layers (random fused checkpoint-layout weights) through
                prepare_params_host(sub4="planes") -> stack_layers ->
                prefill_scanned (64-token prompts) -> decode_tokens_scanned
                (32 tokens) at B = 1 and 8: K4 in plane mode over a 3N/8
                wide "pl" stack; the same model under sub4="nibble", the
                first decode step's logits of both agreeing;
     segments   a 4-bit + 3-bit stack at 7B widths, depth 4: an s4r launch
                and a plane launch (li_cache) against one homogeneous
                nibble launch, within 2e-4 with KV codes equal;
     eval       eval.perplexity(seqlen=2048, batch=1) over random INT4
                checkpoint-layout weights (activations O(1)) on a seeded
                two-window stream (2047-token windows through K10), K10
                held to its plain version on every layer's operands, s a
                window and K10's device ms; the log-perplexity within 1e-3
                relative of the masked route;
     qlora      QLoRA training (qlora_train_step) at llama_7b() widths and
                32 layers over random INT4-g128 weights in the checkpoint
                layout (activations O(1)), r = 8 adapters on wq/wv, AdamW
                lr 3e-4, B = 4 x 513 tokens, with the dense and the int8
                backward: every layer's K11/K12 held to the plain
                versions, 4 timed steps (wall s split into forward and
                backward, tok/s, K10/K11/K12 device ms and launches, 32
                each a step, peak memory), one step's loss and adapter
                gradients against the plain versions, the backbone
                bit-equal after the steps;
     gptq       GPTQ conversion (quantize_llama_gptq, 4-bit g128) of a
                seeded f32 model at llama_7b() widths, depth 2, fused
                layers, on 128 x 2048 seeded calibration tokens: s of the
                Hessians, the Cholesky, the column loop a linear and the
                propagation (K10 f32, 256 launches), peak memory; every
                linear's Hessian loss below round to nearest's, codes in
                range, one wo solved on the CPU from the same H within the
                CPU test's tolerance; the result saved under the bf16
                serving config, loaded, served by DecodeEngine on K4 (K1,
                K9) and by generate B=8 (K8, K5, K9), one decode_step held
                to the plain versions;
     fixture    the accuracy fixture (run_fixture(steps=200, gptq_bits=(4,
                3))) on the card: five perplexities, train / GPTQ / eval
                s, ppl_float < 4 and int4 GPTQ < 1.05 x float held, every
                GPTQ'd linear below RTN on its Hessian loss, int4 GPTQ <=
                RTN x 1.002 recorded (fault R9), K8 launched.
It prints one JSON line of per-kernel and per-path numbers, the card's
name and power limit, and last {"ok": true, "device": {...}}. It exits
non-zero without CUDA or without the repository beside it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

H100_HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
SEED = 0
K5_ENTRY = "sbt_decode_attention"  # K5's C entry point (KernelEvents names)

failures = []
probes = {}  # measurements that are no kernel's: printed in the JSON line


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


def graph_ms(fn, iters):
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so that the host's time to issue them is not
    counted (beside cuda_ms, which times the calls as issued). None, with
    the reason printed, where a call cannot be captured."""
    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(2):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                fn(i)
        graph.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters
    except RuntimeError as e:
        print("graph timing unavailable: {}".format(e), flush=True)
        return None


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / H100_HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def _scale_range(K, bits, unit):
    """Scales U(lo, hi) * mult of a random linear, as (lo, hi, mult).
    Default U(0.001, 0.01) * 16 / 2^bits. ``unit``: U(0.5, 1.5) times
    about 1 / (sd of the codes * sqrt(K)), so that with zero-centred
    codes each linear keeps its input's scale and the residual stream
    stays O(1) over the layers (at the default, the codes' mean of -1/2
    and the FFN make rows of ~1e3 by layer 1, and the softmax of every
    later layer is near one-hot)."""
    if not unit:
        return 0.001, 0.01, 16.0 / 2 ** bits
    return 0.5, 1.5, 1.0 / (((4 ** bits - 1) / 12.0) ** 0.5 * K ** 0.5)


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


UNFUSED = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
FUSED = ("wqkv", "wo", "w13", "w2")


def _linear_shape(cfg, name):
    hd = cfg.head_dim
    return {"wqkv": (cfg.dim, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
            "w13": (cfg.dim, 2 * cfg.ffn_dim),
            "wq": (cfg.dim, cfg.n_heads * hd),
            "wk": (cfg.dim, cfg.n_kv_heads * hd),
            "wv": (cfg.dim, cfg.n_kv_heads * hd),
            "wo": (cfg.n_heads * hd, cfg.dim),
            "w1": (cfg.dim, cfg.ffn_dim), "w3": (cfg.dim, cfg.ffn_dim),
            "w2": (cfg.ffn_dim, cfg.dim)}[name]


def random_plane_linear(K, N, bits, g, device, gs=128, copies=None,
                        unit=False):
    """A random GPTQ QuantLinear in the container load_quant_checkpoint
    returns: "w" column planes at 2/4/8 bits or 3-bit low2 + high1, N
    padded as the JAX package pads it, f32 scales U(0.001, 0.01) * 16 /
    2^bits and mid-range zeros, impl "auto". ``copies`` adds a leading
    axis of that many independent copies (for timing from HBM).
    ``unit``: zeros 2^(bits-1) - 1/2 (codes centred on 0) and scales from
    _scale_range."""
    import torch
    from sparsebit_tpu_torch.llm.quant import QuantLinear
    from sparsebit_tpu_torch.ops.packing import pallas_n_pad

    lead = () if copies is None else (copies,)
    Np = N + pallas_n_pad(N, bits)

    def planes(cols):
        return torch.randint(0, 256, lead + (K, cols), dtype=torch.uint8,
                             generator=g, device=device)

    if bits == 3:
        packed = {"low2": planes(Np // 4), "high1": planes(Np // 8)}
    else:
        packed = {"w": planes(Np * bits // 8)}
    G = K // gs
    lo, hi, mult = _scale_range(K, bits, unit)
    s = torch.empty(lead + (G, Np), device=device).uniform_(
        lo, hi, generator=g) * mult
    z = torch.full(lead + (G, Np), 2 ** (bits - 1) - (0.5 if unit else 0.0),
                   device=device)
    return QuantLinear(packed, s, z, bits, gs, N)


def build_plane_params(cfg, device, bits_of, seed, names=UNFUSED,
                       unit=False):
    """Random weights in the checkpoint layout (the one load_quant_checkpoint
    returns for a GPTQ model): unfused wq/wk/wv/wo/w1/w2/w3 (or, with
    ``names=FUSED``, fused wqkv/wo/w13/w2) from random_plane_linear at
    ``bits_of(layer, name)`` bits (``unit`` passed on), g128, bf16 norms,
    embedding and an untied dense bf16 head, made on the card from a
    seeded generator."""
    import torch
    from sparsebit_tpu_torch.llm.quant import DenseLinear

    g = torch.Generator(device=device).manual_seed(seed)
    ones = torch.ones(cfg.dim, dtype=torch.bfloat16, device=device)
    layers = []
    for li in range(cfg.n_layers):
        layer = {"attn_norm": ones, "ffn_norm": ones}
        for name in names:
            K, N = _linear_shape(cfg, name)
            layer[name] = random_plane_linear(K, N, bits_of(li, name), g,
                                              device, unit=unit)
        layers.append(layer)

    def dense(shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02).to(
            torch.bfloat16)

    return {"tok_embed": dense((cfg.vocab_size, cfg.dim)), "layers": layers,
            "norm": ones,
            "lm_head": DenseLinear(dense((cfg.dim, cfg.vocab_size)))}


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
               bnd, lib_ms, shape, gms=None, ratio=None):
        # tol: one bound for every element; or None with ratio, the
        # largest error over its own element's bound
        ok = err <= tol if ratio is None else ratio <= 1.0
        tol_s = ("{:.3e}".format(tol) if ratio is None
                 else "elementwise, worst err/tol {:.3f}".format(ratio))
        # share of the bound reached (bound / ms) and ms over the library's
        frac = bnd[0] / ms
        vs_lib = None if lib_ms is None else ms / lib_ms
        print("{:<4} {:<34} err {:.3e} tol {} {} | {:.4f} ms "
              "plain {:.4f} ms bound {:.4f} ms ({}, {:.1%} of it) lib "
              "{}".format(
                  kernel, shape, err, tol_s, "ok" if ok else "BAD", ms,
                  plain_ms, bnd[0], bnd[1], frac,
                  "-" if lib_ms is None else "{:.4f} ms (kernel/lib "
                  "{:.2f}x)".format(lib_ms, vs_lib)),
              flush=True)
        if gms:  # device ms from graph replay: kernel, library
            print("{:<4} {:<34} device (graph replay) {} ms, lib {} "
                  "ms".format(kernel, shape, *("-" if t is None else
                                                "{:.4f}".format(t)
                                                for t in gms)), flush=True)
        if not ok:
            fail("{} {} error {:.3e} over tol {}".format(kernel, shape, err,
                                                         tol_s))
        if name:
            results.append({
                "name": name, "kernel": kernel, "route": "cuda",
                "source": src, "replaces": replaces, "shape": shape,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
                "bound_frac": frac, "ms_over_library": vs_lib,
            })
            if gms:
                results[-1].update(device_ms=gms[0], library_device_ms=gms[1])
            if ratio is not None:
                results[-1].update(err_over_tol=ratio)

    # K1 on the four 7B matmuls at the decode rows (M = 1, 8, 64: K1s on
    # the chunk and unfused routes, the streaming tile) and at the main
    # cell's admission rows (M = 16, 32, 128, 768: its prefill_at groups;
    # 512 kept from earlier runs; the tensor-core admission tile past 64):
    # bit-equal to the plain version in the kernel's order (k1_plan), eager
    # and graph-replay (device) ms
    k1_src = "sparsebit_tpu_torch/csrc/quant_matmul.cu"
    for wname in FUSED:
        ql = layers[wname]
        w, s, z = ql.packed["s4r"], ql.scales, ql.zeros
        gs = ql.groupsize
        K, N = w.shape[1] * 2, w.shape[2]
        G = K // gs
        for M in (1, 8, 16, 32, 64, 128, 512, 768):
            x = torch.randn((M, K), generator=g, device=dev)
            x8, xs = tokenwise_quant(x)
            tile, gps = QM.k1_plan(M, K, N, gs)
            out = QM.quant_matmul_s4(x8, xs, w, s, z, gs, li=0)
            ref = QM._qmm_s4_plain(x8, xs, w[0], s[0], z[0], gs, gps)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()

            def run(i):
                return QM.quant_matmul_s4(x8, xs, w, s, z, gs, li=i % Lx)

            ms = cuda_ms(run, 20)
            gms = (graph_ms(run, 20), None)
            pms = cuda_ms(lambda i: QM._qmm_s4_plain(
                x8, xs, w[i % Lx], s[i % Lx], z[i % Lx], gs, gps), 3, 1)
            nbytes = M * K + 4 * M + K * N // 2 + 2 * G * N * 2 + 4 * M * N
            bnd = bound_ms(nbytes, 2 * M * K * N, "int8")
            # decode reads a layer of the stack (K1s); admission one linear
            rep_at = ("sparsebit_tpu/ops/quant_matmul.py:693" if M <= 64
                      else "sparsebit_tpu/ops/quant_matmul.py:443")
            record("K1 {} M={}".format(wname, M), "K1", k1_src, rep_at, err,
                   0.0, ms, pms, bnd, None, "{} {}x{}->{} {}{}".format(
                       wname, M, K, N, tile,
                       "" if tile == "admit" else " gps {}".format(gps)),
                   gms)
    int_mm_probe(g)

    k2_checks(cfg, record, g)
    k3_checks(stacked, cfg, record, g)

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
        gms = (graph_ms(lambda i: MV.bf16_matvec(x, W), 20),
               graph_ms(lambda i: torch.matmul(x, W), 20))
        nbytes = 2 * cfg.dim * W.shape[1] + 2 * Bm * cfg.dim \
            + 4 * Bm * W.shape[1]
        bnd = bound_ms(nbytes, 2 * Bm * cfg.dim * W.shape[1], "bf16")
        record("K9 B={}".format(Bm), "K9",
               "sparsebit_tpu_torch/csrc/matvec.cu",
               "sparsebit_tpu/ops/matvec.py:21", err, tol, ms, pms, bnd, lms,
               "B={} {}->{}".format(Bm, cfg.dim, W.shape[1]), gms)

    k4_checks(stacked, cfg, record, g)
    k4_plane_checks(cfg, record, g)
    plane_checks(cfg, record, g)
    k5_checks(cfg, record, g)
    k10_checks(cfg, record, g)
    k11_k12_checks(cfg, record, g)


K2_LENGTHS = [0, 17, 100, 255, 300, 411, 480, 511]
# (B, S, H, Hkv, D, lengths): the 7B decode at S = 512, K5's S = 2048
# lengths, and 64 query heads a kv head
K2_CASES = [(8, 512, 32, 32, 128, K2_LENGTHS),
            (8, 2048, 32, 32, 128, [(b + 1) * 256 - 1 for b in range(8)]),
            (8, 512, 64, 1, 128, K2_LENGTHS)]


def k2_planted(q, kn, vn, caches, li, length, out, C):
    """Errors of K2's output ``out`` against the plain version over two
    faulted copies of the cache ``caches`` (as they were before the call):
    in the longest batch row, the row past its first split (rows [0, len]
    cut into C ranges; with C = 1 the second half) with the largest
    weight p * vs for query head 0, its largest V code with the top bit
    flipped, or its V scale doubled. Each must exceed K2's tolerance."""
    import torch
    from sparsebit_tpu_torch.ops import attention as A

    b = int(torch.argmax(length).item())
    n = int(length[b].item()) + 1
    lo = -(-n // C) if C > 1 else n // 2
    rows = slice(lo, n - 1)  # row len_b is written by the call itself
    k, v, ks, vs = caches
    D = q.shape[-1]
    qb = q[b, 0].to(torch.bfloat16).float()
    score = (k[li, b, rows, 0].float() @ qb) * ks[li, b, rows, 0] / D ** 0.5
    r = lo + int(torch.argmax(torch.exp(score - score.max())
                              * vs[li, b, rows, 0]).item())
    errs = []
    for kind in ("code", "scale"):
        f = [t.clone() for t in caches]
        if kind == "code":
            d = int(torch.argmax(f[1][li, b, r, 0].abs().int()).item())
            f[1][li, b, r, 0, d] ^= -128  # the top bit
        else:
            f[3][li, b, r, 0] *= 2
        ref = A._attn_update_plain(q, kn, vn, *f, li, length)
        errs.append((out - ref).abs().max().item())
    return errs


def k2_checks(cfg, record, g):
    """K2 against its plain version at K2_CASES over 8 cache layers
    (cycled, so that the cache streams from HBM): KV codes and scales
    exact, out within 2e-3 of the plain version and of the cluster-order
    oracle (_attn_update_cluster_plain at the kernel's cluster size);
    eager and graph-replay ms; two planted faults past the first split
    (k2_planted) must each exceed the tolerance."""
    import torch
    from sparsebit_tpu_torch.ops import _kernels
    from sparsebit_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    Lc, tol = 8, 2e-3
    for B, S, H, Hkv, D, lens in K2_CASES:
        kc = torch.randint(-128, 128, (Lc, B, S, Hkv, D), dtype=torch.int8,
                           generator=g, device=dev)
        vc = torch.randint(-128, 128, (Lc, B, S, Hkv, D), dtype=torch.int8,
                           generator=g, device=dev)
        ksc = torch.empty((Lc, B, S, Hkv), device=dev).uniform_(
            0.001, 0.05, generator=g)
        vsc = torch.empty((Lc, B, S, Hkv), device=dev).uniform_(
            0.001, 0.05, generator=g)
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, D), generator=g, device=dev)
        kn = torch.randn((B, Hkv, D), generator=g, device=dev)
        vn = torch.randn((B, Hkv, D), generator=g, device=dev)
        before = [t.clone() for t in (kc, vc, ksc, vsc)]
        caches = [t.clone() for t in before]
        C = A.k2_cluster(B, S, Hkv, _kernels.sm_count(dev))
        out = A.decode_attention_update(q, kn, vn, kc, vc, ksc, vsc, 3,
                                        length)
        ref = A._attn_update_plain(q, kn, vn, *caches, 3, length)
        oracle = A._attn_update_cluster_plain(
            q, kn, vn, *[t.clone() for t in before], 3, length, C)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b)
                    for a, b in zip((kc, vc, ksc, vsc), caches))
        tag = "B={} S={} H={} Hkv={} D={}".format(B, S, H, Hkv, D)
        if not exact:
            fail("K2 {} cache codes/scales differ from the plain "
                 "version".format(tag))
        err = (out - ref).abs().max().item()
        err_o = (out - oracle).abs().max().item()
        if err_o > tol:
            fail("K2 {} error {:.3e} against the cluster-order oracle over "
                 "{:.0e}".format(tag, err_o, tol))
        planted = k2_planted(q, kn, vn, before, 3, length, out, C)
        print("K2   {} cluster {}: err vs oracle {:.3e}; planted faults "
              "(flipped V code, doubled V scale) err {:.3e} / {:.3e}, "
              "{:.1f}x / {:.1f}x the tolerance".format(
                  tag, C, err_o, *planted, *(e / tol for e in planted)),
              flush=True)
        if min(planted) <= tol:
            fail("K2 {}: a planted fault within the tolerance {}".format(
                tag, planted))
        del before, caches

        def run(i):
            return A.decode_attention_update(q, kn, vn, kc, vc, ksc, vsc,
                                             i % Lc, length)

        ms = cuda_ms(run, 50)
        gms = (graph_ms(run, 20), None)
        pms = cuda_ms(lambda i: A._attn_update_plain(
            q, kn, vn, kc, vc, ksc, vsc, i % Lc, length), 3, 1)
        rows = int(length.sum().item()) + B  # rows [0, len_b] per batch row
        nbytes = (rows * Hkv * (2 * D + 8) + 4 * B * H * D * 2
                  + 4 * 2 * B * Hkv * D)
        bnd = bound_ms(nbytes, 4 * rows * (H // Hkv) * Hkv * D, "f32")
        record("K2 " + tag, "K2", "sparsebit_tpu_torch/csrc/attention.cu",
               "sparsebit_tpu/ops/attention.py:662", err, tol, ms, pms, bnd,
               None, "{} cluster {} codes {}".format(
                   tag, C, "exact" if exact else "DIFFER"), gms)
        del kc, vc, ksc, vsc
    torch.cuda.empty_cache()


def k3_checks(stacked, cfg, record, g):
    """K3 bit-equal to _ffn_plain (the kernel's order: the norm's tree,
    s4_plan's K splits) at llama_7b() widths, B = 1, 8 and 64, over the
    32 layers' stacks cycled so that the weights stream from HBM; eager
    and graph-replay ms; a doubled W2 scale (column 0 of a group past
    W2's first split) must break the equality."""
    import torch
    from sparsebit_tpu_torch.ops import ffn_fused as FF
    from sparsebit_tpu_torch.ops import quant_matmul as QM

    dev = torch.device("cuda")
    layers = stacked["layers"]
    w13, w2 = layers["w13"], layers["w2"]
    F, dim, Lx = cfg.ffn_dim, cfg.dim, cfg.n_layers
    gs = w13.groupsize
    args = (w13.packed["s4r"], w13.scales, w13.zeros, w2.packed["s4r"],
            w2.scales, w2.zeros, layers["ffn_norm"])
    g2 = min(QM.s4_plan(F, dim, gs), F // gs - 1)  # W2's second split
    for Bf in (1, 8, 64):
        x = torch.randn((Bf, dim), generator=g, device=dev).to(
            torch.bfloat16)
        out = FF.ffn_block_fused(x, *args, 0, gs, cfg.rms_eps)
        lw = [a[0] for a in args]
        ref = FF._ffn_plain(x.float(), *lw, gs, cfg.rms_eps)
        s2f = lw[4].clone()
        s2f[g2, 0] *= 2
        ref_f = FF._ffn_plain(x.float(), *lw[:4], s2f, *lw[5:], gs,
                              cfg.rms_eps)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        err_f = (out - ref_f).abs().max().item()
        print("K3   B={}: planted fault (W2 scale of group {} column 0 "
              "doubled) err {:.3e}".format(Bf, g2, err_f), flush=True)
        if err_f <= 0.0:
            fail("K3 B={}: a doubled W2 scale left the output equal".format(
                Bf))

        def run(i):
            return FF.ffn_block_fused(x, *args, i % Lx, gs, cfg.rms_eps)

        ms = cuda_ms(run, 20)
        gms = (graph_ms(run, 20), None)
        pms = cuda_ms(lambda i: FF._ffn_plain(
            x.float(), *[a[i % Lx] for a in args], gs, cfg.rms_eps), 3, 1)
        G1, G2 = dim // gs, F // gs
        nbytes = (dim * F + F * dim // 2 + 2 * 2 * (G1 * 2 * F + G2 * dim)
                  + 2 * dim + 2 * Bf * dim + 4 * Bf * dim)
        bnd = bound_ms(nbytes, 2 * Bf * (dim * 2 * F + F * dim), "int8")
        record("K3 B={}".format(Bf), "K3",
               "sparsebit_tpu_torch/csrc/ffn_fused.cu",
               "sparsebit_tpu/ops/ffn_fused.py:45", err, 0.0, ms, pms, bnd,
               None, "B={} dim={} F={}".format(Bf, dim, F), gms)


def ab_timings(root, results):
    """With ``--ab ROOT`` (another tree of the repository, e.g. the parent
    commit unpacked by git archive): k10_ab.py --k2k3 times ROOT, this
    tree, this tree and ROOT in turns, K2 and K3 at K2_CASES and B =
    1/8/64 (device ms) and K4 / K4p at phase 2's contiguous shapes (eager
    ms), each tree on operands of its own from the same seeds; each of
    those rows gains ``ab_ms`` (this tree's two readings) and
    ``ab_root_ms`` (ROOT's)."""
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, os.path.join(here, "k10_ab.py"), "--k2k3", root,
         here, here, root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=1200)
    print(res.stdout, flush=True)
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    if res.returncode != 0 or len(lines) != 4:
        fail("k10_ab.py --k2k3 exited {} with {} lines".format(
            res.returncode, len(lines)))
        return
    keys = {"K2": "k2_ms", "K3": "k3_ms", "K4": "k4_ms", "K4p": "k4_ms"}
    for r in results:
        key = keys.get(r["kernel"])
        tag = r["shape"].split(" cluster")[0].split(" L=")[0]
        if key is None or tag not in lines[0].get(key, {}):
            continue
        r["ab_root_ms"] = [lines[0][key][tag], lines[3][key][tag]]
        r["ab_ms"] = [lines[1][key][tag], lines[2][key][tag]]


def int_mm_probe(g):
    """Context only, no kernel's yardstick: torch._int_mm, PyTorch's own
    int8 tensor-core GEMM (int32 out, no group epilogue: not K1's
    function), at K1's largest admission product, M = 512, 4096 -> 22016,
    eager and graph-replay ms. The port never calls it."""
    import torch

    dev = torch.device("cuda")
    a = torch.randint(-128, 128, (512, 4096), dtype=torch.int8,
                      generator=g, device=dev)
    b = torch.randint(-128, 128, (22016, 4096), dtype=torch.int8,
                      generator=g, device=dev).t()
    try:
        ms = cuda_ms(lambda i: torch._int_mm(a, b), 20)
    except RuntimeError as e:  # a library call, timed for context only
        print("torch._int_mm unavailable: {}".format(e), flush=True)
        return
    dms = graph_ms(lambda i: torch._int_mm(a, b), 20)
    probes["torch._int_mm M=512 4096->22016 ms (context)"] = ms
    probes["torch._int_mm M=512 4096->22016 device ms (context)"] = dms
    print("context: torch._int_mm int8 M=512 4096->22016 (no group "
          "epilogue) {:.4f} ms, device {}".format(
              ms, "-" if dms is None else "{:.4f}".format(dms)), flush=True)


def plane_checks(cfg, record, g):
    """K8 (f32 x, "w" planes), K6 (int8 x, "w" planes) and K7 (3-bit
    planes, f32 and int8 x) against _qmm_planes_plain at the 7B unfused
    shapes, B = 1, 8, 64: all three shapes at 4 bits, 4096 -> 11008 at 2
    and 8 bits (K8, K6) and at 3 bits (K7, N padded to 11264); then the
    split-K edges: 11008 -> 4096 at 3 bits (86 groups in uneven splits),
    the per-channel 8-bit head 4096 -> 32000 (one group: no split) and
    B = 37. Tolerance 1e-4 of max |out| (tests/test_ops.py:81,115,139);
    a second call must give equal bits (the K splits are added in split
    order); 8 copies of each weight are cycled so that it streams from
    HBM; a second time per case from a CUDA-graph replay (device time,
    without the wrapper's host cost). No PyTorch call computes a
    group-quantized matmul, so library_ms is null."""
    import torch
    from sparsebit_tpu_torch.ops import quant_matmul as QM
    from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant

    dev = torch.device("cuda")
    nc = 8
    src = "sparsebit_tpu_torch/csrc/quant_matmul_planes.cu"
    rep = {"K8": "sparsebit_tpu/ops/quant_matmul.py:57",
           "K6": "sparsebit_tpu/ops/quant_matmul.py:844",
           "K7": "sparsebit_tpu/ops/quant_matmul.py:241"}
    d, f = cfg.dim, cfg.ffn_dim
    cases = [(b, K, N, 128, (1, 8, 64))
             for b in (4,) for K, N in ((d, d), (d, f), (f, d))]
    cases += [(b, d, f, 128, (1, 8, 64)) for b in (2, 8)]
    cases += [(3, d, f, 128, (1, 8, 64))]
    cases += [(3, f, d, 128, (8, 37)), (8, d, cfg.vocab_size, -1, (8,))]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bits, K, N, gsz, Ms in cases:
        lin = random_plane_linear(K, N, bits, g, dev, gs=gsz if gsz > 0
                                  else K, copies=nc)
        Np, gs = lin.n_padded, gsz
        G = K // lin.groupsize
        w_bytes = sum(t[0].numel() for t in lin.packed.values())
        for a8 in (False, True):
            kern = "K7" if bits == 3 else ("K6" if a8 else "K8")
            for M in Ms:
                x = torch.randn((M, K), generator=g, device=dev)
                if a8:
                    x = tokenwise_quant(x)[0]
                pk = [{k: v[i] for k, v in lin.packed.items()}
                      for i in range(nc)]

                def run(i):
                    c = i % nc
                    s, z = lin.scales[c], lin.zeros[c]
                    if bits == 3:
                        return QM.quant_matmul_3bit(x, pk[c], s, z, gs, Np,
                                                    a8=a8)
                    fn = QM.quant_matmul_w_a8 if a8 else QM.quant_matmul_w
                    return fn(x, pk[c]["w"], s, z, bits, gs, Np)

                def plain(i):
                    c = i % nc
                    return QM._qmm_planes_plain(x, pk[c], lin.scales[c],
                                                lin.zeros[c], bits, gs, Np)

                out, ref = run(0), plain(0)
                again = run(0)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                tol = 1e-4 * ref.abs().max().item()
                splits = QM.planes_plan(bits, M, K, Np, gs, sms)[3]
                if not torch.equal(out, again):
                    fail("{} {}-bit M={} {}->{}: two calls differ ({} K "
                         "splits)".format(kern, bits, M, K, N, splits))
                ms = cuda_ms(run, 20)
                pms = cuda_ms(plain, 3, 1)
                gms = (graph_ms(run, 20), None)
                nbytes = (w_bytes + 2 * 4 * G * Np + M * K * (1 if a8 else 4)
                          + 4 * M * Np)
                bnd = bound_ms(nbytes, 2 * M * K * Np, "int8" if a8 else "f32")
                shape = "{}-bit {} x{} {}->{}{} ({} splits)".format(
                    bits, "int8" if a8 else "f32", M, K, N,
                    " per channel" if gs <= 0 else "", splits)
                named = (K, N) == (d, f) and bits in (3, 4) and M == 8
                record("{} {}".format(kern, shape) if named else None, kern,
                       src, rep[kern], err, tol, ms, pms, bnd, None, shape,
                       gms)
        del lin
    torch.cuda.empty_cache()


def k5_checks(cfg, record, g):
    """K5 against _decode_attn_plain at S = 2048, H = Hkv = 32, D = 128,
    B = 1, 8, 32, int8 and bf16 caches with lengths spread across rows, and
    one GQA case (Hkv = 8); atol 2e-4 (tests/test_attention.py:43). Layer
    copies of the cache are cycled so that it streams from HBM. The
    library call is scaled_dot_product_attention over the bf16 cache (a
    boolean mask for the lengths); SDPA takes no int8 cache with scales, so
    the int8 cases have none."""
    import torch
    from sparsebit_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    S, D, H = 2048, cfg.head_dim, cfg.n_heads
    cases = [(B, H, q) for B in (1, 8, 32) for q in ("int8", "bf16")]
    cases += [(8, 8, "int8"), (8, H, "f32")]
    for B, Hkv, kind in cases:
        quant = kind == "int8"
        Lc = 8 if B <= 8 else 4
        shape = (Lc, B, S, Hkv, D)
        if quant:
            k = torch.randint(-127, 128, shape, dtype=torch.int8,
                              generator=g, device=dev)
            v = torch.randint(-127, 128, shape, dtype=torch.int8,
                              generator=g, device=dev)
            ks = torch.empty(shape[:-1], device=dev).uniform_(
                0.0005, 0.002, generator=g)
            vs = torch.empty(shape[:-1], device=dev).uniform_(
                0.001, 0.01, generator=g)
        else:
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            k = torch.randn(shape, generator=g, device=dev).to(dt)
            v = torch.randn(shape, generator=g, device=dev).to(dt)
            ks = vs = None
        q = torch.randn((B, H, D), generator=g, device=dev)
        length = ((torch.arange(B, device=dev) + 1) * S // B - 1).to(
            torch.int32)

        def sc(t, li):
            return None if t is None else t[li]

        def run(i):
            return A.decode_attention_stacked(q, k, v, ks, vs, i % Lc, length)

        def plain(i):
            li = i % Lc
            return A._decode_attn_plain(q, k[li], v[li], sc(ks, li),
                                        sc(vs, li), length)

        out, ref = run(0), plain(0)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ms = cuda_ms(run, 20)
        pms = cuda_ms(plain, 3, 1)
        lms = lib = None
        if not quant:
            qb = q.to(k.dtype)[:, :, None]
            mask = (torch.arange(S, device=dev)[None, :]
                    <= length[:, None])[:, None, None]

            def lib(i):
                li = i % Lc
                return torch.nn.functional.scaled_dot_product_attention(
                    qb, k[li].transpose(1, 2), v[li].transpose(1, 2),
                    attn_mask=mask)

            lms = cuda_ms(lib, 20)
        gms = (graph_ms(run, 20), None if lib is None else graph_ms(lib, 20))
        rows = int(length.sum().item()) + B
        row_bytes = (Hkv * (2 * D + 8) if quant
                     else Hkv * 2 * D * k.element_size())
        nbytes = rows * row_bytes + 2 * 4 * B * H * D + 4 * B
        bnd = bound_ms(nbytes, 4 * rows * (H // Hkv) * Hkv * D, "f32")
        tag = "{} B={} S={} H={} Hkv={}".format(kind, B, S, H, Hkv)
        named = B == 8
        record("K5 " + tag if named else None, "K5",
               "sparsebit_tpu_torch/csrc/decode_attention.cu",
               "sparsebit_tpu/ops/attention.py:499", err, 2e-4, ms, pms, bnd,
               lms, tag, gms)
        del k, v, ks, vs
    torch.cuda.empty_cache()


K10_ENTRY = "sbt_flash_attention"  # K10's C entry point


def k10_within(out, ref, q, k, v, sm_scale):
    """K10's output against flash_attention_plain's on the same operands:
    (max abs error, the largest error over its element's own bound,
    flash_tolerance)."""
    from sparsebit_tpu_torch.ops import flash_attention as FA

    d = (out.float() - ref.float()).abs()
    tol = FA.flash_tolerance(q, k, v, ref, sm_scale=sm_scale)
    return d.max().item(), (d / tol).max().item()


def k10_planted(q, k, v, ref, scale):
    """Planted faults held to the same bound as K10 (flash_tolerance), at
    the operands of phase 2's first case: key tile 0 skipped for rows
    >= 128, its weights mis-rescaled by e^0.5 there (a stale running
    max), and every row missing its own key (the diagonal off by one),
    each as f32 softmax attention with a score bias. Returns {fault:
    share of the rows it touches with an element over the bound}."""
    import torch
    from sparsebit_tpu_torch.ops import flash_attention as FA

    S = q.shape[2]
    tol = FA.flash_tolerance(q, k, v, ref, sm_scale=scale)
    shares = {}
    for fault, first in (("far_tile", 128), ("rescaled_tile", 128),
                         ("diagonal", 1)):
        bias = torch.zeros((S, S), device=q.device)
        if fault == "diagonal":
            idx = torch.arange(1, S, device=q.device)
            bias[idx, idx] = float("-inf")
        else:
            bias[first:, :64] = (float("-inf") if fault == "far_tile"
                                 else 0.5)
        bad = biased_attention(q, k, v, scale, bias)
        over = ((bad.float() - ref.float()).abs() > tol).any(dim=-1)
        shares[fault] = over[..., first:].float().mean().item()
    return shares


def biased_attention(q, k, v, scale, bias):
    """Causal softmax attention in f32 with an additive (S, S) score bias
    (-inf drops a key), q (B, H, S, D), k/v (B, Hkv, S, D): a planted
    fault. Returns q's dtype."""
    import torch

    S = q.shape[2]
    n_rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(n_rep, dim=1)
    vf = v.float().repeat_interleave(n_rep, dim=1)
    above = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    sc = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    sc = (sc + bias).masked_fill_(above, float("-inf"))
    return torch.matmul(torch.softmax(sc, dim=-1), vf).to(q.dtype)


def far_tile_fault(q, k, v, *, sm_scale):
    """A stand-in for llama.flash_attention with a planted fault: key tile
    0 (keys 0-63) dropped from rows >= 128."""
    import torch

    S = q.shape[2]
    bias = torch.zeros((S, S), device=q.device)
    bias[128:, :64] = float("-inf")
    return biased_attention(q, k, v, sm_scale, bias)


def k10_checks(cfg, record, g):
    """K10 against flash_attention_plain (the same tiles and order in
    eager torch) on the card, causal, operands in the port's (B, S, H, hd)
    layout read through strides: bf16 H=32 hd=128 at B=1 S=2048 (the
    2048-token prefill) and B=8 S=512 (a full 512 admission bucket), hd 64
    and 256 at S=1024 (H = dim / hd), ragged S = 2047 (a perplexity
    window) and 100, f32 at S=512, Hkv=8 at S=2048, and B=4 S=512, the
    qlora path's shape, in the serving and in the kLse instantiation
    (flash_attention_fwd, the training forward; its lse within 2^-14 of
    the plain version's). Tolerance: each element within its own bound
    (flash_tolerance); a second launch gives the same bits; on the first
    case the same bound must also reject planted faults (k10_planted:
    every row a skipped or mis-rescaled key tile touches). Kernel ms (CUDA
    events), device ms (graph replay), plain ms; the library call is
    scaled_dot_product_attention (is_causal) on the same operands, timed
    as a yardstick only. Bound: q, k, v, out (and lse) once against
    4 B H hd S(S+1)/2 operations."""
    import torch
    import torch.nn.functional as F
    from sparsebit_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    hd0, H0 = cfg.head_dim, cfg.n_heads
    cases = [("bf16", 1, 2048, H0, H0, hd0), ("bf16", 8, 512, H0, H0, hd0),
             ("bf16", 1, 1024, cfg.dim // 64, cfg.dim // 64, 64),
             ("bf16", 1, 1024, cfg.dim // 256, cfg.dim // 256, 256),
             ("bf16", 1, 2047, H0, H0, hd0), ("bf16", 1, 100, H0, H0, hd0),
             ("f32", 1, 512, H0, H0, hd0), ("bf16", 1, 2048, H0, 8, hd0),
             ("bf16", 4, 512, H0, H0, hd0), ("bf16 lse", 4, 512, H0, H0, hd0)]
    for kind, B, S, H, Hkv, D in cases:
        with_lse = kind.endswith(" lse")
        dt = torch.bfloat16 if kind.startswith("bf16") else torch.float32

        def make(h):
            return torch.randn((B, S, h, D), generator=g, device=dev).to(
                dt).transpose(1, 2)

        q, k, v = make(H), make(Hkv), make(Hkv)
        scale = D ** -0.5

        def run(i):
            if with_lse:
                return FA.flash_attention_fwd(q, k, v, sm_scale=scale)
            return (FA.flash_attention(q, k, v, sm_scale=scale),)

        got = run(0)
        ref = FA.flash_attention_plain(q, k, v, sm_scale=scale,
                                       return_lse=with_lse)
        ref = ref if with_lse else (ref,)
        again = run(1)
        torch.cuda.synchronize()
        out = got[0]
        tag = "{} B={} S={} H={} Hkv={} hd={}".format(kind, B, S, H, Hkv, D)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if not same:
            fail("K10 {}: a second launch gives other bits".format(tag))
        err, ratio = k10_within(out, ref[0], q, k, v, scale)
        lse_note = ""
        if with_lse:
            lse_err = (got[1] - ref[1]).abs().max().item()
            lse_note = ", lse max err {:.3e} (tol 2^-14)".format(lse_err)
            if not lse_err <= 2.0 ** -14:
                fail("K10 {}: lse err {:.3e} over 2^-14".format(tag, lse_err))
        print("K10 {}: second launch bit-equal {}{}".format(tag, same,
                                                            lse_note),
              flush=True)
        del again
        ref = ref[0]
        if (kind, B, S, H, Hkv) == ("bf16", 1, 2048, H0, H0):
            shares = k10_planted(q, k, v, ref, scale)
            print("K10 planted faults at bf16 B=1 S=2048: share of touched "
                  "rows over the bound {}".format(shares), flush=True)
            probes["k10_planted_faults"] = shares
            if shares["far_tile"] < 1.0 or shares["rescaled_tile"] < 1.0:
                fail("K10's bound passes a planted tile fault: {}".format(
                    shares))

        def lib(i):
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale, enable_gqa=Hkv < H)

        ms = cuda_ms(run, 20)
        pms = cuda_ms(lambda i: FA.flash_attention_plain(
            q, k, v, sm_scale=scale, return_lse=with_lse), 3, 1)
        lms = cuda_ms(lib, 20)
        gms = (graph_ms(run, 20), graph_ms(lib, 20))
        esz = q.element_size()
        nbytes = esz * (2 * B * H * S * D + 2 * B * Hkv * S * D) + (
            4 * B * H * S if with_lse else 0)
        bnd = bound_ms(nbytes, 4 * B * H * D * S * (S + 1) // 2,
                       kind.split()[0])
        record("K10 " + tag, "K10",
               "sparsebit_tpu_torch/csrc/flash_attention.cu",
               "sparsebit_tpu/llm/llama.py:155 -> jax/experimental/pallas/"
               "ops/tpu/flash_attention.py:342", err, None, ms, pms, bnd,
               lms, tag, gms, ratio=ratio)
        del q, k, v, out, ref, got
    torch.cuda.empty_cache()


K11_ENTRY, K12_ENTRY = "sbt_flash_bwd_dkv", "sbt_flash_bwd_dq"
FLASH_SRC = "sparsebit_tpu_torch/csrc/flash_attention.cu"
FLASH_JAX = ("sparsebit_tpu/llm/llama.py:155 -> jax/experimental/pallas/ops/"
             "tpu/flash_attention.py:")


def bwd_within(got, ref, tol):
    """(max abs error, the largest error over its element's own bound)
    over pairs of gradients."""
    errs = [(a.float() - b.float()).abs() for a, b in zip(got, ref)]
    return (max(e.max().item() for e in errs),
            max((e / t).max().item() for e, t in zip(errs, tol)))


def bwd_planted(q, k, v, lse, do, di, scale, fault):
    """The backward as whole (S, S) f32 matrices, P and dS rounded to the
    operands' dtype, with a planted fault: "skip_q_tile" (K11 skips query
    tile 2, rows 128-191, for key tile 0), "no_di" (dS without its di term,
    in K11 and K12) or "no_diag_tile" (K12 skips each row's own key tile).
    kv heads summed over their query heads. Returns (dq, dk, dv) f32."""
    import torch

    f32 = torch.float32
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    kf = k.to(f32).repeat_interleave(rep, dim=1)
    vf = v.to(f32).repeat_interleave(rep, dim=1)
    qf, dof = q.to(f32), do.to(f32)
    above = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s.masked_fill_(above, float("-inf")) - lse[..., None])
    del s
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    if fault != "no_di":
        dp -= di[..., None]
    ds = (dp * p * scale).to(q.dtype).to(f32)
    del dp
    p = p.to(q.dtype).to(f32)
    pk, dsk, dsq = p, ds, ds
    if fault == "skip_q_tile":
        pk, dsk = p.clone(), ds.clone()
        pk[..., 128:192, 0:64] = 0.0
        dsk[..., 128:192, 0:64] = 0.0
    if fault == "no_diag_tile":
        dsq = ds.clone()
        for t0 in range(0, S, 64):
            dsq[..., t0:t0 + 64, t0:t0 + 64] = 0.0

    def kv_sum(t):
        return t.reshape(B, Hkv, rep, S, D).sum(dim=2)

    return (torch.matmul(dsq, kf),
            kv_sum(torch.matmul(dsk.transpose(-1, -2), qf)),
            kv_sum(torch.matmul(pk.transpose(-1, -2), dof)))


def bwd_planted_shares(q, k, v, lse, do, di, refs, tols, scale):
    """Planted faults held to the same bounds as K11/K12
    (flash_bwd_tolerance): {fault: {gradient: share of the rows it
    touches with an element over the bound}} (key tile 0's dK/dV rows for
    a skipped query tile, every row for dS without di, the rows past the
    first tile for a skipped diagonal tile)."""
    S = q.shape[2]
    names = ("dq", "dk", "dv")
    out = {}
    for fault, touched, rows in (
            ("skip_q_tile", ("dk", "dv"), slice(0, 64)),
            ("no_di", ("dq", "dk"), slice(0, S)),
            ("no_diag_tile", ("dq",), slice(64, S))):
        bad = dict(zip(names, bwd_planted(q, k, v, lse, do, di, scale,
                                          fault)))
        out[fault] = {}
        for i, n in enumerate(names):
            if n in touched:
                over = ((bad[n] - refs[i].float()).abs() > tols[i]).any(
                    dim=-1)
                out[fault][n] = over[..., rows].float().mean().item()
        del bad
    return out


def sdpa_bwd_graph_ms(q, k, v, do, scale, gqa):
    """SDPA's causal backward (dq, dk, dv in one autograd.grad over a saved
    forward) on the device: 20 calls captured in a graph and replayed; a
    capture that fails is tried once more. Where it fails again, the
    profiler's device time of every kernel 10 eager calls launch, over 10.
    Returns (ms, method)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                         scale=scale, enable_gqa=gqa)

    def bwd(i):
        return torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True)

    for _ in range(2):
        ms = graph_ms(bwd, 20)
        if ms is not None:
            return ms, "graph"
    for i in range(3):
        bwd(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            bwd(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return (us / 10 / 1e3 if us > 0 else None), "profiler"


def k11_k12_checks(cfg, record, g):
    """K11 (dK, dV) and K12 (dQ) against their plain versions on the card,
    causal, operands in the port's (B, S, H, hd) layout read through
    strides, the kernels' own lse (K10's, itself held to the plain
    version's within 2^-14) and di given to both: bf16 H=32 hd=128 at
    B=4 S=512 (the qlora path's shape) and B=1 S=2048, hd 64 and 256 at
    S=1024, ragged S = 2047 and 100, f32 at S=512, and Hkv=8 at S=2048.
    Tolerance: each element within its own bound (flash_bwd_tolerance);
    on the first case the same bounds must reject planted faults
    (bwd_planted_shares: every touched row of a skipped query tile, and
    at least 95 % of those of a dS without di and of a skipped diagonal
    tile). Kernel ms (CUDA events), device ms (graph replay), plain ms;
    the library call is SDPA's backward (is_causal: dq, dk, dv together),
    timed as a yardstick only (sdpa_bwd_graph_ms). A second launch of
    each kernel gives the same bits. Bounds: K11 4 and K12 3 causal-half
    products of 2 B H hd S(S+1)/2 operations at the bf16 (or f32) peak,
    against q, k, v, dO, lse, di read once and the gradients written
    once."""
    import torch
    import torch.nn.functional as F
    from sparsebit_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    hd0, H0 = cfg.head_dim, cfg.n_heads
    cases = [("bf16", 4, 512, H0, H0, hd0), ("bf16", 1, 2048, H0, H0, hd0),
             ("bf16", 1, 1024, cfg.dim // 64, cfg.dim // 64, 64),
             ("bf16", 1, 1024, cfg.dim // 256, cfg.dim // 256, 256),
             ("bf16", 1, 2047, H0, H0, hd0), ("bf16", 1, 100, H0, H0, hd0),
             ("f32", 1, 512, H0, H0, hd0), ("bf16", 1, 2048, H0, 8, hd0)]
    warm = torch.zeros((1, 2, 128, 64), dtype=torch.bfloat16, device=dev)
    # SDPA's first capture in the process, thrown away
    sdpa_bwd_graph_ms(warm, warm, warm, warm, 0.125, False)
    for kind, B, S, H, Hkv, D in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32

        def make(h):
            return torch.randn((B, S, h, D), generator=g, device=dev).to(
                dt).transpose(1, 2)

        q, k, v, do = make(H), make(Hkv), make(Hkv), make(H)
        scale = D ** -0.5
        tag = "{} B={} S={} H={} Hkv={} hd={}".format(kind, B, S, H, Hkv, D)
        out, lse = FA.flash_attention_fwd(q, k, v, sm_scale=scale)
        ref, ref_lse = FA.flash_attention_plain(q, k, v, sm_scale=scale,
                                                return_lse=True)
        lse_err = (lse - ref_lse).abs().max().item()
        _, out_ratio = k10_within(out, ref, q, k, v, scale)
        print("K10 with lse {}: lse max err {:.3e} (tol 2^-14), out worst "
              "err/tol {:.3f}".format(tag, lse_err, out_ratio), flush=True)
        if not (lse_err <= 2.0 ** -14 and out_ratio <= 1.0):
            fail("K10 with lse {}: lse err {:.3e}, out err/tol {:.3f}"
                 .format(tag, lse_err, out_ratio))
        di = FA.flash_di(out, do)
        dk, dv = FA.flash_attention_dkv(q, k, v, lse, do, di, sm_scale=scale)
        dq = FA.flash_attention_dq(q, k, v, lse, do, di, sm_scale=scale)
        pdk, pdv = FA.flash_bwd_dkv_plain(q, k, v, lse, do, di,
                                          sm_scale=scale)
        pdq = FA.flash_bwd_dq_plain(q, k, v, lse, do, di, sm_scale=scale)
        torch.cuda.synchronize()
        tq, tk, tv = FA.flash_bwd_tolerance(q, k, v, lse, do, di, pdq, pdk,
                                            pdv, sm_scale=scale)
        e11 = bwd_within((dk, dv), (pdk, pdv), (tk, tv))
        e12 = bwd_within((dq,), (pdq,), (tq,))
        again = FA.flash_attention_dkv(q, k, v, lse, do, di, sm_scale=scale)
        again += (FA.flash_attention_dq(q, k, v, lse, do, di,
                                        sm_scale=scale),)
        same = all(torch.equal(x, y) for x, y in zip((dk, dv, dq), again))
        print("K11/K12 {}: second launch bit-equal {}".format(tag, same),
              flush=True)
        if not same:
            fail("K11/K12 {}: a second launch gives other bits".format(tag))
        del again
        if (B, S, H, Hkv) == (4, 512, H0, H0):
            shares = bwd_planted_shares(q, k, v, lse, do, di,
                                        (pdq, pdk, pdv), (tq, tk, tv), scale)
            print("K11/K12 planted faults at {}: share of touched rows "
                  "over the bound {}".format(tag, shares), flush=True)
            probes["k11_k12_planted_faults"] = shares
            if min(shares["skip_q_tile"].values()) < 1.0 or min(
                    min(shares[f].values()) for f in
                    ("no_di", "no_diag_tile")) < 0.95:
                fail("K11/K12's bound passes a planted fault: {}".format(
                    shares))
        del tq, tk, tv, pdq, pdk, pdv, dq, dk, dv

        def dkv(i):
            return FA.flash_attention_dkv(q, k, v, lse, do, di,
                                          sm_scale=scale)

        def dqk(i):
            return FA.flash_attention_dq(q, k, v, lse, do, di,
                                         sm_scale=scale)

        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=True, scale=scale, enable_gqa=Hkv < H)

        def lib(i):
            return torch.autograd.grad(lib_out, (qr, kr, vr), do,
                                       retain_graph=True)

        ms = (cuda_ms(dkv, 20), cuda_ms(dqk, 20))
        pms = (cuda_ms(lambda i: FA.flash_bwd_dkv_plain(
            q, k, v, lse, do, di, sm_scale=scale), 3, 1),
            cuda_ms(lambda i: FA.flash_bwd_dq_plain(
                q, k, v, lse, do, di, sm_scale=scale), 3, 1))
        lms = cuda_ms(lib, 20)
        glib, how = sdpa_bwd_graph_ms(q, k, v, do, scale, Hkv < H)
        print("SDPA backward {}: device {} ms ({})".format(
            tag, "-" if glib is None else "{:.4f}".format(glib), how),
            flush=True)
        gms = ((graph_ms(dkv, 20), glib), (graph_ms(dqk, 20), glib))
        esz = q.element_size()
        half = B * H * D * S * (S + 1)  # 2 B H hd S(S+1)/2
        q_b, kv_b = esz * B * H * S * D, esz * B * Hkv * S * D
        stats_b = 8 * B * H * S  # lse and di, f32
        bounds = (bound_ms(2 * q_b + 4 * kv_b + stats_b, 4 * half, kind),
                  bound_ms(3 * q_b + 2 * kv_b + stats_b, 3 * half, kind))
        for i, (kid, (err, ratio), off) in enumerate(
                (("K11", e11, "796"), ("K12", e12, "1146"))):
            record("{} {}".format(kid, tag), kid, FLASH_SRC,
                   FLASH_JAX + off, err, None, ms[i], pms[i], bounds[i],
                   lms, tag, gms[i], ratio=ratio)
        del q, k, v, do, out, ref, lse, di, qr, kr, vr, lib_out
    torch.cuda.empty_cache()


def k4_checks(stacked, cfg, record, g):
    """K4 against its plain version at llama_7b() widths, all 32 layers,
    S = 512, mixed lengths (rows past the first 128-row block): B = 1, 8
    and 32 on a contiguous cache, B = 8 on a paged pool with a scrambled
    block table. The KV codes and scales written and the output must equal
    the plain version's exactly (tolerance 0): the plain version takes
    every float sum in the kernel's order, its s4r matmuls in the kernel's
    K-split order."""
    import torch
    from sparsebit_tpu_torch.ops import layer_fused as LF

    dev = torch.device("cuda")
    layers = stacked["layers"]
    lins = [layers[n] for n in ("wqkv", "wo", "w13", "w2")]
    wargs = [t for ln in lins for t in (ln.packed["s4r"], ln.scales,
                                        ln.zeros)]
    norms = (layers["attn_norm"], layers["ffn_norm"])
    w_bytes = sum(t.numel() * t.element_size() for t in wargs + list(norms))
    w_count = sum(ln.packed["s4r"].numel() * 2 for ln in lins)
    S, Hkv, Hq, D = 512, cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    Lx = cfg.n_layers
    gs = lins[0].groupsize
    rng_pos = torch.Generator().manual_seed(SEED + 4)
    cases = [(1, False, [300]),
             (8, False, [0, 17, 100, 255, 300, 411, 480, 511]),
             (32, False, torch.randint(0, S, (32,),
                                       generator=rng_pos).tolist()),
             (8, True, [0, 17, 100, 255, 300, 411, 480, 511])]
    for B, paged, pos_l in cases:
        n_chunks = S // 128
        bt = n_blocks = None
        if paged:
            n_blocks = B * n_chunks + 4
            perm = torch.randperm(n_blocks, generator=rng_pos)[:B * n_chunks]
            bt = perm.reshape(B, n_chunks).to(dev, torch.int32)
        x, pos, cos, sin, cache = _k4_case(cfg, B, pos_l, g, S, bt, n_blocks)
        plain = [t.clone() for t in cache]
        bt_p = bt if paged else torch.arange(
            B, dtype=torch.int32, device=dev)[:, None]
        ws = [tuple(wargs[i:i + 3]) for i in range(0, 12, 3)]

        def run_kernel(i):
            return LF.fused_decoder_layers(
                x, pos, cos, sin, *wargs, *norms, *cache, cfg, gs, bt=bt)[0]

        def run_plain(i):
            return LF._fused_layers_plain(
                x, pos, cos, sin, ws, *norms, *plain, bt_p, S, gs,
                cfg.rms_eps, Hq, Hkv)

        out = run_kernel(0)
        ref = run_plain(0)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(cache, plain))
        if not exact:
            fail("K4 B={}{} cache codes/scales differ from the plain "
                 "version".format(B, " paged" if paged else ""))
        finite = bool(torch.isfinite(out).all().item())
        if not finite:
            fail("K4 B={} output not finite".format(B))
        err = (out - ref).abs().max().item()
        tol = 0.0
        ms = cuda_ms(run_kernel, 10)
        pms = cuda_ms(run_plain, 1, 0)
        rows = sum(min(p, S - 1) + 1 for p in pos_l)
        kv_bytes = Lx * (rows + B) * Hkv * (2 * D + 8)
        nbytes = w_bytes + kv_bytes + 2 * 4 * B * cfg.dim + 2 * 4 * B * D
        ops = 2 * B * w_count + Lx * 4 * rows * Hq * D
        bnd = bound_ms(nbytes, ops, "int8")
        tag = "K4 B={}{}".format(B, " paged" if paged else "")
        if not paged:
            k4_phases(tag, run_kernel, Lx)
        record(tag, "K4", "sparsebit_tpu_torch/csrc/layer_fused.cu",
               "sparsebit_tpu/ops/layer_fused.py:213", err, tol, ms, pms,
               bnd, None, "{} L={} S={} codes {}".format(
                   tag, Lx, S, "exact" if exact else "DIFFER"))
        del cache, plain
        torch.cuda.empty_cache()


def _k4_case(cfg, B, pos_l, g, S=512, bt=None, n_blocks=None):
    """A random int8 cache (contiguous, or a pool of n_blocks blocks of
    128 rows) with bf16-rounded scales, positions, rope terms and bf16
    rows x for a K4 call at cfg's widths."""
    import torch
    from sparsebit_tpu_torch.llm.decode import _rope_cos_sin

    dev = torch.device("cuda")
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    lead = (cfg.n_layers, B, S) if bt is None else (cfg.n_layers, n_blocks,
                                                    128)
    kc = torch.randint(-128, 128, lead + (Hkv, D), dtype=torch.int8,
                       generator=g, device=dev)
    vc = torch.randint(-128, 128, lead + (Hkv, D), dtype=torch.int8,
                       generator=g, device=dev)
    ksc = torch.empty(lead + (Hkv,), device=dev).uniform_(
        0.001, 0.05, generator=g).to(torch.bfloat16).float()
    vsc = torch.empty(lead + (Hkv,), device=dev).uniform_(
        0.001, 0.05, generator=g).to(torch.bfloat16).float()
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    cos, sin = _rope_cos_sin(cfg, pos)
    x = torch.randn((B, cfg.dim), generator=g, device=dev).to(
        torch.bfloat16).float()
    return x, pos, cos, sin, [kc, vc, ksc, vsc]


def k4_plane_checks(cfg, record, g):
    """K4's plane mode ("K4p", _mm_step_planes) against its plain version
    at llama_7b() widths, all 32 layers, S = 512: 3 and 2 bits, B = 1 and
    8, random plane concats over the padded widths (W13 2F = 22016 ->
    22528 at 3 bits, NP = 2816) with bf16 qparams. Output, KV codes and
    scales must be equal (tolerance 0): the plain version takes every
    float sum in the kernel's order. No PyTorch call computes a decoder
    backbone with a 2/3-bit weight stream (library_ms null, as K4's)."""
    import torch
    from sparsebit_tpu_torch.ops import layer_fused as LF
    from sparsebit_tpu_torch.ops.packing import pallas_n_pad

    dev = torch.device("cuda")
    Lx, S, gs = cfg.n_layers, 512, 128
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    K_N = [_linear_shape(cfg, n) for n in FUSED]
    norms = tuple(torch.ones((Lx, cfg.dim), dtype=torch.bfloat16,
                             device=dev) for _ in range(2))
    for bits in (3, 2):
        wargs = []
        for K, N in K_N:
            Ns = N + pallas_n_pad(N, bits)
            width = 3 * Ns // 8 if bits == 3 else Ns // 4
            s = torch.empty((Lx, K // gs, Ns), device=dev).uniform_(
                0.001, 0.01, generator=g) * (16.0 / 2 ** bits)
            wargs += [torch.randint(0, 256, (Lx, K, width), dtype=torch.uint8,
                                    generator=g, device=dev),
                      s.to(torch.bfloat16),
                      torch.full((Lx, K // gs, Ns), float(2 ** (bits - 1)),
                                 dtype=torch.bfloat16, device=dev)]
        ws = [tuple(wargs[i:i + 3]) for i in range(0, 12, 3)]
        w_bytes = sum(t.numel() * t.element_size()
                      for t in wargs + list(norms))
        w_count = Lx * sum(K * N for K, N in K_N)
        for B, pos_l in ((1, [300]),
                         (8, [0, 17, 100, 255, 300, 411, 480, 511])):
            x, pos, cos, sin, cache = _k4_case(cfg, B, pos_l, g, S)
            plain = [t.clone() for t in cache]
            bt_p = torch.arange(B, dtype=torch.int32, device=dev)[:, None]

            def run_kernel(i):
                return LF.fused_decoder_layers(
                    x, pos, cos, sin, *wargs, *norms, *cache, cfg, gs,
                    wbits=bits)[0]

            def run_plain(i):
                return LF._fused_layers_plain(
                    x, pos, cos, sin, ws, *norms, *plain, bt_p, S, gs,
                    cfg.rms_eps, Hq, Hkv, wbits=bits)

            out = run_kernel(0)
            ref = run_plain(0)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(cache, plain))
            if not exact:
                fail("K4p {}-bit B={} cache codes/scales differ from the "
                     "plain version".format(bits, B))
            if not bool(torch.isfinite(out).all().item()):
                fail("K4p {}-bit B={} output not finite".format(bits, B))
            err = (out - ref).abs().max().item()
            ms = cuda_ms(run_kernel, 10)
            pms = cuda_ms(run_plain, 1, 0)
            rows = sum(min(p, S - 1) + 1 for p in pos_l)
            kv_bytes = Lx * (rows + B) * Hkv * (2 * D + 8)
            nbytes = w_bytes + kv_bytes + 2 * 4 * B * cfg.dim + 2 * 4 * B * D
            ops = 2 * B * w_count + Lx * 4 * rows * Hq * D
            tag = "K4p {}-bit B={}".format(bits, B)
            k4_phases(tag, run_kernel, Lx)
            record(tag, "K4p", "sparsebit_tpu_torch/csrc/layer_fused.cu",
                   "sparsebit_tpu/ops/layer_fused.py:167", err, 0.0, ms, pms,
                   bound_ms(nbytes, ops, "int8"), None,
                   "{} L={} S={} codes {}".format(
                       tag, Lx, S, "exact" if exact else "DIFFER"))
            del cache, plain
        del wargs, ws
        torch.cuda.empty_cache()
    grid_barrier_probe()


_traced = {}  # the phase-trace build of K4: "proc", "path", then "lib"


def start_traced_k4_build():
    """Start nvcc on csrc/layer_fused.cu with -DSBT_PHASE_TRACE, beside the
    kernel library's own build: a separate library whose K4 stamps its
    phases and which adds the grid-barrier probe (the shipped library has
    neither). Its own nvcc process, so it builds in parallel."""
    import hashlib

    from sparsebit_tpu_torch.ops import _kernels

    src = _kernels.CSRC / "layer_fused.cu"
    flags = (*_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, "-DSBT_PHASE_TRACE")
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(_kernels.CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    path = _kernels.BUILD_DIR / "libsbt_k4_trace_{}.so".format(
        h.hexdigest()[:16])
    _traced["path"] = path
    if path.exists():
        return
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".so.tmp{}".format(os.getpid()))
    _traced["tmp"] = tmp
    _traced["proc"] = subprocess.Popen(
        [_kernels._nvcc(), *flags, "-I", str(_kernels.CSRC), "-shared",
         "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def traced_k4_lib():
    """The phase-trace build of K4, loaded (waits for nvcc); None, with a
    failure recorded, if it did not build."""
    import ctypes

    from sparsebit_tpu_torch.ops import _kernels

    if "lib" in _traced:
        return _traced["lib"]
    proc = _traced.pop("proc", None)
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail("phase-trace build of layer_fused.cu: " + out[-2000:])
            _traced["lib"] = None
            return None
        os.replace(_traced["tmp"], _traced["path"])
    lib = ctypes.CDLL(str(_traced["path"]))
    lib.sbt_layers_fused.argtypes = _kernels.SIGNATURES["sbt_layers_fused"]
    lib.sbt_layers_fused.restype = ctypes.c_int
    lib.sbt_phase_trace_set.argtypes = [ctypes.c_void_p]
    lib.sbt_phase_trace_set.restype = ctypes.c_int
    lib.sbt_phase_name.argtypes = [ctypes.c_int]
    lib.sbt_phase_name.restype = ctypes.c_char_p
    lib.sbt_phase_marks.restype = ctypes.c_int
    lib.sbt_grid_sync_probe.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    lib.sbt_grid_sync_probe.restype = ctypes.c_int
    _traced["lib"] = lib
    return lib


def k4_phases(tag, run_kernel, L):
    """One more K4 launch, from the phase-trace build: the mean ms a layer
    of each phase (block 0's device clock after each grid barrier, so a
    phase's time includes the wait for its slowest block). The kernel
    names each phase it stamps."""
    import torch
    from sparsebit_tpu_torch.ops import _kernels

    lib = traced_k4_lib()
    if lib is None:
        return
    buf = torch.zeros((L, lib.sbt_phase_marks(), 2), dtype=torch.int64,
                      device="cuda")
    shipped = _kernels.lib
    _kernels.check(lib.sbt_phase_trace_set(buf.data_ptr()),
                   "sbt_phase_trace_set")
    _kernels.lib = lambda: lib
    try:
        run_kernel(0)
        torch.cuda.synchronize()
    finally:
        _kernels.lib = shipped
        _kernels.check(lib.sbt_phase_trace_set(None), "sbt_phase_trace_set")
    ph = {}
    for row in buf.cpu().tolist():
        for (_, t0), (pid, t1) in zip(row, row[1:]):
            if pid == 0:
                break
            name = lib.sbt_phase_name(pid).decode()
            ph[name] = ph.get(name, 0.0) + (t1 - t0) * 1e-6 / L
    probes["phase ms a layer, " + tag] = ph
    print("{} phases, ms a layer: {} (sum {:.4f})".format(
        tag, ", ".join("{} {:.4f}".format(k, v) for k, v in ph.items()),
        sum(ph.values())), flush=True)


def grid_barrier_probe():
    """The cost of one grid barrier of K4's persistent grid (plane mode
    adds one a layer, between W13 and the GLU): a cooperative launch of
    n barriers and nothing else, n = 2000 against n = 0, CUDA events,
    from the phase-trace build."""
    import ctypes

    from sparsebit_tpu_torch.ops import _kernels

    lib = traced_k4_lib()
    if lib is None:
        return
    for wbits, B in ((3, 1), (3, 8), (4, 8)):
        grid = ctypes.c_int(0)

        def launch(n):
            _kernels.check(lib.sbt_grid_sync_probe(
                n, wbits, B, ctypes.addressof(grid), _kernels.stream()),
                "sbt_grid_sync_probe")

        t = {n: cuda_ms(lambda i: launch(n), 5) for n in (0, 2000)}
        us = 1e3 * (t[2000] - t[0]) / 2000
        probes["grid barrier us, {}-bit B={}".format(wbits, B)] = us
        print("grid barrier of K4's grid ({}-bit, B={}, {} blocks): {:.3f} "
              "us each; 32 layers x 1 barrier = {:.4f} ms a step".format(
                  wbits, B, grid.value, us, 32 * us * 1e-3), flush=True)


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
                c.length[:, None], None, Dm._scan_cache(c), c.quantized,
                cfg)
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


PROMPT_LENS = [16, 40, 60, 100, 130, 170, 200, 25]


_WRAPPERS = {}


class _PlaneLaunches:
    """K4's plane-mode count (``fused_decoder_layers.plane_launches``) as
    a wrapper-like ``launches`` attribute."""

    def __init__(self, k4):
        self.k4 = k4

    @property
    def launches(self):
        return self.k4.plane_launches

    @launches.setter
    def launches(self, n):
        self.k4.plane_launches = n


def _wrappers():
    """The kernel wrappers by id, as first seen (before any phase patches a
    module attribute): each counts its launches in ``launches``."""
    from sparsebit_tpu_torch.ops import attention, ffn_fused, layer_fused
    from sparsebit_tpu_torch.ops import flash_attention, matvec, quant_matmul

    if _WRAPPERS:
        return _WRAPPERS
    _WRAPPERS.update({"K1": quant_matmul.quant_matmul_s4,
            "K2": attention.decode_attention_update,
            "K3": ffn_fused.ffn_block_fused,
            "K4": layer_fused.fused_decoder_layers,
            "K4p": _PlaneLaunches(layer_fused.fused_decoder_layers),
            "K5": attention.decode_attention,
            "K6": quant_matmul.quant_matmul_w_a8,
            "K7": quant_matmul.quant_matmul_3bit,
            "K8": quant_matmul.quant_matmul_w,
            "K9": matvec.bf16_matvec,
            "K10": flash_attention.flash_attention,
            "K11": flash_attention.flash_attention_dkv,
            "K12": flash_attention.flash_attention_dq})
    return _WRAPPERS


def _reset_launches():
    for w in _wrappers().values():
        w.launches = 0


def _launches():
    return {k: w.launches for k, w in _wrappers().items()}


def _prompts(cfg, with_prefix_pair=False):
    """The 8 prompts of PR 1's run (seeded); with_prefix_pair adds A, a
    256-token prompt, first, and B = A + 40 tokens, last."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 3)
    out = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
           for n in PROMPT_LENS]
    if with_prefix_pair:
        a = torch.randint(0, cfg.vocab_size, (256,), generator=gen).tolist()
        b = a + torch.randint(0, cfg.vocab_size, (40,),
                              generator=gen).tolist()
        out = [a] + out + [b]
    return out


def drive(eng, prompts, chunk_fn_name, path, expect, n_new=32,
          time_k4=False, timer=None):
    """Run one engine over ``prompts`` (greedy, n_new tokens each) with
    every kernel count set to 0 just before and read just after: fails if
    a kernel of ``expect`` was not launched, a request got another number
    of tokens or a logit row was not finite. With a KernelEvents ``timer``
    (patched in), the kernels of the decode chunks are timed: their device
    ms per step, and K5's; and the admissions: host s around each
    ``_prefill_call`` (a prefill_at group) and K1's device ms inside, with
    K1's launches by shape over the whole run. Returns (results,
    stats)."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm import serving as Sv
    from sparsebit_tpu_torch.ops import quant_matmul as QM

    wrappers = _wrappers()
    finite, chunk_s, k4_ev, admit = [], [], [], []
    k1_shapes = {}
    orig_prefill = eng._prefill_call
    orig_k1 = QM.quant_matmul_s4

    def prefill_timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if timer is not None:
            timer.on = True
        out = orig_prefill(*a, **kw)
        torch.cuda.synchronize()
        evs = []
        if timer is not None:
            timer.on = False
            evs, timer.events = timer.events, []
        admit.append((time.perf_counter() - t, evs))
        return out

    def k1_counted(x8, xs, w, *a, li=None, **kw):
        key = "M={} {}->{}".format(x8.shape[0], x8.shape[1], w.shape[-1])
        k1_shapes[key] = k1_shapes.get(key, 0) + 1
        return orig_k1(x8, xs, w, *a, li=li, **kw)

    # the wrapper counts its launches on its module attribute: this one
    # while patched in, added to the wrapper's own count after the run
    k1_counted.launches = 0
    orig_sample = Dm.sample_logits_vec
    orig_chunk = getattr(Sv, chunk_fn_name)
    orig_k4 = Dm.fused_decoder_layers

    def sample_checked(logits, temps, generator=None):
        finite.append(torch.isfinite(logits).all())
        return orig_sample(logits, temps, generator)

    def chunk_timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if timer is not None:
            timer.on = True
        out = orig_chunk(*a, **kw)
        if timer is not None:
            timer.on = False
        torch.cuda.synchronize()
        chunk_s.append((time.perf_counter() - t, a[6]))
        return out

    def k4_timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig_k4(*a, **kw)
        ev[1].record()
        k4_ev.append(ev)
        return out

    Dm.sample_logits_vec = Sv.sample_logits_vec = sample_checked
    setattr(Sv, chunk_fn_name, chunk_timed)
    eng._prefill_call = prefill_timed
    QM.quant_matmul_s4 = k1_counted
    if time_k4:
        Dm.fused_decoder_layers = k4_timed
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    if timer is not None:
        timer.events = []
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = eng.run()
        torch.cuda.synchronize()
    finally:
        Dm.sample_logits_vec = Sv.sample_logits_vec = orig_sample
        setattr(Sv, chunk_fn_name, orig_chunk)
        Dm.fused_decoder_layers = orig_k4
        QM.quant_matmul_s4 = orig_k1
        orig_k1.launches += k1_counted.launches
        eng._prefill_call = orig_prefill
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    if len(res) != len(prompts) or any(len(res[r]) != n_new for r in rids):
        fail("{}: {} requests with lengths {}".format(
            path, len(res), [len(v) for v in res.values()]))
    if not all(bool(f.item()) for f in finite):
        fail("{}: non-finite logits".format(path))
    for k in expect:
        if launches[k] <= 0:
            fail("{} was not launched on the {} path".format(k, path))
    dec_s = sum(t for t, _ in chunk_s)
    steps = sum(n for _, n in chunk_s)
    B = eng.max_batch
    stats = {"requests": len(res), "tokens": sum(map(len, res.values())),
             "run_s": wall, "decode_steps": steps,
             "decode_ms_per_step": 1e3 * dec_s / steps,
             "decode_tok_s": B * steps / dec_s, "launches": launches}
    if time_k4:
        stats["k4_device_ms_per_step"] = sum(
            a.elapsed_time(b) for a, b in k4_ev) / len(k4_ev)
    stats["k1_launches_by_shape"] = k1_shapes
    stats["admission_groups"] = len(admit)
    stats["admission_s"] = sum(a[0] for a in admit)
    if timer is not None:
        adm = {"sbt_qmm_s4": 0.0, K10_ENTRY: 0.0}
        for _, evs in admit:
            for name, (ea, eb) in evs:
                if name in adm:
                    adm[name] += ea.elapsed_time(eb)
        stats["admission_k1_device_ms"] = adm["sbt_qmm_s4"]
        stats["admission_k10_device_ms"] = adm[K10_ENTRY]
        print("{}: admission {} _prefill_call groups, {:.4f} s host, K1 "
              "device {:.3f} ms and K10 {:.3f} ms inside; K1 launches by "
              "shape {}".format(path, len(admit), stats["admission_s"],
                                adm["sbt_qmm_s4"], adm[K10_ENTRY],
                                k1_shapes), flush=True)
        dev_ms, by = timer.take_ms()
        stats["kernel_device_ms_per_step"] = dev_ms / steps
        stats["k5_device_ms_per_step"] = by.get(K5_ENTRY, 0.0) / steps
        stats["entry_device_ms_per_step"] = {n: t / steps
                                             for n, t in by.items()}
        print("{}: K5 {:.4f} ms/step device of the decode kernels' "
              "{:.3f}".format(path, stats["k5_device_ms_per_step"],
                              stats["kernel_device_ms_per_step"]),
              flush=True)
    print("{}: {} requests, {} tokens, run {:.3f} s; decode {} steps at "
          "B={}, {:.3f} ms/step, {:.1f} tok/s{}; launches {}".format(
              path, stats["requests"], stats["tokens"], wall, steps, B,
              stats["decode_ms_per_step"], stats["decode_tok_s"],
              "; K4 device {:.3f} ms/step".format(
                  stats["k4_device_ms_per_step"]) if time_k4 else "",
              launches), flush=True)
    return [res[r] for r in rids], stats


class _Patched:
    """Replace module attributes for the duration of a ``with`` block."""

    def __init__(self, pairs):
        self.pairs = pairs  # [(module, name, replacement)]
        self.saved = []

    def __enter__(self):
        for mod, name, new in self.pairs:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)
        return self

    def __exit__(self, *exc):
        for mod, name, old in reversed(self.saved):
            setattr(mod, name, old)


def plain_versions():
    """Route the non-scanned decode's kernel wrappers (K1, K5-K8) to their
    plain versions, on whatever device the tensors are."""
    from sparsebit_tpu_torch.ops import attention as A
    from sparsebit_tpu_torch.ops import quant_matmul as QM

    def w(x, wt, s, z, bits, gs, N):
        return QM._qmm_planes_plain(x.float(), {"w": wt}, s, z, bits, gs, N)

    def w_a8(x8, wt, s, z, bits, gs, N):
        return QM._qmm_planes_plain(x8, {"w": wt}, s, z, bits, gs, N)

    def three(x, packed, s, z, gs, N, a8=False):
        x = x if a8 else x.float()
        return QM._qmm_planes_plain(x, packed, s, z, 3, gs, N)

    def attn(q, k, v, ks, vs, length, li=None):
        if li is not None:
            k, v = k[li], v[li]
            ks = None if ks is None else ks[li]
            vs = None if vs is None else vs[li]
        return A._decode_attn_plain(q, k, v, ks, vs, length)

    def s4(x8, xs, wt, s, z, gs, li=None):
        if li is not None:
            wt, s, z = wt[li], s[li], z[li]
        M, K = x8.shape
        gs = gs if gs > 0 else K
        return QM._qmm_s4_plain(x8, xs, wt, s, z, gs,
                                QM.k1_plan(M, K, wt.shape[-1], gs)[1])

    return _Patched([(QM, "quant_matmul_w", w),
                     (QM, "quant_matmul_w_a8", w_a8),
                     (QM, "quant_matmul_3bit", three),
                     (QM, "quant_matmul_s4", s4),
                     (A, "decode_attention", attn)])


class KernelEvents:
    """CUDA events around every kernel launch while enabled (the kernel
    library's entry points, reached through ``_kernels.lib()``): the
    kernels' device ms, summed per decode step by the caller."""

    def __init__(self):
        from sparsebit_tpu_torch.ops import _kernels

        self.events = []
        self.on = False
        real = _kernels.lib
        timer = self

        class Lib:
            def __getattr__(self, name):
                return timer._wrap(name, getattr(real(), name))

        lib = Lib()
        self.patch = _Patched([(_kernels, "lib", lambda: lib)])

    def _wrap(self, name, fn):
        import torch

        def timed(*a):
            if not self.on:
                return fn(*a)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            self.events.append((name, ev))
            return out
        return timed

    def take_ms(self):
        """(total device ms, {C entry point: device ms}) since the last
        take."""
        import torch

        torch.cuda.synchronize()
        by = {}
        for name, (a, b) in self.events:
            by[name] = by.get(name, 0.0) + a.elapsed_time(b)
        self.events = []
        return sum(by.values()), by


def _logits_agree(a, b, atol=0.1):
    """Max |a - b| within atol and equal argmax wherever b's top-2 margin
    exceeds 2 * atol (the discipline of the small-model check)."""
    import torch

    err = (a - b).abs().max().item()
    top2 = torch.topk(b, 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * atol
    same = bool((a.argmax(-1)[decisive] == b.argmax(-1)[decisive]).all())
    return err, err <= atol and same and bool(a.isfinite().all())


def step_vs_plain(params, cfg, prompt, tag):
    """Prefill ``prompt`` on the kernels, then one decode_step from two
    copies of that cache: on the kernels, and with every wrapper routed to
    its plain version on the card. Logits within atol 0.1 with equal
    decisive argmax. Returns the error."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache

    B, S = prompt.shape
    cache = init_kv_cache(cfg, B, S + 8, device="cuda")
    logits, cache = Dm.prefill(params, prompt, cache, cfg)
    tok = logits.argmax(-1).to(torch.int32)
    twin = init_kv_cache(cfg, B, S + 8, device="cuda")
    for name in ("k", "v", "k_scale", "v_scale", "length"):
        getattr(twin, name).copy_(getattr(cache, name))
    got, _ = Dm.decode_step(params, tok, cache, cfg)
    with plain_versions():
        ref, _ = Dm.decode_step(params, tok, twin, cfg)
    err, ok = _logits_agree(got.float(), ref.float())
    print("{}: one decode_step on the kernels vs the plain versions on the "
          "card: max logit err {:.3e} (atol 0.1), {}".format(
              tag, err, "ok" if ok else "BAD"), flush=True)
    if not ok:
        fail("{}: decode_step logits differ from the plain versions' "
             "(err {:.3e})".format(tag, err))
    return err


def run_generate(params, cfg, prompt, n_new, timer, tag, **kw):
    """decode.generate with every kernel count set to 0 just before and
    read just after: prefill s, wall ms per decode step and the timed
    kernels' device ms per step. Returns (tokens, stats)."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm

    times = {"prefill": 0.0, "steps": 0}
    finite = []
    orig_prefill, orig_step = Dm.prefill, Dm.decode_step

    def prefill(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        timer.on = False
        out = orig_prefill(*a, **k)
        torch.cuda.synchronize()
        times["prefill"] += time.perf_counter() - t
        timer.on = True
        return out

    def step(*a, **k):
        out = orig_step(*a, **k)
        finite.append(torch.isfinite(out[0]).all())
        times["steps"] += 1
        return out

    timer.events = []
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Patched([(Dm, "prefill", prefill), (Dm, "decode_step", step)]):
        toks = Dm.generate(params, prompt, cfg, max_new_tokens=n_new, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timer.on = False
    dev_ms, by = timer.take_ms()
    launches = _launches()
    n = times["steps"]
    stats = {"B": prompt.shape[0], "prompt": prompt.shape[1],
             "new_tokens": n_new, "prefill_s": times["prefill"],
             "decode_steps": n,
             "wall_ms_per_step": 1e3 * (wall - times["prefill"]) / n,
             "kernel_device_ms_per_step": dev_ms / n,
             "k5_device_ms_per_step": by.get(K5_ENTRY, 0.0) / n,
             "launches": launches}
    ok = (tuple(toks.shape) == (prompt.shape[0], n_new)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and all(bool(f.item()) for f in finite))
    print("{}: B={} prompt {} + {} tokens: prefill {:.3f} s, decode {:.3f} "
          "ms/step wall, kernels {:.3f} ms/step device; launches {}".format(
              tag, stats["B"], stats["prompt"], n_new, stats["prefill_s"],
              stats["wall_ms_per_step"], stats["kernel_device_ms_per_step"],
              launches), flush=True)
    print("{}: K5 {:.4f} ms/step device of the kernels' {:.3f}".format(
        tag, stats["k5_device_ms_per_step"],
        stats["kernel_device_ms_per_step"]), flush=True)
    if not ok:
        fail("{}: tokens {} not of shape ({}, {}) in the vocabulary, or "
             "logits not finite".format(tag, tuple(toks.shape),
                                        prompt.shape[0], n_new))
    return toks, stats


def _expect(tag, launches, want, absent=()):
    for k in want:
        if launches[k] <= 0:
            fail("{} was not launched on the {} path".format(k, tag))
    for k in absent:
        if launches[k]:
            fail("{} was launched {} times on the {} path".format(
                k, launches[k], tag))


def generate_paths(cfg):
    """Phase 4, this slice's main path and its neighbours.
      generate  llama_7b() widths, 32 layers, random GPTQ INT4-g128 in
                the checkpoint layout, impl "auto", int8 KV: B = 1 (64-token
                prompt, 64 greedy tokens), B = 8 (32 tokens), one sampled
                run (temperature 0.8, top_k 40, top_p 0.9), and 16 tokens
                over a bf16 cache; K8 + K5, and one decode_step held to
                the plain versions;
      mixed     2/3/4/8-bit linears at 7B widths, depth 4, through
                save_quant_checkpoint / load_quant_checkpoint (arrays
                equal), generate with impl "auto" (K7, K8) and "a8" (K6,
                K7);
      chunk     DecodeEngine on a 4/8-bit model K4 refuses (depth 4):
                decode_chunk with K1, K6 and K5, and no K4."""
    import torch
    from sparsebit_tpu_torch.llm import llama as L
    from sparsebit_tpu_torch.llm import serving as Sv
    from sparsebit_tpu_torch.llm.convert import (
        load_quant_checkpoint, save_quant_checkpoint)
    from sparsebit_tpu_torch.llm.quant import QuantLinear

    out = {}
    timer = KernelEvents()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    with timer.patch:
        params = build_plane_params(cfg, torch.device("cuda"),
                                    lambda li, n: 4, SEED + 6)
        p1 = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                           device="cuda")
        p8 = torch.randint(0, cfg.vocab_size, (8, 64), generator=gen,
                           device="cuda")
        runs = [("generate B=1 greedy", p1, 64, {}),
                ("generate B=8 greedy", p8, 32, {}),
                ("generate B=1 sampled", p1, 32,
                 dict(temperature=0.8, top_k=40, top_p=0.9,
                      generator=torch.Generator(device="cuda").manual_seed(
                          SEED + 7))),
                ("generate B=1 greedy bf16 KV", p1, 16,
                 dict(kv_quantized=False))]
        for tag, prompt, n, kw in runs:
            _, st = run_generate(params, cfg, prompt, n, timer, tag, **kw)
            _expect(tag, st["launches"], ("K5", "K8"), ("K4",))
            out[tag] = st
        out["generate B=1 greedy"]["step_vs_plain_err"] = step_vs_plain(
            params, cfg, p1, "generate")
        del params
        torch.cuda.empty_cache()

        depth = 4
        cfg_m = dataclasses.replace(cfg, n_layers=depth)
        bits = (2, 3, 4, 8)
        params = build_plane_params(
            cfg_m, torch.device("cuda"),
            lambda li, n: bits[(li + UNFUSED.index(n)) % 4], SEED + 8)
        layers_bit = {"layers.{}.{}".format(li, n): bits[(li + j) % 4]
                      for li in range(depth) for j, n in enumerate(UNFUSED)}
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            save_quant_checkpoint(tmp, params, layers_bit, cfg_m, 128)
            loaded, cfg_l, bits_l = load_quant_checkpoint(tmp)
            io_s = time.perf_counter() - t
        same = bits_l == layers_bit and cfg_l == cfg_m
        for a, b in zip(params["layers"], loaded["layers"]):
            for n in UNFUSED:
                x, y = a[n], b[n]
                same &= all(torch.equal(x.packed[k], y.packed[k])
                            for k in x.packed)
                same &= torch.equal(x.scales, y.scales) and \
                    torch.equal(x.zeros, y.zeros) and y.impl == "auto"
        print("mixed: npz checkpoint written and read in {:.1f} s, arrays "
              "equal {}".format(io_s, same), flush=True)
        if not same:
            fail("mixed: the npz round trip changed the model")
        del params
        prompt = p8[:2, :32]
        for impl in ("auto", "a8"):
            pm = loaded if impl == "auto" else L.quantize_llama_params(
                loaded, lambda p, lin: (lin._replace(impl="a8")
                                        if isinstance(lin, QuantLinear)
                                        else lin), skip=())
            tag = "mixed impl={} depth {}".format(impl, depth)
            _, st = run_generate(pm, cfg_m, prompt, 16, timer, tag)
            _expect(tag, st["launches"], ("K5", "K7") + (
                ("K8",) if impl == "auto" else ("K6",)), ("K4",))
            st["step_vs_plain_err"] = step_vs_plain(pm, cfg_m, prompt, tag)
            out[tag] = st
        del loaded, pm
        torch.cuda.empty_cache()

        cfg_c = dataclasses.replace(cfg, n_layers=depth)
        params = build_plane_params(
            cfg_c, torch.device("cuda"),
            lambda li, n: (4, 8)[(li + UNFUSED.index(n)) % 2], SEED + 9)
        eng = Sv.DecodeEngine(params, cfg_c, max_batch=8, max_len=512,
                              chunk=8, device="cuda")
        if eng._stacked_chunks:
            fail("chunk: DecodeEngine put a model K4 refuses on K4")
        _, st = drive(eng, _prompts(cfg), "decode_chunk",
                      "chunk (DecodeEngine on decode_chunk, 4/8-bit, depth "
                      "{})".format(depth), ("K1", "K5", "K6"), n_new=16,
                      timer=timer)
    _expect("chunk", st["launches"], (), ("K4",))
    st["depth"] = depth
    out["chunk"] = st
    del eng, params
    torch.cuda.empty_cache()
    return out


def serve_paths(params, cfg):
    """Phase 4: the engines at 7B widths, one path at a time.
      main     DecodeEngine on K4 (8 requests x 32 tokens, PR 1's run):
               ms/step, tok/s, K4 device ms/step beside the wall ms/step;
      unfused  decode_chunk_scanned with FORCE_LAYER_KERNEL = False at a
               reduced depth (K1/K2/K3), a route no engine takes itself;
      paged    PagedDecodeEngine(block 128) and the fixed-slot engine on
               the same 10 requests (a 256-token shared-prefix pair
               added), admissions pinned to prefill_at: equal tokens."""
    import dataclasses
    import types

    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm import serving as Sv

    out = {}
    kw = dict(max_batch=8, max_len=512, chunk=8, device="cuda")
    eng = Sv.DecodeEngine(params, cfg, **kw)
    if not eng._stacked_chunks:
        fail("DecodeEngine at 7B is not on the megakernel route")
    timer = KernelEvents()
    with timer.patch:
        _, out["main"] = drive(eng, _prompts(cfg), "decode_chunk_scanned",
                               "main (DecodeEngine, K4)",
                               ("K1", "K4", "K9"), time_k4=True, timer=timer)
    del eng
    torch.cuda.empty_cache()

    depth = min(4, cfg.n_layers)
    cfg_u = dataclasses.replace(cfg, n_layers=depth)
    params_u = dict(params, layers=params["layers"][:depth])
    class ScannedEngine(Sv.DecodeEngine):
        """Every decode chunk on decode_chunk_scanned over stack_layers
        params: with FORCE_LAYER_KERNEL = False the unfused scanned route,
        which no engine takes by itself."""

        def _decode_chunk_call(self, temps, n):
            return Sv.decode_chunk_scanned(
                self.params_stacked, self.next_tok, self.cache, temps,
                self._gen, self.cfg, n)

    timer = KernelEvents()
    Dm.FORCE_LAYER_KERNEL = False
    try:
        eng = ScannedEngine(params_u, cfg_u, **kw)
        with timer.patch:
            toks, st = drive(
                eng, _prompts(cfg), "decode_chunk_scanned",
                "unfused (decode_chunk_scanned, FORCE_LAYER_KERNEL=False, "
                "depth {})".format(depth), ("K1", "K2", "K3", "K9"),
                n_new=8, timer=timer)
    finally:
        Dm.FORCE_LAYER_KERNEL = None
    del eng
    # the same model and requests on the K4 route: where do tokens agree?
    eng = ScannedEngine(params_u, cfg_u, **kw)
    toks4, _ = drive(eng, _prompts(cfg), "decode_chunk_scanned",
                     "unfused's model on K4 (depth {})".format(depth),
                     ("K4",), n_new=8)
    del eng
    by = st["entry_device_ms_per_step"]
    st.update(depth=depth, k2_device_ms_per_step=by.get("sbt_attn_update",
                                                        0.0),
              k3_device_ms_per_step=by.get("sbt_ffn_block", 0.0),
              tokens_equal_k4_route=[a == b for a, b in zip(toks, toks4)],
              tokens_agree_k4_route=[
                  next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       len(a)) for a, b in zip(toks, toks4)])
    print("unfused: K2 {:.4f} and K3 {:.4f} ms/step device of the kernels' "
          "{:.3f}, wall {:.3f} ms/step; tokens equal to the K4 route's in "
          "{} of {} requests (leading tokens equal: {})".format(
              st["k2_device_ms_per_step"], st["k3_device_ms_per_step"],
              st["kernel_device_ms_per_step"], st["decode_ms_per_step"],
              sum(st["tokens_equal_k4_route"]), len(toks),
              st["tokens_agree_k4_route"]), flush=True)
    out["unfused"] = st
    torch.cuda.empty_cache()

    prompts = _prompts(cfg, with_prefix_pair=True)
    eng = Sv.DecodeEngine(params, cfg, **kw)
    ref, out["fixed_10"] = drive(eng, prompts, "decode_chunk_scanned",
                                 "fixed-slot, 10 requests",
                                 ("K1", "K4", "K9"))
    out["fixed_10"]["prefix_hits"] = eng.prefix_hits
    del eng
    torch.cuda.empty_cache()
    eng = Sv.PagedDecodeEngine(params, cfg, block=128, **kw)
    eng._prefill_call = types.MethodType(
        lambda self, tokens, scratch, lasts, offsets: Dm.prefill_at(
            self.params, tokens, scratch, self.cfg, lasts, offsets), eng)
    got, out["paged"] = drive(eng, prompts, "decode_chunk_paged",
                              "paged (PagedDecodeEngine, block 128)",
                              ("K1", "K4", "K9"))
    held = sum(1 for r in eng._ref if r > 0)
    cached = sum(len(e["blocks"]) for e in eng._prefix.values())
    out["paged"].update(prefix_hits=eng.prefix_hits, blocks_held=held,
                        blocks_in_prefix_cache=cached,
                        tokens_equal_fixed_slot=got == ref)
    print("paged: prefix hits {} (fixed-slot {}), blocks held at the end "
          "{} (prefix cache {}), tokens equal to the fixed-slot engine's: "
          "{}".format(eng.prefix_hits, out["fixed_10"]["prefix_hits"], held,
                      cached, got == ref), flush=True)
    if got != ref:
        bad = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
        fail("paged tokens differ from the fixed-slot engine's in "
             "requests {}".format(bad))
    if eng.prefix_hits < 1 or held != cached:
        fail("paged: {} prefix hits, {} blocks held, {} cached".format(
            eng.prefix_hits, held, cached))
    del eng
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(SEED + 12)
    lens = (1000, 1400, 1700, 2000)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    max_len = -(-(max(lens) + 16) // 128) * 128
    eng = Sv.PagedDecodeEngine(params, cfg, max_batch=len(lens), block=128,
                               max_len=max_len, chunk=8, device="cuda")
    timer = KernelEvents()
    with timer.patch:
        _, out["paged_cold"] = drive(
            eng, prompts, "decode_chunk_paged",
            "paged_cold (PagedDecodeEngine, block 128, its own cold "
            "admissions)", ("K1", "K4", "K9", "K10"), n_new=16, timer=timer)
    out["paged_cold"].update(prompt_lens=list(lens), max_len=max_len,
                             prefix_hits=eng.prefix_hits)
    if eng.prefix_hits:
        fail("paged_cold: {} prefix hits, all admissions should be "
             "cold".format(eng.prefix_hits))
    del eng
    torch.cuda.empty_cache()
    return out


def prefill_paths(cfg):
    """Phase 4, path prefill: the paged engine's cold admission,
    prefill_cold_scanned over the stacked INT4-g128 s4r weights of
    build_random_params at 7B widths (as the engines serve them: W4A8
    linears), 32 layers, into an
    int8 scratch cache, at B=1 S=2048 and B=8 S=512 (ragged last tokens):
    K10 for every layer's attention, K1 for the linears, K9 for the
    last-token head. Beside it, on the same prompt, the masked routes:
      masked      the same function with llama._flash_ok patched to False
                  (the (S, S) mask and f32 scores of attention_scores over
                  the raw K/V rows: the port's route before K10);
      prefill_at  the admission route of prefix hits (a (B, S, S_max)
                  mask and f32 scores over the dequantized int8 cache).
    Each route runs once to warm up, then timed: wall s, K10's and K1's
    device ms inside (CUDA events around each launch), launches, and the
    peak device memory above the resident weights and cache. Checks: in
    the flash route's warm-up call, every layer's K10 output against
    flash_attention_plain on the operands the path gave it (k10_within,
    as phase 2); the logits of all three routes agree (atol 0.1, equal
    decisive argmax); layer 0's KV codes are equal in all three (they
    precede any attention). Later layers' codes are reported, not held:
    on a bf16 W4A8 model every linear re-rounds its input to int8, so one
    bf16 ulp of difference in an attention output (flash rounds P to bf16,
    the masked routes do not) moves later layers' codes by 10-23 on
    random models whose activations stay O(1), and on this model, whose
    layer-0 FFN writes rows of ~1e3, by up to 254 (attention_reach_probe.py
    measures both). The per-layer hold is therefore the check that sees
    K10 past layer 0 here; the eval path's loss does too."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm import llama as L
    from sparsebit_tpu_torch.llm import serving as Sv
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
    from sparsebit_tpu_torch.llm.quant import QuantLinear

    params = L.quantize_llama_params(
        build_random_params(cfg, torch.device("cuda")),
        lambda path, lin: (Sv._serving_layout(lin)
                           if isinstance(lin, QuantLinear) else lin),
        skip=())
    stacked = Dm.stack_layers(params)
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    timer = KernelEvents()
    for B, S in ((1, 2048), (8, 512)):
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda")
        last = (S - 1 - 37 * torch.arange(B, device="cuda")).to(torch.int32)
        zeros = torch.zeros(B, dtype=torch.int32, device="cuda")

        def call(route, cache, patch=()):
            if route == "prefill_at":
                return Dm.prefill_at(params, tokens, cache, cfg, last, zeros)
            if route == "masked":
                patch = [(L, "_flash_ok", lambda q: False)]
            with _Patched(patch):
                return Dm.prefill_cold_scanned(stacked, tokens, cache, cfg,
                                               last)

        runs, held = {}, []
        for route in ("flash", "masked", "prefill_at"):
            call(route, init_kv_cache(cfg, B, S, True, device="cuda"),
                 [(L, "flash_attention", k10_held(held))])
            cache = init_kv_cache(cfg, B, S, True, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _reset_launches()
            timer.events = []
            with timer.patch:
                timer.on = True
                t0 = time.perf_counter()
                logits, cache = call(route, cache)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                timer.on = False
                dev_ms, by = timer.take_ms()
            launches = _launches()
            st = {"B": B, "S": S, "route": route, "wall_s": wall,
                  "kernel_device_ms": dev_ms,
                  "k10_device_ms": by.get(K10_ENTRY, 0.0),
                  "k1_device_ms": by.get("sbt_qmm_s4", 0.0),
                  "peak_bytes_above_resident":
                      torch.cuda.max_memory_allocated() - base,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "launches": launches}
            print("prefill {} B={} S={}: {:.4f} s wall, K10 {:.3f} ms, K1 "
                  "{:.3f} ms device inside; peak {:.3f} GB above the "
                  "resident {:.3f} GB; launches {}".format(
                      route, B, S, wall, st["k10_device_ms"],
                      st["k1_device_ms"],
                      st["peak_bytes_above_resident"] / 1e9, base / 1e9,
                      launches), flush=True)
            runs[route] = (logits, cache, st)
        tag = "prefill B={} S={}".format(B, S)
        lf, cf, sf = runs["flash"]
        _expect(tag, sf["launches"], ("K1", "K9", "K10"))
        k10 = {r: runs[r][2]["launches"]["K10"] for r in runs}
        if k10 != {"flash": cfg.n_layers, "masked": 0, "prefill_at": 0}:
            fail("{}: K10 launches by route {} (want {} on the flash route "
                 "only)".format(tag, k10, cfg.n_layers))
        k10_held_report(tag, held, cfg.n_layers)
        sf["k10_vs_plain"] = held
        for route in ("masked", "prefill_at"):
            lo, co, so = runs[route]
            err, ok = _logits_agree(lf, lo)
            diffs = [max((a[li, :, :S].int() - b[li, :, :S].int()).abs()
                         .max().item() for a, b in ((cf.k, co.k),
                                                    (cf.v, co.v)))
                     for li in range(cfg.n_layers)]
            print("{}: flash vs {} logits max err {:.3e} (atol 0.1) {}; KV "
                  "codes of layer 0 {}; max code diff by layer {}".format(
                      tag, route, err, "ok" if ok else "BAD",
                      "equal" if diffs[0] == 0 else "DIFFER", diffs),
                  flush=True)
            if not ok:
                fail("{}: flash and {} logits differ (err {:.3e})".format(
                    tag, route, err))
            if diffs[0]:
                fail("{}: flash and {} layer-0 KV codes differ by {}".format(
                    tag, route, diffs[0]))
            sf[route] = dict(so, logits_err_vs_flash=err,
                             kv_code_diff_by_layer=diffs)
        out[tag] = sf
        del runs, lf, cf, lo, co
        torch.cuda.empty_cache()
    del params, stacked
    torch.cuda.empty_cache()
    return out


def k10_held(log):
    """A stand-in for llama.flash_attention that holds each K10 output to
    the plain version on the same operands (k10_within), appending (max
    error, worst error over its bound) to ``log``."""
    from sparsebit_tpu_torch.ops import flash_attention as FA

    def held(q, k, v, *, sm_scale):
        out = FA.flash_attention(q, k, v, sm_scale=sm_scale)
        ref = FA.flash_attention_plain(q, k, v, sm_scale=sm_scale)
        log.append(k10_within(out, ref, q, k, v, sm_scale))
        return out
    return held


def k10_held_report(tag, held, n_want):
    """Print and check what k10_held logged: every call within its bound,
    ``n_want`` calls."""
    bad = [i for i, (_, r) in enumerate(held) if r > 1.0]
    print("{}: K10 vs plain on each layer's operands over {} calls: max err "
          "{:.3e}, worst err/tol {:.3f}: {}".format(
              tag, len(held), max((e for e, _ in held), default=float("nan")),
              max((r for _, r in held), default=float("nan")),
              "ok" if not bad and len(held) == n_want else "BAD"), flush=True)
    if bad or len(held) != n_want:
        fail("{}: K10 differs from its plain version in calls {} (of {} "
             "checked, {} wanted)".format(tag, bad, len(held), n_want))


def eval_path(cfg):
    """Phase 4, path eval: perplexity(seqlen=2048, batch=1) over random
    INT4-g128 weights in the checkpoint layout (the generate path's
    model), on a seeded two-window token stream: each window feeds the
    backbone 2047 tokens (ragged, fault R7) and every layer's attention is
    K10; the linears take the dense route at M = 2047, as the reference's
    XLA path. The weights are made with ``unit`` (activations O(1), so
    that attention reaches the loss). A first call holds every K10 launch
    to the plain version on its operands (k10_held); a second runs a
    planted fault in every layer (far_tile_fault) and reports how far it
    moves the log-perplexity; then, timed, s a window, K10's device ms
    inside and its launches; the log-perplexity within 1e-3 relative of
    the same call on the masked route (llama._flash_ok patched to
    False)."""
    import numpy as np
    import torch
    from sparsebit_tpu_torch.llm import eval as Ev
    from sparsebit_tpu_torch.llm import llama as L

    params = build_plane_params(cfg, torch.device("cuda"), lambda li, n: 4,
                                SEED + 6, unit=True)
    gen = torch.Generator().manual_seed(SEED + 13)
    stream = torch.randint(0, cfg.vocab_size, (2 * 2048 + 7,),
                           generator=gen).numpy()
    held = []
    with _Patched([(L, "flash_attention", k10_held(held))]):
        Ev.perplexity(params, stream, cfg, seqlen=2048, batch=1,
                      device="cuda")
    k10_held_report("eval", held, 2 * cfg.n_layers)
    with _Patched([(L, "flash_attention", far_tile_fault)]):
        ppl_fault = Ev.perplexity(params, stream, cfg, seqlen=2048, batch=1,
                                  device="cuda")
    timer = KernelEvents()
    res = {}
    for route in ("flash", "masked"):
        patch = [] if route == "flash" else [(L, "_flash_ok",
                                              lambda q: False)]
        _reset_launches()
        with timer.patch, _Patched(patch):
            torch.cuda.synchronize()
            timer.events = []
            timer.on = True
            t0 = time.perf_counter()
            ppl = Ev.perplexity(params, stream, cfg, seqlen=2048, batch=1,
                                device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            timer.on = False
            _, by = timer.take_ms()
        res[route] = {"ppl": ppl, "s_per_window": wall / 2,
                      "k10_device_ms": by.get(K10_ENTRY, 0.0),
                      "launches": _launches()}
        print("eval {}: perplexity {:.6f} over 2 windows of 2048, {:.3f} s "
              "a window, K10 {:.3f} ms device inside; launches {}".format(
                  route, ppl, wall / 2, res[route]["k10_device_ms"],
                  res[route]["launches"]), flush=True)
    f, m = res["flash"], res["masked"]
    rel = abs(np.log(f["ppl"]) - np.log(m["ppl"])) / abs(np.log(m["ppl"]))
    rel_fault = abs(np.log(ppl_fault) - np.log(f["ppl"])) / abs(
        np.log(f["ppl"]))
    print("eval: log-perplexity flash vs masked rel {:.3e} (tol 1e-3); a "
          "planted fault (key tile 0 dropped from rows >= 128 in every "
          "layer) moves it by rel {:.3e}".format(rel, rel_fault), flush=True)
    probes["eval log-ppl rel shift, planted far-tile fault"] = rel_fault
    if not (np.isfinite(f["ppl"]) and rel <= 1e-3):
        fail("eval: log-perplexity {} vs masked {} (rel {:.3e})".format(
            f["ppl"], m["ppl"], rel))
    if f["launches"]["K10"] != 2 * cfg.n_layers or m["launches"]["K10"]:
        fail("eval: K10 launched {} times (want {}), {} on the masked "
             "route".format(f["launches"]["K10"], 2 * cfg.n_layers,
                            m["launches"]["K10"]))
    f.update(masked=m, log_ppl_rel_vs_masked=rel, k10_vs_plain=held)
    del params
    torch.cuda.empty_cache()
    return {"eval": f}


QLORA_STEPS = 4
# the adapters' gradients on the kernels against the plain versions:
# (relative norm, cosine) by backward mode. Dense: bf16 activations whose
# last bits differ where the kernels' sums run in another order. int8: the
# backward also requantizes each g row per token, so where those bits
# differ a code moves by one; that is the noise the reference bounds its
# int8 gradients by against f32 (tests/test_llm.py:276-277).
QLORA_GRAD_TOL = {"dense": (0.05, 0.999), "int8": (0.15, 0.99)}


def _tensors(tree):
    """Every tensor of a params tree, linears' fields included."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "__dict__"):
        return _tensors(tree.__dict__)
    return []


def bwd_held(log):
    """A stand-in for flash_attention.flash_attention_bwd that holds each
    K11/K12 call to the plain versions on the same operands (K10's lse,
    the call's di), appending (max error, worst error over its bound) of
    K11 and of K12 to ``log``."""
    from sparsebit_tpu_torch.ops import flash_attention as FA

    real = FA.flash_attention_bwd

    def held(q, k, v, out, lse, do, *, sm_scale):
        dq, dk, dv = real(q, k, v, out, lse, do, sm_scale=sm_scale)
        do = do.to(q.dtype)
        di = FA.flash_di(out, do)
        pdk, pdv = FA.flash_bwd_dkv_plain(q, k, v, lse, do, di,
                                          sm_scale=sm_scale)
        pdq = FA.flash_bwd_dq_plain(q, k, v, lse, do, di, sm_scale=sm_scale)
        tq, tk, tv = FA.flash_bwd_tolerance(q, k, v, lse, do, di, pdq, pdk,
                                            pdv, sm_scale=sm_scale)
        log.append((bwd_within((dk, dv), (pdk, pdv), (tk, tv)),
                    bwd_within((dq,), (pdq,), (tq,))))
        return dq, dk, dv
    return held


def plain_flash():
    """Route K10 (with its lse), K11 and K12 to their plain versions, on
    whatever device the tensors are."""
    from sparsebit_tpu_torch.ops import flash_attention as FA

    def fwd(q, k, v, *, sm_scale):
        return FA.flash_attention_plain(q, k, v, sm_scale=sm_scale,
                                        return_lse=True)

    return _Patched([(FA, "flash_attention_fwd", fwd),
                     (FA, "flash_attention_dkv", FA.flash_bwd_dkv_plain),
                     (FA, "flash_attention_dq", FA.flash_bwd_dq_plain)])


def _lora_grads(lora):
    import torch

    return torch.cat([lora[k][n].grad.reshape(-1).float() for k in
                      sorted(lora) for n in ("lora_A", "lora_B")])


def qlora_path(cfg):
    """Phase 4, path qlora (this slice's main path): QLoRA training at
    llama_7b() widths and 32 layers. The frozen backbone is random INT4-g128
    in the checkpoint layout (unfused column-plane linears, f32 qparams,
    impl "auto", a bf16 head; ``unit`` scales, so that activations stay
    O(1) and gradients reach through every attention), wrapped by
    wrap_llama_lora(r=8, alpha=16) on wq and wv; AdamW at lr 3e-4 with
    optax.adamw's weight decay (qlora.adamw); B = 4 windows of 513 seeded
    tokens (S = 512 after the shift). Each backward mode, the dense one
    (g @ dequant(W)^T) and prepare_train's int8 one, runs:
      1. a warm-up loss and backward with every K11/K12 call held to the
         plain versions on the operands the path gave it (bwd_held,
         flash_bwd_tolerance), 32 each;
      2. QLORA_STEPS timed qlora_train_steps, every kernel count set to 0
         just before each and read just after: wall s split into forward,
         backward and the optimiser step, tokens/s, K10/K11/K12 device
         ms (CUDA events around each launch) and launches (32 each a
         step), peak memory above the resident weights, adapters and
         optimiser state, the loss of each step;
      3. the adapters' gradients at the trained state on the kernels and
         with K10/K11/K12 routed to their plain versions (plain_flash):
         loss within 1e-3 relative, gradients within QLORA_GRAD_TOL's
         relative norm and cosine for the mode;
      4. every backbone tensor bit-equal to its copy from before the
         steps, every adapter tensor moved, each loss finite."""
    import torch
    from sparsebit_tpu_torch.llm import qlora as Q
    from sparsebit_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    params = Q.wrap_llama_lora(
        build_plane_params(cfg, dev, lambda li, n: 4, SEED + 6, unit=True),
        r=8, alpha=16.0,
        generator=torch.Generator(device=dev).manual_seed(SEED + 14))
    tokens = torch.randint(0, cfg.vocab_size, (4, 513), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 15))
    n_tok = tokens.shape[0] * (tokens.shape[1] - 1)
    timer = KernelEvents()
    out = {}
    for mode in ("dense", "int8"):
        tag = "qlora {}".format(mode)
        t0 = time.perf_counter()
        p = params if mode == "dense" else Q.prepare_train(params)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        lora = {k: {n: t.detach().clone() for n, t in v.items()}
                for k, v in Q.extract_lora(p).items()}
        lora0 = [t.clone() for t in _tensors(lora)]
        backbone = [t.clone() for t in _tensors(p)]
        opt = Q.adamw(lora, 3e-4)

        held = []
        with _Patched([(FA, "flash_attention_bwd", bwd_held(held))]):
            Q.qlora_loss_fn(lora, p, tokens, cfg).backward()
        torch.cuda.synchronize()
        bad = [i for i, ((_, r11), (_, r12)) in enumerate(held)
               if r11 > 1.0 or r12 > 1.0]
        worst = (max((h[0][1] for h in held), default=float("nan")),
                 max((h[1][1] for h in held), default=float("nan")))
        print("{}: K11/K12 vs plain on each layer's operands over {} calls: "
              "worst err/tol {:.3f} / {:.3f}: {}".format(
                  tag, len(held), *worst,
                  "ok" if not bad and len(held) == cfg.n_layers else "BAD"),
              flush=True)
        if bad or len(held) != cfg.n_layers:
            fail("{}: K11/K12 differ from their plain versions in calls {} "
                 "(of {} checked, {} wanted)".format(tag, bad, len(held),
                                                     cfg.n_layers))

        steps = []
        for step in range(QLORA_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _reset_launches()
            timer.events = []
            with timer.patch:
                timer.on = True
                t0 = time.perf_counter()
                opt.zero_grad(set_to_none=True)
                loss = Q.qlora_loss_fn(lora, p, tokens, cfg)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                loss.backward()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                opt.step()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                timer.on = False
                _, by = timer.take_ms()
            launches = _launches()
            st = {"loss": loss.item(), "wall_s": t3 - t0,
                  "forward_s": t1 - t0, "backward_s": t2 - t1,
                  "optimizer_s": t3 - t2, "tokens_per_s": n_tok / (t3 - t0),
                  "k10_device_ms": by.get(K10_ENTRY, 0.0),
                  "k11_device_ms": by.get(K11_ENTRY, 0.0),
                  "k12_device_ms": by.get(K12_ENTRY, 0.0),
                  "peak_bytes_above_resident":
                      torch.cuda.max_memory_allocated() - base,
                  "resident_bytes": base, "launches": launches}
            print("{} step {}: loss {:.6f}; {:.4f} s wall (forward {:.4f}, "
                  "backward {:.4f}, step {:.4f}), {:.1f} tok/s; K10 {:.3f} / "
                  "K11 {:.3f} / K12 {:.3f} ms device; peak {:.3f} GB above "
                  "the resident {:.3f} GB; launches {}".format(
                      tag, step, st["loss"], st["wall_s"], st["forward_s"],
                      st["backward_s"], st["optimizer_s"],
                      st["tokens_per_s"], st["k10_device_ms"],
                      st["k11_device_ms"], st["k12_device_ms"],
                      st["peak_bytes_above_resident"] / 1e9, base / 1e9,
                      launches), flush=True)
            got = {k: launches[k] for k in ("K10", "K11", "K12")}
            if got != dict.fromkeys(got, cfg.n_layers):
                fail("{} step {}: launches {} (want {} each)".format(
                    tag, step, got, cfg.n_layers))
            if not torch.isfinite(loss):
                fail("{} step {}: loss {}".format(tag, step, loss.item()))
            steps.append(st)

        grads = {}
        for route in ("kernels", "plain"):
            opt.zero_grad(set_to_none=True)
            with (plain_flash() if route == "plain" else _Patched([])):
                loss = Q.qlora_loss_fn(lora, p, tokens, cfg)
                loss.backward()
            grads[route] = (loss.item(), _lora_grads(lora))
        (lk, gk), (lp, gp) = grads["kernels"], grads["plain"]
        rel = ((gk - gp).norm() / gp.norm()).item()
        cos = (gk @ gp / (gk.norm() * gp.norm())).item()
        loss_rel = abs(lk - lp) / abs(lp)
        tol_rel, tol_cos = QLORA_GRAD_TOL[mode]
        print("{}: one step on the kernels vs the plain versions: loss {:.6f}"
              " / {:.6f} (rel {:.3e}, tol 1e-3); adapter gradients rel {:.3e} "
              "(tol {}), cos {:.6f} (tol {})".format(
                  tag, lk, lp, loss_rel, rel, tol_rel, cos, tol_cos),
              flush=True)
        if not (loss_rel <= 1e-3 and rel <= tol_rel and cos >= tol_cos):
            fail("{}: kernels and plain versions differ (loss rel {:.3e}, "
                 "gradients rel {:.3e}, cos {:.6f})".format(
                     tag, loss_rel, rel, cos))
        same = all(torch.equal(a, b) for a, b in zip(backbone, _tensors(p)))
        moved = all(not torch.equal(a, b) for a, b in zip(lora0,
                                                          _tensors(lora)))
        print("{}: backbone bit-equal after the steps {}; every adapter "
              "tensor moved {}".format(tag, same, moved), flush=True)
        if not (same and moved):
            fail("{}: backbone changed ({}) or an adapter did not move ({})"
                 .format(tag, not same, not moved))
        out[tag] = {"steps": steps, "prepare_train_s": prep_s,
                    "launches": {k: sum(s["launches"][k] for s in steps)
                                 for k in steps[0]["launches"]},
                    "k11_k12_vs_plain": held, "loss_vs_plain_rel": loss_rel,
                    "grad_vs_plain_rel": rel, "grad_vs_plain_cos": cos}
        del p, lora, lora0, backbone, opt, grads, gk, gp, loss
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out




GPTQ_DEPTH = 2
GPTQ_CALIB = (128, 2048)  # the reference's calibration, convert.py:37


def gptq_within(got, ref):
    """tests/test_torch_gptq.py's tolerance between two solves of one
    linear: at least 99.5 % of the codes equal, every fake-quant weight
    within one quantization step of its group (|dwq| <= 1.001 step +
    1e-6). Returns (fraction of equal codes, worst |dwq| / step, ok)."""
    import torch

    gs = got["wq"].shape[0] // got["scales"].shape[0]
    step = torch.repeat_interleave(ref["scales"], gs, 0)
    dwq = (got["wq"] - ref["wq"]).abs()
    same = (got["codes"] == ref["codes"]).float().mean().item()
    ok = same >= 0.995 and bool((dwq <= step * 1.001 + 1e-6).all())
    return same, (dwq / step).max().item(), ok


def gptq_linear_record(w, H, res, groupsize):
    """One solved linear against round to nearest (QuantLinear.from_dense)
    on the same Hessian: both Hessian-weighted losses tr(dW^T H dW) / KN,
    and whether codes, scales and zeros are finite and in range."""
    import torch
    from sparsebit_tpu_torch.llm.quant import QuantLinear

    w = w.to(torch.float32)
    bits = res["bits"]
    qmax = 2 ** bits - 1
    rtn = QuantLinear.from_dense(w, bits=bits, groupsize=groupsize)

    def hessian_loss(wq):
        d = wq - w
        return ((d * (H @ d)).sum() / d.numel()).item()

    z = res["zeros"]
    return {"shape": list(w.shape), "bits": bits, "loss": res["loss"],
            "hessian_loss": hessian_loss(res["wq"]),
            "rtn_hessian_loss": hessian_loss(rtn.dequantize()),
            "in_range": bool(
                int(res["codes"].max()) <= qmax
                and torch.isfinite(res["scales"]).all()
                and bool((res["scales"] > 0).all())
                and torch.isfinite(z).all()
                and bool(((z >= 0) & (z <= qmax) & (z == z.round())).all())
                and torch.isfinite(res["wq"]).all())}


def gptq_records_held(tag, records):
    """Fail unless every record's GPTQ Hessian loss is strictly below
    RTN's and its codes, scales and zeros are in range."""
    for rec in records:
        if not rec["hessian_loss"] < rec["rtn_hessian_loss"]:
            fail("{} {}: Hessian loss {} not below RTN's {}".format(
                tag, rec["path"], rec["hessian_loss"],
                rec["rtn_hessian_loss"]))
        if not rec["in_range"]:
            fail("{} {}: codes, scales or zeros out of range".format(
                tag, rec["path"]))


def timed_into(times, key, fn):
    """fn with a synchronise before and after each call, its wall s added
    to times[key] (appended where times[key] is a list)."""
    import torch

    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if isinstance(times[key], list):
            times[key].append(dt)
        else:
            times[key] += dt
        return out
    return run


def column_loop_profile(w, H, bits, kw):
    """One column loop (gptq._gptq_core) of a linear on the card under
    torch.profiler: wall s, the device time of its kernels and their
    launches, so that the loop's host share shows. Device time None where
    the profiler records none."""
    import torch
    from sparsebit_tpu_torch.llm import gptq as G

    U, dead = G._hinv_cholesky(H, kw["percdamp"])
    W = w.clone()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        G._gptq_core(W, U, dead, bits, kw["groupsize"], 128, kw["sym"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    out = {"wall_s_profiled": wall, "device_ms": dev_ms or None,
           "kernel_launches": sum(e.count for e in events),
           "columns": w.shape[0]}
    print("gptq column loop {} under torch.profiler: {:.2f} s wall, {} "
          "({} columns)".format(
              list(w.shape), wall, "kernels {:.1f} ms device in {} launches"
              .format(dev_ms, out["kernel_launches"]) if dev_ms else
              "device time not measured", w.shape[0]), flush=True)
    return out


def gptq_path(cfg):
    """Phase 4, path gptq: GPTQ conversion on the card, its checkpoint
    served. llama_7b() widths at depth GPTQ_DEPTH (the only cut, for
    time), f32, seeded weights made on the card, fused wqkv/w13;
    calibration on GPTQ_CALIB seeded token ids; quantize_llama_gptq
    (4-bit, g128, no act-order, so that K4 takes the result), with TF32
    off (main sets allow_tf32 = False: GPTQ is IEEE f32). Timed with a
    synchronise around each: the Hessian accumulation (the float layer's
    intermediates and add_batch), the Cholesky, the column loop a linear
    and the propagation, with K10's launches (f32, hd 128, S = 2048 in
    decoder_layer's causal_attention) and device ms inside, and the peak
    memory. Held: every linear's Hessian-weighted loss strictly below
    round to nearest's (QuantLinear.from_dense) on the same H, its codes,
    scales and zeros finite and in range; the first wo (4096 x 4096) also
    solved on the CPU from the same H, within gptq_within; K10 at the
    propagation's shape held to its plain version once. Then
    save_quant_checkpoint under the bf16 serving config,
    load_quant_checkpoint (arrays equal), DecodeEngine(max_batch=8) on K4
    with K1 and K9 (8 requests x 32 tokens), generate B=8 x 16 on K8, K5
    and K9, and one decode_step on the kernels against the plain
    versions."""
    import torch
    from sparsebit_tpu_torch.llm import convert as C
    from sparsebit_tpu_torch.llm import gptq as G
    from sparsebit_tpu_torch.llm import llama as L
    from sparsebit_tpu_torch.llm import serving as Sv

    dev = torch.device("cuda")
    cfg_f = dataclasses.replace(cfg, n_layers=GPTQ_DEPTH, dtype="float32")
    params = L.fuse_llama_params(L.init_llama_params(
        cfg_f, torch.Generator(device=dev).manual_seed(SEED + 20),
        device=dev))
    calib = torch.randint(0, cfg.vocab_size, GPTQ_CALIB, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED + 21))

    held = []
    x0 = params["tok_embed"][calib[:1]]
    inv_freq = L.rope_frequencies(cfg_f, device=dev)
    pos = torch.arange(GPTQ_CALIB[1], dtype=torch.int32, device=dev)[None]
    with _Patched([(L, "flash_attention", k10_held(held))]):
        L.decoder_layer(params["layers"][0], x0, cfg_f, inv_freq, pos, None)
    k10_held_report("gptq propagation shape (f32, S=2048)", held, 1)
    del x0

    times = {"hessian": 0.0, "cholesky": 0.0, "column_loop": [],
             "propagation": 0.0, "checks": 0.0}
    linears = []
    timer = KernelEvents()

    class Acc(G.HessianAccumulator):
        add_batch = timed_into(times, "hessian",
                               G.HessianAccumulator.add_batch)

    orig_layer = L.decoder_layer

    def propagate(*a, **kw):
        timer.on = True
        out = timed_into(times, "propagation", orig_layer)(*a, **kw)
        timer.on = False
        return out

    orig_solve = C.gptq_quantize_mixed
    cpu_case = []

    def solve(w, H, **kw):
        res = orig_solve(w, H, **kw)
        t = time.perf_counter()
        rec = gptq_linear_record(w, H, res, kw["groupsize"])
        rec["column_loop_s"] = times["column_loop"][-1]
        if tuple(w.shape) == (cfg.dim, cfg.dim) and not cpu_case:
            cpu_case.append((w.to(torch.float32).cpu(), H.cpu(), kw, rec, {
                k: res[k].cpu() for k in ("codes", "wq", "scales")}))
        linears.append(rec)
        torch.cuda.synchronize()
        times["checks"] += time.perf_counter() - t
        return res

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with timer.patch, _Patched([
            (C, "HessianAccumulator", Acc),
            (C, "_layer_intermediates",
             timed_into(times, "hessian", C._layer_intermediates)),
            (G, "_hinv_cholesky",
             timed_into(times, "cholesky", G._hinv_cholesky)),
            (G, "_gptq_core",
             timed_into(times, "column_loop", G._gptq_core)),
            (C, "gptq_quantize_mixed", solve),
            (L, "decoder_layer", propagate)]):
        t0 = time.perf_counter()
        qparams, layers_bit = C.quantize_llama_gptq(
            params, calib, cfg_f, candidate_bits=(4,), groupsize=128,
            verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - times["checks"]
    _, by = timer.take_ms()
    launches = _launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    for w, H, kw, rec, got in cpu_case:  # the first wo, solved on the CPU
        t = time.perf_counter()
        ref = G.gptq_quantize(w, H, bits=rec["bits"],
                              groupsize=kw["groupsize"], sym=kw["sym"],
                              percdamp=kw["percdamp"])
        rec["cpu_s"] = time.perf_counter() - t
        same, worst, ok = gptq_within(got, ref)
        rec.update(cpu_codes_equal=same, cpu_worst_steps=worst,
                   cpu_loss=ref["loss"], cpu_ok=ok)
        rec["column_loop_profile"] = column_loop_profile(
            w.to(dev), H.to(dev), rec["bits"], kw)
    out = {"depth": GPTQ_DEPTH, "calib": list(GPTQ_CALIB), "wall_s": wall,
           "hessian_s": times["hessian"], "cholesky_s": times["cholesky"],
           "column_loop_s": sum(times["column_loop"]),
           "propagation_s": times["propagation"],
           "k10_device_ms": by.get(K10_ENTRY, 0.0), "launches": launches,
           "peak_gb_above_resident": peak, "linears": linears,
           "k10_vs_plain": held}
    print("gptq: {} layers at 7B widths, calibration {} x {}: {:.1f} s wall; "
          "Hessians {:.2f} s, Cholesky {:.2f} s, column loop {:.2f} s, "
          "propagation {:.2f} s (K10 {:.1f} ms device in {} launches); peak "
          "{:.2f} GB above the resident".format(
              GPTQ_DEPTH, *GPTQ_CALIB, wall, times["hessian"],
              times["cholesky"], out["column_loop_s"], times["propagation"],
              out["k10_device_ms"], launches["K10"], peak), flush=True)
    for name, rec in zip([p for li in range(GPTQ_DEPTH) for p in (
            "layers.{}.{}".format(li, n) for n in L._LINEAR_NAMES
            if n in params["layers"][li])], linears):
        rec["path"] = name
        print("gptq {} {}: column loop {:.2f} s, Hessian loss {:.4e} vs RTN "
              "{:.4e} ({:.2f} %), codes in range {}{}".format(
                  name, rec["shape"], rec["column_loop_s"],
                  rec["hessian_loss"], rec["rtn_hessian_loss"],
                  100 * rec["hessian_loss"] / rec["rtn_hessian_loss"],
                  rec["in_range"],
                  "" if "cpu_ok" not in rec else
                  "; CPU solve from the same H ({:.1f} s): codes equal "
                  "{:.5f}, worst |dwq| {:.3f} steps, loss {:.6e} vs {:.6e} "
                  "{}".format(rec["cpu_s"], rec["cpu_codes_equal"],
                              rec["cpu_worst_steps"], rec["cpu_loss"],
                              rec["loss"],
                              "ok" if rec["cpu_ok"] else "BAD")), flush=True)
        if not rec.get("cpu_ok", True):
            fail("gptq {}: the card's solve differs from the CPU's".format(
                name))
    gptq_records_held("gptq", linears)
    if len(linears) != 4 * GPTQ_DEPTH or not any("cpu_ok" in r
                                                 for r in linears):
        fail("gptq: {} linears solved, the CPU comparison {}".format(
            len(linears), "missing" if linears else "not run"))
    _expect("gptq", launches, ("K10",))
    if launches["K10"] != GPTQ_DEPTH * GPTQ_CALIB[0]:
        fail("gptq: K10 launched {} times in the propagation, want "
             "{}".format(launches["K10"], GPTQ_DEPTH * GPTQ_CALIB[0]))
    del params, calib
    torch.cuda.empty_cache()

    cfg_s = dataclasses.replace(cfg_f, dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        C.save_quant_checkpoint(tmp, qparams, layers_bit, cfg_s, 128)
        loaded, cfg_l, bits_l = C.load_quant_checkpoint(tmp)
        io_s = time.perf_counter() - t
    same = bits_l == layers_bit and cfg_l == cfg_s and all(
        torch.equal(a[n].packed["w"], b[n].packed["w"])
        and torch.equal(a[n].scales, b[n].scales)
        for a, b in zip(qparams["layers"], loaded["layers"])
        for n in FUSED)
    print("gptq: checkpoint under the bf16 serving config written and read "
          "in {:.1f} s, arrays equal {}".format(io_s, same), flush=True)
    if not same:
        fail("gptq: the npz round trip changed the converted model")
    del qparams
    torch.cuda.empty_cache()

    eng = Sv.DecodeEngine(loaded, cfg_l, max_batch=8, max_len=512, chunk=8,
                          device="cuda")
    if not eng._stacked_chunks:
        fail("gptq: DecodeEngine did not put the converted model on K4")
    timer = KernelEvents()
    with timer.patch:
        _, out["serve"] = drive(eng, _prompts(cfg), "decode_chunk_scanned",
                                "gptq serve (DecodeEngine on the converted "
                                "checkpoint, K4)", ("K1", "K4", "K9"),
                                timer=timer)
    del eng
    torch.cuda.empty_cache()
    prompt = torch.randint(0, cfg.vocab_size, (8, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 22))
    with timer.patch:
        _, st = run_generate(loaded, cfg_l, prompt, 16, timer,
                             "gptq generate B=8")
    _expect("gptq generate B=8", st["launches"], ("K5", "K8", "K9"), ("K4",))
    st["step_vs_plain_err"] = step_vs_plain(loaded, cfg_l, prompt,
                                            "gptq generate")
    out["generate"] = st
    out["checkpoint_io_s"] = io_s
    del loaded
    torch.cuda.empty_cache()
    return {"gptq": out}


def fixture_path():
    """Phase 4, path fixture: the accuracy fixture on the card,
    run_fixture(steps=200, gptq_bits=(4, 3)) (train a tiny LLaMA on the
    Markov corpus with Adam, float / RTN / GPTQ perplexity at int4 and
    int3, g32, 64-token windows). Prints the five perplexities and the
    train, GPTQ and eval seconds. Held: ppl_float < 4 and int4 GPTQ <
    1.05 x float (tests/test_fixture.py), and every GPTQ'd linear's
    Hessian loss strictly below RTN's on the same H (gptq_linear_record,
    28 linears). The test's third claim, int4 GPTQ <= RTN x 1.002, is
    printed and recorded with its numbers, not held: the card's training
    (deterministic) gives a model on which the JAX package's own GPTQ
    misses it by the same margin (fault R9: the claim sits inside the
    spread of trained models; fixture_margin_probe.py measures it). At M = 64 the int4 linears take K8; the
    int3 ones take the dense route (g32 is no lane multiple:
    supports_planes), so K7 does not launch; head_dim 32 keeps attention
    on the masked scores (no K10)."""
    import torch
    from sparsebit_tpu_torch.llm import convert as C
    from sparsebit_tpu_torch.llm import fixture as F

    times = {"train": 0.0, "gptq": 0.0, "eval": 0.0}
    linears = []

    orig_solve = C.gptq_quantize_mixed

    def solve(w, H, **kw):
        res = orig_solve(w, H, **kw)
        linears.append(gptq_linear_record(w, H, res, kw["groupsize"]))
        return res

    _reset_launches()
    with _Patched([(F, "train_tiny_llama",
                    timed_into(times, "train", F.train_tiny_llama)),
                   (F, "quantize_llama_gptq",
                    timed_into(times, "gptq", F.quantize_llama_gptq)),
                   (F, "perplexity", timed_into(times, "eval", F.perplexity)),
                   (C, "gptq_quantize_mixed", solve)]):
        res = F.run_fixture(steps=200, gptq_bits=(4, 3), device="cuda")
    launches = _launches()
    for i, rec in enumerate(linears):
        rec["path"] = "int{} #{}".format(rec["bits"], i % 14)
    out = dict(res, train_s=times["train"], gptq_s=times["gptq"],
               eval_s=times["eval"], launches=launches, linears=linears)
    print("fixture: ppl float {:.6f}, RTN int4 {:.6f}, GPTQ int4 {:.6f}, "
          "RTN int3 {:.6f}, GPTQ int3 {:.6f}; train {:.2f} s, GPTQ {:.2f} s "
          "(incl. the Hessian checks), eval {:.2f} s; launches {}".format(
              res["ppl_float"], res["ppl_rtn_int4"], res["ppl_gptq_int4"],
              res["ppl_rtn_int3"], res["ppl_gptq_int3"], times["train"],
              times["gptq"], times["eval"], launches), flush=True)
    ratio = [r["hessian_loss"] / r["rtn_hessian_loss"] for r in linears]
    print("fixture: {} GPTQ'd linears, Hessian loss / RTN's {:.3f} .. "
          "{:.3f}".format(len(linears), min(ratio), max(ratio)), flush=True)
    gptq_records_held("fixture", linears)
    if len(linears) != 2 * 2 * 7:
        fail("fixture: {} linears solved, want 28".format(len(linears)))
    held = {"ppl_float < 4": res["ppl_float"] < 4.0,
            "int4 GPTQ < 1.05 x float":
                res["ppl_gptq_int4"] < 1.05 * res["ppl_float"]}
    margin = res["ppl_gptq_int4"] / res["ppl_rtn_int4"] - 1
    out.update(claims=held, gptq_vs_rtn_int4=margin,
               gptq_le_rtn_x1002_int4=margin <= 0.002)
    print("fixture: claims {}; int4 GPTQ / RTN - 1 = {:+.4%} (the test's "
          "GPTQ <= RTN x 1.002: {}, recorded, not held: R9); int3 {:+.4%}"
          .format(held, margin, "holds" if margin <= 0.002 else "MISS",
                  res["ppl_gptq_int3"] / res["ppl_rtn_int3"] - 1),
          flush=True)
    for claim, ok in held.items():
        if not ok:
            fail("fixture: {} does not hold ({})".format(claim, res))
    _expect("fixture", launches, ("K8",), ("K7", "K10"))
    return {"fixture": out}


def run_scanned(sp, cfg, prompt, n_new, tag):
    """prefill_scanned (the per-layer branch), one decode_step_scanned and
    decode_tokens_scanned of n_new greedy tokens over a 128-row int8 cache,
    every kernel count set to 0 just before and read just after: prefill
    s, wall ms per decode step and K4's device ms per step (CUDA events).
    Returns (stats, the first decode step's logits)."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache

    B = prompt.shape[0]
    cache = init_kv_cache(cfg, B, 128, device="cuda")
    k4_ev = []
    orig_k4 = Dm.fused_decoder_layers

    def k4_timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig_k4(*a, **kw)
        ev[1].record()
        k4_ev.append(ev)
        return out

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = Dm.prefill_scanned(sp, prompt, cache, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first, cache = Dm.decode_step_scanned(
        sp, logits.argmax(-1).to(torch.int32), cache, cfg)
    tok = first.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Patched([(Dm, "fused_decoder_layers", k4_timed)]):
        toks, cache = Dm.decode_tokens_scanned(sp, tok, cache, cfg, n_new)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    stats = {"B": B, "prompt": prompt.shape[1], "new_tokens": n_new,
             "prefill_s": prefill_s, "wall_ms_per_step": 1e3 * wall / n_new,
             "k4_device_ms_per_step": (sum(a.elapsed_time(b)
                                           for a, b in k4_ev) / len(k4_ev)
                                       if k4_ev else None),
             "launches": launches}
    ok = (tuple(toks.shape) == (B, n_new)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and bool(torch.isfinite(first).all())
          and cache.length.tolist() == [prompt.shape[1] + 1 + n_new] * B)
    print("{}: B={} prompt {} + {} tokens: prefill {:.3f} s, decode {:.3f} "
          "ms/step wall, K4 {} ms/step device; launches {}".format(
              tag, B, prompt.shape[1], n_new, prefill_s,
              stats["wall_ms_per_step"],
              "-" if stats["k4_device_ms_per_step"] is None else "{:.3f}"
              .format(stats["k4_device_ms_per_step"]), launches),
          flush=True)
    if not ok:
        fail("{}: tokens {} not of shape ({}, {}) in the vocabulary, "
             "logits not finite or lengths {}".format(
                 tag, tuple(toks.shape), B, n_new, cache.length.tolist()))
    return stats, first.float()


def plane_paths(cfg):
    """Phase 4, this slice's paths.
      planes    a uniform INT3-g128 model at llama_7b() widths, 32 layers,
                random fused checkpoint-layout weights: prepare_params_host
                (sub4="planes") -> stack_layers -> prefill_scanned ->
                decode_tokens_scanned at B = 1 and 8 (K4 in plane mode, K7
                at the B = 1 prefill); then the same model under
                sub4="nibble" (K4 nibble mode); the first decode step's
                logits of the two agree on the decisive argmax;
      segments  layers of 4, 4, 3 and 3 bits at 7B widths (depth 4, cut
                for time): an s4r launch over layers 0-1 then a plane
                launch over layers 2-3 (li_cache 2), the f32 rows carried
                between them, against one homogeneous nibble launch over
                all four: within 2e-4, KV codes and scales equal."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.ops import layer_fused as LF

    out = {}
    dev = torch.device("cuda")
    params = build_plane_params(cfg, dev, lambda li, n: 3, SEED + 10,
                                names=FUSED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    prompts = {B: torch.randint(0, cfg.vocab_size, (B, 64), generator=gen,
                                device="cuda") for B in (1, 8)}
    first = {}
    for sub4 in ("planes", "nibble"):
        sp = Dm.stack_layers(Dm.prepare_params_host(params, sub4=sub4))
        w = sp["layers"]["wqkv"]
        if sub4 == "planes":
            width = w.packed["pl"].shape[-1]
            print("planes: wqkv stack {} bytes wide for {} padded columns "
                  "({} bits), containers {}".format(
                      width, w.n_padded, w.bits, sorted(w.packed)),
                  flush=True)
            if width * 8 != 3 * w.n_padded or set(w.packed) != {"pl"}:
                fail("planes: the wqkv stack is not the 3N/8-wide plane "
                     "concat")
        for B in (1, 8):
            tag = "{} B={}".format(sub4, B)
            out[tag], first[tag] = run_scanned(sp, cfg, prompts[B], 32, tag)
            want = ("K4", "K9") + (("K4p",) if sub4 == "planes" else ())
            want += ("K7",) if (sub4, B) == ("planes", 1) else ()
            _expect(tag, out[tag]["launches"], want,
                    () if sub4 == "planes" else ("K4p",))
        del sp
        torch.cuda.empty_cache()
    del params
    for B in (1, 8):
        err, ok = _logits_agree(first["planes B={}".format(B)],
                                first["nibble B={}".format(B)])
        out["planes B={}".format(B)]["first_step_vs_nibble_err"] = err
        print("planes vs nibble, first decode step B={}: max logit err "
              "{:.3e}, decisive argmax equal: {}".format(B, err, ok),
              flush=True)
        if not ok:
            fail("planes B={}: first decode step differs from the nibble "
                 "serving (err {:.3e})".format(B, err))

    depth, B, gs = 4, 8, 128
    cfg_s = dataclasses.replace(cfg, n_layers=depth)
    bits = (4, 4, 3, 3)
    layers = build_plane_params(cfg_s, dev, lambda li, n: bits[li],
                                SEED + 12, names=FUSED)["layers"]

    def stacks(lyrs, conv, key):
        ws = []
        for n in FUSED:
            lins = [conv(lyr[n]).with_sz_dtype(torch.bfloat16)
                    for lyr in lyrs]
            ws += [torch.stack([ln.packed[key] for ln in lins]),
                   torch.stack([ln.scales for ln in lins]),
                   torch.stack([ln.zeros for ln in lins])]
        return ws

    homog = stacks(layers, lambda ln: ln.with_nibble_serving(), "s4r")
    seg4 = stacks(layers[:2], lambda ln: ln.with_s4_rows(drop_fold=True),
                  "s4r")
    seg3 = stacks(layers[2:], lambda ln: ln.with_plane_serving(), "pl")
    an = torch.stack([lyr["attn_norm"] for lyr in layers])
    fn = torch.stack([lyr["ffn_norm"] for lyr in layers])
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x, pos, cos, sin, cache = _k4_case(
        cfg_s, B, [0, 17, 100, 255, 300, 411, 480, 511], g)
    seg_cache = [t.clone() for t in cache]
    _reset_launches()
    ref = LF.fused_decoder_layers(x, pos, cos, sin, *homog, an, fn, *cache,
                                  cfg_s, gs)[0]
    h = LF.fused_decoder_layers(x, pos, cos, sin, *seg4, an[:2], fn[:2],
                                *seg_cache, cfg_s, gs, wbits=4,
                                li_cache=0)[0]
    h = LF.fused_decoder_layers(h, pos, cos, sin, *seg3, an[2:], fn[2:],
                                *seg_cache, cfg_s, gs, wbits=3,
                                li_cache=2)[0]
    torch.cuda.synchronize()
    launches = _launches()
    err = (h - ref).abs().max().item()
    close = bool(torch.allclose(h, ref, rtol=2e-4, atol=2e-4))
    exact = all(torch.equal(a, b) for a, b in zip(seg_cache, cache))
    out["segments"] = {"depth": depth, "B": B, "bits": list(bits),
                       "max_abs_err": err, "codes_equal": exact,
                       "launches": launches}
    print("segments (4,4 | 3,3 bits, depth {}): two launches vs one "
          "homogeneous nibble launch: max err {:.3e} (rtol = atol = 2e-4: "
          "{}), KV codes and scales equal: {}; launches {}".format(
              depth, err, close, exact, launches), flush=True)
    if not close or not exact:
        fail("segments: err {:.3e}, codes equal {}".format(err, exact))
    _expect("segments", launches, ("K4", "K4p"))
    del layers, homog, seg4, seg3, cache, seg_cache
    torch.cuda.empty_cache()
    return out


def main(argv):
    ab_root = argv[argv.index("--ab") + 1] if "--ab" in argv else None
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
    start_traced_k4_build()
    _kernels.lib()
    _wrappers()  # the wrappers as imported, before any phase patches them
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
    if ab_root is not None:
        t0 = time.perf_counter()
        ab_timings(ab_root, results)
        print("K2/K3/K4 A/B against {} {:.1f} s".format(
            ab_root, time.perf_counter() - t0))
    small_model_check()
    t0 = time.perf_counter()
    paths = generate_paths(cfg)
    print("generate, mixed and chunk paths {:.1f} s".format(
        time.perf_counter() - t0))
    t0 = time.perf_counter()
    paths.update(serve_paths(params, cfg))
    print("main, unfused, paged and paged_cold paths {:.1f} s".format(
        time.perf_counter() - t0))
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.update(prefill_paths(cfg))
    print("prefill paths {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    paths.update(plane_paths(cfg))
    print("planes and segments paths {:.1f} s".format(
        time.perf_counter() - t0))
    t0 = time.perf_counter()
    paths.update(eval_path(cfg))
    print("eval path {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    paths.update(qlora_path(cfg))
    print("qlora path {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    paths.update(gptq_path(cfg))
    print("gptq path {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    paths.update(fixture_path())
    print("fixture path {:.1f} s".format(time.perf_counter() - t0))
    # launches of each kernel on the path that runs it: K5 and K8 on
    # generate (this slice's main path), K6 on the engine's decode_chunk
    # route, K7 on the mixed-precision model (its int8 form with impl
    # "a8"), K2/K3 on the unfused route, K1, K4 and K9 on the K4 engine,
    # K4's plane mode on the planes path, K10 on the 2048-token cold
    # prefill, K11 and K12 on QLoRA training (the dense backward's 4 steps)
    where = {"K2": "unfused", "K3": "unfused", "K5": "generate B=8 greedy",
             "K6": "chunk", "K7": "mixed impl=auto depth 4",
             "K8": "generate B=8 greedy", "K4p": "planes B=8",
             "K10": "prefill B=1 S=2048", "K11": "qlora dense",
             "K12": "qlora dense"}
    for r in results:
        r["path"] = where.get(r["kernel"], "main")
        if r["kernel"] == "K7" and "int8" in r["shape"]:
            r["path"] = "mixed impl=a8 depth 4"
        r["launches"] = paths[r["path"]]["launches"][r["kernel"]]
    print(json.dumps({"kernels": results, "paths": paths, "probes": probes,
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
    try:
        rc = main(sys.argv[1:])
    finally:
        if "proc" in _traced:  # a phase-trace build never waited for
            _traced["proc"].kill()
            _traced["proc"].wait()
    sys.exit(rc)
