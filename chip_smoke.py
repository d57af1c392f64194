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
                the K4 route (where the tokens agree); then with
                FORCE_FFN_KERNEL = False as well (the FFN blocks on the
                stacked linears, no K3): wall and device ms a step of
                both, each decision's logits within 0.1 of K3's run (with
                equal decisive argmax) while the tokens agree;
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
     longctx    the long-context int8-attention record
                (examples/llm/int8attn_longctx_torch.py --trained) cut to
                20 training steps at B=4 S=2047 (K10 f32 with the lse,
                K11/K12 f32), RTN int4-g64, a 1900-token prefill into one
                int8 cache and 32 teacher-forced steps from it and a clone
                on route A (decode_step: K5) and route B
                (decode_step_scanned at B=1: K4, its route checked): both
                NLLs, the greedy agreement, wall and kernels' device s of
                a training step, the prefill and each route;
     int4kv     DecodeEngine(kv_quantized="int4") on main's model and
                requests (decode_chunk: K1, K9, the plain attention over
                the dequantized layer; no K4, no K5): ms/step wall and
                device, cache bytes of the int4 / int8 / bf16 modes, the
                same requests over a bf16 cache (K5), tokens equal up to
                near ties, one step's int4 codes equal to the CPU's, and
                the int4 route at depth 2 on the card against the CPU;
     kpad       main's model with every W2 K-padded by with_k_pad(1024)
                (11008 -> 11264 rows) beside the unpadded one on K4:
                every decision's logits and every token equal, K4's
                device ms/step of both;
     tp         TPDecodeEngine(max_batch=8, max_len=512, chunk=8) at
                T=1 on a one-rank NCCL group, llama_7b() widths, 32 layers,
                generate's INT4-g128 checkpoint-layout weights (unfused),
                int8 KV: main's 8 requests x 32 tokens, then one extending
                a served prompt (a prefix hit); K1 per shard, K9, the
                plain attention. DecodeEngine on the same weights and
                requests is the yardstick: admission logits within 1e-3,
                tokens equal up to near ties; wall ms/step, K1's device
                ms a step and launches by shape, admission s;
     tp2        the same model and traffic on two ranks spawned on the one
                card over gloo (NCCL refuses two ranks on one device):
                tokens equal and gathered logits bit-equal across the
                ranks, rank 0's admission logits within 0.1 of tp's, K1 at
                the T=2 shard shapes; wall ms/step (through the host);
     pptrain    pipelined QLoRA (pp_qlora_train_step) on two gloo ranks on
                the card: pp 2, M 2, qlora's model at 8 layers, B=4 S=512,
                a warm-up and 3 steps: s a step (forward, backward,
                exchanges), K10-K12 launches a rank, peak memory; losses
                equal across ranks; loss and adapter gradients against
                the single rank's qlora_loss_fn; backbone bit-equal;
     tptrain    a tp=2 float step of tp_llama_loss (7B widths, 2 layers,
                B=2 S=512): loss and every leaf's gradient against one
                rank's llama_loss backward;
     sptrain    sp=2, all_gather and ring (B=1 S=2048): loss and
                gradients against one rank's;
     pptp       tp 2 x pp 2 on four gloo ranks: one pp_tp_qlora_loss Adam
                step over exact packed shards, the loss against one rank;
     dpqat      BatchNorm over a dp group at resnet18's shapes against the
                whole batch, then the resnet18 LSQ QAT CLI under
                torchrun's variables on two gloo ranks against one rank;
     offload    StreamingLlama over 32 INT4-g128 layers (checkpoint
                layout: K8) from pinned host memory on a copy stream,
                prefetch 2, prefill B=1 S=128 and 8 decode steps against
                the resident prefill / decode_step (logits within 0.1):
                ms/token, H2D GB/s streamed and on the copy stream beside
                a bare pinned 1 GB copy's, the share of copy time hidden
                under compute, peak memory above the resident part;
     quantcore  fake_quant forward and backward per tensor (2048 x 4096)
                and per channel (11008 x 4096) against the CPU (forward
                and gx equal, gs / gzp within the f32 sum bound), minmax
                / mse / percentile qparams per channel (the CPU on the
                first 2048 rows) and percentile per tensor over 45M
                elements, an LSQ step (scale gradients within the bound).
     graphptq   the PTQ basecase flow at full width: resnet18 (seeded card
                weights), 224x224x3 NHWC, batch 64, qconfig.yaml's scheme,
                QuantModel -> 16 calibration batches -> calc_qparams ->
                set_quant, 2048 seeded eval images: trace / capture /
                layerwise / observer seconds, float and fake-quant ms a
                batch and images/s, calibration peak memory, node counts;
                quantizers off equal to float (atol 1e-4), w8a8 rel MSE in
                (0, 5e-2), every quantizer's qparams against the CPU at
                batch 8 (cuDNN TF32 off);
     graphcalib asym calibration, the aciq / kl_histogram (per tensor and
                per channel) / mse activation observers (s a quantizer,
                held against the CPU on the same data; per-channel KL's
                error split by leaving each activation quantizer out)
                and AdaRound W4 on the first three convs at half the
                reference's 20000 steps (s a step, each layer's
                hard-rounded reconstruction loss held to its bound as a
                multiple of nearest rounding's), resnet18 at batch 16;
     cnnfixture the CNN accuracy fixture (run_cnn_fixture(): 300 steps,
                4096 / 2048 images), the three claims of
                tests/test_fixture_cnn.py held;
     deploy     graphptq's W8A8 resnet18 lowered to int8 compute
                (quantization/deploy.py) at B=64: int8 / fake-quant /
                float ms a batch; every Int8 node within 2e-5 of its
                fake-quant op on the same input; end-to-end error and
                top-1 agreement reported;
     export     QuantModel.export and DeployedModel.export (torch.export),
                each loaded back: seconds, bytes, output bit-equal;
     errprof    get_quantization_error on that resnet18 at B=16, async
                and sync: seconds, the five worst nodes, state kept;
     qat        the resnet18 QAT CLI's flow at 224x224, B=64, for each of
                the LSQ / LSQ+ / PACT / DoReFa yamls: calibrate, init_QAT,
                3 + 10 steps of make_qat_step (s a step split into
                forward / backward / optimiser, images/s, peak memory),
                a learnable moved, one small step equal to the CPU's;
     qatdeit    deit_small at 224x224, B=64, qconfig_lsq / _gelu_lsqplus:
                the figures of qat through the quantized attention path;
     bertptq    bert_base at S=128, B=32, the CoLA yaml (percentile):
                float and fake-quant ms a batch, W8A8 relative MSE;
     trfixture  the transformer fixtures at the JAX artifact's settings
                through record_fixture_torch.py, the claims of
                tests/test_fixture_transformer.py held, the records
                written to chiprun_out/ACCURACY_torch.json.
     prune      resnet18 B=64 structured pruning (the structured_imagenet1k
                sconfig), masks card vs CPU, 20 masked SGD steps, export;
     prunebert  bert_base S=128 B=32 unstructured 0.7; bert_qa S=384 B=16
                through the squad CLI's ratchet;
     zoo        graphptq's flow on mobilenet_v2, efficientnet_lite0 and
                regnetx_600mf;
     gpt2ptq    the wikitext PTQ CLI's flow on gpt2_small (12 layers, 768
                wide, vocab 50257) at 8 x 1024 tokens: float and int8
                perplexity, ms a batch, calc_qparams s, peak memory,
                quantizers off equal to float, qparams card vs CPU at
                depth 2;
     yolo       the detection PTQ CLI's flow (MSE, FUSE_BN) on yolov3
                (Darknet-53) at 416 x 416 B=8 with random BatchNorm
                statistics: map shapes, ms, the per-layer error, the
                maps' spread; yolov4, yolov5s, yolov3_tiny at the same
                size; qparams card vs CPU on yolov3_darknet21;
     bevdet     the BEVDet QAT CLI's flow (qconfig_lsq_4w4f.yaml) on
                bevdet_lite at its default, B=8: the view transform
                against a float64 per-point oracle and bit-equal twice,
                calibration, init_QAT, 4 Adam steps with the loss
                falling, one step card vs CPU;
     importtorch  torchvision resnet18 and HF GPT-2 (gpt2_small) layouts
                through the importers, bit-equal to the models filled
                directly;
     profiling  utils/profiling.py's wall_timer and trace around
                gpt2_small forwards: the trace names CUDA kernels.
The gptq path also holds the LLM quantizer's scale arithmetic on the card
bit-equal to the CPU's (gptq_scale_arithmetic).
The graph regime has no Pallas kernel in the JAX package and launches no
kernel of the port (its counts are read and must stay 0).
It prints one JSON line of per-kernel and per-path numbers, the card's
name and power limit, and last {"ok": true, "device": {...}}. It exits
non-zero without CUDA or without the repository beside it.
"""

import dataclasses
import json
import math
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
            bnd = bound_ms(_k1_bytes(M, K, N, gs), 2 * M * K * N, "int8")
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
# (B, S, H, Hkv, hd) of the long-context record's training attention
# (examples/llm/int8attn_longctx_torch.py --trained; path longctx): f32
LONGCTX_ATTN = (4, 2047, 4, 4, 128)


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
    the plain version's), and the long-context record's training shape
    (LONGCTX_ATTN: f32, B=4 S=2047 H=4 hd 128) with the lse. Tolerance:
    each element within its own bound (flash_tolerance); a second launch
    gives the same bits; on the first
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
             ("bf16", 4, 512, H0, H0, hd0), ("bf16 lse", 4, 512, H0, H0, hd0),
             ("f32 lse",) + LONGCTX_ATTN]
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
    S=1024, ragged S = 2047 and 100, f32 at S=512, Hkv=8 at S=2048, and
    the long-context record's training shape (LONGCTX_ATTN, f32).
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
             ("f32", 1, 512, H0, H0, hd0), ("bf16", 1, 2048, H0, 8, hd0),
             ("f32",) + LONGCTX_ATTN]
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
        chunk_s.append((time.perf_counter() - t, a[-1]))
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
    twin = cache.clone()
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
               then again with FORCE_FFN_KERNEL = False (K1/K2, no K3),
               each decision's logits within 0.1 of K3's run;
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

    # the unfused route twice: its FFN blocks on K3, then on the stacked
    # linears (FORCE_FFN_KERNEL = False); each decision's logits compared
    # while the two runs' tokens agree
    runs = {}
    Dm.FORCE_LAYER_KERNEL = False
    try:
        for force in (True, False):
            Dm.FORCE_FFN_KERNEL = force
            timer = KernelEvents()
            eng = ScannedEngine(params_u, cfg_u, **kw)
            rows = {}
            with timer.patch, _record_decisions(eng, rows):
                toks, st = drive(
                    eng, _prompts(cfg), "decode_chunk_scanned",
                    "unfused (decode_chunk_scanned, FORCE_LAYER_KERNEL="
                    "False, FORCE_FFN_KERNEL={}, depth {})".format(
                        force, depth),
                    ("K1", "K2", "K3", "K9") if force else ("K1", "K2", "K9"),
                    n_new=8, timer=timer)
            runs[force] = (toks, st, [rows[r] for r in sorted(rows)])
            del eng
    finally:
        Dm.FORCE_LAYER_KERNEL = None
        Dm.FORCE_FFN_KERNEL = None
    toks, st, rows_k3 = runs[True]
    toks_pl, st_pl, rows_pl = runs[False]
    _expect("unfused FORCE_FFN_KERNEL=False", st_pl["launches"], (), ("K3",))
    ffn_errs, ffn_ok = [], True
    for ra, rb, ta, tb in zip(rows_k3, rows_pl, toks, toks_pl):
        m = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 len(ta) - 1)
        err, good = _logits_agree(torch.stack(ra[:m + 1]).float(),
                                  torch.stack(rb[:m + 1]).float())
        ffn_errs.append(err)
        ffn_ok = ffn_ok and good
    print("unfused FORCE_FFN_KERNEL True / False: {:.3f} / {:.3f} ms/step "
          "wall, {:.3f} / {:.3f} ms/step the kernels' device; logits while "
          "the tokens agree within {:.3e} (atol 0.1), tokens equal in {} of "
          "{} requests".format(
              st["decode_ms_per_step"], st_pl["decode_ms_per_step"],
              st["kernel_device_ms_per_step"],
              st_pl["kernel_device_ms_per_step"], max(ffn_errs),
              sum(a == b for a, b in zip(toks, toks_pl)), len(toks)),
          flush=True)
    if not ffn_ok:
        fail("unfused: FORCE_FFN_KERNEL=False logits differ from K3's "
             "(err {:.3e})".format(max(ffn_errs)))
    out["unfused_ffn_plain"] = dict(
        st_pl, logits_err_vs_k3=max(ffn_errs),
        tokens_equal_k3=[a == b for a, b in zip(toks, toks_pl)])
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
    """Every tensor of a params tree once, linears' fields included."""
    from sparsebit_tpu_torch.llm.convert import tree_tensors

    return tree_tensors(tree)


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
    out["scale_arithmetic"] = gptq_scale_arithmetic(cfg)
    return {"gptq": out}


def gptq_scale_arithmetic(cfg):
    """The LLM quantizer's scale arithmetic on the card against the CPU,
    bit for bit (ROADMAP numerics contracts): ``(wmax - wmin) / qmax`` is
    an exact division on both (``div_exact``; a division by a plain
    number is a multiply by its reciprocal on the card); at a 7B wo's
    width (4096 x 4096, g128) at 2/3/4/8 bits, and the GPTQ solver itself
    with U = I (no error propagates) on its first 512 rows at 4 bits."""
    import torch
    from sparsebit_tpu_torch.llm import gptq as G
    from sparsebit_tpu_torch.llm.quant import LLMQuantizer

    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    w = torch.randn((cfg.dim, cfg.dim), generator=g, device="cuda") * 0.02
    wg = w.reshape(cfg.dim // 128, 128, cfg.dim)
    differ = {}
    for bits in (2, 3, 4, 8):
        q = LLMQuantizer(bits=bits)
        s_card, z_card = q.find_params(wg)
        s_cpu, z_cpu = q.find_params(wg.cpu())
        differ["{}bit".format(bits)] = (int((s_card.cpu() != s_cpu).sum())
                                        + int((z_card.cpu() != z_cpu).sum()))
    K = 512
    eye = torch.eye(K, device="cuda")
    dead = torch.zeros(K, dtype=torch.bool, device="cuda")
    card = G._gptq_core(w[:K].clone(), eye, dead, 4, 128, 128, False)
    cpu = G._gptq_core(w[:K].cpu().clone(), eye.cpu(), dead.cpu(), 4, 128,
                       128, False)
    differ["solver U=I codes"] = int((card[0].cpu() != cpu[0]).sum())
    differ["solver U=I scales"] = int((card[1].cpu() != cpu[1]).sum())
    print("gptq: scale arithmetic, card vs CPU, elements that differ: "
          "{}".format(differ), flush=True)
    if any(differ.values()):
        fail("gptq: the quantizer's scales or codes differ between the "
             "card and the CPU: {}".format(differ))
    return differ


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


LONGCTX_STEPS = 20  # training steps of the record's 250
LONGCTX_CTX = 1900  # the record's prefill
LONGCTX_DECODE = 32  # teacher-forced steps of the record's 128
# route A on the kernels vs the plain versions, max |logit diff|: well under
# the gap between the two routes (0.033 on the card, 1.1e-2 on the CPU)
LONGCTX_A_ATOL = 1e-3


def longctx_step_checks(sparams, stacked, cache, cfg, tok):
    """From the record's prefilled cache, one step of each route held
    against its plain version on the card at the record's shape (dim 512,
    F 384, gs 64, H = Hkv = 4, hd 128, a 2048-row int8 cache):
      A  decode_step on the kernels (K5, K8) against every wrapper routed
         to its plain version (plain_versions): logits within
         LONGCTX_A_ATOL, equal argmax where the top-2 margin exceeds twice
         it;
      B  decode_step_scanned's K4 launch against LF._fused_layers_plain on
         the same inputs: output, KV codes and scales equal (tolerance 0,
         as in k4_checks).
    Each side runs on its own clone of ``cache``. Returns (A's error, B's
    error, B's cache equal)."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.ops import layer_fused as LF

    got, _ = Dm.decode_step(sparams, tok, cache.clone(), cfg)
    with plain_versions():
        ref, _ = Dm.decode_step(sparams, tok, cache.clone(), cfg)
    a_err, a_ok = _logits_agree(got.float(), ref.float(), LONGCTX_A_ATOL)

    real, held = Dm.fused_decoder_layers, {}

    def k4_and_plain(*a, **kw):
        x, pos, cos, sin = a[:4]
        ws = tuple(tuple(a[4 + 3 * i:7 + 3 * i]) for i in range(4))
        norms, kv, gs = a[16:18], a[18:22], a[23]
        li = kw.get("li_cache", 0)
        kv = [t[li:li + norms[0].shape[0]] for t in kv]
        plain = [t.clone() for t in kv]
        out = real(*a, **kw)
        bt = kw.get("bt")
        if bt is None:
            bt = torch.arange(x.shape[0], dtype=torch.int32,
                              device=x.device)[:, None]
        s_act = bt.shape[1] * kv[0].shape[2]
        if kw.get("s_active") is not None:
            s_act = min(int(kw["s_active"]), s_act)
        ref = LF._fused_layers_plain(
            x, pos, cos.float().contiguous(), sin.float().contiguous(), ws,
            *norms, *plain, bt, s_act, gs, cfg.rms_eps, cfg.n_heads,
            cfg.n_kv_heads, kw.get("wbits", 4), cfg.ffn_dim)
        held.update(err=(out[0] - ref).abs().max().item(),
                    exact=all(torch.equal(p, q) for p, q in zip(kv, plain)),
                    finite=bool(torch.isfinite(out[0]).all().item()))
        return out

    with _Patched([(Dm, "fused_decoder_layers", k4_and_plain)]):
        Dm.decode_step_scanned(stacked, tok, cache.clone(), cfg)
    torch.cuda.synchronize()
    print("longctx: one step from the prefilled cache against the plain "
          "versions on the card: route A max logit err {:.3e} (atol {}), "
          "{}; route B's K4 output err {:.3e} (tol 0), cache codes/scales "
          "{}".format(a_err, LONGCTX_A_ATOL, "ok" if a_ok else "BAD",
                      held.get("err", float("nan")),
                      "exact" if held.get("exact") else "DIFFER"),
          flush=True)
    if not a_ok:
        fail("longctx: route A's decode_step logits differ from the plain "
             "versions' (err {:.3e})".format(a_err))
    if not held:
        fail("longctx: route B did not reach K4")
    elif not (held["err"] == 0.0 and held["exact"] and held["finite"]):
        fail("longctx: K4 differs from its plain version at the record's "
             "shape (output err {:.3e}, cache {})".format(
                 held["err"], "exact" if held["exact"] else "DIFFER"))
    return a_err, held.get("err"), held.get("exact")


def longctx_path():
    """Phase 4, path longctx: the long-context int8-attention record
    (examples/llm/int8attn_longctx_torch.py --trained) at a cut depth.
    exp36's f32 model (dim 512, 4 heads of 128, ffn 384, 2 fused layers,
    vocab 256) from seeded weights trains LONGCTX_STEPS Adam steps at B=4
    S=2047 on the 1M-token Markov stream (K10 f32 with its lse output,
    K11/K12 f32: 2 launches each a step), is quantized RTN int4-g64, and
    prefills LONGCTX_CTX tokens of the held-out walk into one int8 cache;
    from that cache and a clone, LONGCTX_DECODE teacher-forced steps on
    route A (decode_step: K5, f32 attention over the int8 codes) and on
    route B (decode_step_scanned at B=1: K4, its predicate checked). It
    prints both NLLs, the greedy agreement and the wall and kernels'
    device s of a training step, the prefill and each route; the losses
    finite and falling, the NLLs finite, K4 launched once a route-B step.
    After the counts are read, longctx_step_checks holds one step of each
    route from a third clone of the cache against the plain versions."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm import fixture as F
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache

    dev = torch.device("cuda")
    cfg = F.longctx_config()
    t0 = time.perf_counter()
    stream = F.markov_stream(1_000_000, cfg.vocab_size)
    ev = torch.from_numpy(F.markov_stream(
        LONGCTX_CTX + LONGCTX_DECODE + 2, cfg.vocab_size,
        walk_seed=4321)).to(dev)
    stream_s = time.perf_counter() - t0
    params = F.init_longctx_params(cfg, SEED, device=dev)
    timer = KernelEvents()
    ends = []

    def on_step(i, loss):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        timer.on = True
        out = fn()
        timer.on = False
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        dev_ms, by = timer.take_ms()
        return out, wall, dev_ms, by

    _reset_launches()
    with timer.patch:
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        losses, train_s, train_ms, train_by = timed(
            lambda: F.train_on_stream(params, cfg, stream,
                                      steps=LONGCTX_STEPS, on_step=on_step))
        step_s = [b - a for a, b in zip(ends, ends[1:])]
        sparams, stacked = F.quantize_rtn_serving(params, bits=4,
                                                  groupsize=64)
        k4_route = Dm._scan_uses_layer_kernel(1, stacked["layers"], "int8",
                                              cfg, 1)
        cache = init_kv_cache(cfg, 1, cfg.max_seq_len, True, device=dev)
        (_, cache), pre_s, pre_ms, pre_by = timed(lambda: Dm.prefill(
            sparams, ev[None, :LONGCTX_CTX], cache, cfg))
        twin, spare = cache.clone(), cache.clone()
        feed = ev[LONGCTX_CTX:LONGCTX_CTX + LONGCTX_DECODE]
        k4_before = _launches()["K4"]
        la, a_s, a_ms, a_by = timed(lambda: F.decode_fed(
            Dm.decode_step, sparams, cache, cfg, feed))
        lb, b_s, b_ms, b_by = timed(lambda: F.decode_fed(
            Dm.decode_step_scanned, stacked, twin, cfg, feed))
    launches = _launches()
    k4_b = launches["K4"] - k4_before
    a_err, k4_err, k4_exact = longctx_step_checks(sparams, stacked, spare,
                                                  cfg, feed[:1])
    summ = F.route_summary(la, lb, ev[LONGCTX_CTX + 1:
                                      LONGCTX_CTX + 1 + LONGCTX_DECODE])
    n = LONGCTX_DECODE
    st = {"train_steps": LONGCTX_STEPS, "train_loss_first": losses[0],
          "train_loss_last": losses[-1], "stream_s": stream_s,
          "train_wall_s": train_s,
          "train_step_wall_s": {"first": step_s[0],
                                "median_rest": sorted(step_s[1:])[
                                    len(step_s[1:]) // 2]},
          "train_kernel_device_s_per_step": train_ms / 1e3 / LONGCTX_STEPS,
          "train_device_ms_per_step_by_entry": {
              k: v / LONGCTX_STEPS for k, v in train_by.items()},
          "prefill_wall_s": pre_s, "prefill_kernel_device_s": pre_ms / 1e3,
          "route_a_wall_s_per_step": a_s / n,
          "route_a_kernel_device_s_per_step": a_ms / 1e3 / n,
          "route_b_wall_s_per_step": b_s / n,
          "route_b_kernel_device_s_per_step": b_ms / 1e3 / n,
          "route_b": "K4" if k4_route and k4_b == n else "not K4",
          "k4_launches_route_b": k4_b, "launches": launches,
          "route_a_vs_plain_max_err": a_err, "k4_vs_plain_max_err": k4_err,
          "k4_vs_plain_cache_exact": k4_exact}
    st.update(summ)
    print("longctx: {} training steps at B=4 S=2047 (f32, hd 128): loss "
          "{:.4f} -> {:.4f}, a step {:.4f} s wall (first {:.4f}), kernels' "
          "device {:.4f} s a step ({}); prefill {} tokens {:.4f} s wall, "
          "kernels {:.4f} s; {} teacher-forced steps: route A (decode_step, "
          "K5) NLL {:.5f} ppl {:.4f}, {:.5f} s a step wall, kernels {:.5f} "
          "s; route B (decode_step_scanned, {}) NLL {:.5f} ppl {:.4f}, "
          "{:.5f} s a step wall, kernels {:.5f} s; int8 / f32 ppl - 1 = "
          "{:+.4%}, greedy agree {}; launches {}; streams made in {:.1f} s"
          .format(LONGCTX_STEPS, losses[0], losses[-1],
                  st["train_step_wall_s"]["median_rest"], step_s[0],
                  st["train_kernel_device_s_per_step"],
                  {k: round(v, 4) for k, v in
                   st["train_device_ms_per_step_by_entry"].items()},
                  LONGCTX_CTX, pre_s, pre_ms / 1e3, n, summ["nll_f32"],
                  summ["ppl_f32"], a_s / n, a_ms / 1e3 / n, st["route_b"],
                  summ["nll_int8"], summ["ppl_int8"], b_s / n,
                  b_ms / 1e3 / n, summ["rel_ppl_increase"],
                  summ["greedy_agree"], launches, stream_s), flush=True)
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail("longctx: training losses {:.4f} -> {:.4f}".format(
            losses[0], losses[-1]))
    if st["route_b"] != "K4":
        fail("longctx: route B is not K4 (predicate {}, {} K4 launches in "
             "{} steps)".format(k4_route, k4_b, n))
    if not (math.isfinite(summ["nll_f32"]) and math.isfinite(
            summ["nll_int8"]) and la.shape == lb.shape == (
                n, cfg.vocab_size)):
        fail("longctx: route logits {} / {}, NLL {} / {}".format(
            tuple(la.shape), tuple(lb.shape), summ["nll_f32"],
            summ["nll_int8"]))
    _expect("longctx", launches, ("K4", "K5", "K10", "K11", "K12"))
    want = {k: 2 * LONGCTX_STEPS for k in ("K10", "K11", "K12")}
    if {k: launches[k] for k in want} != want:
        fail("longctx: K10/K11/K12 launches {} (want {} each: 2 layers a "
             "step)".format({k: launches[k] for k in want},
                            2 * LONGCTX_STEPS))
    del params, sparams, stacked, cache, twin, spare
    torch.cuda.empty_cache()
    return {"longctx": st}


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


def _record_decisions(eng, rows):
    """Patch ``eng`` and the engines' sampling so that ``rows`` maps each
    request id to the logits rows of its decisions, in order (the
    admission's, then one a decode step); a _Patched context."""
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm import serving as Sv

    order = []
    orig = Dm.sample_logits_vec
    orig_admit, orig_chunk = eng._admit_group, eng._decode_chunk

    def sample(logits, temps, generator=None):
        for rid, row in zip(order, logits):
            if rid is not None:
                rows.setdefault(rid, []).append(row.detach().clone())
        return orig(logits, temps, generator)

    def admit(admits, *a):
        order[:] = [req.rid for _, req, _ in admits]
        return orig_admit(admits, *a)

    def chunk(temps, n):
        order[:] = [s.rid if s is not None else None for s in eng.slots]
        return orig_chunk(temps, n)

    return _Patched([(Dm, "sample_logits_vec", sample),
                     (Sv, "sample_logits_vec", sample),
                     (eng, "_admit_group", admit),
                     (eng, "_decode_chunk", chunk)])


def _cache_bytes(cfg, B, S, mode):
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache

    c = init_kv_cache(cfg, B, S, mode, device="meta")
    return sum(t.numel() * t.element_size()
               for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None)


def _int4_card_vs_cpu(params, cfg, depth=2):
    """The int4 route on the card against the port on the CPU, at main's
    widths and ``depth`` layers in the engine's serving layout: prefill of
    8 x 32 tokens into an int4 cache, then two decode steps fed the
    card's greedy tokens; logits within 0.1 with decisive argmax equal
    (_logits_agree), and the share of equal int4 codes in the caches
    (bf16 activations may round a code differently)."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm import llama as L
    from sparsebit_tpu_torch.llm import serving as Sv
    from sparsebit_tpu_torch.llm.convert import map_params
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
    from sparsebit_tpu_torch.llm.quant import QuantLinear

    cfg2 = dataclasses.replace(cfg, n_layers=depth)
    p2 = L.quantize_llama_params(
        dict(params, layers=params["layers"][:depth]),
        lambda p, lin: (Sv._serving_layout(lin)
                        if isinstance(lin, QuantLinear) else lin), skip=())
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    prompt = torch.randint(0, cfg.vocab_size, (8, 32), generator=g,
                           device="cuda")
    runs, toks = {}, []
    for dev, p in (("cuda", p2), ("cpu", map_params(lambda t: t.cpu(), p2))):
        cache = init_kv_cache(cfg2, 8, 40, "int4", device=dev)
        logits, cache = Dm.prefill(p, prompt.to(dev), cache, cfg2)
        out = [logits.float().cpu()]
        for i in range(2):
            if dev == "cuda":
                toks.append(logits.argmax(-1).to(torch.int32))
            logits, cache = Dm.decode_step(p, toks[i].to(dev), cache, cfg2)
            out.append(logits.float().cpu())
        runs[dev] = (out, cache.k.cpu(), cache.v.cpu())
    errs, ok = [], True
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        err, good = _logits_agree(a, b)
        errs.append(err)
        ok &= good
    same = float(sum((runs["cuda"][i] == runs["cpu"][i]).sum()
                     for i in (1, 2)) / (2 * runs["cpu"][1].numel()))
    print("int4kv: depth {} on the card vs the CPU: prefill and two decode "
          "steps, logits max err {} (atol 0.1, decisive argmax equal: {}), "
          "int4 code bytes equal {:.4%}".format(
              depth, ["{:.4f}".format(e) for e in errs], ok, same),
          flush=True)
    if not ok:
        fail("int4kv: the card's int4 route differs from the CPU's (errs "
             "{})".format(errs))
    return dict(depth=depth, max_abs_err=errs, logits_agree=ok,
                code_bytes_equal=same)


def int4kv_path(params, cfg):
    """Phase 4, path int4kv: DecodeEngine(kv_quantized="int4") at 7B
    widths, 32 layers, B=8, max_len 512, main's 8 prompts x 32 greedy
    tokens. K4 reads an int8 cache only, so the engine decodes on
    decode_chunk: the linears on K1 (a8), the head on K9, the attention the
    plain masked attention over the dequantized layer (no K5). Prints
    ms/step wall and device, the launches, and the cache bytes of the int4,
    int8 and bf16 modes. The same requests on the bf16-cache route
    (kv_quantized=False, decode_chunk with K5): the admission logits'
    error printed, greedy tokens equal up to each request's first
    difference, where the bf16 route's margin between the two tokens must
    be a near tie: at most twice the admission's logit error (the rule of
    tests/test_torch_engine.py). One step's int4 codes and scales on the
    card bit-equal to _quant_heads on the CPU, and the int4 route at depth
    2 on the card against the CPU (_int4_card_vs_cpu)."""
    import torch
    from sparsebit_tpu_torch.llm import kv_cache as Kc
    from sparsebit_tpu_torch.llm import serving as Sv

    kw = dict(max_batch=8, max_len=512, chunk=8, device="cuda")
    prompts = _prompts(cfg)
    seen = []
    orig_q = Kc._quant_heads

    def quant_seen(x, mode="int8"):
        out = orig_q(x, mode)
        if mode == "int4" and x.shape[1] == 1 and not seen:
            seen.append((x.detach().cpu(), out[0].cpu(), out[1].cpu()))
        return out

    runs = {}
    for mode in ("int4", False):
        eng = Sv.DecodeEngine(params, cfg, kv_quantized=mode, **kw)
        if eng._stacked_chunks:
            fail("int4kv: the {} cache engine is on K4".format(mode))
        rows = {}
        timer = KernelEvents()
        tag = "int4kv ({} cache, decode_chunk)".format(
            "int4" if mode else "bf16")
        with timer.patch, _record_decisions(eng, rows), _Patched(
                [(Kc, "_quant_heads", quant_seen)]):
            toks, st = drive(eng, prompts, "decode_chunk", tag,
                             ("K1", "K9") + (() if mode else ("K5",)),
                             timer=timer)
        runs[mode] = (toks, st, [rows[rid] for rid in sorted(rows)])
        del eng
        torch.cuda.empty_cache()
    toks4, st, rows4 = runs["int4"]
    toksb, stb, rowsb = runs[False]
    _expect("int4kv", st["launches"], ("K1", "K9"), ("K4", "K5"))
    B = kw["max_batch"]
    # each request's first decision: the admission's logits row
    adm4 = torch.stack([r[0] for r in rows4]).float()
    admb = torch.stack([r[0] for r in rowsb]).float()
    err0 = float((adm4 - admb).abs().max())
    scale = float(admb.abs().max())
    # near tie: twice the admission's logit error (measured before any
    # decode step), as test_torch_engine.py's NEAR_TIE is twice the
    # route's known logit error
    near = 2 * err0
    firsts, margins = [], []
    for r, (a, b) in enumerate(zip(toks4, toksb)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        firsts.append(i)
        if i < len(a):
            row = rowsb[r][i].float()
            margins.append(float(row[b[i]] - row[a[i]]))
    ties_ok = all(m <= near for m in margins)
    q = {}
    if seen:
        x, codes, scales = seen[0]
        rc, rs = orig_q(x, "int4")
        q = dict(codes_equal=bool(torch.equal(codes, rc)),
                 scales_equal=bool(torch.equal(scales, rs)),
                 rows=int(x.shape[0] * x.shape[2]))
    st.update(bf16_route=dict(decode_ms_per_step=stb["decode_ms_per_step"],
                              kernel_device_ms_per_step=stb[
                                  "kernel_device_ms_per_step"],
                              launches=stb["launches"]),
              cache_bytes={m: _cache_bytes(cfg, B, kw["max_len"], m)
                           for m in ("int4", "int8", False)},
              admission_max_abs_err_vs_bf16=err0,
              admission_max_abs_logit=scale,
              near_tie=near,
              first_differences_near_ties=ties_ok,
              tokens_equal_bf16_route=[a == b for a, b in zip(toks4, toksb)],
              leading_tokens_equal=firsts,
              bf16_margin_at_first_difference=margins, step_quant=q)
    cb = st["cache_bytes"]
    print("int4kv: {:.3f} ms/step wall, kernels {:.3f} ms/step device "
          "(bf16 route {:.3f} / {:.3f}); cache bytes int4 {} int8 {} bf16 "
          "{}; admission logits max |int4 - bf16| {:.4f} of max |logit| "
          "{:.4f}; tokens equal in {} of {} "
          "requests, leading equal {}, bf16 margins at the first "
          "difference {} (near tie <= {:.4f}: {}); one step's int4 "
          "codes/scales vs the CPU {}".format(
              st["decode_ms_per_step"], st["kernel_device_ms_per_step"],
              stb["decode_ms_per_step"], stb["kernel_device_ms_per_step"],
              cb["int4"], cb["int8"], cb[False], err0, scale,
              sum(st["tokens_equal_bf16_route"]), len(toks4), firsts,
              ["{:.4f}".format(m) for m in margins], near, ties_ok, q),
          flush=True)
    if not ties_ok:
        fail("int4kv: against the bf16 route, first-difference margins {} "
             "past twice the admission's error {:.4f}".format(margins, err0))
    st["card_vs_cpu"] = _int4_card_vs_cpu(params, cfg)
    if not (q.get("codes_equal") and q.get("scales_equal")):
        fail("int4kv: the card's int4 codes/scales differ from the CPU's "
             "({})".format(q))
    return {"int4kv": st}


TP_KW = dict(max_batch=8, max_len=512, chunk=8)
TP_EXT = 24  # tokens the extension request adds to a served prompt
TP_ADMISSION_ATOL = 1e-3  # tp against DecodeEngine: one K1 on equal codes
TP2_ATOL = 0.1  # tp2 against tp: bf16 partial sums added in another order
# K1's (K -> N) at 7B, T=2: wq/wk/wv, wo, w1/w3 (5504 columns, packed to
# the 4-bit width multiple 5632 as the reference's from_codes pads), w2
TP2_SHAPES = ("4096->2048", "2048->4096", "4096->5632", "5504->4096")


def _tp_requests(cfg):
    """main's 8 prompts and one that extends the first by TP_EXT tokens."""
    import torch

    prompts = _prompts(cfg)
    gen = torch.Generator().manual_seed(SEED + 19)
    ext = prompts[0] + torch.randint(0, cfg.vocab_size, (TP_EXT,),
                                     generator=gen).tolist()
    return prompts, ext


def _tp_serve(eng, tag, chunk_fn_name, expect):
    """The tp paths' traffic on ``eng`` through drive(): 8 requests x 32
    greedy tokens, then the extension request (8 tokens), which must hit
    the prefix cache. Returns (tokens, the extension's tokens, each
    request's decision logits (n, V) in request order, stats)."""
    import torch

    prompts, ext = _tp_requests(eng.cfg)
    rows = {}
    timer = KernelEvents()
    with timer.patch, _record_decisions(eng, rows):
        toks, st = drive(eng, prompts, chunk_fn_name, tag, expect,
                         timer=timer)
        ext_toks, _ = drive(eng, [ext], chunk_fn_name, tag + ", extension",
                            (), n_new=8)
    st["prefix_hits"] = eng.prefix_hits
    st["k1_device_ms_per_step"] = st["entry_device_ms_per_step"].get(
        "sbt_qmm_s4", 0.0)
    print("{}: K1 {:.4f} ms/step device of the kernels' {:.3f}, wall {:.3f} "
          "ms/step, admission {:.4f} s; prefix hits {}".format(
              tag, st["k1_device_ms_per_step"],
              st["kernel_device_ms_per_step"], st["decode_ms_per_step"],
              st["admission_s"], eng.prefix_hits), flush=True)
    if eng.prefix_hits != 1:
        fail("{}: {} prefix hits for the extension request, want 1".format(
            tag, eng.prefix_hits))
    return (toks, ext_toks[0],
            [torch.stack(rows[r]).float() for r in sorted(rows)], st)


def tp_path(cfg):
    """Phase 4, path tp: TPDecodeEngine at T=1 on a one-rank NCCL group,
    llama_7b() widths, 32 layers, generate's checkpoint-layout INT4-g128
    weights (unfused, build_plane_params) and an int8 KV cache,
    max_batch 8, max_len 512, chunk 8: main's 8 requests x 32 greedy
    tokens, then a request that extends the first prompt (a prefix hit).
    Each linear is K1 on its (whole) shard, the head K9, the attention the
    reference's plain masked attention over the dequantized layer. The
    yardstick is DecodeEngine on the same weights and requests (the
    decode_chunk route: K1, K5, K9). Held: the admission logits within
    TP_ADMISSION_ATOL (both admit through prefill_at's attention and K1 on
    equal codes); greedy tokens equal up to each request's first
    difference, where the yardstick's margin between the two tokens must
    be a near tie: at most twice the routes' logit error (the larger of
    the admission's and the first decode step's, where the first token
    agrees), the rule of the int4kv path. Records wall ms/step, K1's
    device ms per step and launches by shape, admission s. Returns (paths
    entry, the admission logits on the CPU for tp2)."""
    import torch
    import torch.distributed as dist
    from sparsebit_tpu_torch.llm import serving as Sv
    from sparsebit_tpu_torch.parallel.mesh import make_mesh
    from sparsebit_tpu_torch.parallel.multihost import (
        free_port, initialize_multihost)

    params = build_plane_params(cfg, torch.device("cuda"), lambda li, n: 4,
                                SEED + 6)
    initialize_multihost("localhost:{}".format(free_port()), 1, 0,
                         device="cuda")
    try:
        backend = dist.get_backend()
        t0 = time.perf_counter()
        mesh = make_mesh(dp=1, tp=1, device_type="cuda")
        eng = Sv.TPDecodeEngine(params, cfg, mesh, device="cuda", **TP_KW)
        shard_s = time.perf_counter() - t0
        toks, ext, rows, st = _tp_serve(
            eng, "tp (TPDecodeEngine, T=1, {})".format(backend),
            "tp_decode_chunk", ("K1", "K9"))
        del eng
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    eng = Sv.DecodeEngine(params, cfg, device="cuda", **TP_KW)
    ytoks, yext, yrows, yst = _tp_serve(
        eng, "tp yardstick (DecodeEngine, decode_chunk)", "decode_chunk",
        ("K1", "K5", "K9"))
    del eng, params
    torch.cuda.empty_cache()
    st["k1_step_replay"] = k1_step_replay(cfg, 1)
    _expect("tp", st["launches"], ("K1", "K9"), ("K4", "K5", "K6"))
    if backend != "nccl":
        fail("tp: the one-rank group runs {}, want nccl".format(backend))
    adm = torch.stack([r[0] for r in rows])
    yadm = torch.stack([r[0] for r in yrows])
    err0, ok0 = _logits_agree(adm, yadm, atol=TP_ADMISSION_ATOL)
    toks, ytoks = toks + [ext], ytoks + [yext]
    err1 = max([float((a[1] - b[1]).abs().max()) for a, b, t, y in zip(
        rows, yrows, toks, ytoks) if t[0] == y[0]] or [0.0])
    near = 2 * max(err0, err1)
    firsts, margins = [], []
    for i, (a, b) in enumerate(zip(toks, ytoks)):
        k = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        firsts.append(k)
        if k < len(a):
            margins.append(float(yrows[i][k][b[k]] - yrows[i][k][a[k]]))
    ties_ok = all(m <= near for m in margins)
    st.update(shard_s=shard_s, backend=backend,
              admission_max_abs_err_vs_engine=err0,
              admission_bit_equal=bool(torch.equal(adm, yadm)),
              first_step_max_abs_err_vs_engine=err1, near_tie=near,
              leading_tokens_equal=firsts,
              engine_margin_at_first_difference=margins,
              first_differences_near_ties=ties_ok,
              yardstick=dict(decode_ms_per_step=yst["decode_ms_per_step"],
                             kernel_device_ms_per_step=yst[
                                 "kernel_device_ms_per_step"],
                             admission_s=yst["admission_s"],
                             launches=yst["launches"]))
    print("tp: shards built in {:.2f} s; admission logits vs DecodeEngine "
          "max err {:.3e} (atol {}; bit-equal {}), first decode step {:.3e}; "
          "tokens equal in {} of {} requests, leading equal {}, margins at "
          "the first difference {} (near tie <= {:.4f}: {}); wall {:.3f} "
          "ms/step (DecodeEngine {:.3f}); K1 {:.4f} ms/step between events "
          "in the engine, {} by graph replay of the step's launches".format(
              shard_s, err0, TP_ADMISSION_ATOL, st["admission_bit_equal"],
              err1, sum(a == b for a, b in zip(toks, ytoks)), len(toks),
              firsts, ["{:.4f}".format(m) for m in margins], near, ties_ok,
              st["decode_ms_per_step"], yst["decode_ms_per_step"],
              st["k1_device_ms_per_step"],
              st["k1_step_replay"]["graph_ms_a_step"]), flush=True)
    if not ok0:
        fail("tp: admission logits differ from DecodeEngine's (err "
             "{:.3e}, atol {})".format(err0, TP_ADMISSION_ATOL))
    if not ties_ok:
        fail("tp: first-difference margins {} past the near tie "
             "{:.4f}".format(margins, near))
    return {"tp": st}, adm.cpu()


def _tp2_rank(rank, address):
    """One rank of path tp2 (a spawned process on the same card): the tp
    path's model made from the same seed on the card, this rank's shards
    kept, its traffic served over gloo. Returns tokens, decision logits
    (CPU), stats and this process's failures."""
    import torch
    import torch.distributed as dist
    from sparsebit_tpu_torch.llm.llama import llama_7b
    from sparsebit_tpu_torch.llm.serving import TPDecodeEngine
    from sparsebit_tpu_torch.parallel.mesh import make_mesh
    from sparsebit_tpu_torch.parallel.multihost import initialize_multihost

    initialize_multihost(address, 2, rank, backend="gloo", device="cuda:0")
    try:
        _wrappers()
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = llama_7b()
        params = build_plane_params(cfg, torch.device("cuda"),
                                    lambda li, n: 4, SEED + 6)
        t0 = time.perf_counter()
        mesh = make_mesh(dp=1, tp=2, device_type="cuda")
        eng = TPDecodeEngine(params, cfg, mesh, device="cuda", **TP_KW)
        shard_s = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        toks, ext, rows, st = _tp_serve(
            eng, "tp2 rank {} (TPDecodeEngine, T=2, gloo)".format(rank),
            "tp_decode_chunk", ("K1", "K9"))
        st.update(shard_s=shard_s, backend=dist.get_backend(),
                  cache_kv_heads=int(eng.cache.k.shape[3]))
    finally:
        dist.destroy_process_group()
    return {"tokens": toks, "ext": ext, "rows": [r.cpu() for r in rows],
            "stats": st, "failures": list(failures)}


def _k1_case(K, N, copies, g, gs=128):
    """Random s4r weights (copies, K/2, N) with bf16 scales and zeros."""
    import torch

    dev = torch.device("cuda")
    w = torch.randint(0, 256, (copies, K // 2, N), dtype=torch.uint8,
                      generator=g, device=dev)
    s = torch.empty((copies, K // gs, N), device=dev).uniform_(
        0.001, 0.01, generator=g).to(torch.bfloat16)
    z = torch.full((copies, K // gs, N), 8.0, dtype=torch.bfloat16,
                   device=dev)
    return w, s, z


def _k1_bytes(M, K, N, gs=128):
    """K1's bytes at (M, K -> N): x int8 and its scales, the nibbles, bf16
    scales and zeros, the f32 output."""
    return M * K + 4 * M + K * N // 2 + 2 * (K // gs) * N * 2 + 4 * M * N


TP2_MS = (8, 16, 32, 128, 768)  # tp2's K1 rows: decode 8, admission groups


def k1_shard_checks():
    """The kernels at tp2's shard shapes, each against its plain version:
    K1 at the four 7B T=2 shapes (TP2_SHAPES) at every M the path
    launches it with (TP2_MS: a decode step and the admission groups),
    over 8 copies of the weights cycled so that they come from HBM,
    bit-equal in k1_plan's order; K9 on the head's vocab shard (4096 ->
    16000, another k_splits split than phase 2's 32000 columns) at B = 1
    and 8, within phase 2's tolerance (1e-3 of max |plain|). Eager and
    graph-replay (device) ms, the plain version's ms and the bound; K9
    also ``x @ W``'s. Returns the records."""
    import torch
    from sparsebit_tpu_torch.ops import _kernels
    from sparsebit_tpu_torch.ops import matvec as MV
    from sparsebit_tpu_torch.ops import quant_matmul as QM
    from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant

    dev, gs, copies = torch.device("cuda"), 128, 8
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    out = []
    for shape in TP2_SHAPES:
        K, N = map(int, shape.split("->"))
        w, s, z = _k1_case(K, N, copies, g, gs)
        for M in TP2_MS:
            x8, xs = tokenwise_quant(torch.randn((M, K), generator=g,
                                                 device=dev))
            tile, gps = QM.k1_plan(M, K, N, gs)

            def run(i):
                return QM.quant_matmul_s4(x8, xs, w, s, z, gs,
                                          li=i % copies)

            def plain(i):
                c = i % copies
                return QM._qmm_s4_plain(x8, xs, w[c], s[c], z[c], gs, gps)

            err = float((run(0) - plain(0)).abs().max())
            ms = cuda_ms(run, 20)
            dms = graph_ms(run, 20)
            pms = cuda_ms(plain, 3, 1)
            bnd = bound_ms(_k1_bytes(M, K, N, gs), 2 * M * K * N, "int8")
            out.append({"kernel": "K1", "shape": "M={} {}".format(M, shape),
                        "tile": tile, "gps": gps, "max_abs_err": err,
                        "tol": 0.0, "ms": ms, "device_ms": dms,
                        "plain_ms": pms, "bound_ms": bnd[0],
                        "bound_by": bnd[1]})
            print("K1   T=2 shard M={} {} ({}, gps {}): err {:.3e} (bit-"
                  "equal required) | {:.4f} ms, device {} ms, plain {:.4f} "
                  "ms, bound {:.4f} ms ({})".format(
                      M, shape, tile, gps, err, ms, "-" if dms is None
                      else "{:.4f}".format(dms), pms, *bnd), flush=True)
            if err != 0.0:
                fail("K1 at the T=2 shard M={} {}: err {:.3e}".format(
                    M, shape, err))
        del w, s, z
    K, N = 4096, 16000  # llama_7b's lm_head, one rank's vocab columns
    W = (torch.randn((K, N), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    splits = MV.k_splits(K, N, _kernels.sm_count(dev))
    for B in (1, 8):
        x = torch.randn((B, K), generator=g, device=dev).to(torch.bfloat16)
        ref = MV._bf16_matvec_plain(x, W)
        err = float((MV.bf16_matvec(x, W) - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max())
        ms = cuda_ms(lambda i: MV.bf16_matvec(x, W), 20)
        dms = graph_ms(lambda i: MV.bf16_matvec(x, W), 20)
        pms = cuda_ms(lambda i: MV._bf16_matvec_plain(x, W), 5, 1)
        lms = cuda_ms(lambda i: torch.matmul(x, W), 20)
        bnd = bound_ms(2 * K * N + 2 * B * K + 4 * B * N, 2 * B * K * N,
                       "bf16")
        out.append({"kernel": "K9", "shape": "B={} {}->{}".format(B, K, N),
                    "k_splits": splits, "max_abs_err": err, "tol": tol,
                    "ms": ms, "device_ms": dms, "plain_ms": pms,
                    "library_ms": lms, "bound_ms": bnd[0],
                    "bound_by": bnd[1]})
        print("K9   T=2 head shard B={} {}->{} (k_splits {}): err {:.3e} tol "
              "{:.3e} | {:.4f} ms, device {} ms, plain {:.4f} ms, x @ W "
              "{:.4f} ms, bound {:.4f} ms ({})".format(
                  B, K, N, splits, err, tol, ms, "-" if dms is None
                  else "{:.4f}".format(dms), pms, lms, *bnd), flush=True)
        if not err <= tol:
            fail("K9 at the T=2 head shard B={}: err {:.3e} over tol "
                 "{:.3e}".format(B, err, tol))
    return out


def k1_step_replay(cfg, T, M=8):
    """K1's time in one decode step at a tp path's widths, without the
    path's host: the step's launches (wq, wk, wv, wo, w1, w3, w2 of every
    layer, T's shards, M rows) in the engine's order, each on its own
    copy of 8 weight stacks a shape cycled so that they come from HBM,
    timed issued back to back (CUDA events around the sequence) and as
    one replayed CUDA graph (device time alone). The tp paths time each
    launch between events while the engine runs, so their K1 figure also
    holds what the host leaves between a kernel's start and end events.
    Returns the record."""
    import torch
    from sparsebit_tpu_torch.ops import quant_matmul as QM
    from sparsebit_tpu_torch.ops.int8_matmul import tokenwise_quant

    dev, gs, copies = torch.device("cuda"), 128, 8
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    D, F = cfg.dim, cfg.ffn_dim
    Fp = -(-(F // T) // 256) * 256  # w1/w3 shards packed to 256 columns
    layer = ([(D, D // T)] * 3 + [(D // T, D)] + [(D, Fp)] * 2
             + [(F // T, D)])
    stacks = {kn: _k1_case(*kn, copies, g, gs) for kn in set(layer)}
    xq = {K: tokenwise_quant(torch.randn((M, K), generator=g, device=dev))
          for K in {k for k, _ in layer}}
    seq, used = [], {}
    for _ in range(cfg.n_layers):
        for kn in layer:
            used[kn] = used.get(kn, -1) + 1
            seq.append((kn, used[kn] % copies))

    def run(i):
        (K, N), li = seq[i % len(seq)]
        return QM.quant_matmul_s4(*xq[K], *stacks[(K, N)], gs, li=li)

    n = len(seq)
    eager = cuda_ms(run, n, n) * n
    graph = graph_ms(run, n)
    nbytes = sum(_k1_bytes(M, K, N, gs) for (K, N), _ in seq)
    ops = sum(2 * M * K * N for (K, N), _ in seq)
    bnd = bound_ms(nbytes, ops, "int8")
    rec = {"T": T, "M": M, "launches_a_step": n,
           "shapes_a_layer": ["{}->{}".format(*kn) for kn in layer],
           "eager_ms_a_step": eager,
           "graph_ms_a_step": None if graph is None else graph * n,
           "bound_ms_a_step": bnd[0], "bound_by": bnd[1]}
    print("K1   one decode step at T={} widths (M={}, {} launches, {}): "
          "issued back to back {:.4f} ms, graph replay {} ms, bound {:.4f} "
          "ms ({})".format(T, M, n, rec["shapes_a_layer"], eager,
                           "-" if graph is None
                           else "{:.4f}".format(graph * n), *bnd),
          flush=True)
    del stacks
    torch.cuda.empty_cache()
    return rec


def tp2_path(tp_admission):
    """Phase 4, path tp2: two ranks spawned on the one card over gloo
    (NCCL refuses two ranks on one device), each building tp's model from
    the same seed and keeping its shards (K1 at 7B T=2: 4096->2048,
    2048->4096, 4096->5504 packed as 5632 columns, 5504->4096). gloo
    moves every all_reduce and all_gather of CUDA tensors through the
    host, so the wall ms/step is no measure of multi-GPU speed. Held:
    both ranks' tokens equal, their gathered logits bit-equal, rank 0's
    admission logits within TP2_ATOL of tp's with equal decisive argmax,
    K1 at the four T=2 shard shapes on both ranks (launches per rank
    recorded); before the ranks start, K1 and K9 alone at the shapes and
    rows the ranks give them (k1_shard_checks) and one decode step's K1
    launches replayed (k1_step_replay)."""
    import torch
    from sparsebit_tpu_torch.llm.llama import llama_7b
    from sparsebit_tpu_torch.parallel.multihost import free_port, spawn_ranks

    k1_shards = k1_shard_checks()
    k1_step = k1_step_replay(llama_7b(), 2)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_ranks(_tp2_rank, 2,
                      args=("localhost:{}".format(free_port()),))
    wall = time.perf_counter() - t0
    for rank, r in enumerate(res):
        for f in r["failures"]:
            fail("tp2 rank {}: {}".format(rank, f))
    a, b = res
    same_tokens = a["tokens"] == b["tokens"] and a["ext"] == b["ext"]
    bit_equal = len(a["rows"]) == len(b["rows"]) and all(
        torch.equal(x, y) for x, y in zip(a["rows"], b["rows"]))
    adm = torch.stack([r[0] for r in a["rows"]])
    err, ok = _logits_agree(adm, tp_admission, atol=TP2_ATOL)
    shapes_ok = []
    for r in res:
        seen = r["stats"]["k1_launches_by_shape"]
        shapes_ok.append(all(any(k.endswith(" " + s) for k in seen)
                             for s in TP2_SHAPES))
    st = {"ranks": [r["stats"] for r in res], "spawn_s": wall,
          "tokens_equal_across_ranks": same_tokens,
          "logits_bit_equal_across_ranks": bit_equal,
          "admission_max_abs_err_vs_tp": err,
          "k1_at_t2_shapes": shapes_ok,
          "launches": res[0]["stats"]["launches"],
          "launches_per_rank": [r["stats"]["launches"] for r in res],
          "k1_shard_checks": k1_shards, "k1_step_replay": k1_step,
          "collectives": "gloo on CUDA tensors (all_reduce, all_gather)"}
    print("tp2: 2 ranks in {:.1f} s (spawn, weights, shards, serving); "
          "tokens equal across ranks {}, gathered logits bit-equal {}, rank "
          "0 admission vs tp max err {:.3e} (atol {}), K1 at the T=2 shapes "
          "{}; wall {} ms/step (gloo through the host); K1 {} ms/step "
          "between events in the engine, {} by graph replay of the step's "
          "launches; K1 launches by shape, rank 0: {}".format(
              wall, same_tokens, bit_equal, err, TP2_ATOL, shapes_ok,
              ["{:.3f}".format(r["stats"]["decode_ms_per_step"])
               for r in res],
              ["{:.4f}".format(r["stats"]["k1_device_ms_per_step"])
               for r in res], k1_step["graph_ms_a_step"],
              a["stats"]["k1_launches_by_shape"]), flush=True)
    if not same_tokens:
        fail("tp2: the ranks' tokens differ")
    if not bit_equal:
        fail("tp2: the ranks' gathered logits differ")
    if not ok:
        fail("tp2: rank 0's admission logits vs tp's err {:.3e} (atol "
             "{})".format(err, TP2_ATOL))
    if not all(shapes_ok):
        fail("tp2: K1 missed a T=2 shard shape {}".format(TP2_SHAPES))
    return {"tp2": st}

# ---- training over ranks: pptrain, tptrain, sptrain, pptp, dpqat ----------
#
# gloo carries every exchange and collective of these ranks through the
# host (two or four ranks share the one card; NCCL refuses that), so no
# wall time here measures multi-card speed.

PP_LAYERS, PP_M, PP_STEPS = 8, 2, 3  # pptrain: 4 layers a stage
PPTP_LAYERS = 4
TRAIN_LAYERS = 2  # tptrain, sptrain
SP_SEQ = 2048
# tptrain / sptrain against the single rank, per leaf: (relative norm,
# cosine). bf16 weights and activations; the ranks' products sum in
# other orders (row-parallel partials added in bf16 after the
# all_reduce, sp's plain attention against K10-K12).
TRAIN_GRAD_TOL = (0.05, 0.999)
DPQAT_LR = 1e-4  # the resnet18 QAT CLI's default


def _rank_env(rank, world, address):
    """torchrun's variables for a spawned rank on the one card; its
    collective timeout cut so that a hang fails the path within the run."""
    from sparsebit_tpu_torch.parallel import multihost

    host, port = address.split(":")
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    multihost.TIMEOUT_S = 300


def _agree(got, want):
    """(relative norm, cosine) of two gradients flattened."""
    got, want = got.float().reshape(-1), want.float().reshape(-1)
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    cos = float(got @ want / (got.norm() * want.norm()).clamp_min(1e-30))
    return rel, cos


def _train_cfg(n_layers):
    from sparsebit_tpu_torch.llm.llama import llama_7b

    return dataclasses.replace(llama_7b(), n_layers=n_layers)


def _trainable(tree):
    from sparsebit_tpu_torch.llm.convert import trainable

    return trainable(tree)


def _qlora_model(cfg):
    """path qlora's model at cfg's depth: random INT4-g128 checkpoint-layout
    weights (unit scales), r = 8 adapters on wq and wv, and B = 4 windows
    of 513 seeded tokens."""
    import torch
    from sparsebit_tpu_torch.llm import qlora as Q

    dev = torch.device("cuda")
    params = Q.wrap_llama_lora(
        build_plane_params(cfg, dev, lambda li, n: 4, SEED + 6, unit=True),
        r=8, alpha=16.0,
        generator=torch.Generator(device=dev).manual_seed(SEED + 14))
    tokens = torch.randint(0, cfg.vocab_size, (4, 513), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 15))
    return params, tokens


def _pptrain(rank):
    """Path pptrain on this rank (see pptrain_path)."""
    import torch
    import torch.distributed as dist
    from sparsebit_tpu_torch.llm import qlora as Q
    from sparsebit_tpu_torch.parallel import pp as PP
    from sparsebit_tpu_torch.parallel import tp as TP
    from sparsebit_tpu_torch.parallel.mesh import make_mesh_named, sum_grads

    cfg = _train_cfg(PP_LAYERS)
    mesh = make_mesh_named("cuda", dp=1, pp=2)
    sid = mesh.get_local_rank("pp")
    params, tokens = _qlora_model(cfg)
    pp_params = PP.stack_llama_stages(params, 2, rank=sid)
    lora = PP.pp_extract_lora(pp_params)
    ids = {id(t) for v in lora.values() for t in v.values()}
    backbone = [t.clone() for t in _tensors(pp_params) if id(t) not in ids]
    lora0 = [t.clone() for t in _tensors(lora)]
    opt = Q.adamw(lora, 3e-4)

    marks, exch = [], {"s": 0.0, "n": 0}
    real_loss, real_sum, real_exchange = (PP.pp_qlora_loss, PP.sum_grads,
                                          TP._exchange)

    def timed_loss(*a):
        out = real_loss(*a)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out

    def timed_sum(*a, **kw):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return real_sum(*a, **kw)

    def timed_exchange(*a):
        t0 = time.perf_counter()
        out = real_exchange(*a)
        exch["s"] += time.perf_counter() - t0
        exch["n"] += 1
        return out

    timer = KernelEvents()
    steps = []
    with _Patched([(PP, "pp_qlora_loss", timed_loss),
                   (PP, "sum_grads", timed_sum),
                   (TP, "_exchange", timed_exchange)]), timer.patch:
        for step in range(1 + PP_STEPS):  # a warm-up, then the timed steps
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _reset_launches()
            marks.clear()
            exch.update(s=0.0, n=0)
            timer.events = []
            timer.on = True
            t0 = time.perf_counter()
            lora, loss = PP.pp_qlora_train_step(lora, opt, pp_params, tokens,
                                                cfg, mesh, PP_M)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            timer.on = False
            _, by = timer.take_ms()
            st = {"loss": loss.item(), "wall_s": t3 - t0,
                  "forward_s": marks[0] - t0,
                  "backward_s": marks[1] - marks[0],
                  "grad_sum_and_optimizer_s": t3 - marks[1],
                  "exchange_s": exch["s"], "exchanges": exch["n"],
                  "k10_device_ms": by.get(K10_ENTRY, 0.0),
                  "k11_device_ms": by.get(K11_ENTRY, 0.0),
                  "k12_device_ms": by.get(K12_ENTRY, 0.0),
                  "peak_bytes_above_resident":
                      torch.cuda.max_memory_allocated() - base,
                  "resident_bytes": base, "launches": _launches()}
            if step:
                steps.append(st)
            if not math.isfinite(st["loss"]):
                fail("pptrain rank {} step {}: loss {}".format(
                    rank, step, st["loss"]))

    # the gradients at the trained state against the single rank's
    opt.zero_grad(set_to_none=True)
    loss = PP.pp_qlora_loss(lora, pp_params, tokens, cfg, mesh, PP_M)
    loss.backward()
    sum_grads(lora, mesh, ("dp",))
    g = mesh.get_group("pp")
    per = PP_LAYERS // 2
    full = Q.extract_lora(params)  # every stage's adapters, this rank's
    with torch.no_grad():          # trained ones: share them
        for (li, name) in sorted(full):
            for t in full[li, name].values():
                dist.broadcast(t, src=dist.get_global_rank(g, li // per),
                               group=g)
    ref = {k: {n: t.detach().clone().requires_grad_(True)
               for n, t in v.items()} for k, v in full.items()}
    ref_loss = Q.qlora_loss_fn(ref, params, tokens, cfg)
    ref_loss.backward()
    leaves = [(k, n) for k in sorted(lora) for n in ("lora_A", "lora_B")]
    worst, n_bad = _adapters_held(
        "pptrain stage {}".format(sid),
        {(k, n): lora[k][n].grad for k, n in leaves},
        {((s, i, name), n): ref[s * per + i, name][n].grad
         for (s, i, name), n in leaves})
    same = all(torch.equal(a, b) for a, b in zip(
        backbone, [t for t in _tensors(pp_params) if id(t) not in ids]))
    moved = all(not torch.equal(a, b) for a, b in zip(lora0, _tensors(lora)))
    return {"stage": sid, "steps": steps, "losses": [s["loss"]
                                                     for s in steps],
            "loss_at_trained_state": loss.item(),
            "single_rank_loss": ref_loss.item(),
            "loss_vs_single_rel": abs(loss.item() - ref_loss.item())
            / abs(ref_loss.item()),
            "adapter_grads_vs_single": worst,
            "adapters_past_tol": n_bad, "backbone_bit_equal": same, "adapters_moved": moved,
            "launches": {k: sum(s["launches"][k] for s in steps)
                         for k in steps[0]["launches"]}}


def _shard_slice(full, name, t, T):
    """Rank t's block of an unsharded weight gradient (w as (in, out))."""
    kind = name.split(".")[-1]
    if kind in ("wq", "wk", "wv", "w1", "w3", "lm_head"):
        n = full.shape[1] // T
        return full[:, t * n:(t + 1) * n]
    if kind in ("wo", "w2"):
        n = full.shape[0] // T
        return full[t * n:(t + 1) * n]
    return full


def _leaf_grads(params):
    """{leaf name: gradient} of a (TP-sharded) LLaMA params tree."""
    from sparsebit_tpu_torch.parallel.tp import TPLinear

    def grad(x):
        if isinstance(x, TPLinear):
            x = x.local()
        return (x.w if hasattr(x, "w") else x).grad

    out = {k: grad(params[k]) for k in ("tok_embed", "norm", "lm_head")}
    for i, layer in enumerate(params["layers"]):
        for name, x in layer.items():
            out["layers.{}.{}".format(i, name)] = grad(x)
    return out


def _single_rank_grads(cfg, params, tokens):
    """(loss, {leaf: gradient}) of llama_loss on one rank (K10-K12)."""
    import copy

    from sparsebit_tpu_torch.llm.llama import llama_loss

    ref = _trainable(copy.deepcopy(params))
    loss = llama_loss(ref, tokens, cfg)
    loss.backward()
    return loss.item(), _leaf_grads(ref)


def _grads_held(tag, got, want, T=1, t=0):
    """Each leaf's gradient (the rank's block) against the single rank's:
    (worst relative norm, worst cosine, the leaves past TRAIN_GRAD_TOL)."""
    worst_rel, worst_cos, bad = 0.0, 1.0, []
    for name, w in want.items():
        rel, cos = _agree(got[name], _shard_slice(w, name, t, T))
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        if rel > TRAIN_GRAD_TOL[0] or cos < TRAIN_GRAD_TOL[1]:
            bad.append((name, rel, cos))
    if bad:
        fail("{}: gradients past (rel {}, cos {}): {}".format(
            tag, *TRAIN_GRAD_TOL, bad[:6]))
    return worst_rel, worst_cos, len(bad)


def _adapters_held(tag, got, want):
    """Each adapter leaf's gradient, ``got`` {(key, "lora_A" / "lora_B"):
    gradient}, against the single rank's ``want`` (the rank's block) by
    QLORA_GRAD_TOL["dense"]: {leaf kind: [worst relative norm, worst
    cosine]} and the number of leaves past it."""
    tol_rel, tol_cos = QLORA_GRAD_TOL["dense"]
    worst, bad = {}, []
    for k, g in got.items():
        rel, cos = _agree(g, want[k])
        w = worst.setdefault(k[-1], [0.0, 1.0])
        w[0], w[1] = max(w[0], rel), min(w[1], cos)
        if rel > tol_rel or cos < tol_cos:
            bad.append((k, rel, cos))
    if bad:
        fail("{}: adapter gradients past (rel {}, cos {}): {}".format(
            tag, tol_rel, tol_cos, bad[:6]))
    return worst, len(bad)


def _tptrain(rank):
    """Path tptrain on this rank (see pptrain_path)."""
    import torch
    from sparsebit_tpu_torch.llm.llama import init_llama_params
    from sparsebit_tpu_torch.parallel import tp as TP
    from sparsebit_tpu_torch.parallel.mesh import make_mesh, sum_grads

    dev = torch.device("cuda")
    cfg = _train_cfg(TRAIN_LAYERS)
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 30), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 513), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 31))
    ref_loss, ref = _single_rank_grads(cfg, params, tokens)
    mesh = make_mesh(dp=1, tp=2, device_type="cuda")
    _, T, r = TP.tp_group(mesh)
    ptp = _trainable(TP.shard_llama_params_tp(params, cfg, T, rank=r))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    loss = TP.tp_llama_loss(ptp, tokens, cfg, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    sum_grads(ptp, mesh, ("dp",))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():  # the step: plain SGD, lr 1e-3
        for t in _tensors(ptp):
            if t.grad is not None:
                t -= 1e-3 * t.grad
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _launches()
    tag = "tptrain rank {}".format(rank)
    rel, cos, n_bad = _grads_held(tag, _leaf_grads(ptp), ref, T, r)
    loss_rel = abs(loss.item() - ref_loss) / abs(ref_loss)
    if not (loss_rel <= 1e-3 and math.isfinite(loss.item())):
        fail("{}: loss {} against the single rank's {}".format(
            tag, loss.item(), ref_loss))
    return {"tp_rank": r, "loss": loss.item(), "single_rank_loss": ref_loss,
            "loss_vs_single_rel": loss_rel, "worst_grad_rel": rel,
            "worst_grad_cos": cos, "leaves_past_tol": n_bad,
            "wall_s": t3 - t0, "forward_s": t1 - t0, "backward_s": t2 - t1,
            "update_s": t3 - t2,
            "peak_bytes_above_resident":
                torch.cuda.max_memory_allocated() - base,
            "launches": launches}


def _sptrain(rank):
    """Path sptrain on this rank (see pptrain_path)."""
    import torch
    from sparsebit_tpu_torch.llm.llama import init_llama_params
    from sparsebit_tpu_torch.parallel.mesh import make_mesh_named, sum_grads
    from sparsebit_tpu_torch.parallel.sp import sp_llama_loss

    dev = torch.device("cuda")
    cfg = _train_cfg(TRAIN_LAYERS)
    params = init_llama_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 32), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, SP_SEQ), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 33))
    ref_loss, ref = _single_rank_grads(cfg, params, tokens)
    mesh = make_mesh_named("cuda", sp=2)
    out = {}
    for ring in (False, True):
        import copy

        p = _trainable(copy.deepcopy(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_launches()
        t0 = time.perf_counter()
        loss = sp_llama_loss(p, tokens, cfg, mesh, ring=ring)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        sum_grads(p, mesh, ("sp",))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tag = "sptrain ring={} rank {}".format(ring, rank)
        rel, cos, n_bad = _grads_held(tag, _leaf_grads(p), ref)
        loss_rel = abs(loss.item() - ref_loss) / abs(ref_loss)
        if not (loss_rel <= 1e-3 and math.isfinite(loss.item())):
            fail("{}: loss {} against the single rank's {}".format(
                tag, loss.item(), ref_loss))
        out["ring={}".format(ring)] = {
            "loss": loss.item(), "single_rank_loss": ref_loss,
            "loss_vs_single_rel": loss_rel, "worst_grad_rel": rel,
            "worst_grad_cos": cos, "leaves_past_tol": n_bad,
            "forward_s": t1 - t0, "backward_s": t2 - t1,
            "peak_bytes_above_resident":
                torch.cuda.max_memory_allocated() - base,
            "launches": _launches()}
        del p, loss
        torch.cuda.empty_cache()
    return out


def _train_rank(rank, address):
    """Two ranks spawned on the one card over gloo: paths pptrain, tptrain
    and sptrain in turn, every kernel count set to 0 before each."""
    import torch
    import torch.distributed as dist
    from sparsebit_tpu_torch.parallel.multihost import initialize_multihost

    _rank_env(rank, 2, address)
    initialize_multihost(address, 2, rank, backend="gloo", device="cuda:0")
    out = {}
    try:
        _wrappers()
        torch.backends.cuda.matmul.allow_tf32 = False
        for name, fn in (("pptrain", _pptrain), ("tptrain", _tptrain),
                         ("sptrain", _sptrain)):
            t0 = time.perf_counter()
            out[name] = fn(rank)
            out[name]["path_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"paths": out, "failures": list(failures)}


def _pptp_rank(rank, address):
    """One of path pptp's four ranks (see pptp_path)."""
    import torch
    import torch.distributed as dist
    from sparsebit_tpu_torch.llm import qlora as Q
    from sparsebit_tpu_torch.parallel import pp as PP
    from sparsebit_tpu_torch.parallel import tp as TP
    from sparsebit_tpu_torch.parallel.mesh import make_mesh_named, sum_grads
    from sparsebit_tpu_torch.parallel.multihost import initialize_multihost

    _rank_env(rank, 4, address)
    initialize_multihost(address, 4, rank, backend="gloo", device="cuda:0")
    try:
        _wrappers()
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = _train_cfg(PPTP_LAYERS)
        params, tokens = _qlora_model(cfg)
        full = Q.extract_lora(params)
        g = torch.Generator(device="cuda").manual_seed(SEED + 16)
        with torch.no_grad():  # lora_B off zero: lora_A takes a gradient
            for k in sorted(full):
                b = full[k]["lora_B"]
                b.copy_(1e-3 * torch.randn(b.shape, generator=g,
                                           device=b.device))
        want = {k: {n: t.detach().clone().requires_grad_(True)
                    for n, t in v.items()} for k, v in full.items()}
        ref_loss = Q.qlora_loss_fn(want, params, tokens, cfg)
        ref_loss.backward()
        ref = ref_loss.item()
        mesh = make_mesh_named("cuda", dp=1, tp=2, pp=2)
        _, T, r = TP.tp_group(mesh)
        sid = mesh.get_local_rank("pp")
        ppp = PP.stack_llama_stages(TP.shard_llama_params_tp_packed(
            params, cfg, T, rank=r), 2, rank=sid)
        del params
        lora = PP.pp_extract_lora(ppp)
        opt = torch.optim.Adam(Q.lora_parameters(lora), lr=3e-4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_launches()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = PP.pp_tp_qlora_loss(lora, ppp, tokens, cfg, mesh, PP_M)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        sum_grads(lora, mesh, ("dp",))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = _launches()
        rel = abs(loss.item() - ref) / abs(ref)
        if not (rel <= 1e-3 and math.isfinite(loss.item())):
            fail("pptp rank {}: loss {} against the single rank's {}".format(
                rank, loss.item(), ref))
        per = PPTP_LAYERS // 2
        got, block = {}, {}
        for (s, i, name), ad in lora.items():
            w = want[s * per + i, name]
            kind = ppp["stages"][s][i][name].kind
            for n, t in ad.items():  # col: lora_B's columns; row: A's rows
                wg = w[n].grad
                if kind == "col" and n == "lora_B":
                    wg = wg.chunk(T, dim=1)[r]
                elif kind == "row" and n == "lora_A":
                    wg = wg.chunk(T, dim=0)[r]
                got[(s, i, name), n], block[(s, i, name), n] = t.grad, wg
        worst, n_bad = _adapters_held("pptp rank {}".format(rank), got,
                                      block)
        out = {"tp_rank": r, "stage": sid, "loss": loss.item(),
               "single_rank_loss": ref, "loss_vs_single_rel": rel,
               "adapter_grads_vs_single": worst,
               "adapters_past_tol": n_bad,
               "wall_s": t3 - t0, "forward_s": t1 - t0,
               "backward_s": t2 - t1, "optimizer_s": t3 - t2,
               "peak_bytes_above_resident":
                   torch.cuda.max_memory_allocated() - base,
               "launches": launches}
    finally:
        dist.destroy_process_group()
    return {"path": out, "failures": list(failures)}


class _Halves:
    """Stands in one process for path dpqat's dp group of two ranks (see
    _run_qat_cli)."""


def _halves_moments(real):
    """nn.modules._group_moments, which over _Halves sums BatchNorm's
    statistics as the two ranks do: each half's sums, then the two added
    (what gloo's all_reduce of two ranks computes)."""
    def moments(x, dims, group):
        if not isinstance(group, _Halves):
            return real(x, dims, group)
        ch = next(i for i in range(x.dim()) if i not in dims)
        shape = [-1 if i == ch else 1 for i in range(x.dim())]
        n = x.numel() // x.shape[ch]
        parts = x.chunk(2)
        s0, s1 = (p.sum(dim=dims) for p in parts)
        mean = (s0 + s1) / n
        d0, d1 = (p - mean.reshape(shape) for p in parts)
        return mean, ((d0 * d0).sum(dim=dims) + (d1 * d1).sum(dim=dims)) / n
    return moments


def _halves_conv2d(real):
    """F.conv2d over each half of the batch, as each rank computes it."""
    import torch

    def conv2d(x, *a, **kw):
        outs = [real(p, *a, **kw) for p in x.chunk(2)]
        fmt = (torch.channels_last if outs[0].is_contiguous(
            memory_format=torch.channels_last) else torch.contiguous_format)
        return torch.cat(outs).contiguous(memory_format=fmt)
    return conv2d


def _run_qat_cli(argv, halves=False):
    """The resnet18 QAT CLI's main(argv), with what each optimiser step
    finds recorded: the parameters and their gradients (after the dp
    average) in the optimiser's order, and BatchNorm's running statistics
    as that step's forward left them. Returns (the CLI's result, [{"params":
    [(param, grad)], "bn": {name: tensor}} a step], wall s).

    ``halves``: one process on the global batch that sums as path dpqat's
    two ranks do, its reference: in each training step every convolution
    runs on each half of the batch and BatchNorm sums each half's
    statistics, then adds the two; calibration is the plain one rank's, as
    every rank calibrates on the whole batches. Its forward is then the
    ranks' bit for bit, so no 4-bit activation falls to the other side of
    a rounding tie; its gradients are the global batch's mean, summed in
    another order than the ranks' average."""
    import importlib.util

    import torch
    import torch.nn.functional as F
    from sparsebit_tpu_torch.nn import modules as M
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    spec = importlib.util.spec_from_file_location("qat_resnet18_cli", (
        os.path.join(QAT_DIR, "imagenet1k_resnet18", "main_torch.py")))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    seen, models = [], []
    make = cli.make_qat_step

    def keep_model(qmodel, *a, **kw):
        models.append(qmodel)
        step = make(qmodel, *a, **kw)
        if not halves:
            return step
        for node in qmodel.graph.op_nodes:
            for m in node.op.modules():
                if isinstance(m, M.BatchNorm2d):
                    m.dp_group = _Halves()

        def halves_step(*batch):
            with _Patched([(F, "conv2d", _halves_conv2d(F.conv2d)),
                           (M, "_group_moments",
                            _halves_moments(M._group_moments))]):
                return step(*batch)
        return halves_step

    def record(optimizer, args, kwargs):
        bn = {"{}.{}".format(n, k): v.detach().cpu().clone()
              for n, p in models[0].trainable_params().items()
              for k, v in p.items() if "running_" in k}
        seen.append({"params": [
            (p.detach().cpu().clone(),
             None if p.grad is None else p.grad.detach().cpu().clone())
            for grp in optimizer.param_groups for p in grp["params"]],
            "bn": bn})

    cli.make_qat_step = keep_model
    hook = register_optimizer_step_pre_hook(record)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        hook.remove()
    return res, seen, wall


def _dpqat_argv():
    return ["--qconfig", os.path.join(QAT_DIR, "imagenet1k_resnet18",
                                      "qconfig_lsq.yaml"),
            "--batch", "64", "--img", "224", "--lr", str(DPQAT_LR),
            "--device", "cuda"]


# resnet18's BatchNorm inputs at 224 x 224, B = 64 (NHWC)
DPQAT_BN_SHAPES = ((64, 112, 112, 64), (64, 56, 56, 64), (64, 28, 28, 128),
                   (64, 14, 14, 256), (64, 7, 7, 512))


def _dp_batchnorm_checks(mesh):
    """nn.BatchNorm2d in training mode over the dp group on the rank's rows
    of a seeded global batch, at each of DPQAT_BN_SHAPES, against the same
    module on the whole batch on the card: the largest relative error of
    the rank's output rows, the running statistics, gamma's and beta's
    gradients (summed over dp) and the rank's input-gradient rows."""
    import copy

    import torch
    from sparsebit_tpu_torch.nn import BatchNorm2d, data_parallel
    from sparsebit_tpu_torch.parallel.mesh import sum_grads

    dev = torch.device("cuda")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    out = {}
    for shape in DPQAT_BN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED + 60)
        x = torch.randn(shape, generator=g, device=dev) * 3 + 1
        cot = torch.randn(shape, generator=g, device=dev)
        bn = BatchNorm2d(shape[-1], device=dev)
        with torch.no_grad():
            bn.weight.copy_(torch.rand(shape[-1], generator=g, device=dev)
                            + 0.5)
            bn.bias.copy_(torch.randn(shape[-1], generator=g, device=dev))
        ref = copy.deepcopy(bn)
        xr = x.clone().requires_grad_(True)
        ref_out = ref.execute(xr, training=True)
        (ref_out * cot).sum().backward()
        per = shape[0] // mesh["dp"].size()
        rows = slice(mesh.get_local_rank("dp") * per,
                     (mesh.get_local_rank("dp") + 1) * per)
        xl = x[rows].clone().requires_grad_(True)
        with data_parallel(mesh.get_group("dp"), bn):
            y = bn.execute(xl, training=True)
            (y * cot[rows]).sum().backward()
        sum_grads([bn.weight, bn.bias], mesh, ("dp",))
        out["x".join(map(str, shape))] = max(
            rel(y.detach(), ref_out.detach()[rows]),
            rel(bn.running_mean, ref.running_mean),
            rel(bn.running_var, ref.running_var),
            rel(bn.weight.grad, ref.weight.grad),
            rel(bn.bias.grad, ref.bias.grad), rel(xl.grad, xr.grad[rows]))
    return out


def _dpqat_rank(rank, address):
    """One of path dpqat's two ranks: BatchNorm over the dp group at
    resnet18's shapes (_dp_batchnorm_checks), then the CLI under
    torchrun's variables on the one card; its group is gloo (NCCL refuses
    two ranks on one device; the CLI takes multihost's default backend,
    named here)."""
    import torch
    import torch.distributed as dist
    from sparsebit_tpu_torch.parallel import multihost
    from sparsebit_tpu_torch.parallel.mesh import make_mesh

    _rank_env(rank, 2, address)
    multihost.BACKENDS = dict(multihost.BACKENDS, cuda="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _wrappers()
    multihost.initialize_multihost(device="cuda")
    try:
        bn = _dp_batchnorm_checks(make_mesh(dp=2, device_type="cuda"))
    finally:
        dist.destroy_process_group()
    _reset_launches()
    res, seen, wall = _run_qat_cli(_dpqat_argv())
    return {"loss": res["loss"], "state": res["state"], "steps": seen[:1],
            "n_steps": len(seen), "wall_s": wall, "launches": _launches(),
            "bn_checks": bn, "failures": list(failures)}


def train_paths():
    """Phase 4, paths pptrain (this slice's main path), tptrain and
    sptrain: two ranks spawned on the one card over gloo (NCCL refuses
    two ranks on one device), every kernel count set to 0 in each rank
    before a path and read after it.
      pptrain  pp = 2, M = 2 microbatches: path qlora's model at 8 layers
               (4 a stage; llama_7b() widths, random INT4-g128 checkpoint
               layout, r = 8 adapters on wq/wv), B = 4 x 513 tokens,
               qlora.adamw lr 3e-4: a warm-up and PP_STEPS
               pp_qlora_train_steps, wall s a step split into forward,
               backward, the dp gradient sum with the optimiser, and the
               host-staged exchanges inside; K10/K11/K12 device ms and
               launches a rank; peak memory. Held: both ranks' losses
               equal and finite; at the trained state, the pipelined loss
               within 1e-3 relative and each of the stage's adapter
               leaves' gradients (lora_A and lora_B of every layer) within
               QLORA_GRAD_TOL (dense) of the single rank's
               qlora_loss_fn on the same weights, adapters and tokens;
               the backbone bit-equal after the steps, every adapter
               moved, K10/K11/K12 launched on each rank.
      tptrain  tp = 2, a float training step of tp_llama_loss at 7B
               widths, 2 layers, B = 2, S = 512: loss within 1e-3 and
               every leaf's gradient (the rank's shard) within
               TRAIN_GRAD_TOL of the single rank's llama_loss backward
               (K10-K12), K10/K11/K12 launched.
      sptrain  sp = 2, ring False and True, 7B widths, 2 layers, B = 1,
               S = 2048: loss within 1e-3, gradients (summed over sp)
               within TRAIN_GRAD_TOL of the single rank's."""
    from sparsebit_tpu_torch.parallel.multihost import free_port, spawn_ranks

    t0 = time.perf_counter()
    res = spawn_ranks(_train_rank, 2,
                      args=("localhost:{}".format(free_port()),))
    wall = time.perf_counter() - t0
    for rank, r in enumerate(res):
        for f in r["failures"]:
            fail("rank {}: {}".format(rank, f))
    a, b = (r["paths"] for r in res)
    out = {}
    pp = {"ranks": [a["pptrain"], b["pptrain"]], "spawn_s": wall,
          "transport": "gloo; CUDA activations staged through host memory "
                       "for each exchange"}
    pp["launches"] = a["pptrain"]["launches"]
    pp["launches_per_rank"] = [a["pptrain"]["launches"],
                               b["pptrain"]["launches"]]
    equal = a["pptrain"]["losses"] == b["pptrain"]["losses"]
    for r in (a, b):
        p = r["pptrain"]
        st = p["steps"]
        print("pptrain stage {}: losses {}; a step {} s wall (forward {}, "
              "backward {}, grad sum + optimiser {}; exchanges {} in {} "
              "s); K10 / K11 / K12 {} / {} / {} ms device a step; peak {:.3f} "
              "GB above {:.3f} GB resident; launches {}; at the trained "
              "state loss {:.6f} vs single rank {:.6f} (rel {:.3e}), "
              "each adapter leaf's gradient, worst [rel, cos] by kind {} "
              "(tol {}); backbone bit-equal {}, adapters moved {}".format(
                  p["stage"], ["{:.6f}".format(v) for v in p["losses"]],
                  ["{:.4f}".format(s["wall_s"]) for s in st],
                  ["{:.4f}".format(s["forward_s"]) for s in st],
                  ["{:.4f}".format(s["backward_s"]) for s in st],
                  ["{:.4f}".format(s["grad_sum_and_optimizer_s"])
                   for s in st], st[0]["exchanges"],
                  ["{:.4f}".format(s["exchange_s"]) for s in st],
                  *(["{:.3f}".format(s[k]) for s in st] for k in (
                      "k10_device_ms", "k11_device_ms", "k12_device_ms")),
                  max(s["peak_bytes_above_resident"] for s in st) / 1e9,
                  st[0]["resident_bytes"] / 1e9, p["launches"],
                  p["loss_at_trained_state"], p["single_rank_loss"],
                  p["loss_vs_single_rel"], p["adapter_grads_vs_single"],
                  QLORA_GRAD_TOL["dense"], p["backbone_bit_equal"],
                  p["adapters_moved"]), flush=True)
        if not p["loss_vs_single_rel"] <= 1e-3:
            fail("pptrain stage {}: loss rel {:.3e} against the single "
                 "rank".format(p["stage"], p["loss_vs_single_rel"]))
        if not (p["backbone_bit_equal"] and p["adapters_moved"]):
            fail("pptrain stage {}: backbone changed or an adapter did not "
                 "move".format(p["stage"]))
        _expect("pptrain stage {}".format(p["stage"]), p["launches"],
                ("K10", "K11", "K12"))
    if not equal:
        fail("pptrain: the ranks' losses differ: {} / {}".format(
            a["pptrain"]["losses"], b["pptrain"]["losses"]))
    pp["losses_equal_across_ranks"] = equal
    out["pptrain"] = pp

    for r in (a, b):
        t = r["tptrain"]
        print("tptrain tp rank {}: loss {:.6f} vs single rank {:.6f} (rel "
              "{:.3e}); worst leaf gradient rel {:.3e} cos {:.6f} (tol {}); "
              "{:.4f} s (forward {:.4f}, backward + sum {:.4f}, update "
              "{:.4f}); peak {:.3f} GB; launches {}".format(
                  t["tp_rank"], t["loss"], t["single_rank_loss"],
                  t["loss_vs_single_rel"], t["worst_grad_rel"],
                  t["worst_grad_cos"], TRAIN_GRAD_TOL, t["wall_s"],
                  t["forward_s"], t["backward_s"], t["update_s"],
                  t["peak_bytes_above_resident"] / 1e9, t["launches"]),
              flush=True)
        _expect("tptrain tp rank {}".format(t["tp_rank"]), t["launches"],
                ("K10", "K11", "K12"))
    out["tptrain"] = {"ranks": [a["tptrain"], b["tptrain"]],
                      "launches": a["tptrain"]["launches"],
                      "launches_per_rank": [a["tptrain"]["launches"],
                                            b["tptrain"]["launches"]]}

    for mode in ("ring=False", "ring=True"):
        for rank, r in enumerate((a, b)):
            s = r["sptrain"][mode]
            print("sptrain {} rank {}: loss {:.6f} vs single rank {:.6f} (rel "
                  "{:.3e}); worst leaf gradient rel {:.3e} cos {:.6f}; "
                  "forward {:.4f} s, backward + sum {:.4f} s; peak {:.3f} GB; "
                  "launches {}".format(
                      mode, rank, s["loss"], s["single_rank_loss"],
                      s["loss_vs_single_rel"], s["worst_grad_rel"],
                      s["worst_grad_cos"], s["forward_s"], s["backward_s"],
                      s["peak_bytes_above_resident"] / 1e9, s["launches"]),
                  flush=True)
    out["sptrain"] = {"ranks": [a["sptrain"], b["sptrain"]],
                      "launches": a["sptrain"]["ring=False"]["launches"]}
    return out


def pptp_path():
    """Phase 4, path pptp: four ranks spawned on the one card over gloo,
    tp = 2 x pp = 2: path qlora's model at 4 layers, its packed INT4
    weights split exactly over tp (shard_llama_params_tp_packed: codes
    sliced, the adapters split with them), one Adam step (lr 3e-4) of
    pp_tp_qlora_loss at B = 4, S = 512, M = 2, from adapters whose lora_B
    is seeded off zero (so that lora_A, replicated over tp and summed by
    _copy_to in the backward, takes a gradient). Held: the loss within
    1e-3 relative of the single rank's QLoRA loss on the same packed
    weights and adapters, the same on every rank; each adapter leaf's
    gradient (the rank's block) within QLORA_GRAD_TOL (dense) of the
    single rank's; K10/K11/K12 launched on each.
    Recorded: s split into forward, backward and optimiser, peak memory,
    launches (K8 where QuantLinear's "auto" route takes it)."""
    from sparsebit_tpu_torch.parallel.multihost import free_port, spawn_ranks

    t0 = time.perf_counter()
    res = spawn_ranks(_pptp_rank, 4,
                      args=("localhost:{}".format(free_port()),))
    wall = time.perf_counter() - t0
    for rank, r in enumerate(res):
        for f in r["failures"]:
            fail("pptp rank {}: {}".format(rank, f))
    ranks = [r["path"] for r in res]
    for p in ranks:
        print("pptp tp rank {} stage {}: loss {:.6f} vs single rank {:.6f} "
              "(rel {:.3e}); each adapter leaf's gradient (the rank's "
              "block), worst [rel, cos] by kind {} (tol {}); {:.4f} s "
              "(forward {:.4f}, backward {:.4f}, optimiser {:.4f}); peak "
              "{:.3f} GB; launches {}".format(
                  p["tp_rank"], p["stage"], p["loss"], p["single_rank_loss"],
                  p["loss_vs_single_rel"], p["adapter_grads_vs_single"],
                  QLORA_GRAD_TOL["dense"], p["wall_s"], p["forward_s"],
                  p["backward_s"], p["optimizer_s"],
                  p["peak_bytes_above_resident"] / 1e9, p["launches"]),
              flush=True)
        _expect("pptp tp rank {} stage {}".format(p["tp_rank"], p["stage"]),
                p["launches"], ("K10", "K11", "K12"))
    if len({p["loss"] for p in ranks}) != 1:
        fail("pptp: the ranks' losses differ: {}".format(
            [p["loss"] for p in ranks]))
    return {"pptp": {"ranks": ranks, "spawn_s": wall,
                     "launches": ranks[0]["launches"],
                     "launches_per_rank": [p["launches"] for p in ranks]}}


DPQAT_BN_TOL = 1e-5
# dpqat's first step against the one process that sums as the two ranks
# do, each trainable's gradient: largest |difference| over the largest
# |gradient| of that leaf. The two sum the gradients in other orders
# (the ranks their halves, then the average); a sum in place of the
# average reads 1.0, LSQ's count of the rank's elements alone sqrt(2) - 1
# = 0.41 on the activation scales, and BatchNorm on the rank's rows alone
# moves the 4-bit codes downstream.
DPQAT_GRAD_TOL = 1e-2


def dpqat_path():
    """Phase 4, path dpqat: two ranks spawned on the one card (gloo).
    First, BatchNorm over the dp group at resnet18's five BatchNorm
    shapes at 224 x 224, B = 64 (_dp_batchnorm_checks): held within
    DPQAT_BN_TOL relative of the whole batch's module on the card. Then
    the resnet18 LSQ QAT CLI (imagenet1k_resnet18/main_torch.py) under
    torchrun's variables, at a global B = 64 of 224 x 224 images for its
    2 steps (Adam, lr 1e-4), against the same CLI in one process on the
    global batch, summing as the two ranks do (_run_qat_cli's
    ``halves``); TF32 off in all. Held against it, at the first optimiser
    step: the parameters (calibrated, QAT-initialised, broadcast) within
    1e-6 relative, BatchNorm's running statistics as the first forward
    left them within DPQAT_BN_TOL, and every trainable's dp-averaged
    gradient within DPQAT_GRAD_TOL of that leaf's largest; both ranks'
    losses equal and finite. Printed, not held: the state after the 2
    steps against it, and the first step against the plain one-rank CLI.
    A bit moved in a BatchNorm sum or a convolution sends a 4-bit
    activation at a rounding tie to the other code, so the plain one rank
    is not the same computation (the path prints how far it lands), and
    after the first Adam step a weight at a tie does the same."""
    import torch
    from sparsebit_tpu_torch.parallel.multihost import free_port, spawn_ranks

    res = spawn_ranks(_dpqat_rank, 2,
                      args=("localhost:{}".format(free_port()),))
    for rank, r in enumerate(res):
        for f in r["failures"]:
            fail("dpqat rank {}: {}".format(rank, f))
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref, seen, ref_wall = _run_qat_cli(_dpqat_argv(), halves=True)
        one, one_seen, one_wall = _run_qat_cli(_dpqat_argv())
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def first_step(mine, want):
        """(parameters, worst leaf gradient, BatchNorm statistics) rel,
        and the worst leaf gradient of a sum in place of the average."""
        pairs = [(g, w) for (_, g), (_, w) in zip(mine["params"],
                                                  want["params"])
                 if w is not None]
        return (max(rel(a, b) for (a, _), (b, _) in zip(mine["params"],
                                                        want["params"])),
                max(rel(g, w) for g, w in pairs),
                max(rel(mine["bn"][k], v) for k, v in want["bn"].items()),
                max(rel(2 * g, w) for g, w in pairs))

    def after_steps(r, want):
        stats = [k for k in want["state"] if "running_" in k]
        return (max(rel(r["state"][k], want["state"][k]) for k in stats),
                max(rel(r["state"][k], want["state"][k])
                    for k in want["state"] if k not in stats))

    out = {"reference_wall_s": ref_wall, "one_rank_wall_s": one_wall,
           "ranks": []}
    for rank, r in enumerate(res):
        bn_worst = max(r["bn_checks"].values())
        mine = r["steps"][0]
        params_rel, grad_rel, bn1, summed = first_step(mine, seen[0])
        _, one_grad, one_bn, _ = first_step(mine, one_seen[0])
        bn2, tr2 = after_steps(r, ref)
        one_bn2, one_tr2 = after_steps(r, one)
        rec = {"bn_checks": r["bn_checks"], "loss": r["loss"],
               "reference_loss": ref["loss"], "one_rank_loss": one["loss"],
               "first_step_params_rel": params_rel,
               "first_step_worst_leaf_grad_rel": grad_rel,
               "first_step_bn_running_stats_rel": bn1,
               "first_step_worst_leaf_grad_rel_if_summed": summed,
               "bn_stats": len(seen[0]["bn"]),
               "after_steps_bn_running_stats_rel": bn2,
               "after_steps_worst_trainable_rel": tr2,
               "one_rank_first_step_worst_leaf_grad_rel": one_grad,
               "one_rank_first_step_bn_running_stats_rel": one_bn,
               "one_rank_after_steps_bn_running_stats_rel": one_bn2,
               "one_rank_after_steps_worst_trainable_rel": one_tr2,
               "steps": r["n_steps"], "wall_s": r["wall_s"],
               "launches": r["launches"]}
        out["ranks"].append(rec)
        print("dpqat rank {}: BatchNorm over dp at resnet18's shapes, worst "
              "rel {:.3e} (tol {}) {}; the CLI, {} steps in {:.2f} s (the "
              "reference {:.2f} s, the plain one rank {:.2f} s); loss {:.6f} "
              "(reference {:.6f}, plain one rank {:.6f}); held at the first "
              "step against the reference: parameters rel {:.3e} (tol "
              "1e-6), the worst leaf's gradient rel {:.3e} (tol {}; a sum "
              "in place of the average reads {:.3e}), BatchNorm's {} "
              "running statistics rel {:.3e} (tol {}); printed: after the "
              "steps, running statistics rel {:.3e} and the worst trainable "
              "rel {:.3e}; against the plain one rank, the first step's "
              "worst leaf gradient rel {:.3e} and statistics rel {:.3e}, "
              "after the steps {:.3e} / {:.3e}; launches {}".format(
                  rank, bn_worst, DPQAT_BN_TOL, r["bn_checks"], r["n_steps"],
                  r["wall_s"], ref_wall, one_wall, r["loss"], ref["loss"],
                  one["loss"], params_rel, grad_rel, DPQAT_GRAD_TOL, summed,
                  len(seen[0]["bn"]), bn1, DPQAT_BN_TOL, bn2, tr2, one_grad,
                  one_bn, one_bn2, one_tr2, r["launches"]), flush=True)
        if not (bn_worst <= DPQAT_BN_TOL and params_rel <= 1e-6
                and grad_rel <= DPQAT_GRAD_TOL and bn1 <= DPQAT_BN_TOL
                and math.isfinite(r["loss"])
                and r["n_steps"] == len(seen) == 2 and seen[0]["bn"]):
            fail("dpqat rank {}: {}".format(rank, rec))
        _expect("dpqat rank {}".format(rank), r["launches"], (),
                tuple(_wrappers()))
    if res[0]["loss"] != res[1]["loss"]:
        fail("dpqat: the ranks' losses differ")
    out["launches"] = res[0]["launches"]
    return {"dpqat": out}


def kpad_path(params, cfg):
    """Phase 4, path kpad: every W2 of main's model K-padded by
    QuantLinear.with_k_pad(1024) (11008 -> 11264 rows, the reference's
    example), served by DecodeEngine on K4 beside the unpadded model on
    the same requests (main's 8 prompts x 32 tokens): K4 launched on both,
    every decision's logits and every token equal (K4 reads each layer's
    first F rows of the padded stack, in the unpadded K split)."""
    import torch
    from sparsebit_tpu_torch.llm import llama as L
    from sparsebit_tpu_torch.llm import serving as Sv

    padded = L.quantize_llama_params(
        params, lambda p, lin: lin.with_k_pad(1024) if p.endswith("w2")
        else lin, skip=())
    kp = padded["layers"][0]["w2"].k_padded
    kw = dict(max_batch=8, max_len=512, chunk=8, device="cuda")
    runs = []
    for tag, p in (("unpadded", params), ("padded", padded)):
        eng = Sv.DecodeEngine(p, cfg, **kw)
        if not eng._stacked_chunks:
            fail("kpad: the {} model is not on K4".format(tag))
        rows = {}
        with _record_decisions(eng, rows):
            toks, st = drive(eng, _prompts(cfg), "decode_chunk_scanned",
                             "kpad ({}, W2 rows {})".format(
                                 tag, kp if tag == "padded" else cfg.ffn_dim),
                             ("K1", "K4", "K9"), time_k4=True)
        runs.append((toks, st, rows))
        del eng
        torch.cuda.empty_cache()
    (ta, sa, ra), (tb, sb, rb) = runs
    same_logits = sorted(ra) == sorted(rb) and all(
        len(ra[r]) == len(rb[r]) and all(
            torch.equal(a, b) for a, b in zip(ra[r], rb[r])) for r in ra)
    out = dict(sb, w2_rows=kp, tokens_equal=ta == tb,
               logits_equal=same_logits,
               unpadded_k4_device_ms_per_step=sa["k4_device_ms_per_step"],
               unpadded_launches=sa["launches"])
    print("kpad: W2 K-padded {} -> {}: K4 {:.3f} ms/step device (unpadded "
          "{:.3f}); tokens equal {}, every decision's logits equal {}"
          .format(cfg.ffn_dim, kp, sb["k4_device_ms_per_step"],
                  sa["k4_device_ms_per_step"], ta == tb, same_logits),
          flush=True)
    if kp != -(-cfg.ffn_dim // 1024) * 1024 or kp == cfg.ffn_dim \
            or ta != tb or not same_logits:
        fail("kpad: the padded model (W2 rows {}) differs from the unpadded "
             "one on K4 (tokens equal {}, logits equal {})".format(
                 kp, ta == tb, same_logits))
    return {"kpad": out}


OFFLOAD_PREFETCH = 2
OFFLOAD_STEPS = 8


def _layer_bytes(layer):
    from sparsebit_tpu_torch.llm.convert import map_params

    seen = []
    map_params(lambda t: seen.append(t.numel() * t.element_size()) or t,
               layer)
    return sum(seen)


def offload_path(cfg):
    """Phase 4, path offload: StreamingLlama over 32 INT4-g128 layers at
    7B widths (checkpoint layout, impl "auto": K8 for the decode steps'
    linears, the dense route at the prefill's M = 128, the plain masked
    attention, the head a matmul over (B, S, dim)) streamed from pinned
    host memory on a copy stream, prefetch 2: prefill B=1 S=128 and 8
    greedy decode steps, against the resident prefill / decode_step on the
    same params fed the same tokens (logits within 0.1, decisive argmax
    equal: the resident step attends through K5). Prints ms/token, the H2D
    GB/s streaming reaches (weight bytes a step over the step) and over
    the copy stream's busy time, a bare pinned 1 GB copy's GB/s, the share
    of copy time hidden under compute (against the same StreamingLlama over
    device-resident layers), and the peak device memory above the resident
    part while decoding, against prefetch + 1 layers."""
    import torch
    from sparsebit_tpu_torch.llm import decode as Dm
    from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
    from sparsebit_tpu_torch.llm.offload import (
        StreamingLlama, offload_llama_params)

    dev = torch.device("cuda")
    params = build_plane_params(cfg, dev, lambda li, n: 4, SEED + 14)
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=g,
                           device="cuda")
    S_max = 128 + OFFLOAD_STEPS + 8

    def run(prefill, step, toks=None, after_prefill=None):
        """prefill + OFFLOAD_STEPS decode steps (greedy, or fed toks):
        (logits list, tokens, s per call)."""
        cache = init_kv_cache(cfg, 1, S_max, device="cuda")
        times = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill(prompt, cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if after_prefill is not None:
            after_prefill()
        out, fed = [logits], []
        for i in range(OFFLOAD_STEPS):
            tok = (logits.argmax(-1).to(torch.int32) if toks is None
                   else toks[i])
            fed.append(tok)
            t = time.perf_counter()
            logits, cache = step(tok, cache)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            out.append(logits)
        return out, fed, times

    _reset_launches()
    ref, toks, res_s = run(lambda p, c: Dm.prefill(params, p, c, cfg),
                           lambda t, c: Dm.decode_step(params, t, c, cfg))
    res_launches = _launches()
    # the same code path over device-resident layers: compute alone (the
    # second of two runs; the first warms the allocator's cache)
    compute = StreamingLlama(params, cfg, OFFLOAD_PREFETCH)
    for _ in range(2):
        _, _, comp_s = run(compute.prefill, compute.decode_step, toks)
    layer_b = _layer_bytes(params["layers"][0])
    t = time.perf_counter()
    host = offload_llama_params(params)
    pin_s = time.perf_counter() - t
    pinned = all(t.is_pinned() for t in host["layers"][0]["wq"].packed.values())
    del params, compute
    torch.cuda.empty_cache()

    sl = StreamingLlama(host, cfg, OFFLOAD_PREFETCH)
    copies = []  # each layer's (start, done) events on the copy stream
    orig_fetch = sl._fetch

    def fetch(i):
        out = orig_fetch(i)
        copies.append(out[1:])
        return out

    sl._fetch = fetch
    base = torch.cuda.memory_allocated()
    peaks = []

    def prefill_peak():
        peaks.append(torch.cuda.max_memory_allocated() - base)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    got, _, str_s = run(sl.prefill, sl.decode_step, toks, prefill_peak)
    launches = _launches()
    # the decode steps' peak (the prefill's M = 128 linears take the dense
    # route, whose f32 dequantized weights dominate its peak)
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.synchronize()
    copy_ms = [a.elapsed_time(b) for a, b in copies]
    n_layers = cfg.n_layers
    step_copy_s = [sum(copy_ms[i * n_layers:(i + 1) * n_layers]) / 1e3
                   for i in range(1 + OFFLOAD_STEPS)]
    dec = slice(1, None)
    ms_tok = 1e3 * sum(str_s[dec]) / OFFLOAD_STEPS
    comp_ms = 1e3 * sum(comp_s[dec]) / OFFLOAD_STEPS
    copy_tok_ms = 1e3 * sum(step_copy_s[dec]) / OFFLOAD_STEPS
    hidden = max(0.0, min(1.0, (copy_tok_ms + comp_ms - ms_tok)
                          / copy_tok_ms))
    step_bytes = layer_b * n_layers
    big = torch.empty(2 ** 30, dtype=torch.uint8).pin_memory()
    dst = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    dst.copy_(big, non_blocking=True)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(3):
        dst.copy_(big, non_blocking=True)
    ev[1].record()
    torch.cuda.synchronize()
    bare = 3 * 2 ** 30 / (ev[0].elapsed_time(ev[1]) / 1e3) / 1e9
    del big, dst
    errs, ok = [], True
    for a, b in zip(got, ref):
        err, good = _logits_agree(a.float(), b.float())
        errs.append(err)
        ok &= good
    out = dict(prefetch=OFFLOAD_PREFETCH, layers=n_layers, prompt=128,
               decode_steps=OFFLOAD_STEPS, pinned=pinned, pin_s=pin_s,
               layer_bytes=layer_b, ms_per_token=ms_tok,
               resident_ms_per_token=1e3 * sum(res_s[dec]) / OFFLOAD_STEPS,
               compute_only_ms_per_token=comp_ms,
               copy_busy_ms_per_token=copy_tok_ms,
               prefill_s=str_s[0], h2d_gb_s_streaming=step_bytes / (
                   ms_tok / 1e3) / 1e9,
               h2d_gb_s_copy_stream=step_bytes / (copy_tok_ms / 1e3) / 1e9,
               h2d_gb_s_bare_1gb=bare, copy_hidden_share=hidden,
               peak_above_resident_bytes=peak,
               peak_in_layers=peak / layer_b,
               prefill_peak_above_resident_bytes=peaks[0],
               max_abs_err_vs_resident=max(errs), logits_agree=ok,
               launches=launches, resident_launches=res_launches)
    print("offload: {} layers of {:.1f} MB from pinned memory ({}; pinned "
          "in {:.1f} s), prefetch {}: {:.2f} ms/token (resident {:.2f}, the "
          "same code over resident layers {:.2f}), prefill S=128 {:.3f} s; "
          "H2D {:.2f} GB/s streaming, {:.2f} GB/s over the copy stream's "
          "busy time, bare pinned 1 GB copy {:.2f} GB/s; copy time hidden "
          "{:.1%}; peak device memory above resident while decoding "
          "{:.1f} MB = {:.2f} layers (prefill {:.1f} MB); logits vs resident "
          "max err {:.4f} (atol 0.1, decisive argmax equal: {}); launches {}"
          .format(
              n_layers, layer_b / 1e6, pinned, pin_s, OFFLOAD_PREFETCH,
              ms_tok, out["resident_ms_per_token"], comp_ms, str_s[0],
              out["h2d_gb_s_streaming"], out["h2d_gb_s_copy_stream"], bare,
              hidden, peak / 1e6, peak / layer_b, peaks[0] / 1e6, max(errs),
              ok, launches),
          flush=True)
    if not ok:
        fail("offload: streamed logits differ from the resident ones "
             "(max err {:.4f})".format(max(errs)))
    if not pinned:
        fail("offload: the host layers are not pinned")
    if peak > (OFFLOAD_PREFETCH + 2) * layer_b:
        fail("offload: decoding peaks {:.1f} MB above resident, more than "
             "prefetch + 2 layers".format(peak / 1e6))
    # the head is applied to (B, 1, dim) rows as the reference applies it
    # (offload.py:150), which the bf16 matvec K9 does not take
    _expect("offload", launches, ("K8",), ("K5", "K4"))
    del sl, host
    torch.cuda.empty_cache()
    return {"offload": out}


def _fq_check(tag, x, s, zp, qmin, qmax, g):
    """fake_quant forward and backward on the card against the CPU on the
    same tensors: forward and gx equal, gs and gzp within n * 2^-24 * sum
    |term| twice (two f32 sums of the same terms in any order). Returns
    (stats, ok)."""
    import torch
    from sparsebit_tpu_torch.quantization import fake_quant as FQ

    gy = torch.randn(x.shape, generator=g, device="cuda")
    res = {}
    def leaf(t, dev):
        return t.detach().to(dev).clone().requires_grad_(True)

    for dev in ("cuda", "cpu"):
        xt, st, zt = leaf(x, dev), leaf(s, dev), leaf(zp, dev)
        if dev == "cuda":
            fwd_ms = cuda_ms(lambda i: FQ.fake_quant(xt, st, zt, qmin, qmax),
                             10)
        y = FQ.fake_quant(xt, st, zt, qmin, qmax)
        y.backward(gy.to(dev))
        res[dev] = [t.detach().cpu() for t in (y, xt.grad, st.grad, zt.grad)]
    # the elementwise terms, for the sums' bound
    sf = leaf(s.expand(x.shape), "cpu")
    zf = leaf(zp.expand(x.shape), "cpu")
    FQ.fake_quant(x.detach().cpu(), sf, zf, qmin, qmax).backward(gy.cpu())
    n = x.numel() // s.numel()
    (y, gx, gs, gz), (yc, gxc, gsc, gzc) = res["cuda"], res["cpu"]
    errs, ok = {}, torch.equal(y, yc) and torch.equal(gx, gxc)
    for name, a, b, terms in (("gs", gs, gsc, sf.grad), ("gzp", gz, gzc,
                                                          zf.grad)):
        abs_sum = FQ._reduce_to_shape(terms.abs(), s.shape)
        bound = 2 * n * 2.0 ** -24 * abs_sum + 1e-30
        errs[name] = float((a - b).abs().max())
        ok &= bool(((a - b).abs() <= bound).all())
    st = dict(shape=list(x.shape), qparams=list(s.shape), fwd_ms=fwd_ms,
              forward_equal=bool(torch.equal(y, yc)),
              gx_equal=bool(torch.equal(gx, gxc)), max_abs_err=errs)
    print("quantcore: fake_quant {} {}: forward {} and gx {} the CPU's, gs "
          "/ gzp max err {} within n 2^-24 sum|term|: {}; forward {:.4f} ms"
          .format(tag, list(x.shape), "equal" if st["forward_equal"] else
                  "DIFFER", "equal" if st["gx_equal"] else "DIFFER", errs,
                  ok, fwd_ms), flush=True)
    return st, ok


def _qcfg(target, qscheme, observer="minmax", qtype="uniform", bit=4):
    from sparsebit_tpu_torch.quantization.common import QuantTarget
    from sparsebit_tpu_torch.utils.config import CfgNode

    return CfgNode({
        "TARGET": [getattr(QuantTarget, target)], "QSCHEME": qscheme,
        "QUANTIZER": {"TYPE": qtype, "BIT": bit, "GROUPSIZE": -1},
        "OBSERVER": {"TYPE": observer, "PERCENTILE": {"ALPHA": 0.001},
                     "LAYOUT": "NLC"}})


QUANTCORE_CPU_ROWS = 2048  # rows of the weight the CPU repeats


def quantcore_path():
    """Phase 4, path quantcore: the graph regime's bottom layer on the
    card against the port on the CPU (no kernel: elementwise PyTorch).
    fake_quant forward and backward per tensor on a (2048, 4096)
    activation and per channel on an (11008, 4096) weight: forward and gx
    equal, gs and gzp within the f32 bound of a sum in another order. An
    LSQ quantizer's step on the weight (4-bit per channel: calibration,
    fake-quant MSE, backward, one Adam step): the scale gradients within
    the same bound of the CPU's. minmax, mse and percentile qparams per
    channel on the weight (the card on all rows, timed; the CPU on the
    first 2048, equal for minmax and percentile; mse's choice within
    rounding of the CPU's least loss), and percentile per tensor over all
    45M elements on the card (a sort: torch.quantile refuses past
    2^24)."""
    import torch
    from sparsebit_tpu_torch.quantization import fake_quant as FQ
    from sparsebit_tpu_torch.quantization.observers import build_observer
    from sparsebit_tpu_torch.quantization.quant_descriptor import (
        QuantDescriptor)
    from sparsebit_tpu_torch.quantization.quantizers import build_quantizer

    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    out = {}
    ok_all = True
    act = torch.randn((2048, 4096), generator=g, device="cuda") * 2
    st, ok = _fq_check("per tensor", act, torch.tensor(0.05),
                       torch.tensor(3.0), 0, 255, g)
    out["fake_quant_per_tensor"] = st
    ok_all &= ok
    w = torch.randn((11008, 4096), generator=g, device="cuda") * 0.02
    s = (w.abs().amax(1, keepdim=True) / 7).cpu()
    st, ok = _fq_check("per channel", w, s, torch.zeros_like(s), -8, 7, g)
    out["fake_quant_per_channel"] = st
    ok_all &= ok

    cpu_w = w[:QUANTCORE_CPU_ROWS].cpu()
    obs = {}
    for name in ("minmax", "mse", "percentile"):
        cfg = _qcfg("WEIGHT", "per-channel-symmetric", observer=name)
        res = {}
        for dev, data in (("cuda", w), ("cpu", cpu_w)):
            o = build_observer(cfg, QuantDescriptor(cfg))
            o.update(data)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sc, zp = o.calc_qparams()
            torch.cuda.synchronize()
            res[dev] = (sc.cpu(), zp.cpu(), time.perf_counter() - t)
        (sa, za, ta), (sb, zb, tb) = res["cuda"], res["cpu"]
        sa, za = sa[:QUANTCORE_CPU_ROWS], za[:QUANTCORE_CPU_ROWS]
        if name == "mse":
            # each channel's loss at the card's choice and at the CPU's
            def loss(sc, zp):
                dq = FQ.fake_quant(cpu_w, sc[:, None], zp[:, None], -8, 7)
                return ((cpu_w - dq) ** 2).sum(-1) / cpu_w.shape[1]

            la, lb = loss(sa, za), loss(sb, zb)
            differ = int((sa != sb).sum())
            good = bool((la <= lb * (1 + 2 * 4096 * 2.0 ** -24)).all())
        else:
            differ = int((sa != sb).sum() + (za != zb).sum())
            good = differ == 0
        obs[name] = dict(card_s=ta, cpu_s_rows=tb, channels_differ=differ,
                         held=good)
        ok_all &= good
        print("quantcore: {} per channel on the (11008, 4096) weight: card "
              "{:.3f} s; the first {} rows on the CPU ({:.3f} s): {} "
              "channels differ, held {}".format(
                  name, ta, QUANTCORE_CPU_ROWS, tb, differ, good), flush=True)
    cfg = _qcfg("WEIGHT", "per-tensor-symmetric", observer="percentile")
    o = build_observer(cfg, QuantDescriptor(cfg))
    o.update(w)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mn, mx = o.calc_minmax()
    torch.cuda.synchronize()
    srt = torch.sort(w.reshape(-1)).values
    n = srt.numel()
    pos, neg = int((w >= 0).sum()), int((w < 0).sum())
    want = (srt[max(round(neg * 0.001), 1) - 1],
            srt[n - round(pos * 0.001) - 1])
    good = bool(mn == want[0]) and bool(mx == want[1])
    obs["percentile_per_tensor_45M"] = dict(card_s=time.perf_counter() - t,
                                            held=good)
    ok_all &= good
    print("quantcore: percentile per tensor over {} elements on the card: "
          "({:.6f}, {:.6f}), the sorted order's kth values: {}".format(
              n, float(mn), float(mx), good), flush=True)
    out["observers"] = obs

    # LSQ: the card's quantizer calibrates (its initial scale, a mean
    # |w| a channel, within 1e-5 of the CPU's: a reduction), then both
    # start from the card's scale, take the fake-quant MSE's gradient and
    # one Adam step
    from sparsebit_tpu_torch.quantization.quantizers.base import learnable

    cfg = _qcfg("WEIGHT", "per-channel-symmetric", qtype="lsq")
    grads, init = {}, None
    for dev, data in (("cuda", w), ("cpu", w.cpu())):
        q = build_quantizer(cfg)
        q.update_observer(data)
        q.calc_qparams()
        if init is None:
            init = q.scale.detach().cpu().clone()
        else:
            init_err = float(((q.scale.detach() - init).abs()
                              / init.abs()).max())
            q.scale = learnable(init)
        q.enable_quant()
        opt = torch.optim.Adam([q.scale], lr=1e-3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = q(data)
        loss = ((y - data) ** 2).mean()
        loss.backward()
        grad = q.scale.grad.detach().cpu().clone()
        opt.step()
        torch.cuda.synchronize()
        grads[dev] = (grad, q.scale.detach().cpu(), loss.item(),
                      time.perf_counter() - t, y.detach().cpu())
    (ga, sa, la, ta, ya), (gb, sb, lb, tb, yb) = grads["cuda"], grads["cpu"]
    # each channel's scale gradient is ratio times a sum of 4096 terms,
    # each |d loss / dy| = 2 |y - w| / N times at most 8 (qmax - zp or
    # qmin - zp at 4 bits, or |round(x/s) - x/s| <= 1/2)
    wc = w.cpu()
    ratio = 1.0 / (4096 * 7) ** 0.5
    term_sum = (2 * (yb - wc).abs() / wc.numel() * 8).sum(1)
    bound = 2 * 4096 * 2.0 ** -24 * ratio * term_sum + 1e-30
    err = (ga - gb).abs().reshape(-1)
    good = bool(torch.equal(ya, yb)) and bool((err <= bound).all()) \
        and init_err <= 1e-5
    out["lsq_step"] = dict(card_s=ta, cpu_s=tb, loss_card=la, loss_cpu=lb,
                           init_scale_rel_err=init_err,
                           forward_equal=bool(torch.equal(ya, yb)),
                           grad_max_abs_err=float(err.max()), held=good,
                           scale_max_abs_diff_after=float((sa - sb).abs()
                                                          .max()))
    ok_all &= good
    print("quantcore: LSQ step on the weight: card {:.3f} s (CPU {:.3f} s), "
          "initial scale rel err {:.2e}, forward equal {}, loss {:.6e} / "
          "{:.6e}, scale grads max err {:.3e} within the sum bound: {}; "
          "scales after one Adam step differ by {:.3e}".format(
              ta, tb, init_err, out["lsq_step"]["forward_equal"], la, lb,
              float(err.max()), good,
              out["lsq_step"]["scale_max_abs_diff_after"]), flush=True)
    if not ok_all:
        fail("quantcore: the card differs from the CPU ({})".format(out))
    return {"quantcore": out}


# ---- phase 4: the graph regime (no kernel of its own: PyTorch calls) ------

# the PTQ basecase's scheme (read without PyYAML where it is missing:
# utils.config.load_yaml)
BASECASE_QCONFIG = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "examples",
    "post_training_quantization", "imagenet1k_basecase", "qconfig.yaml")
GRAPH_BATCH, GRAPH_CALIB_BATCHES, GRAPH_EVAL = 64, 16, 2048  # main.py's
GRAPH_CPU_BATCH = 8  # the card against the CPU
# channels of a per-channel activation the CPU repeats: a feature map's
# first 4, the fc input's first 64 (the CPU's KL search takes ~0.07 s a
# channel)
CPU_CHANNELS, CPU_FC_CHANNELS = 4, 64
CALIB_BATCH = 16  # graphcalib: one calibration batch
ADAROUND_STEPS = 10000  # half the reference's budget (adaround.py:66)
# AdaRound's layers, each with the bound held on its hard-rounded loss as
# a multiple of rounding to nearest's. conv1 reads i.i.d. N(0, 1) pixels,
# so its loss is a multiple of the summed squared weight errors, which
# rounding to nearest minimises: it can tie, not win. The layer1 convs
# read correlated activations; at 20000 steps, with the reconstruction
# loss averaged over pixels (the reference's), they reach 0.10 and 0.09
# of nearest's and conv1 0.9990, where an AdaRound that never steps keeps
# nearest's rounding but for ties (adaround_probe.py, H100 80GB HBM3,
# 700 W); at 10000 steps 0.1053, 0.0936 and 0.9990 (graphcalib_path alone
# on the same card), so the half budget keeps the whole run well inside
# its time limit (AdaRound took 326 s of a 1012 s run at 20000 steps).
ADAROUND_LAYERS = {"conv1": 1.001, "layer1.0.conv1": 0.75,
                   "layer1.0.conv2": 0.75}


_GRAPH = {}  # graphptq's calibrated W8A8 resnet18, for deploy and export


def _images(gen, n, size=224):
    import torch

    return torch.randn((n, size, size, 3), generator=gen, device="cuda")


def _rel_mse(a, b):
    return float(((a - b) ** 2).mean() / ((b ** 2).mean() + 1e-12))


def _calibrate(qmodel, batches, asym=False, cpu_pick=None):
    """prepare_calibration, the capture of ``batches`` and calc_qparams
    (asym: with w_quant and a_quant), every quantizer's calc_qparams
    timed (synchronised). ``cpu_pick(quantizer)``: whether to copy the
    quantizer's observed data to the CPU first (a per-channel feature's
    first CPU_CHANNELS channels, CPU_FC_CHANNELS of a 2-D one: channels
    are searched independently) and
    compute the same observer there. Returns (seconds, [(quantizer, data, card scale, card
    zero point, CPU scale, CPU zero point)])."""
    import torch
    from sparsebit_tpu_torch.quantization.quantizers.base import Quantizer

    orig = Quantizer.calc_qparams
    times = {"FEATURE": [], "WEIGHT": []}
    cpu = []

    def timed(self):
        if self.fake_fused:
            return orig(self)
        data = None
        if cpu_pick is not None and cpu_pick(self):
            data = [d[..., :CPU_CHANNELS if d.dim() > 2 else CPU_FC_CHANNELS]
                    .cpu() if self.qdesc.is_perchannel else d.cpu()
                    for d in self.observer.data_cache.get_data_cache()]
        torch.cuda.synchronize()
        t = time.perf_counter()
        scale, zp = orig(self)
        torch.cuda.synchronize()
        times[self.qdesc.target.name].append(time.perf_counter() - t)
        if data is not None:
            o = type(self.observer)(self.observer.cfg, self.qdesc)
            for d in data:
                o.update(d)
            cs, cz = o.calc_qparams()
            n = cs.numel()  # per channel: the first channels
            cpu.append((self, data, scale.reshape(-1)[:n].cpu(),
                        zp.reshape(-1)[:n].cpu(), cs.reshape(-1),
                        cz.reshape(-1)))
        return scale, zp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel.prepare_calibration()
    for b in batches:
        qmodel(b)
    torch.cuda.synchronize()
    capture = time.perf_counter() - t0
    with _Patched([(Quantizer, "calc_qparams", timed)]):
        t0 = time.perf_counter()
        qmodel.calc_qparams(asym, asym, asym)
        torch.cuda.synchronize()
        calc = time.perf_counter() - t0
    obs = sum(times["FEATURE"]) + sum(times["WEIGHT"])
    return dict(capture_s=capture, calc_qparams_s=calc,
                observers_s=obs, layerwise_forward_s=calc - obs,
                activation_quantizers=len(times["FEATURE"]),
                weight_quantizers=len(times["WEIGHT"]),
                s_a_activation_quantizer=(sum(times["FEATURE"]) / max(
                    1, len(times["FEATURE"])))), cpu


def _cpu_held(rec, rtol=1e-5):
    """The card's qparams against the same observer's on the CPU over the
    same data: scale within rtol relative and zero points equal (MinMax,
    ACIQ: reductions; KL: the same candidate); MSE: the card's choice no
    worse on the CPU's loss than the CPU's own choice, within the f32
    bound of two sums of the same N terms (2 N 2^-24). Returns (max scale
    rel err, zero points differing, held)."""
    import torch
    from sparsebit_tpu_torch.quantization.fake_quant import fake_quant

    err, zdiff, ok = 0.0, 0, True
    for q, data, s, z, cs, cz in rec:
        if q.observer.TYPE == "mse":
            x = torch.cat([d.reshape(-1) for d in data]).double()
            loss = [float(((fake_quant(x, a.double(), b.double(),
                                       *q.qdesc.qrange) - x) ** 2).mean())
                    for a, b in ((s, z), (cs, cz))]
            ok &= loss[0] <= loss[1] * (1 + 2 * x.numel() * 2.0 ** -24)
            continue
        e = float(((s - cs).abs() / cs.abs()).max())
        d = int((z != cz).sum())
        err, zdiff = max(err, e), zdiff + d
        ok &= e <= rtol and d == 0
    return err, zdiff, ok


def graphptq_path():
    """Phase 4, path graphptq: the PTQ basecase flow
    (imagenet1k_basecase/main.py) at full width on the card: resnet18
    with seeded weights made on the card, 224 x 224 x 3 NHWC, batch 64,
    qconfig.yaml's W8 per-channel-symmetric / A8 per-tensor-affine MinMax
    scheme; QuantModel -> prepare_calibration -> 16 calibration batches ->
    calc_qparams -> set_quant(True, True), then 2048 seeded eval images.
    Prints the seconds of trace + convert, capture, the layerwise walk and
    the observers' qparams; float and fake-quant ms per batch and images/s
    (CUDA events after warm-up); the peak device memory of calibration;
    node counts. Held: quantizers off equal to the float model within
    atol 1e-4; w8a8 relative MSE in (0, 5e-2); the card's qparams of every
    quantizer against the port's on the CPU at batch 8 over the same
    images and weights (cuDNN TF32 off): scales within 1e-5 relative,
    zero points equal. The graph regime launches no kernel of the port
    (the JAX package has no Pallas kernel there)."""
    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.nn.graph import Tracer

    torch.backends.cudnn.allow_tf32 = False
    cfg = parse_qconfig(BASECASE_QCONFIG)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    model = create_model("resnet18", seed=SEED, device="cuda").eval()
    calib = [_images(gen, GRAPH_BATCH) for _ in range(GRAPH_CALIB_BATCHES)]
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = QuantModel(model, cfg, (calib[0],))
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    n_traced = len(Tracer().trace(model, (calib[0][:1],)).op_nodes)
    quantizers = [q for _, op in qmodel.qmodules()
                  for q in (op.input_quantizer, op.weight_quantizer)
                  if q is not None]
    nodes = dict(traced=n_traced, after_build_and_fuse=len(
        qmodel.graph.op_nodes), qmodules=len(list(qmodel.qmodules())),
        quantizers=len(quantizers),
        fake_fused=sum(q.fake_fused for q in quantizers))
    with torch.no_grad():
        off_err = float((qmodel(calib[0]) - model(calib[0])).abs().max())
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, _ = _calibrate(qmodel, calib)
    peak = torch.cuda.max_memory_allocated() - base
    qmodel.set_quant(w_quant=True, a_quant=True)
    egen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    f_out, q_out = [], []
    with torch.no_grad():
        for _ in range(GRAPH_EVAL // GRAPH_BATCH):
            x = _images(egen, GRAPH_BATCH)
            f_out.append(model(x))
            q_out.append(qmodel(x))
        float_ms = cuda_ms(lambda i: model(x), 10)
        quant_ms = cuda_ms(lambda i: qmodel(x), 10)
    launches = _launches()
    f, q = torch.cat(f_out), torch.cat(q_out)
    rel = _rel_mse(q, f)
    agree = float((q.argmax(1) == f.argmax(1)).float().mean())

    # the card against the CPU at batch 8: the same images and weights
    s_err, z_diff, n_q, cpu_s = _qparams_card_vs_cpu(
        model, cfg, calib[0][:GRAPH_CPU_BATCH])
    cpu_ok = s_err <= 1e-5 and z_diff == 0
    del calib
    _GRAPH.update(model=model, qmodel=qmodel, x=x)
    out = dict(times, trace_convert_s=trace_s, nodes=nodes,
               quant_off_max_err=off_err, calib_peak_bytes=peak,
               float_ms_per_batch=float_ms, quant_ms_per_batch=quant_ms,
               float_images_s=GRAPH_BATCH / float_ms * 1e3,
               quant_images_s=GRAPH_BATCH / quant_ms * 1e3,
               w8a8_rel_mse=rel, top1_agreement=agree, eval_images=len(f),
               cpu_batch=GRAPH_CPU_BATCH, cpu_quantizers=n_q,
               cpu_scale_max_rel_err=s_err, cpu_zero_points_differ=z_diff,
               cpu_calibration_s=cpu_s, launches=launches)
    print("graphptq: resnet18 224x224 B={} x {} calibration batches: trace "
          "+ convert {:.3f} s, capture {:.3f} s, calc_qparams {:.3f} s "
          "(layerwise forward {:.3f} s, observers {:.3f} s over {} "
          "activation / {} weight quantizers), calibration peak {:.2f} GB; "
          "nodes {}; quant off vs float max err {:.2e}; float {:.3f} ms / "
          "batch ({:.0f} images/s), fake-quant {:.3f} ms / batch ({:.0f} "
          "images/s); w8a8 rel MSE {:.3e} over {} images, top-1 agreement "
          "{:.4f}; card vs CPU at B={}: {} quantizers, scales max rel err "
          "{:.2e}, {} zero points differ; launches {}".format(
              GRAPH_BATCH, GRAPH_CALIB_BATCHES, trace_s, times["capture_s"],
              times["calc_qparams_s"], times["layerwise_forward_s"],
              times["observers_s"], times["activation_quantizers"],
              times["weight_quantizers"], peak / 1e9, nodes, off_err,
              float_ms, out["float_images_s"], quant_ms,
              out["quant_images_s"], rel, len(f), agree, GRAPH_CPU_BATCH,
              n_q, s_err, z_diff, launches), flush=True)
    if off_err > 1e-4:
        fail("graphptq: quantizers off differ from the float model by "
             "{:.2e}".format(off_err))
    if not 0 < rel < 5e-2:
        fail("graphptq: w8a8 relative MSE {:.3e} outside (0, 5e-2)".format(
            rel))
    if not cpu_ok:
        fail("graphptq: the card's qparams differ from the CPU's (scale "
             "rel err {:.2e}, {} zero points)".format(s_err, z_diff))
    _expect("graphptq", launches, (), tuple(launches))
    torch.cuda.empty_cache()
    return {"graphptq": out}


def capture_adaround_layers(qmodel, x, max_steps=None):
    """Calibrate ``qmodel`` on the batch ``x`` and record each AdaRound
    layer's reconstruct_qlayer call: {node name: (QModule, its calibration
    inputs, their float outputs, seconds a step)}. With ``max_steps`` the
    layers are reconstructed at that budget (timed, synchronised);
    without, they are left as calibration found them (no v)."""
    import torch
    from sparsebit_tpu_torch.quantization.quantizers import adaround

    names = {id(op): name for name, op in qmodel.qmodules()}
    orig = adaround.reconstruct_qlayer
    got = {}

    def record(layer, inputs, outputs, **kw):
        secs = None
        if max_steps is not None:
            torch.cuda.synchronize()
            t = time.perf_counter()
            orig(layer, inputs, outputs, **kw)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t) / kw["max_steps"]
        got[names[id(layer)]] = (layer, inputs, outputs, secs)
        return layer

    qmodel.prepare_calibration()
    qmodel(x)
    if max_steps is not None:
        qmodel.calibration_runner.adaround_max_steps = max_steps
    with _Patched([(adaround, "reconstruct_qlayer", record)]):
        qmodel.calc_qparams()
    return got


def adaround_losses(op, inputs, outputs):
    """reconstruct_qlayer's reconstruction loss (|.|^2 summed over a
    sample, averaged over samples) of the QModule ``op``'s layer on its
    calibration inputs against their float outputs, for the
    rectified-sigmoid weight that AdaRound trains, for its hard rounding
    and for rounding to nearest: (soft, hard, nearest)."""
    import torch

    wq, w = op.weight_quantizer, op.get_weight().detach()
    assert wq.TYPE == "adaround" and wq.is_enable and wq.v is not None
    qmin, qmax = wq.qdesc.qrange
    was = wq.training
    with torch.no_grad():
        def loss(wt):
            d = op.module.execute(inputs, params={"weight": wt}) - outputs
            return float((d ** 2).sum() / d.shape[0])

        nearest = ((torch.round(w / wq.scale) + wq.zero_point).clamp(
            qmin, qmax) - wq.zero_point) * wq.scale
        wq.train(True)
        soft = loss(wq(w))
        wq.train(False)
        hard = loss(wq(w))
        wq.train(was)
        return soft, hard, loss(nearest)


def graphcalib_path():
    """Phase 4, path graphcalib: the other calibrators on resnet18 (seeded
    card weights) over one batch of 16 seeded 224 x 224 images: the
    basecase scheme calibrated asymmetrically (asym=True, each layer on
    its quantized predecessors); the aciq, kl_histogram (2048 bins; per
    tensor, and per channel) and mse activation observers, each with
    seconds a quantizer, the w8a8 relative MSE against float, and the
    card's qparams held against the same observer's on the CPU over the
    same data (``_cpu_held``; every activation quantizer, a per-channel
    feature map's first 4 channels, the fc input's first 64; MSE every
    fourth; none checked fails); for per-channel KL, the w8a8 relative
    MSE with each activation quantizer left out in turn, the largest
    drop printed. AdaRound W4 (per channel) on the first three convs
    through the calibration at adaround_max_steps = ADAROUND_STEPS, s a
    step, and each layer's reconstruction loss on its
    calibration inputs (``adaround_losses``): the hard-rounded weight's
    held to its bound in ADAROUND_LAYERS as a multiple of rounding to
    nearest's, the rectified sigmoid's printed."""
    import copy

    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.utils.config import load_yaml

    torch.backends.cudnn.allow_tf32 = False
    model = create_model("resnet18", seed=SEED, device="cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    x = _images(gen, CALIB_BATCH)
    with torch.no_grad():
        ref = model(x)
    base = load_yaml(BASECASE_QCONFIG)

    def cfg_with(a_obs=None, a_scheme=None, w_type=None, w_bit=None):
        d = copy.deepcopy(base)
        if a_obs:
            d["A"]["OBSERVER"]["TYPE"] = a_obs
        if a_scheme:
            d["A"]["QSCHEME"] = a_scheme
        if w_type:
            d["W"]["QUANTIZER"]["TYPE"] = w_type
        if w_bit:
            d["W"]["QUANTIZER"]["BIT"] = w_bit
        return parse_qconfig(d)

    def feature(q):
        return q.qdesc.target.name == "FEATURE"

    every4 = {"n": 0}

    def fourth(q):
        if not feature(q):
            return False
        every4["n"] += 1
        return every4["n"] % 4 == 1

    def rel_mse(qmodel):
        with torch.no_grad():
            return _rel_mse(qmodel(x), ref)

    def leave_one_out(qmodel):
        """{node: w8a8 rel MSE with that node's input quantizer off}"""
        drops = {}
        for name, op in qmodel.qmodules():
            iq = op.input_quantizer
            if iq is None or iq.fake_fused or not iq.is_enable:
                continue
            op.set_quant(w_quant=True, a_quant=False)
            drops[name] = rel_mse(qmodel)
            op.set_quant(w_quant=True, a_quant=True)
        return drops

    cases = [("asym minmax", cfg_with(), True, feature),
             ("aciq", cfg_with("ACIQ"), False, feature),
             ("kl_histogram per tensor", cfg_with("KL_HISTOGRAM"), False,
              feature),
             ("kl_histogram per channel", cfg_with(
                 "KL_HISTOGRAM", "per-channel-affine"), False, feature),
             ("mse", cfg_with("MSE"), False, fourth)]
    out, launches_all = {}, {}
    _reset_launches()
    for tag, cfg, asym, pick in cases:
        qmodel = QuantModel(model, cfg, (x,))
        times, rec = _calibrate(qmodel, [x], asym=asym, cpu_pick=pick)
        qmodel.set_quant(w_quant=True, a_quant=True)
        rel = rel_mse(qmodel)
        err, zd, ok = _cpu_held(rec)
        ok &= len(rec) > 0
        # the basecase scheme keeps graphptq's bound; the other observers'
        # errors are printed, per-channel KL's with its largest contributor
        ok &= rel < 5e-2 if asym else math.isfinite(rel)
        out[tag] = dict(times, w8a8_rel_mse=rel, cpu_checked=len(rec),
                        cpu_scale_max_rel_err=err, cpu_zero_points_differ=zd,
                        held=ok)
        note = ""
        if tag == "kl_histogram per channel":
            drops = leave_one_out(qmodel)
            worst = min(drops, key=drops.get)
            out[tag].update(leave_one_out=drops, largest_drop=worst)
            note = "; without {}'s input quantizer {:.3e} (next lowest " \
                "{:.3e})".format(worst, drops[worst], sorted(
                    drops.values())[1])
        print("graphcalib: {}: calc_qparams {:.3f} s ({:.4f} s an "
              "activation quantizer over {}), w8a8 rel MSE {:.3e}{}; {} "
              "quantizers against the CPU: scales max rel err {:.2e}, {} "
              "zero points differ, held {}".format(
                  tag, times["calc_qparams_s"],
                  times["s_a_activation_quantizer"],
                  times["activation_quantizers"], rel, note, len(rec), err,
                  zd, ok), flush=True)
        if not ok:
            fail("graphcalib: {} ({})".format(tag, out[tag]))
        del qmodel

    # AdaRound W4 on the first three convs, uniform W4 elsewhere
    qmodel = QuantModel(model, cfg_with(w_bit=4), (x,))
    ada_cfg = cfg_with(w_type="adaround", w_bit=4)
    for name in ADAROUND_LAYERS:
        qmodel.get_qmodule(name).build_quantizer(ada_cfg)
    t0 = time.perf_counter()
    got = capture_adaround_layers(qmodel, x, ADAROUND_STEPS)
    torch.cuda.synchronize()
    ada_s = time.perf_counter() - t0
    qmodel.set_quant(w_quant=True, a_quant=True)
    layers, ok = {}, sorted(got) == sorted(ADAROUND_LAYERS)
    for name, (op, inputs, outputs, sps) in got.items():
        ls, la, ln = adaround_losses(op, inputs, outputs)
        bound = ADAROUND_LAYERS[name]
        layers[name] = dict(s_per_step=sps, soft_loss=ls, adaround_loss=la,
                            nearest_loss=ln, hard_over_nearest=la / ln,
                            bound=bound, held=la <= bound * ln)
        ok &= la <= bound * ln
    rel = rel_mse(qmodel)
    launches_all.update(_launches())
    out["adaround"] = dict(layers=layers, max_steps=ADAROUND_STEPS,
                           calc_qparams_s=ada_s, w4a8_rel_mse=rel, held=ok)
    print("graphcalib: AdaRound W4 on {} at adaround_max_steps = {}: s a "
          "step {}; calc_qparams {:.3f} s; reconstruction loss soft / "
          "hard-rounded / nearest rounding's (hard / nearest, bound) {}; "
          "w4a8 rel MSE {:.3e}; held {}".format(
              tuple(ADAROUND_LAYERS), ADAROUND_STEPS,
              {k: "{:.5f}".format(v["s_per_step"]) for k, v in
               layers.items()}, ada_s,
              {k: "{:.4g} / {:.4g} / {:.4g} ({:.4f}, {})".format(
                  v["soft_loss"], v["adaround_loss"], v["nearest_loss"],
                  v["hard_over_nearest"], v["bound"])
               for k, v in layers.items()}, rel, ok), flush=True)
    if not ok:
        fail("graphcalib: AdaRound ({})".format(out["adaround"]))
    out["launches"] = launches_all
    _expect("graphcalib", launches_all, (), tuple(launches_all))
    del qmodel, got
    torch.cuda.empty_cache()
    return {"graphcalib": out}


def cnnfixture_path():
    """Phase 4, path cnnfixture: the graph regime's accuracy fixture on the
    card at the artifact's settings, run_cnn_fixture() (300 steps, 4096
    training / 2048 eval images, w8a8 and w4a8). Held: the claims of
    tests/test_fixture_cnn.py (top-1 > 0.6; int8 PTQ < 2 points; w4a8 <
    15 points and not above w8a8 + 2). Its record goes under "cnn_ptq"
    in accuracy/ACCURACY_torch.json."""
    import torch
    from sparsebit_tpu_torch.quantization.tools.fixture import (
        run_cnn_fixture,
    )

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    t0 = time.perf_counter()
    res = run_cnn_fixture(device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches()
    f, q8, q4 = res["acc_float"], res["acc_w8a8"], res["acc_w4a8"]
    held = {"learned": f > 0.6, "int8 PTQ < 2 points": q8 > f - 0.02,
            "w4a8 < 15 points, <= w8a8 + 2": q4 > f - 0.15
            and q4 <= q8 + 0.02}
    print("cnnfixture: top-1 float {:.4f}, w8a8 {:.4f}, w4a8 {:.4f} "
          "({} steps, {} / {} images) in {:.2f} s; claims {}".format(
              f, q8, q4, res["train_steps"], res["n_train"], res["n_eval"],
              secs, held), flush=True)
    for claim, ok in held.items():
        if not ok:
            fail("cnnfixture: {} does not hold ({})".format(claim, res))
    _expect("cnnfixture", launches, (), tuple(launches))
    return {"cnnfixture": dict(res, seconds=secs, claims=held,
                               launches=launches)}


# ---- phase 4: QAT, the error profiler, deploy and export, the transformer
# ---- zoo (the graph regime; no kernel of its own: PyTorch calls)

QAT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "quantization_aware_training")
PTQ_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "post_training_quantization")
QAT_YAMLS = ("qconfig_lsq.yaml", "qconfig_lsq_plus.yaml",
             "qconfig_pact.yaml", "qconfig_dorefa.yaml")
DEIT_YAMLS = ("qconfig_lsq.yaml", "qconfig_gelu_lsqplus.yaml")
QAT_BATCH, QAT_CALIB, QAT_WARMUP, QAT_STEPS = 64, 4, 3, 10
QAT_LR = 1e-4  # the resnet18 QAT CLI's default
BERT_BATCH, BERT_SEQ, BERT_CALIB = 32, 128, 8


class _StepTimer:
    """Splits each QAT step (``make_qat_step``'s) into forward, backward
    and optimiser seconds: the loss function is entered when the forward
    has run, the optimiser's ``step`` when the backward has; the card is
    synchronised at each mark."""

    def __init__(self, loss_fn, optimizer):
        import torch

        self.times = []
        self._t = None
        orig = optimizer.step

        def loss(*a):
            torch.cuda.synchronize()
            self._t.append(time.perf_counter())
            return loss_fn(*a)

        def step(*a, **kw):
            torch.cuda.synchronize()
            self._t.append(time.perf_counter())
            r = orig(*a, **kw)
            torch.cuda.synchronize()
            self._t.append(time.perf_counter())
            return r

        optimizer.step = step
        self.loss_fn = loss

    def run(self, fn):
        import torch

        torch.cuda.synchronize()
        self._t = [time.perf_counter()]
        r = fn()
        t0, t1, t2, t3 = self._t
        self.times.append((t1 - t0, t2 - t1, t3 - t2))
        return r

    def summary(self, skip):
        import statistics

        rows = self.times[skip:]
        f, b, o = (statistics.median(c) for c in zip(*rows))
        total = [sum(r) for r in rows]
        return dict(s_per_step=statistics.median(total),
                    s_per_step_min=min(total), s_per_step_max=max(total),
                    forward_s=f, backward_s=b, optimizer_s=o,
                    timed_steps=len(rows))


def _quant_leaves(trainable):
    return {(n, k): v.detach().clone() for n, p in trainable.items()
            for k, v in p.items() if "quantizer" in k}


def _qat_run(qmodel, calib, batches, labels, loss_fn, make_opt, tag):
    """Calibrate, init_QAT and QAT_WARMUP + QAT_STEPS steps of
    ``make_qat_step`` on the card, timed; returns the figures, and the
    loss and learnables checks (held by the caller)."""
    import torch
    from sparsebit_tpu_torch.quantization.tools.qat import (
        init_qat_state,
        make_qat_step,
    )

    t0 = time.perf_counter()
    qmodel.prepare_calibration()
    for b in calib:
        qmodel(b)
    qmodel.init_QAT()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    qmodel.train()
    trainable, opt = init_qat_state(qmodel, make_opt)
    before = _quant_leaves(trainable)
    timer = _StepTimer(loss_fn, opt)
    step = make_qat_step(qmodel, timer.loss_fn, opt)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(QAT_WARMUP + QAT_STEPS):
        j = i % len(batches)
        trainable, loss = timer.run(lambda: step(trainable, batches[j],
                                                 labels[j]))
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated() - base
    after = _quant_leaves(trainable)
    moved = sum(not torch.equal(v, after[k]) for k, v in before.items())
    qmodel.eval()
    out = dict(timer.summary(QAT_WARMUP), calibrate_init_s=calib_s,
               peak_bytes_above_model=peak, losses=losses,
               quantizer_learnables=len(before), learnables_moved=moved)
    out["images_s"] = len(labels[0]) / out["s_per_step"]
    print("{}: {:.4f} s a step (forward {:.4f}, backward {:.4f}, optimiser "
          "{:.4f}; min {:.4f} max {:.4f} over {}), {:.0f} images/s, peak "
          "{:.2f} GB above the model, calibrate + init_QAT {:.2f} s, loss "
          "{:.4f} -> {:.4f}, {} of {} quantizer learnables moved".format(
              tag, out["s_per_step"], out["forward_s"], out["backward_s"],
              out["optimizer_s"], out["s_per_step_min"],
              out["s_per_step_max"], QAT_STEPS, out["images_s"], peak / 1e9,
              calib_s, losses[0], losses[-1], moved, len(before)),
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail("{}: a loss is not finite: {}".format(tag, losses))
    if not moved:
        fail("{}: no quantizer learnable moved".format(tag))
    return out


def _to(t, device):
    if isinstance(t, (tuple, list)):
        return type(t)(_to(v, device) for v in t)
    return t.to(device)


def _qat_card_vs_cpu(yaml_path, model=None, x=None, target=None,
                     loss_fn=None):
    """One QAT step at a small size (by default resnet18 num_classes=16,
    2 x 64 x 64 x 3, cross entropy; else ``model`` on the CPU, ``x``,
    ``target`` and ``loss_fn``) on the card and on the CPU from the same
    weights, data and calibration. Held: the loss within 1e-3 relative (the two devices sum
    convolutions in other orders, and a code at a rounding tie may flip);
    all trainables' gradients, as one vector, within 5e-2 relative (L2):
    where x / s lies within an ulp of a 4-bit clip's qmax + 1/2 the two
    devices round to either side, the forward clamps both to qmax but
    the straight-through mask passes the gradient on one side only, and
    BatchNorm's training statistics over a batch of 2 spread that
    through the weights' gradients (1.39e-2 measured, H100 80GB HBM3,
    700 W; a single quantizer's gradient, a sum that cancels to near
    zero, is printed, not held); every trainable after the Adam step
    within 2.01 lr of the CPU's (one Adam step moves a value by at most
    lr, so two steps differ by at most 2 lr where a near-zero gradient's
    sign differs) and 99 % of their elements within 1e-3 lr."""
    import copy

    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.quantization.tools.qat import (
        cross_entropy,
        init_qat_state,
        make_qat_step,
    )

    lr = 1e-3
    if model is None:
        g = torch.Generator().manual_seed(SEED + 50)
        x = torch.randn((2, 64, 64, 3), generator=g)
        target = torch.randint(0, 16, (2,), generator=g)
        model = create_model("resnet18", num_classes=16, seed=SEED,
                             device="cpu").eval()
        loss_fn = cross_entropy
    res = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        q = QuantModel(m, parse_qconfig(yaml_path), (x.to(dev),))
        q.prepare_calibration()
        q(x.to(dev))
        q.init_QAT()
        q.train()
        trainable, opt = init_qat_state(
            q, lambda ps: torch.optim.Adam(ps, lr=lr))
        _, loss = make_qat_step(q, loss_fn, opt)(
            trainable, x.to(dev), _to(target, dev))
        res[dev] = (loss.item(), {
            (n, k): (v.grad.detach().cpu().clone() if v.grad is not None
                     else None, v.detach().cpu().clone())
            for n, p in trainable.items() for k, v in p.items()
            if v.requires_grad})
    (lc, card), (lh, cpu) = res["cuda"], res["cpu"]
    loss_err = abs(lc - lh) / abs(lh)
    grads = [k for k in cpu if cpu[k][0] is not None]
    gc = torch.cat([card[k][0].reshape(-1) for k in grads])
    gh = torch.cat([cpu[k][0].reshape(-1) for k in grads])
    grad_err = float((gc - gh).norm() / gh.norm())
    per = {k: float((card[k][0] - cpu[k][0]).norm()
                    / (cpu[k][0].norm() + 1e-30)) for k in grads}
    worst_grad = max(per, key=per.get)
    diffs = torch.cat([(card[k][1] - cpu[k][1]).abs().reshape(-1)
                       for k in cpu])
    worst = float(diffs.max())
    close = float((diffs <= 1e-3 * lr).float().mean())
    ok = (loss_err <= 1e-3 and grad_err <= 5e-2 and worst <= 2.01 * lr
          and close >= 0.99)
    return dict(loss_card=lc, loss_cpu=lh, loss_rel_err=loss_err,
                grad_rel_l2_err=grad_err,
                worst_tensor_grad=("{}.{}".format(*worst_grad),
                                   per[worst_grad],
                                   float(cpu[worst_grad][0].norm())),
                param_max_abs_err=worst, param_share_within_1e_3_lr=close,
                lr=lr, held=ok)


def qat_path():
    """Phase 4, path qat: the resnet18 QAT CLI's flow at full width on the
    card (imagenet1k_resnet18/main_torch.py): resnet18 with seeded card
    weights, 224 x 224 x 3 NHWC, B=64, each of the four yamls (LSQ, LSQ+,
    PACT, DoReFa; 8-bit conv1 and fc through SPECIFIC, read without
    PyYAML): calibrate 4 batches, init_QAT, 3 warm-up and 10 timed steps
    of make_qat_step (Adam, lr 1e-4): seconds a step split into forward,
    backward and optimiser, images/s, peak memory above the model. Held:
    finite losses, a quantizer learnable moved, and one step at a small
    size equal to the CPU's (_qat_card_vs_cpu's tolerance)."""
    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.quantization.tools.qat import cross_entropy

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    calib = [_images(gen, QAT_BATCH) for _ in range(QAT_CALIB)]
    batches = calib[:2]
    labels = [torch.randint(0, 1000, (QAT_BATCH,), generator=gen,
                            device="cuda") for _ in batches]
    out = {}
    for name in QAT_YAMLS:
        path = os.path.join(QAT_DIR, "imagenet1k_resnet18", name)
        model = create_model("resnet18", seed=SEED, device="cuda").eval()
        qmodel = QuantModel(model, parse_qconfig(path), (calib[0],))
        out[name] = _qat_run(
            qmodel, calib, batches, labels, cross_entropy,
            lambda ps: torch.optim.Adam(ps, lr=QAT_LR),
            "qat resnet18 B={} {}".format(QAT_BATCH, name))
        del model, qmodel
        torch.cuda.empty_cache()
    lsq = os.path.join(QAT_DIR, "imagenet1k_resnet18", QAT_YAMLS[0])
    out["card_vs_cpu"] = _qat_card_vs_cpu(lsq)
    print("qat: one LSQ step card vs CPU (resnet18 16 classes, 2 x 64 x 64): "
          "{}".format(out["card_vs_cpu"]), flush=True)
    if not out["card_vs_cpu"]["held"]:
        fail("qat: the card's step differs from the CPU's: {}".format(
            out["card_vs_cpu"]))
    out["launches"] = _launches()
    _expect("qat", out["launches"], (), tuple(out["launches"]))
    return {"qat": out}


def qatdeit_path():
    """Phase 4, path qatdeit: the DeiT QAT CLI's flow at full width
    (imagenet1k_deit/main_torch.py): deit_small (dim 384, 12 layers, 6
    heads) at 224 x 224, B=64, qconfig_lsq.yaml and
    qconfig_gelu_lsqplus.yaml (8-bit patch embedding and head): calibrate
    4 batches, init_QAT, 3 warm-up and 10 timed AdamW steps (lr 5e-5,
    weight decay 0.05, label smoothing 0.1) through QMatmul(q, k^T) and
    QMatmul(softmax, v), the figures of qat. Held: finite losses, a
    quantizer learnable of the attention products' inputs moved."""
    import torch
    import torch.nn.functional as TF
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.quantization.modules.matmul import MatMul

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    calib = [_images(gen, QAT_BATCH) for _ in range(QAT_CALIB)]
    batches = calib[:2]
    labels = [torch.randint(0, 1000, (QAT_BATCH,), generator=gen,
                            device="cuda") for _ in batches]

    def loss_fn(logits, y):
        return TF.cross_entropy(logits, y, label_smoothing=0.1)

    out = {}
    for name in DEIT_YAMLS:
        path = os.path.join(QAT_DIR, "imagenet1k_deit", name)
        model = create_model("deit_small", seed=SEED, device="cuda").eval()
        qmodel = QuantModel(model, parse_qconfig(path), (calib[0],))
        mm = [n for n in qmodel.graph.op_nodes if isinstance(n.op, MatMul)]
        ids = [p for n in mm for p in n.input_nodes]
        scales = {p.name: p.op.input_quantizer for p in ids}
        r = _qat_run(qmodel, calib, batches, labels, loss_fn,
                     lambda ps: torch.optim.AdamW(
                         ps, lr=5e-5, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=0.05),
                     "qatdeit deit_small B={} {}".format(QAT_BATCH, name))
        r["qmatmuls"] = len(mm)
        r["qmatmul_input_scales"] = {k: float(q.scale.detach().reshape(-1)[0])
                                     for k, q in list(scales.items())[:4]}
        r["qmatmul_inputs_learnable"] = sum(
            bool(q.is_enable and q.trainable_params()) for q in scales.values())
        out[name] = r
        if len(mm) != 24 or r["qmatmul_inputs_learnable"] != 48:
            fail("qatdeit: {} QMatmuls, {} learnable operand quantizers "
                 "(want 24, 48)".format(len(mm),
                                        r["qmatmul_inputs_learnable"]))
        del model, qmodel
        torch.cuda.empty_cache()
    out["launches"] = _launches()
    _expect("qatdeit", out["launches"], (), tuple(out["launches"]))
    return {"qatdeit": out}


def bertptq_path():
    """Phase 4, path bertptq: the CoLA PTQ CLI's flow at full width
    (glue_cola_bert/main_torch.py): bert_base (vocab 30522, dim 768, 12
    layers) with seeded card weights, sequence length 128, B=32,
    qconfig.yaml (W8 MinMax, A8 percentile 0.001, NLC), calibrate 8
    batches; float and fake-quant ms a batch (CUDA events), the W8A8
    relative MSE against float over 4 batches. Held: quantizers off equal
    to the float model within 1e-4, the relative MSE in (0, 5e-2)."""
    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model

    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)

    def tokens():
        return torch.randint(0, 30522, (BERT_BATCH, BERT_SEQ), generator=gen,
                             device="cuda", dtype=torch.int32)

    model = create_model("bert_base", seed=SEED, device="cuda").eval()
    calib = [tokens() for _ in range(BERT_CALIB)]
    t0 = time.perf_counter()
    qmodel = QuantModel(
        model, parse_qconfig(os.path.join(PTQ_DIR, "glue_cola_bert",
                                          "qconfig.yaml")), (calib[0],))
    with torch.no_grad():
        off = float((qmodel(calib[0]) - model(calib[0])).abs().max())
    qmodel.prepare_calibration()
    for b in calib:
        qmodel(b)
    qmodel.calc_qparams()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    qmodel.set_quant(w_quant=True, a_quant=True)
    f_out, q_out = [], []
    with torch.no_grad():
        for _ in range(4):
            x = tokens()
            f_out.append(model(x))
            q_out.append(qmodel(x))
        float_ms = cuda_ms(lambda i: model(x), 10)
        quant_ms = cuda_ms(lambda i: qmodel(x), 10)
    rel = _rel_mse(torch.cat(q_out), torch.cat(f_out))
    out = dict(trace_calibrate_s=calib_s, quant_off_max_err=off,
               float_ms_per_batch=float_ms, quant_ms_per_batch=quant_ms,
               w8a8_rel_mse=rel, launches=_launches())
    print("bertptq: bert_base B={} S={}: trace + calibration ({} batches) "
          "{:.2f} s; float {:.3f} ms a batch, fake-quant {:.3f} ms; W8A8 "
          "rel MSE {:.3e}; quant off vs float {:.2e}".format(
              BERT_BATCH, BERT_SEQ, BERT_CALIB, calib_s, float_ms, quant_ms,
              rel, off), flush=True)
    if off > 1e-4:
        fail("bertptq: quantizers off differ from the float model by "
             "{:.2e}".format(off))
    if not 0 < rel < 5e-2:
        fail("bertptq: W8A8 relative MSE {:.3e} outside (0, 5e-2)".format(
            rel))
    _expect("bertptq", out["launches"], (), tuple(out["launches"]))
    del model, qmodel
    torch.cuda.empty_cache()
    return {"bertptq": out}


def _node_inputs(graph, x, names):
    """{node name: (input args, output)} of ``names`` from one op-by-op
    run of ``graph`` on ``x``."""
    from sparsebit_tpu_torch.nn.graph import Output, Placeholder, \
        SymbolicTensor

    env, got = {}, {}

    def value(a):
        if isinstance(a, SymbolicTensor):
            v = env[a.node.name]
            return v if a.index is None else v[a.index]
        return a

    for n in graph.nodes:
        if isinstance(n.op, Placeholder):
            env[n.name] = x
        elif not isinstance(n.op, Output):
            args = [value(a) for a in n.args]
            env[n.name] = n.op.execute(*args, **n.kwargs)
            if n.name in names:
                got[n.name] = (args, env[n.name])
    return got


def deploy_path():
    """Phase 4, path deploy: graphptq's calibrated W8A8 resnet18 lowered
    to integer compute (quantization/deploy.py: int8 weights, im2col
    codes padded with the zero point, ops/int8_matmul.int8_gemm's
    torch._int_mm) at B=64: int8 ms a batch beside fake-quant and float
    (CUDA events). Held: every Int8 node against its fake-quant op on the
    same input within 2e-5 of the node's largest output, the weights
    int8 buffers. Reported, not held: the end-to-end relative error and
    top-1 agreement (a code at a rounding tie flips between two correct
    pipelines and the flip spreads through later layers)."""
    import torch
    from sparsebit_tpu_torch.quantization.deploy import (
        Int8Conv2d,
        Int8Linear,
        deploy,
    )

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    model, qmodel, x = _GRAPH["model"], _GRAPH["qmodel"], _GRAPH["x"]
    t0 = time.perf_counter()
    dm = deploy(qmodel)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    int8 = {n.name: n.op for n in dm.graph.op_nodes
            if isinstance(n.op, (Int8Conv2d, Int8Linear))}
    with torch.no_grad():
        fq = qmodel(x)
        out = dm(x)
        f = model(x)
        int8_ms = cuda_ms(lambda i: dm(x), 10)
        quant_ms = cuda_ms(lambda i: qmodel(x), 10)
        float_ms = cuda_ms(lambda i: model(x), 10)
        worst, worst_node = 0.0, None
        for name, (args, want) in _node_inputs(qmodel.graph, x,
                                               set(int8)).items():
            got = int8[name].execute(*args)
            err = float((got - want).abs().max() / want.abs().max())
            if err > worst:
                worst, worst_node = err, name
    rel = float((out - fq).norm() / fq.norm())
    agree = float((out.argmax(1) == fq.argmax(1)).float().mean())
    int8_bufs = all(op.wq.dtype == torch.int8 for op in int8.values())
    res = dict(deploy_s=deploy_s, int8_nodes=len(int8),
               int8_ms_per_batch=int8_ms, quant_ms_per_batch=quant_ms,
               float_ms_per_batch=float_ms, node_max_rel_err=worst,
               node_worst=worst_node, end_to_end_rel_err=rel,
               top1_agreement_vs_fake_quant=agree,
               top1_agreement_vs_float=float(
                   (out.argmax(1) == f.argmax(1)).float().mean()),
               weights_int8=int8_bufs, launches=_launches())
    print("deploy: resnet18 B={}: {} int8 nodes in {:.3f} s; int8 {:.3f} ms "
          "a batch, fake-quant {:.3f}, float {:.3f}; each node vs its "
          "fake-quant op max rel err {:.2e} ({}); end to end rel err "
          "{:.3e}, top-1 agreement {:.4f} (vs float {:.4f})".format(
              x.shape[0], len(int8), deploy_s, int8_ms, quant_ms, float_ms,
              worst, worst_node, rel, agree, res["top1_agreement_vs_float"]),
          flush=True)
    if worst > 2e-5:
        fail("deploy: Int8 node {} differs from its fake-quant op by "
             "{:.2e} relative".format(worst_node, worst))
    if not int8_bufs or len(int8) != 21:
        fail("deploy: {} int8 nodes (want 21), int8 weights {}".format(
            len(int8), int8_bufs))
    _expect("deploy", res["launches"], (), tuple(res["launches"]))
    _GRAPH["deployed"] = dm
    return {"deploy": res}


def export_path():
    """Phase 4, path export: QuantModel.export (the fake-quant W8A8
    resnet18 of graphptq) and DeployedModel.export (deploy's integer
    graph) as torch.export programs at B=64 on the card, each loaded back
    with torch.export.load: seconds to export and to load, the
    artifact's bytes. Held: each loaded program's output equal to the
    in-memory model's, bit for bit, and the sidecar's node count."""
    import json
    import shutil
    import tempfile

    import torch

    _reset_launches()
    qmodel, dm, x = _GRAPH["qmodel"], _GRAPH["deployed"], _GRAPH["x"]
    tmp = tempfile.mkdtemp()
    out = {}
    try:
        for tag, obj in (("quant_model", qmodel), ("deployed", dm)):
            d = os.path.join(tmp, tag)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obj.export(d, x)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            prog = torch.export.load(os.path.join(d, "model.pt2")).module()
            load_s = time.perf_counter() - t0
            with torch.no_grad():
                want = obj(x)
                got = prog(x)
            err = float((got - want).abs().max())
            files = sorted(os.listdir(d))
            r = dict(export_s=export_s, load_s=load_s, files=files,
                     bytes={f: os.path.getsize(os.path.join(d, f))
                            for f in files},
                     equal=bool(torch.equal(got, want)), max_abs_err=err)
            if tag == "quant_model":
                with open(os.path.join(d, "quant_meta.json")) as f:
                    r["sidecar_nodes"] = len(json.load(f)["nodes"])
            out[tag] = r
            print("export {}: {:.2f} s, loaded in {:.2f} s, {}; loaded "
                  "program equal to the model {} (max abs err {:.2e})"
                  .format(tag, export_s, load_s, r["bytes"], r["equal"],
                          err), flush=True)
            if not r["equal"]:
                fail("export: the loaded {} program differs from the model "
                     "by {:.2e}".format(tag, err))
    finally:
        shutil.rmtree(tmp)
    if out["quant_model"].get("sidecar_nodes", 0) < 21:
        fail("export: the sidecar lists {} nodes".format(
            out["quant_model"].get("sidecar_nodes")))
    out["launches"] = _launches()
    _expect("export", out["launches"], (), tuple(out["launches"]))
    return {"export": out}


def errprof_path():
    """Phase 4, path errprof: QuantModel.get_quantization_error on
    graphptq's W8A8 resnet18 at B=16, async (one node quantized at a
    time) and sync (quantization propagated): seconds and the five
    nodes of largest MSE. Held: errors finite and non-negative, a node
    with a positive error in each mode, and the caller's quant state
    kept (the model's output after profiling equal to before)."""
    import torch

    _reset_launches()
    qmodel, x = _GRAPH["qmodel"], _GRAPH["x"][:16]
    with torch.no_grad():
        before = qmodel(x)
    out = {}
    for mode, is_async in (("async", True), ("sync", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = qmodel.get_quantization_error(x, is_async=is_async)
        secs = time.perf_counter() - t0
        worst = sorted(err.items(), key=lambda kv: -kv[1])[:5]
        out[mode] = dict(seconds=secs, nodes=len(err), worst5=worst)
        print("errprof {}: {} nodes in {:.3f} s; worst 5 {}".format(
            mode, len(err), secs, worst), flush=True)
        if not err or not all(math.isfinite(v) and v >= 0
                              for v in err.values()) or not any(
                                  v > 0 for v in err.values()):
            fail("errprof {}: errors {}".format(mode, worst))
    with torch.no_grad():
        kept = torch.equal(qmodel(x), before)
    out["quant_state_kept"] = kept
    if not kept:
        fail("errprof: profiling changed the model's quant state")
    out["launches"] = _launches()
    _expect("errprof", out["launches"], (), tuple(out["launches"]))
    return {"errprof": out}


def trfixture_path():
    """Phase 4, path trfixture: the transformer accuracy fixtures on the
    card at the JAX package's artifact settings, through
    record_fixture_torch.py: run_vit_fixture (300 steps, 4096 / 1024),
    run_bert_fixture (300 steps, 4096 / 1024), run_vit_qat_fixture (150
    float and 800 QAT steps, 2048 / 512). Held: the claims of
    tests/test_fixture_transformer.py (ViT learned > 0.6, w8a8 within 3
    points, w4a8 within 15 and <= w8a8 + 2; BERT learned > 0.7, w8a8
    within 3, w4a8 within 15; QAT >= 0.60 and >= PTQ + 0.25). The
    records, with the card's name and power limit, go to
    chiprun_out/ACCURACY_torch.json, merged with the repository's
    accuracy/ACCURACY_torch.json, for accuracy/ACCURACY_torch.json."""
    import importlib.util
    import json

    import torch

    torch.backends.cudnn.allow_tf32 = False
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "record_fixture_torch", os.path.join(PTQ_DIR,
                                             "record_fixture_torch.py"))
    rec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rec)
    _reset_launches()
    t0 = time.perf_counter()
    res = rec.record(["vit", "bert", "vit_qat"], torch.device("cuda"),
                     verbose=False)
    secs = time.perf_counter() - t0
    v, b, q = res["vit_ptq"], res["bert_ptq"], res["vit_qat"]
    held = {
        "vit learned": v["acc_float"] > 0.6,
        "vit int8 < 3 points": v["acc_w8a8"] > v["acc_float"] - 0.03,
        "vit w4a8 < 15 points, <= w8a8 + 2": (
            v["acc_w4a8"] > v["acc_float"] - 0.15
            and v["acc_w4a8"] <= v["acc_w8a8"] + 0.02),
        "bert learned": b["acc_float"] > 0.7,
        "bert int8 < 3 points": b["acc_w8a8"] > b["acc_float"] - 0.03,
        "bert w4a8 < 15 points": b["acc_w4a8"] > b["acc_float"] - 0.15,
        "vit qat >= 0.60, >= ptq + 0.25": (
            q["acc_qat"] >= 0.60 and q["acc_qat"] >= q["acc_ptq"] + 0.25)}
    print("trfixture ({:.1f} s): vit {}; bert {}; vit_qat {}; claims "
          "{}".format(secs, v, b, q, held), flush=True)
    for claim, ok in held.items():
        if not ok:
            fail("trfixture: {} does not hold".format(claim))
    merged = {}
    path = os.path.join(here, "accuracy", "ACCURACY_torch.json")
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged.update(res)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "ACCURACY_torch.json"),
              "w") as f:
        json.dump(merged, f, indent=2)
    launches = _launches()
    _expect("trfixture", launches, (), tuple(launches))
    return {"trfixture": dict(records=res, seconds=secs, claims=held,
                              launches=launches)}


# ---- phase 4: the pruning regime and the rest of the CNN zoo (no kernel) --

PRUNE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "examples", "pruning")
PRUNE_BATCH, PRUNE_STEPS, PRUNE_WARMUP = 64, 20, 3  # the imagenet1k CLI's
PRUNE_LR = 1e-4
PRUNEBERT_RATIO = 0.7
QA_BATCH, QA_SEQ, QA_STEPS = 16, 384, 4  # steps a ratio of the ratchet
QA_RATIOS = (0.2, 0.35, 0.5)  # the squad CLI's schedule
ZOO = ("mobilenet_v2", "efficientnet_lite0", "regnetx_600mf")
ZOO_EVAL_BATCHES = 4


def _masks(smodel):
    """{(node, mask name): tensor} of every SModule's masks."""
    return {(n, k): getattr(op, k) for n, op in smodel.smodules()
            for k in ("w_mask", "b_mask", "ch_mask")
            if getattr(op, k, None) is not None}


def prune_path():
    """Phase 4, path prune: the structured_imagenet1k CLI's flow at full
    width (examples/pruning/structured_imagenet1k/main_torch.py): resnet18
    with seeded card weights, 224 x 224 x 3 NHWC, B=64, its sconfig
    (structured l1norm 0.5, conv1 and fc dense through SPECIFIC, read
    without PyYAML). Prints the seconds of trace + convert and of
    calc_params; float and masked eval ms a batch (CUDA events); 20
    masked finetune steps (SGD lr 1e-4, momentum 0.9) in seconds a step,
    split into forward / backward / optimiser; the peak memory above the
    model; export and load seconds. Held: the card's masks equal, bit for
    bit, the port's on the CPU from the same weights; each block's conv1
    loses int(n * 0.5) channels and every conv feeding an add keeps all;
    the pruned channels of each masked BatchNorm's output are exact zeros
    in the feature map; after the finetune every masked weight is 0 in
    effect, the masks are unchanged bit for bit and the losses finite;
    the exported program loads and its output equals the model's bit for
    bit. No kernel of the port is launched."""
    import copy
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as TF
    from sparsebit_tpu_torch import SparseModel, parse_sconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.sparse.modules.normalization import (
        SBatchNorm2d,
    )

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    cfg = parse_sconfig(os.path.join(PRUNE_DIR, "structured_imagenet1k",
                                     "sconfig.yaml"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    model = create_model("resnet18", seed=SEED, device="cuda").eval()
    xs = [_images(gen, PRUNE_BATCH) for _ in range(2)]
    ys = [torch.randint(0, 1000, (PRUNE_BATCH,), generator=gen,
                        device="cuda") for _ in xs]
    x = xs[0]
    with torch.no_grad():
        float_ms = cuda_ms(lambda i: model(x), 10)
    cpu_model = copy.deepcopy(model).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smodel = SparseModel(model, cfg, (x,))
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    smodel.calc_params()
    torch.cuda.synchronize()
    calc_s = time.perf_counter() - t0
    masks = {k: v.clone() for k, v in _masks(smodel).items()}

    # the CPU from the same weights
    cs = SparseModel(cpu_model, cfg, (x[:2].cpu(),))
    cs.calc_params()
    cmasks = _masks(cs)
    differ = sorted("{}.{}".format(*k) for k, v in masks.items()
                    if k not in cmasks or not torch.equal(v.cpu(), cmasks[k]))
    if set(cmasks) != set(masks):
        differ.append("mask sets")
    del cs, cpu_model

    # which nodes were pruned
    ops = dict(smodel.smodules())
    wrong = []
    for name, op in ops.items():
        if not op.HAS_WEIGHT:
            continue
        n = op.w_mask.shape[0]
        keeps_all = bool((op.w_mask == 1).all())
        if name.endswith(".conv1") and name != "conv1":
            pruned = int((op.w_mask.reshape(n, -1) == 0).all(1).sum())
            if pruned != int(n * 0.5):
                wrong.append(name)
        elif not keeps_all:  # conv2, down_conv feed an add; conv1, fc
            wrong.append(name)
    bns = [n for n, op in ops.items()
           if isinstance(op, SBatchNorm2d) and bool((op.ch_mask == 0).any())]
    with torch.no_grad():
        got = _node_inputs(smodel.graph, x, set(bns))
    nonzero = [n for n in bns
               if bool((got[n][1][..., ops[n].ch_mask == 0] != 0).any())]
    del got
    smodel.eval()
    with torch.no_grad():
        masked_ms = cuda_ms(lambda i: smodel(x), 10)

    # masked finetune, as the CLI runs it
    opt = torch.optim.SGD(model.parameters(), lr=PRUNE_LR, momentum=0.9)
    timer = _StepTimer(TF.cross_entropy, opt)
    smodel.train()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses = []

    def step(j):
        loss = timer.loss_fn(smodel(xs[j]), ys[j])
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss

    for i in range(PRUNE_WARMUP + PRUNE_STEPS):
        losses.append(timer.run(lambda: step(i % 2)).item())
    peak = torch.cuda.max_memory_allocated() - base
    smodel.eval()
    after = _masks(smodel)
    changed = sorted("{}.{}".format(*k) for k, v in masks.items()
                     if not torch.equal(v, after[k]))
    alive = sorted(n for n, op in ops.items() if op.HAS_WEIGHT and bool(
        ((op.module.weight.detach() * op.w_mask)[op.w_mask == 0]
         != 0).any()))
    ft = timer.summary(PRUNE_WARMUP)

    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        smodel.export(tmp, x)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prog = torch.export.load(os.path.join(tmp, "model.pt2")).module()
        load_s = time.perf_counter() - t0
        with torch.no_grad():
            export_equal = bool(torch.equal(prog(x), smodel(x)))
        del prog
    finally:
        shutil.rmtree(tmp)
    out = dict(trace_convert_s=trace_s, calc_params_s=calc_s,
               sparsity=smodel.sparsity(), masks_differ_from_cpu=differ,
               wrongly_pruned=wrong, masked_bns=len(bns),
               bn_pruned_channels_nonzero=nonzero,
               float_ms_per_batch=float_ms, masked_ms_per_batch=masked_ms,
               finetune=ft, finetune_images_s=PRUNE_BATCH / ft["s_per_step"],
               finetune_peak_bytes_above_model=peak, losses=losses,
               masks_changed=changed, masked_weights_alive=alive,
               export_s=export_s, load_s=load_s, export_equal=export_equal,
               launches=_launches())
    print("prune: resnet18 224x224 B={} structured l1norm 0.5: trace + "
          "convert {:.3f} s, calc_params {:.4f} s, sparsity {:.4f}; masks "
          "card vs CPU: {} differ; {} masked BatchNorms; float {:.3f} ms / "
          "batch, masked {:.3f} ms; finetune {:.4f} s a step (forward "
          "{:.4f}, backward {:.4f}, optimiser {:.4f}; min {:.4f} max {:.4f} "
          "over {}), {:.0f} images/s, peak {:.2f} GB above the model, loss "
          "{:.4f} -> {:.4f}; export {:.2f} s, load {:.2f} s, equal {}; "
          "launches {}".format(
              PRUNE_BATCH, trace_s, calc_s, out["sparsity"], len(differ),
              len(bns), float_ms, masked_ms, ft["s_per_step"],
              ft["forward_s"], ft["backward_s"], ft["optimizer_s"],
              ft["s_per_step_min"], ft["s_per_step_max"], PRUNE_STEPS,
              out["finetune_images_s"], peak / 1e9, losses[0], losses[-1],
              export_s, load_s, export_equal, out["launches"]), flush=True)
    if differ:
        fail("prune: the card's masks differ from the CPU's: {}".format(
            differ[:8]))
    if wrong or not bns:
        fail("prune: wrongly pruned nodes {} ({} masked BatchNorms)".format(
            wrong, len(bns)))
    if nonzero:
        fail("prune: pruned channels not zero after {}".format(nonzero))
    if changed or alive:
        fail("prune: the finetune changed masks {} or revived weights "
             "{}".format(changed[:8], alive[:8]))
    if not all(math.isfinite(v) for v in losses):
        fail("prune: a loss is not finite: {}".format(losses))
    if not export_equal:
        fail("prune: the exported program differs from the model")
    _expect("prune", out["launches"], (), tuple(out["launches"]))
    del smodel, model, opt, xs
    torch.cuda.empty_cache()
    return {"prune": out}


def prunebert_path():
    """Phase 4, path prunebert: the unstructured_bert CLI's flow at
    bert_base's width (vocab 30522, dim 768, 12 layers) with seeded card
    weights, S=128, B=32, its sconfig at --ratio 0.7 (embeddings and the
    classifier dense): the seconds of trace + convert and of calc_params
    (a linear quantile a masked linear), float and masked eval ms a batch.
    Then the unstructured_squad CLI's ratchet on bert_qa (the same widths)
    at S=384, B=16: ratios 0.2, 0.35, 0.5 with 4 AdamW steps each (lr
    3e-4, weight decay 1e-4), seeded tokens and span labels: the sparsity
    after each ratio and the seconds a step. Held: each masked linear's
    pruned count within one element of numel * 0.7 (scores equal to the
    threshold, which are kept, aside), the dense ones at 0; every loss
    finite, the masks {0, 1} and qa_outputs dense after the finetune. No
    kernel of the port is launched."""
    import torch
    import torch.nn.functional as TF
    from sparsebit_tpu_torch import SparseModel, parse_sconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.sparse.sparsers.base import quantile_linear

    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    cfg = parse_sconfig(os.path.join(PRUNE_DIR, "unstructured_bert",
                                     "sconfig.yaml"))
    cfg.defrost()
    cfg.SPARSER.RATIO = PRUNEBERT_RATIO
    cfg.freeze()
    model = create_model("bert_base", seed=SEED, device="cuda").eval()
    ids = torch.randint(0, 30522, (BERT_BATCH, BERT_SEQ), generator=gen,
                        device="cuda", dtype=torch.int32)
    with torch.no_grad():
        float_ms = cuda_ms(lambda i: model(ids), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smodel = SparseModel(model, cfg, (ids,))
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    smodel.calc_params()
    torch.cuda.synchronize()
    calc_s = time.perf_counter() - t0
    off, masked = [], 0
    for name, op in smodel.smodules():
        pruned = int((op.w_mask == 0).sum())
        if "classifier" in name:
            if pruned:
                off.append((name, pruned))
            continue
        masked += 1
        scores = op.module.weight.detach().abs()
        at = int((scores == quantile_linear(scores, PRUNEBERT_RATIO)).sum())
        if abs(pruned - PRUNEBERT_RATIO * scores.numel()) > 1 + at:
            off.append((name, pruned))
    smodel.eval()
    with torch.no_grad():
        masked_ms = cuda_ms(lambda i: smodel(ids), 10)
    bert = dict(trace_convert_s=trace_s, calc_params_s=calc_s,
                masked_linears=masked,
                calc_params_ms_a_linear=calc_s / max(masked, 1) * 1e3,
                sparsity=smodel.sparsity(), off_ratio=off,
                float_ms_per_batch=float_ms, masked_ms_per_batch=masked_ms)
    print("prunebert: bert_base B={} S={} unstructured l1norm {}: trace + "
          "convert {:.3f} s, calc_params {:.4f} s ({:.2f} ms a linear over "
          "{}), sparsity {:.4f}; float {:.3f} ms / batch, masked {:.3f} ms"
          .format(BERT_BATCH, BERT_SEQ, PRUNEBERT_RATIO, trace_s, calc_s,
                  bert["calc_params_ms_a_linear"], masked, bert["sparsity"],
                  float_ms, masked_ms), flush=True)
    if off or masked != 12 * 6 + 1:
        fail("prunebert: {} masked linears; off their ratio: {}".format(
            masked, off[:8]))
    del smodel, model
    torch.cuda.empty_cache()

    # the squad CLI's ratchet at bert_qa's full width
    cfg = parse_sconfig(os.path.join(PRUNE_DIR, "unstructured_squad",
                                     "sconfig.yaml"))
    model = create_model("bert_qa", seed=SEED, device="cuda").eval()
    batches = [tuple(torch.randint(lo, hi, shape, generator=gen,
                                   device="cuda")
                     for lo, hi, shape in ((0, 30522, (QA_BATCH, QA_SEQ)),
                                           (0, QA_SEQ, (QA_BATCH,)),
                                           (0, QA_SEQ, (QA_BATCH,))))
               for _ in range(2)]
    smodel = SparseModel(model, cfg, (batches[0][0],))
    smodel.train()
    steps, sparsity, losses, calc = [], [], [], []
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for ratio in QA_RATIOS:
        for _, op in smodel.smodules():
            if op.sparser is not None and op.sparser.ratio > 0.0:
                op.sparser.ratio = ratio
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smodel.calc_params()
        torch.cuda.synchronize()
        calc.append(time.perf_counter() - t0)
        sparsity.append(smodel.sparsity())
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=1e-4)
        timer = _StepTimer(lambda s, e, sb, eb: 0.5 * (
            TF.cross_entropy(s, sb) + TF.cross_entropy(e, eb)), opt)

        def step(j):
            xb, sb, eb = batches[j]
            loss = timer.loss_fn(*smodel(xb), sb, eb)
            opt.zero_grad()
            loss.backward()
            opt.step()
            return loss

        for i in range(QA_STEPS):
            losses.append(timer.run(lambda: step(i % 2)).item())
        steps.append(timer.summary(1))
    peak = torch.cuda.max_memory_allocated() - base
    not01 = sorted(n for n, op in smodel.smodules() if not bool(
        ((op.w_mask == 0) | (op.w_mask == 1)).all()))
    qa_dense = bool((dict(smodel.smodules())["qa_outputs"].w_mask == 1).all())
    qa = dict(ratios=list(QA_RATIOS), sparsity=sparsity,
              calc_params_s=calc, steps=steps, losses=losses,
              peak_bytes_above_model=peak, masks_not_0_1=not01,
              qa_outputs_dense=qa_dense)
    print("prunebert ratchet: bert_qa B={} S={} ratios {}: sparsity {}, "
          "calc_params {} s, s a step {} (forward / backward / optimiser of "
          "the last ratio {:.4f} / {:.4f} / {:.4f}), peak {:.2f} GB above "
          "the model, loss {:.4f} -> {:.4f}".format(
              QA_BATCH, QA_SEQ, list(QA_RATIOS),
              ["{:.4f}".format(s) for s in sparsity],
              ["{:.3f}".format(c) for c in calc],
              ["{:.4f}".format(s["s_per_step"]) for s in steps],
              steps[-1]["forward_s"], steps[-1]["backward_s"],
              steps[-1]["optimizer_s"], peak / 1e9, losses[0], losses[-1]),
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail("prunebert: a loss is not finite: {}".format(losses))
    if not01 or not qa_dense or sparsity != sorted(sparsity):
        fail("prunebert: masks not in {{0, 1}}: {}; qa_outputs dense {}; "
             "sparsity {}".format(not01[:8], qa_dense, sparsity))
    out = dict(bert_base=bert, bert_qa=qa, launches=_launches(),
               peak_bytes=torch.cuda.max_memory_allocated())
    _expect("prunebert", out["launches"], (), tuple(out["launches"]))
    del smodel, model, opt, batches
    torch.cuda.empty_cache()
    return {"prunebert": out}


def _qparams_card_vs_cpu(model, cfg, x):
    """QuantModel on the card and on the CPU (a copy of ``model``) over
    the same batch ``x``: every enabled quantizer's scale, max relative
    error, and zero points differing. Returns (max rel err, zero points
    differing, quantizers compared, CPU seconds)."""
    import copy

    from sparsebit_tpu_torch import QuantModel

    host = copy.deepcopy(model).cpu()  # FUSE_BN folds into the model
    qa = QuantModel(model, cfg, (x,))
    qb = QuantModel(host, cfg, (x.cpu(),))
    t0 = time.perf_counter()
    for qq, xx in ((qa, x), (qb, x.cpu())):
        qq.prepare_calibration()
        qq(xx)
        qq.calc_qparams()
    cpu_s = time.perf_counter() - t0
    s_err, z_diff, n_q = 0.0, 0, 0
    for (name, op), (_, hop) in zip(qa.qmodules(), qb.qmodules()):
        for k in ("input_quantizer", "weight_quantizer"):
            a, b = getattr(op, k), getattr(hop, k)
            if a is None or a.fake_fused:
                continue
            n_q += 1
            s_err = max(s_err, float(((a.scale.cpu() - b.scale).abs()
                                      / b.scale.abs()).max()))
            z_diff += int((a.zero_point.cpu() != b.zero_point).sum())
    return s_err, z_diff, n_q, cpu_s


def zoo_path():
    """Phase 4, path zoo: graphptq's flow (the PTQ basecase CLI's:
    qconfig.yaml's W8 per-channel-symmetric / A8 per-tensor-affine
    MinMax, 16 calibration batches) on mobilenet_v2, efficientnet_lite0
    and regnetx_600mf with seeded card weights, 224 x 224 x 3 NHWC, B=64:
    the seconds of trace + convert and calibration, float and fake-quant
    ms a batch (CUDA events), the W8A8 relative MSE against float over 4
    seeded batches, the calibration peak memory. Held: quantizers off
    equal to the float model within 1e-4, the relative MSE in (0, 5e-2),
    every quantizer's qparams on the card against the port's on the CPU
    at B=8 over the same images and weights (cuDNN TF32 off): scales
    within 1e-5 relative, zero points equal. No kernel of the port is
    launched."""
    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    cfg = parse_qconfig(BASECASE_QCONFIG)
    out = {}
    for k, name in enumerate(ZOO):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 70 + k)
        model = create_model(name, seed=SEED, device="cuda").eval()
        calib = [_images(gen, GRAPH_BATCH)
                 for _ in range(GRAPH_CALIB_BATCHES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qmodel = QuantModel(model, cfg, (calib[0],))
        torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        with torch.no_grad():
            off = float((qmodel(calib[0]) - model(calib[0])).abs().max())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times, _ = _calibrate(qmodel, calib)
        peak = torch.cuda.max_memory_allocated() - base
        qmodel.set_quant(w_quant=True, a_quant=True)
        f_out, q_out = [], []
        with torch.no_grad():
            for _ in range(ZOO_EVAL_BATCHES):
                x = _images(gen, GRAPH_BATCH)
                f_out.append(model(x))
                q_out.append(qmodel(x))
            float_ms = cuda_ms(lambda i: model(x), 10)
            quant_ms = cuda_ms(lambda i: qmodel(x), 10)
        rel = _rel_mse(torch.cat(q_out), torch.cat(f_out))
        # the spread of the float logits over the images: seeded weights
        # under the default BatchNorm statistics shrink a deep CNN's
        # activations, so that its logits are nearly its classifier's bias
        out_std = float(torch.cat(f_out).std(0).mean())
        s_err, z_diff, n_q, cpu_s = _qparams_card_vs_cpu(
            model, cfg, calib[0][:GRAPH_CPU_BATCH])
        r = dict(times, trace_convert_s=trace_s, quant_off_max_err=off,
                 calib_peak_bytes=peak, float_ms_per_batch=float_ms,
                 quant_ms_per_batch=quant_ms, w8a8_rel_mse=rel,
                 float_logit_std_over_images=out_std,
                 qmodules=len(list(qmodel.qmodules())),
                 cpu_quantizers=n_q, cpu_scale_max_rel_err=s_err,
                 cpu_zero_points_differ=z_diff, cpu_calibration_s=cpu_s)
        out[name] = r
        print("zoo {}: 224x224 B={} x {} calibration batches: trace + "
              "convert {:.3f} s, capture {:.3f} s, calc_qparams {:.3f} s, "
              "calibration peak {:.2f} GB; {} qmodules; quant off vs float "
              "{:.2e}; float {:.3f} ms / batch, fake-quant {:.3f} ms; w8a8 "
              "rel MSE {:.3e} (float logits' std over images {:.3e}); card "
              "vs CPU at B={}: {} quantizers, scales max rel err {:.2e}, {} "
              "zero points differ".format(
                  name, GRAPH_BATCH, GRAPH_CALIB_BATCHES, trace_s,
                  times["capture_s"], times["calc_qparams_s"], peak / 1e9,
                  r["qmodules"], off, float_ms, quant_ms, rel, out_std,
                  GRAPH_CPU_BATCH, n_q, s_err, z_diff), flush=True)
        if off > 1e-4:
            fail("zoo {}: quantizers off differ from the float model by "
                 "{:.2e}".format(name, off))
        if not 0 < rel < 5e-2:
            fail("zoo {}: w8a8 relative MSE {:.3e} outside (0, 5e-2)".format(
                name, rel))
        if s_err > 1e-5 or z_diff:
            fail("zoo {}: the card's qparams differ from the CPU's (scale "
                 "rel err {:.2e}, {} zero points)".format(name, s_err,
                                                          z_diff))
        del model, qmodel, calib, f_out, q_out
        torch.cuda.empty_cache()
    out["launches"] = _launches()
    _expect("zoo", out["launches"], (), tuple(out["launches"]))
    return {"zoo": out}


GPT2_BATCH, GPT2_SEQ = 8, 1024  # calibration and eval batches: 8 x 1024
GPT2_CPU_DEPTH, GPT2_CPU_SEQ = 2, 256  # the card against the CPU
YOLO_BATCH, YOLO_SIZE, YOLO_CALIB = 8, 416, 4
YOLO_ALSO = ("yolov4", "yolov5s", "yolov3_tiny")
YOLO_CPU_SIZE = 128  # yolov3_darknet21, B=1, the card against the CPU
BEV_BATCH, BEV_STEPS, BEV_LR = 8, 4, 5e-3  # tests/test_bevdet.py's lr


def _randomize_bn(model, gen):
    """BatchNorm state drawn from ``gen`` as tests/test_torch_graph.py's
    randomize_bn draws it (weight U(0.5, 1.5), bias N(0, 0.2), running
    mean N(0, 0.2), running var U(0.5, 2)): the default statistics make
    BatchNorm the identity and shrink a deep CNN's activations."""
    import torch
    from sparsebit_tpu_torch.nn import BatchNorm2d

    def draw(c, lo=None, hi=None):  # U(lo, hi), or N(0, 0.2)
        if lo is None:
            return torch.randn(c, generator=gen, device="cuda") * 0.2
        return torch.rand(c, generator=gen, device="cuda") * (hi - lo) + lo

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.num_features
                m.weight.copy_(draw(c, 0.5, 1.5))
                m.bias.copy_(draw(c))
                m.running_mean.copy_(draw(c))
                m.running_var.copy_(draw(c, 0.5, 2.0))
    return model


def _nll(logits, ids):
    """Mean next-token negative log-likelihood (the wikitext CLI's ppl)."""
    import torch

    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return float(-logp.gather(-1, ids[:, 1:, None].long()).mean())


def gpt2ptq_path():
    """Phase 4, path gpt2ptq: the wikitext GPT-2 PTQ CLI's flow
    (wikitext_gpt2/main_torch.py, its qconfig.yaml read without PyYAML:
    W8 per-channel MinMax with an ACIQ-Laplace lm_head, A8 per-tensor MSE,
    NLC) on gpt2_small at full width (12 layers, 768 wide, 12 heads,
    vocab 50257, 1024 positions) with seeded card weights: one
    calibration batch of 8 x 1024 seeded tokens, calc_qparams, then a
    second seeded 8 x 1024 batch evaluated with quantizers off (float)
    and on (int8). Prints the perplexities, float and fake-quant ms a
    batch (CUDA events), the seconds of trace + convert and
    calc_qparams, the calibration peak memory, and the softmax input
    quantizers' scales (fault R13: the -1e9 causal mask sets their
    range). Held: quantizers off equal to the float model within 1e-4,
    finite perplexities, and every quantizer's qparams on the card
    against the port's on the CPU at depth 2 (1 x 256 tokens): scales
    within 1e-5 relative, zero points equal. No kernel of the port."""
    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model

    _reset_launches()
    cfg = parse_qconfig(os.path.join(PTQ_DIR, "wikitext_gpt2",
                                     "qconfig.yaml"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    model = create_model("gpt2_small", seed=SEED, device="cuda").eval()

    def stream():
        return torch.randint(0, model.wte.num_embeddings,
                             (GPT2_BATCH, GPT2_SEQ), generator=gen,
                             device="cuda", dtype=torch.int32)

    calib, ids = stream(), stream()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = QuantModel(model, cfg, (calib,))
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    with torch.no_grad():
        float_logits = model(ids)
        off = float((qmodel(ids) - float_logits).abs().max())
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, _ = _calibrate(qmodel, [calib])
    peak = torch.cuda.max_memory_allocated() - base
    with torch.no_grad():
        qmodel.set_quant(True, True)
        int8_logits = qmodel(ids)
        quant_ms = cuda_ms(lambda i: qmodel(ids), 5)
        float_ms = cuda_ms(lambda i: model(ids), 5)
    ppl = (math.exp(_nll(float_logits, ids)), math.exp(_nll(int8_logits,
                                                            ids)))
    softmax_scales = [float(op.input_quantizer.scale) for n, op in
                      qmodel.qmodules() if n.startswith("softmax")]
    del float_logits, int8_logits, qmodel
    torch.cuda.empty_cache()
    small = create_model("gpt2_small", depth=GPT2_CPU_DEPTH, seed=SEED,
                         device="cuda").eval()
    s_err, z_diff, n_q, cpu_s = _qparams_card_vs_cpu(
        small, cfg, calib[:1, :GPT2_CPU_SEQ])
    out = dict(times, trace_convert_s=trace_s, quant_off_max_err=off,
               calib_peak_bytes=peak, float_ms_per_batch=float_ms,
               quant_ms_per_batch=quant_ms, float_ppl=ppl[0],
               int8_ppl=ppl[1], softmax_input_scales=softmax_scales,
               cpu_depth=GPT2_CPU_DEPTH, cpu_quantizers=n_q,
               cpu_scale_max_rel_err=s_err, cpu_zero_points_differ=z_diff,
               cpu_calibration_s=cpu_s)
    print("gpt2ptq: gpt2_small B={} S={}: trace + convert {:.3f} s, capture "
          "{:.3f} s, calc_qparams {:.3f} s, calibration peak {:.2f} GB; "
          "quant off vs float {:.2e}; float {:.3f} ms / batch, fake-quant "
          "{:.3f} ms; ppl float {:.3f}, int8 {:.3f}; softmax input scales "
          "{:.4g}..{:.4g} (R13); card vs CPU at depth {} (1 x {}): {} "
          "quantizers, scales max rel err {:.2e}, {} zero points "
          "differ".format(
              GPT2_BATCH, GPT2_SEQ, trace_s, times["capture_s"],
              times["calc_qparams_s"], peak / 1e9, off, float_ms, quant_ms,
              ppl[0], ppl[1], min(softmax_scales), max(softmax_scales),
              GPT2_CPU_DEPTH, GPT2_CPU_SEQ, n_q, s_err, z_diff), flush=True)
    if off > 1e-4:
        fail("gpt2ptq: quantizers off differ from the float model by "
             "{:.2e}".format(off))
    if not all(math.isfinite(v) for v in ppl):
        fail("gpt2ptq: a perplexity is not finite: {}".format(ppl))
    if s_err > 1e-5 or z_diff:
        fail("gpt2ptq: the card's qparams differ from the CPU's (scale rel "
             "err {:.2e}, {} zero points)".format(s_err, z_diff))
    out["launches"] = _launches()
    _expect("gpt2ptq", out["launches"], (), tuple(out["launches"]))
    return {"gpt2ptq": out}


def _yolo_model(name, gen, x):
    """``name`` with seeded card weights, random BatchNorm affines and
    running statistics (_randomize_bn), then the running statistics of
    the batch ``x`` (one training-mode forward at momentum 1): with
    random statistics alone a Darknet's maps shrink through its 50-odd
    convs (their spread over images 1e-5 to 1e-8 in the CPU rehearsal),
    as the zoo path's logits do under the default ones, and the
    relative MSE then says nothing."""
    import torch
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.nn import BatchNorm2d

    model = _randomize_bn(create_model(name, seed=SEED, device="cuda"), gen)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(x)
    for m in bns:
        m.momentum = 0.1
    return model.eval()


def yolo_path():
    """Phase 4, path yolo: the detection PTQ CLI's flow
    (coco_yolov3_tiny/main_torch.py, its qconfig.yaml: W8 per-channel /
    A8 per-tensor MSE observers, FUSE_BN) on yolov3 (Darknet-53 + FPN, 80
    classes) at 416 x 416, B=8, seeded card weights with random
    BatchNorm statistics (_randomize_bn), 4 seeded calibration batches:
    the three maps' shapes, the seconds of trace + convert and
    calc_qparams, float and fake-quant ms a batch, the mean per-layer
    error (get_quantization_error), the maps' spread over the images,
    the W8A8 relative MSE of each map, the calibration peak memory. Then
    yolov4, yolov5s and yolov3_tiny at the same size: trace, quantizers
    off against float, one calibration batch, float and fake-quant ms.
    Held: the map shapes; quantizers off within 1e-3 of float relative to
    the largest map value: FUSE_BN folds BatchNorm into the weights, a
    rewrite whose f32 rounding these random networks amplify with depth,
    as they amplify quantization noise (yolov3 4.98e-05, yolov4 3.33e-04,
    whose W8A8 relative MSE is ~1; H100 80GB HBM3, 700 W); finite maps
    and errors; every quantizer's qparams on the card against the port's
    on the CPU on yolov3_darknet21 (B=1 at 128 x 128): zero points equal,
    scales within 1e-4 relative, as the activations' ranges differ
    between the devices' convolutions (1.16e-05 measured; the float
    maps' card-vs-CPU difference is printed beside it). No kernel of the
    port."""
    import copy

    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    cfg = parse_qconfig(os.path.join(PTQ_DIR, "coco_yolov3_tiny",
                                     "qconfig.yaml"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    calib = [_images(gen, YOLO_BATCH, YOLO_SIZE) for _ in range(YOLO_CALIB)]
    x = _images(gen, YOLO_BATCH, YOLO_SIZE)
    out = {}
    for name in ("yolov3",) + YOLO_ALSO:
        model = _yolo_model(name, gen, calib[-1])
        with torch.no_grad():  # before QuantModel folds BatchNorm into it
            f_maps = model(x)
            float_ms = cuda_ms(lambda i: model(x), 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qmodel = QuantModel(model, cfg, (calib[0],))
        torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        with torch.no_grad():
            scale = max(float(m.abs().max()) for m in f_maps)
            off = max(float((a - b).abs().max())
                      for a, b in zip(qmodel(x), f_maps)) / max(scale, 1.0)
        full = name == "yolov3"
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times, _ = _calibrate(qmodel, calib if full else calib[:1])
        peak = torch.cuda.max_memory_allocated() - base
        qmodel.set_quant(True, True)
        with torch.no_grad():
            q_maps = qmodel(x)
            quant_ms = cuda_ms(lambda i: qmodel(x), 10)
        shapes = [tuple(m.shape) for m in q_maps]
        r = dict(times, shapes=shapes, trace_convert_s=trace_s,
                 quant_off_rel_max_err=off, calib_peak_bytes=peak,
                 float_ms_per_batch=float_ms, quant_ms_per_batch=quant_ms,
                 map_std_over_images=[float(m.std(0).mean())
                                      for m in f_maps],
                 w8a8_rel_mse=[_rel_mse(a, b)
                               for a, b in zip(q_maps, f_maps)])
        if full:
            t0 = time.perf_counter()
            err = qmodel.get_quantization_error(x)
            r["error_profile_s"] = time.perf_counter() - t0
            r["mean_layer_error"] = float(sum(float(e) for e in err.values())
                                          / len(err))
            r["layers_profiled"] = len(err)
        out[name] = r
        print("yolo {}: {}x{} B={} x {} calibration batches: maps {}; trace "
              "+ convert {:.3f} s, calc_qparams {:.3f} s, calibration peak "
              "{:.2f} GB; quant off vs float {:.2e} of the largest value; "
              "float {:.3f} ms / batch, fake-quant {:.3f} ms; maps' std "
              "over images {}; w8a8 rel MSE {}{}".format(
                  name, YOLO_SIZE, YOLO_SIZE, YOLO_BATCH,
                  len(calib) if full else 1, shapes, trace_s,
                  times["calc_qparams_s"], peak / 1e9, off, float_ms,
                  quant_ms, ["{:.3e}".format(v)
                             for v in r["map_std_over_images"]],
                  ["{:.3e}".format(v) for v in r["w8a8_rel_mse"]],
                  "; mean per-layer error {:.4e} over {} layers ({:.2f} "
                  "s)".format(r["mean_layer_error"], r["layers_profiled"],
                              r["error_profile_s"]) if full else ""),
              flush=True)
        strides = (32, 16, 8) if name != "yolov3_tiny" else (32, 16)
        want = [(YOLO_BATCH, YOLO_SIZE // s, YOLO_SIZE // s, 255)
                for s in strides]
        if shapes != want:
            fail("yolo {}: maps {} != {}".format(name, shapes, want))
        if off > 1e-3:
            fail("yolo {}: quantizers off differ from the float model by "
                 "{:.2e} of its largest value".format(name, off))
        if not all(math.isfinite(v) for v in r["w8a8_rel_mse"]) or (
                full and not math.isfinite(r["mean_layer_error"])):
            fail("yolo {}: a quantized map or error is not finite".format(
                name))
        del model, qmodel, f_maps, q_maps
        torch.cuda.empty_cache()
    xs = _images(gen, 1, YOLO_CPU_SIZE)
    small = _yolo_model("yolov3_darknet21", gen, xs)
    with torch.no_grad():
        on_card = small(xs)
        on_cpu = copy.deepcopy(small).cpu()(xs.cpu())
    float_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                    for a, b in zip(on_card, on_cpu))
    s_err, z_diff, n_q, cpu_s = _qparams_card_vs_cpu(small, cfg, xs)
    out["card_vs_cpu"] = dict(model="yolov3_darknet21", size=YOLO_CPU_SIZE,
                              quantizers=n_q, scale_max_rel_err=s_err,
                              zero_points_differ=z_diff, cpu_s=cpu_s,
                              float_maps_rel_err=float_err)
    print("yolo: card vs CPU, yolov3_darknet21 1 x {0}x{0}: {1} quantizers, "
          "scales max rel err {2:.2e}, {3} zero points differ ({4:.1f} s on "
          "the CPU); the float maps differ by {5:.2e} of their largest "
          "value".format(YOLO_CPU_SIZE, n_q, s_err, z_diff, cpu_s,
                         float_err), flush=True)
    if s_err > 1e-4 or z_diff:
        fail("yolo: the card's qparams differ from the CPU's (scale rel err "
             "{:.2e}, {} zero points)".format(s_err, z_diff))
    out["launches"] = _launches()
    _expect("yolo", out["launches"], (), tuple(out["launches"]))
    return {"yolo": out}


def _lss_oracle(lss, x):
    """The view transform per point in float64 on the card: each point's
    feature added into its cell by index_add_ (the drop cell sliced off)."""
    import torch

    D, C = lss.depth_bins, lss.ctx_ch
    Hb, Wb = lss.bev_hw
    B = x.shape[0] // lss.n_cams
    depth = torch.softmax(x[..., :D].double(), dim=-1)
    feat = (depth[..., :, None] * x[..., D:].double()[..., None, :]).reshape(
        B, -1, C)
    acc = torch.zeros((B, Hb * Wb + 1, C), dtype=torch.float64,
                      device=x.device)
    acc.index_add_(1, lss.cell_ids.long(), feat)
    return acc[:, :-1].reshape(B, Hb, Wb, C)


def bevdet_path():
    """Phase 4, path bevdet: the BEVDet QAT CLI's flow
    (nuscenes_bevdet/main_torch.py) on bevdet_lite at its default (4
    cameras at 64 x 96, 16 depth bins, 32 context channels, BEV 32 x 32,
    10 classes), B=8 scenes (32 images), seeded card weights, its default
    qconfig_lsq_4w4f.yaml read without PyYAML: the view transform on the
    depthnet's output against the float64 per-point oracle (held within
    1e-5 and bit-equal on a second call; its ms), calibration, init_QAT,
    4 Adam steps (lr 5e-3) on the CenterPoint loss against seeded targets
    (s a step split forward / backward / optimiser, peak memory above the
    model; held: the loss falls), and one step at 32 x 48, B=1 on the
    card against the CPU: on the 8w8f yaml held to _qat_card_vs_cpu's
    tolerance; on the 4w4f yaml the loss held within 1e-3 and the
    gradients printed: there a 4-bit code at a rounding tie flips between
    the devices (bev_neck's input, the forward 4e-7 apart before it) and
    the training-mode BatchNorm backward over one BEV map, which cancels
    most of the gradient, spreads the flip to ~0.8 of the gradients'
    norm on every node before it, while two runs on the card agree
    within 8.4e-8 (bevdet_qat_probe.py, H100 80GB HBM3, 700 W). No
    kernel of the port: the pooling is a gather and slot-by-slot
    adds."""
    import importlib.util

    import torch
    from sparsebit_tpu_torch import QuantModel, parse_qconfig
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.quantization.tools.qat import (
        init_qat_state,
        make_qat_step,
    )

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    spec = importlib.util.spec_from_file_location(
        "bevdet_cli", os.path.join(QAT_DIR, "nuscenes_bevdet",
                                   "main_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    yaml_path = os.path.join(QAT_DIR, "nuscenes_bevdet",
                             "qconfig_lsq_4w4f.yaml")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100)
    model = create_model("bevdet_lite", seed=SEED, device="cuda").eval()
    x = torch.randn((BEV_BATCH * 4, 64, 96, 3), generator=gen,
                    device="cuda")
    lss = model.view_transform
    with torch.no_grad():
        feats = model.depthnet(model.img_neck(model.img_backbone(x)))
        pooled = lss(feats)
        again = lss(feats)
        oracle = _lss_oracle(lss, feats)
        lss_ms = cuda_ms(lambda i: lss(feats), 10)
    lss_err = float((pooled.double() - oracle).abs().max())
    lss_equal = bool(torch.equal(pooled, again))
    qmodel = QuantModel(model, parse_qconfig(yaml_path), (x,))
    hm_t = (torch.rand((BEV_BATCH, 32, 32, 10), generator=gen, device="cuda")
            > 0.98).float()
    box_t = torch.randn((BEV_BATCH, 32, 32, 8), generator=gen, device="cuda")
    t0 = time.perf_counter()
    qmodel.prepare_calibration()
    qmodel(x)
    qmodel.init_QAT()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    qmodel.train()
    trainable, opt = init_qat_state(
        qmodel, lambda ps: torch.optim.Adam(ps, lr=BEV_LR))
    timer = _StepTimer(cli.centerpoint_loss, opt)
    step = make_qat_step(qmodel, timer.loss_fn, opt)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(BEV_STEPS):
        trainable, loss = timer.run(lambda: step(trainable, x, (hm_t,
                                                                box_t)))
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated() - base
    qmodel.eval()
    del qmodel, model, trainable, opt
    torch.cuda.empty_cache()
    cvc = {}
    for name in ("qconfig_lsq_8w8f.yaml", "qconfig_lsq_4w4f.yaml"):
        g = torch.Generator().manual_seed(SEED + 101)
        small = create_model("bevdet_lite", img_hw=(32, 48), seed=SEED,
                             device="cpu").eval()
        cvc[name] = _qat_card_vs_cpu(
            os.path.join(QAT_DIR, "nuscenes_bevdet", name), small,
            torch.randn((4, 32, 48, 3), generator=g),
            ((torch.rand((1, 32, 32, 10), generator=g) > 0.98).float(),
             torch.randn((1, 32, 32, 8), generator=g)), cli.centerpoint_loss)
    out = dict(timer.summary(1), view_transform_max_abs_err=lss_err,
               view_transform_bit_equal_twice=lss_equal,
               view_transform_ms=lss_ms, calibrate_init_s=calib_s,
               peak_bytes_above_model=peak, losses=losses, card_vs_cpu=cvc)
    print("bevdet: bevdet_lite B={} (x4 cameras, 64x96): view transform vs "
          "the f64 oracle {:.2e}, bit-equal twice {}, {:.4f} ms; calibrate "
          "+ init_QAT {:.2f} s; {:.4f} s a step (forward {:.4f}, backward "
          "{:.4f}, optimiser {:.4f}), peak {:.2f} GB above the model; loss "
          "{}; one step card vs CPU: {}".format(
              BEV_BATCH, lss_err, lss_equal, lss_ms, calib_s,
              out["s_per_step"], out["forward_s"], out["backward_s"],
              out["optimizer_s"], peak / 1e9,
              ["{:.4f}".format(v) for v in losses], cvc), flush=True)
    if lss_err > 1e-5 or not lss_equal:
        fail("bevdet: the view transform is off the oracle by {:.2e} or "
             "differs between calls".format(lss_err))
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail("bevdet: the QAT loss did not fall: {}".format(losses))
    if not cvc["qconfig_lsq_8w8f.yaml"]["held"] or cvc[
            "qconfig_lsq_4w4f.yaml"]["loss_rel_err"] > 1e-3:
        fail("bevdet: the card's QAT step differs from the CPU's: {}".format(
            cvc))
    out["launches"] = _launches()
    _expect("bevdet", out["launches"], (), tuple(out["launches"]))
    return {"bevdet": out}


def _seeded_like(model, gen):
    """A state dict of ``model``'s names and shapes (the causal mask left
    out) with seeded card values: weights scaled by 1 / sqrt(fan in),
    1-D weights (norm gains) near 1, variances positive."""
    import torch

    out = {}
    for k, v in model.state_dict().items():
        if k.endswith("causal_bias"):
            continue
        t = torch.randn(v.shape, generator=gen, device="cuda")
        if k.endswith("running_var"):
            t = t.abs() + 0.5
        elif v.dim() >= 2:
            t = t * float(v[0].numel()) ** -0.5
        else:
            t = t * 0.1 + float(k.endswith(".weight"))
        out[k] = t
    return out


def _hf_gpt2_layout(sd):
    """The port's GPT-2 state dict in Hugging Face's GPT2LMHeadModel
    layout: ``transformer.h.N`` names, the MLP under ``mlp.``, the
    linears as Conv1D weights (in, out)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            _, n, rest = k.split(".", 2)
            sub, leaf = rest.rsplit(".", 1)
            sub = {"c_fc": "mlp.c_fc", "c_proj": "mlp.c_proj"}.get(sub, sub)
            if leaf == "weight" and not sub.startswith("ln_"):
                v = v.T
            k = "transformer.h.{}.{}.{}".format(n, sub, leaf)
        elif not k.startswith("lm_head"):
            k = "transformer." + k
        out[k] = v
    return out


def importtorch_path():
    """Phase 4, path importtorch: the checkpoint importers on the card. A
    seeded state dict in torchvision's resnet18 layout (``downsample.0/1``,
    ``num_batches_tracked``) through load_resnet_from_torch, and one in
    Hugging Face GPT-2's layout at gpt2_small widths (``transformer.``
    names, Conv1D weights (in, out), lm_head) through load_gpt2_from_hf,
    each against the same model filled directly in the port's layout
    (load_state_dict) on the same values. Held: outputs bit-equal
    (resnet18 on 8 x 224 x 224 images, gpt2_small on 2 x 128 tokens). No
    kernel of the port."""
    import torch
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.models import import_torch as I

    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 110)
    out = {}
    ref = create_model("resnet18", seed=SEED, device="cuda").eval()
    sd = _seeded_like(ref, gen)
    ref.load_state_dict(sd)
    tv = {k.replace("down_conv", "downsample.0").replace(
        "down_bn", "downsample.1"): v for k, v in sd.items()}
    tv.update({k.rsplit(".", 1)[0] + ".num_batches_tracked":
               torch.tensor(1) for k in sd if k.endswith("running_var")})
    got = I.load_resnet_from_torch(
        create_model("resnet18", seed=SEED + 1, device="cuda"), tv).eval()
    x = _images(gen, 8)
    with torch.no_grad():
        r_eq = bool(torch.equal(got(x), ref(x)))
    ref = create_model("gpt2_small", seed=SEED, device="cuda").eval()
    sd = _seeded_like(ref, gen)
    sd["lm_head.weight"] = sd["wte.weight"]  # tied
    ref.load_state_dict(sd, strict=False)
    got = I.load_gpt2_from_hf(
        create_model("gpt2_small", seed=SEED + 1, device="cuda"),
        _hf_gpt2_layout(sd)).eval()
    ids = torch.randint(0, ref.wte.num_embeddings, (2, 128), generator=gen,
                        device="cuda")
    with torch.no_grad():
        g_eq = bool(torch.equal(got(ids), ref(ids)))
    out = dict(resnet18_bit_equal=r_eq, gpt2_small_bit_equal=g_eq)
    print("importtorch: resnet18 (torchvision layout, 8 x 224 x 224) "
          "bit-equal {}; gpt2_small (HF layout, 2 x 128 tokens) bit-equal "
          "{}".format(r_eq, g_eq), flush=True)
    if not (r_eq and g_eq):
        fail("importtorch: an imported model differs from the one filled "
             "directly (resnet18 {}, gpt2_small {})".format(r_eq, g_eq))
    out["launches"] = _launches()
    _expect("importtorch", out["launches"], (), tuple(out["launches"]))
    return {"importtorch": out}


def profiling_path():
    """Phase 4, path profiling: utils/profiling.py on the card around
    gpt2_small (seeded card weights, 8 x 1024 tokens): ``wall_timer``
    with ``sync=True`` around one forward beside CUDA events around the
    same forward, and ``trace`` around another, whose Chrome trace is
    read back. Held: the trace file exists and names CUDA kernels; the
    wall time is no shorter than the events' (the timer waits for the
    card). No kernel of the port."""
    import shutil
    import tempfile

    import torch
    from sparsebit_tpu_torch.models import create_model
    from sparsebit_tpu_torch.utils.profiling import trace, wall_timer

    _reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 120)
    model = create_model("gpt2_small", seed=SEED, device="cuda").eval()
    ids = torch.randint(0, model.wte.num_embeddings, (GPT2_BATCH, GPT2_SEQ),
                        generator=gen, device="cuda")
    logdir = tempfile.mkdtemp(prefix="sbt_trace_")
    try:
        with torch.no_grad():
            model(ids)  # warm-up
            ev_ms = cuda_ms(lambda i: model(ids), 1, warmup=0)
            with wall_timer("profiling gpt2_small forward", sync=True) as box:
                model(ids)
            with trace(logdir) as prof:
                model(ids)
                torch.cuda.synchronize()
        exists = os.path.exists(prof.trace_path)
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = sorted({e["name"] for e in events
                          if e.get("cat") == "kernel"})
        device_us = sum(e.get("dur", 0) for e in events
                        if e.get("cat") == "kernel")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    out = dict(wall_timer_s=box["seconds"], events_ms=ev_ms,
               trace_written=exists, trace_cuda_kernels=len(kernels),
               trace_kernel_ms=device_us / 1e3,
               trace_kernel_sample=kernels[:3])
    print("profiling: gpt2_small {} x {} forward: wall_timer {:.4f} s, CUDA "
          "events {:.3f} ms; trace written {}, {} distinct CUDA kernels "
          "({:.3f} ms of kernel time), e.g. {}".format(
              GPT2_BATCH, GPT2_SEQ, box["seconds"], ev_ms, exists,
              len(kernels), device_us / 1e3, kernels[:3]), flush=True)
    if not (exists and kernels):
        fail("profiling: the trace is missing or names no CUDA kernel")
    if box["seconds"] * 1e3 < 0.5 * ev_ms:
        fail("profiling: wall_timer {:.3f} ms is below the card's {:.3f} "
             "ms".format(box["seconds"] * 1e3, ev_ms))
    out["launches"] = _launches()
    _expect("profiling", out["launches"], (), tuple(out["launches"]))
    return {"profiling": out}


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
    t0 = time.perf_counter()
    paths.update(int4kv_path(params, cfg))
    paths.update(kpad_path(params, cfg))
    print("int4kv and kpad paths {:.1f} s".format(time.perf_counter() - t0))
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp, tp_admission = tp_path(cfg)
    paths.update(tp)
    print("tp path {:.1f} s".format(time.perf_counter() - t0), flush=True)
    t0 = time.perf_counter()
    paths.update(tp2_path(tp_admission))
    print("tp2 path {:.1f} s".format(time.perf_counter() - t0), flush=True)
    t0 = time.perf_counter()
    paths.update(train_paths())
    paths.update(pptp_path())
    paths.update(dpqat_path())
    print("pptrain, tptrain, sptrain, pptp and dpqat paths {:.1f} s".format(
        time.perf_counter() - t0), flush=True)
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
    t0 = time.perf_counter()
    paths.update(longctx_path())
    print("longctx path {:.1f} s".format(time.perf_counter() - t0),
          flush=True)
    t0 = time.perf_counter()
    paths.update(offload_path(cfg))
    print("offload path {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    paths.update(quantcore_path())
    print("quantcore path {:.1f} s".format(time.perf_counter() - t0))
    t0 = time.perf_counter()
    paths.update(graphptq_path())
    paths.update(graphcalib_path())
    paths.update(cnnfixture_path())
    print("graphptq, graphcalib and cnnfixture paths {:.1f} s".format(
        time.perf_counter() - t0))
    for path_fn in (deploy_path, export_path, errprof_path, qat_path,
                    qatdeit_path, bertptq_path, trfixture_path, prune_path,
                    prunebert_path, zoo_path, gpt2ptq_path, yolo_path,
                    bevdet_path, importtorch_path, profiling_path):
        t0 = time.perf_counter()
        paths.update(path_fn())
        print("{} {:.1f} s".format(path_fn.__name__.replace("_", " "),
                                   time.perf_counter() - t0), flush=True)
    _GRAPH.clear()
    # launches of each kernel on the path that runs it: K5 and K8 on
    # generate (this slice's main path), K6 on the engine's decode_chunk
    # route, K7 on the mixed-precision model (its int8 form with impl
    # "a8"), K2/K3 on the unfused route, K1, K4 and K9 on the K4 engine,
    # K4's plane mode on the planes path, K10 on the 2048-token cold
    # prefill, K11 and K12 on QLoRA training (the dense backward's 4 steps);
    # the f32 rows at the long-context record's shape on path longctx
    where = {"K2": "unfused", "K3": "unfused", "K5": "generate B=8 greedy",
             "K6": "chunk", "K7": "mixed impl=auto depth 4",
             "K8": "generate B=8 greedy", "K4p": "planes B=8",
             "K10": "prefill B=1 S=2048", "K11": "qlora dense",
             "K12": "qlora dense"}
    for r in results:
        r["path"] = where.get(r["kernel"], "main")
        if r["kernel"] == "K7" and "int8" in r["shape"]:
            r["path"] = "mixed impl=a8 depth 4"
        if r["shape"].endswith("B={} S={} H={} Hkv={} hd={}".format(
                *LONGCTX_ATTN)):
            r["path"] = "longctx"  # the record's training attention
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
