"""How far an attention fault reaches the checks that hold K10 (flash
causal attention), on the CPU at small widths; no GPU needed.

  python attention_reach_probe.py

1. The per-element bound K10 is held to (ops/flash_attention.
   flash_tolerance), bf16 B=1 H=4 S=512 hd=128: for planted faults (key
   tile 0 skipped from rows >= 128, its weights mis-rescaled by e^0.5
   there, every row missing its own key) the share of touched rows with
   an element over the bound and the smallest row's worst err/tol; for a
   correct attention in another order (f32 softmax, P not rounded) the
   largest err/tol.
2. prefill_cold_scanned on random W4A8 models (chip_smoke's prefill
   model, build_random_params, and one whose activations stay O(1):
   build_plane_params(unit=True) in the serving layout), width 512 / 8
   layers and 1024 / 16, B=2 S=256: the flash route against the masked
   route and against a planted fault in every layer (key tile 0 dropped
   from rows >= 128): logits max error and KV code difference by layer.
3. perplexity (seqlen 256, two windows) on chip_smoke's eval model with
   and without ``unit``, width 512 / 8 layers: log-perplexity of the
   masked route and of the planted fault, relative to the flash route.

On the CPU the flash route runs flash_attention_plain (llama._flash_ok
patched to True).
"""

import sys

import numpy as np
import torch

import chip_smoke as C
from sparsebit_tpu_torch.llm import decode as Dm
from sparsebit_tpu_torch.llm import eval as Ev
from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm import serving as Sv
from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
from sparsebit_tpu_torch.llm.quant import QuantLinear
from sparsebit_tpu_torch.ops import flash_attention as FA

CPU = torch.device("cpu")


def bound_probe():
    rng = np.random.default_rng(70)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 512, 128)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    scale = 128 ** -0.5
    ref = FA.flash_attention_plain(q, k, v, sm_scale=scale)
    tol = FA.flash_tolerance(q, k, v, ref, sm_scale=scale)
    S = q.shape[2]
    for fault, first in (("far_tile", 128), ("rescaled_tile", 128),
                         ("diagonal", 1), ("none (f32 softmax)", 0)):
        bias = torch.zeros((S, S))
        if fault == "diagonal":
            idx = torch.arange(1, S)
            bias[idx, idx] = float("-inf")
        elif fault != "none (f32 softmax)":
            bias[first:, :64] = (float("-inf") if fault == "far_tile"
                                 else 0.5)
        out = C.biased_attention(q, k, v, scale, bias)
        r = ((out.float() - ref.float()).abs() / tol).amax(dim=-1)
        r = r[..., first:]
        print("bound: {:<20} rows over {:.4f}, smallest row err/tol {:.3f}, "
              "largest {:.3f}".format(fault, (r > 1).float().mean().item(),
                                      r.min().item(), r.max().item()))


def config(dim, layers):
    return L.LlamaConfig(vocab_size=512, dim=dim, n_layers=layers,
                         n_heads=dim // 128, n_kv_heads=dim // 128,
                         ffn_dim=dim * 11 // 4 // 128 * 128, max_seq_len=512)


def prefill_probe(dim, layers):
    cfg = config(dim, layers)
    models = {
        "prefill model": C.build_random_params(cfg, CPU),
        "O(1) model": C.build_plane_params(cfg, CPU, lambda li, n: 4,
                                           C.SEED + 12, names=C.FUSED,
                                           unit=True)}
    B, S = 2, 256
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(5))
    last = torch.full((B,), S - 1, dtype=torch.int32)
    for name, p in models.items():
        stacked = Dm.stack_layers(L.quantize_llama_params(
            p, lambda path, lin: (Sv._serving_layout(lin)
                                  if isinstance(lin, QuantLinear) else lin),
            skip=()))
        runs = {}
        for route in ("flash", "masked", "fault"):
            patch = [(L, "_flash_ok", lambda q, r=route: r != "masked")]
            if route == "fault":
                patch.append((L, "flash_attention", C.far_tile_fault))
            with C._Patched(patch):
                runs[route] = Dm.prefill_cold_scanned(
                    stacked, tokens, init_kv_cache(cfg, B, S, True,
                                                   device="cpu"), cfg, last)
        lf, cf = runs["flash"]
        for route in ("masked", "fault"):
            lo, co = runs[route]
            err, _ = C._logits_agree(lf, lo)
            diffs = [max((a[li].int() - b[li].int()).abs().max().item()
                         for a, b in ((cf.k, co.k), (cf.v, co.v)))
                     for li in range(layers)]
            print("prefill: width {} {} layers, {}: flash vs {} logits max "
                  "err {:.4f}; KV code diff by layer {}".format(
                      dim, layers, name, route, err, diffs))


def eval_probe(dim, layers):
    cfg = config(dim, layers)
    stream = torch.randint(0, cfg.vocab_size, (2 * 256 + 7,),
                           generator=torch.Generator().manual_seed(3)).numpy()
    for unit in (False, True):
        params = C.build_plane_params(cfg, CPU, lambda li, n: 4, C.SEED + 6,
                                      unit=unit)
        logp = {}
        for route in ("flash", "masked", "fault"):
            patch = [(L, "_flash_ok", lambda q, r=route: r != "masked")]
            if route == "fault":
                patch.append((L, "flash_attention", C.far_tile_fault))
            with C._Patched(patch):
                logp[route] = np.log(Ev.perplexity(
                    params, stream, cfg, seqlen=256, batch=1, device="cpu"))
        print("eval: width {} {} layers, {}: log-ppl rel, masked {:.3e}, "
              "fault {:.3e}".format(
                  dim, layers, "O(1) model" if unit else "default model",
                  *(abs(logp[r] - logp["flash"]) / abs(logp["flash"])
                    for r in ("masked", "fault"))))


def main():
    bound_probe()
    prefill_probe(512, 8)
    prefill_probe(1024, 16)
    eval_probe(512, 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
