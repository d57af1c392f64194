"""Quantized decode CLI on the PyTorch/CUDA port (the port's
examples/llm/gptq_inference.py; reference:
llama/quantization/inference.py:78).

    python gptq_inference_torch.py --ckpt gptq_ckpt --tokens 128

On the card, generate runs its decode steps on K8 (the packed matmuls),
K5 (decode attention) and K9 (the bf16 lm_head).
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse
import time

import numpy as np
import torch

from sparsebit_tpu_torch.llm.convert import load_quant_checkpoint
from sparsebit_tpu_torch.llm.decode import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--prompt-ids", default=None, help=".npy int32 (B, S)")
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--fp-kv", action="store_true",
                    help="disable INT8 KV cache")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    params, cfg, layers_bit = load_quant_checkpoint(args.ckpt, device=dev)
    bits = sorted(set(layers_bit.values()))
    print("loaded: {} layers, bits {}".format(cfg.n_layers, bits))

    if args.prompt_ids:
        prompt = np.load(args.prompt_ids).astype(np.int32)
    else:
        prompt = np.ones((1, 8), np.int32)

    t0 = time.perf_counter()
    out = generate(params, prompt, cfg, max_new_tokens=args.tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, kv_quantized=not args.fp_kv,
                   generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print("generated {} tokens in {:.2f}s ({:.2f} tok/s, incl. the kernels' "
          "first build)".format(out.numel(), dt, out.numel() / dt))
    print(out.cpu().numpy())
    return out


if __name__ == "__main__":
    main()
