"""GPTQ conversion CLI on the PyTorch/CUDA port (the port's
examples/llm/gptq_convert.py; reference: llama/quantization/convert.py:293).

    python gptq_convert_torch.py --hf-path /path/to/llama --bits 4 3 2 \
        --groupsize 128 --calib-tokens calib.npy --save ckpt_dir

Without --hf-path a random-initialised tiny LLaMA demonstrates the flow.
calib tokens: .npy int32 of shape (n_samples, seqlen) (the reference uses
128 x 2048 wikitext2 samples, convert.py:37). Runs on --device (default
cuda); the checkpoint is the npz format both packages read.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse

import numpy as np
import torch

from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.convert import (
    quantize_llama_gptq,
    save_quant_checkpoint,
)
from sparsebit_tpu_torch.llm.eval import perplexity


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hf-path", default=None)
    ap.add_argument("--bits", type=int, nargs="+", default=[4],
                    help="mixed-precision candidates, e.g. --bits 2 3 4")
    ap.add_argument("--groupsize", type=int, default=128)
    ap.add_argument("--sym", action="store_true")
    ap.add_argument("--calib-tokens", default=None)
    ap.add_argument("--n-samples", type=int, default=16)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--save", default="gptq_ckpt")
    ap.add_argument("--eval", action="store_true",
                    help="wikitext-style ppl before/after")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    if args.hf_path:
        from sparsebit_tpu_torch.llm.import_hf import load_llama_from_hf

        params, cfg = load_llama_from_hf(args.hf_path, torch.float32,
                                         device=dev)
    else:
        print("[warn] no --hf-path; random tiny LLaMA (flow demo)")
        cfg = L.llama_tiny(dim=256, ffn_dim=512, n_layers=2)
        params = L.init_llama_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
        args.seqlen = min(args.seqlen, cfg.max_seq_len)

    if args.calib_tokens:
        calib = np.load(args.calib_tokens).astype(np.int32)[: args.n_samples]
    else:
        calib = np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(args.n_samples, args.seqlen)
        ).astype(np.int32)

    if args.eval:
        ppl = perplexity(params, calib.reshape(-1), cfg, seqlen=args.seqlen,
                         device=dev)
        print("float ppl: {:.4f}".format(ppl))

    qparams, layers_bit = quantize_llama_gptq(
        params, calib, cfg, candidate_bits=tuple(args.bits),
        groupsize=args.groupsize, sym=args.sym, device=dev)
    if args.eval:
        ppl = perplexity(qparams, calib.reshape(-1), cfg, seqlen=args.seqlen,
                         device=dev)
        print("quant ppl: {:.4f}".format(ppl))

    save_quant_checkpoint(args.save, qparams, layers_bit, cfg, args.groupsize)
    print("saved to", args.save)
    return layers_bit


if __name__ == "__main__":
    main()
