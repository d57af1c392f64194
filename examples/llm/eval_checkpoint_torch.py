"""One-command checkpoint accuracy pipeline on the PyTorch/CUDA port (the
port's examples/llm/eval_checkpoint.py; reference:
llama/quantization/convert.py:176-259 llama_eval flow + README table).

    # fp16 vs GPTQ-INT4 perplexity on a real LLaMA + token file:
    python eval_checkpoint_torch.py --hf-path /path/to/llama \
        --tokens wikitext2_test.npy --calib-tokens wikitext2_calib.npy \
        --bits 4 --groupsize 128 --save ckpt_int4 --out results.json

    # re-evaluate an existing GPTQ checkpoint (no fp pass):
    python eval_checkpoint_torch.py --ckpt ckpt_int4 --tokens wikitext2_test.npy

    # smoke mode (no HF weights): random tiny model + synthetic stream
    python eval_checkpoint_torch.py --demo --out results.json

Token files are 1-D int32 .npy streams; --calib-tokens may be the same
stream, reshaped to (n_samples, seqlen) windows for GPTQ. Everything runs
on --device (default cuda), where the backbone's attention is K10 and the
lm_head and log-softmax go in sequence chunks (llm/eval.py).
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse
import json

import numpy as np
import torch

from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.eval import perplexity


def _load_stream(path, n_tokens=None):
    toks = np.load(path).reshape(-1).astype(np.int32)
    if n_tokens:
        toks = toks[:n_tokens]
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hf-path", default=None,
                    help="local HF LLaMA dir (fp baseline + GPTQ source)")
    ap.add_argument("--ckpt", default=None,
                    help="existing GPTQ checkpoint dir (save_quant_checkpoint)")
    ap.add_argument("--tokens", default=None,
                    help="1-D int32 .npy eval token stream")
    ap.add_argument("--calib-tokens", default=None,
                    help="1-D or (n, seqlen) int32 .npy for GPTQ calibration")
    ap.add_argument("--bits", type=int, nargs="+", default=None,
                    help="GPTQ candidate bits (e.g. --bits 2 3 4 for the "
                         "mixed-precision allocator); omit to skip convert")
    ap.add_argument("--groupsize", type=int, default=128)
    ap.add_argument("--sym", action="store_true")
    ap.add_argument("--act-order", action="store_true")
    ap.add_argument("--n-calib", type=int, default=16)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--max-tokens", type=int, default=None,
                    help="truncate the eval stream (quick runs)")
    ap.add_argument("--save", default=None,
                    help="save the GPTQ checkpoint here after converting")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--skip-fp", action="store_true",
                    help="skip the fp baseline perplexity pass")
    ap.add_argument("--demo", action="store_true",
                    help="random tiny model + synthetic stream (smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    result = {"seqlen": args.seqlen, "groupsize": args.groupsize}

    # ---- model + data sources ----------------------------------------------
    fp_params = cfg = None
    calib = None
    if args.demo:
        # an f32 model, so that its checkpoint (float leaves read back in
        # cfg.dtype) is the model that was evaluated
        cfg = L.llama_tiny(dtype="float32")
        fp_params = L.init_llama_params(
            cfg, torch.Generator().manual_seed(0), device=dev)
        args.seqlen = min(args.seqlen, 32)
        result["seqlen"] = args.seqlen
        rng = np.random.RandomState(0)
        toks = rng.randint(1, cfg.vocab_size, size=4 * args.seqlen)
        toks = toks.astype(np.int32)
        calib = toks[: 2 * args.seqlen]
        if args.bits is None:
            args.bits = [4]
        args.groupsize = min(args.groupsize, 32)
        result["groupsize"] = args.groupsize
        result["demo"] = True
    else:
        if not args.tokens:
            raise SystemExit("--tokens required (or --demo)")
        toks = _load_stream(args.tokens, args.max_tokens)
        calib = (_load_stream(args.calib_tokens)
                 if args.calib_tokens else None)
        if args.hf_path:
            from sparsebit_tpu_torch.llm.import_hf import load_llama_from_hf

            fp_params, cfg = load_llama_from_hf(args.hf_path, device=dev)

    # ---- fp baseline ---------------------------------------------------------
    if fp_params is not None and not args.skip_fp:
        ppl = perplexity(fp_params, toks, cfg, seqlen=args.seqlen,
                         verbose=True, device=dev)
        result["fp_ppl"] = round(ppl, 4)
        print("fp ppl = {:.4f}".format(ppl))

    # ---- quantized model -----------------------------------------------------
    qparams = layers_bit = None
    if args.ckpt:
        from sparsebit_tpu_torch.llm.convert import load_quant_checkpoint

        qparams, cfg, layers_bit = load_quant_checkpoint(args.ckpt,
                                                         device=dev)
        result["checkpoint"] = args.ckpt
    elif args.bits:
        if fp_params is None:
            raise SystemExit("--bits needs --hf-path (or --demo)")
        if calib is None:
            raise SystemExit("--bits needs --calib-tokens")
        from sparsebit_tpu_torch.llm.convert import (
            quantize_llama_gptq,
            save_quant_checkpoint,
        )

        n_win = min(args.n_calib, len(calib) // args.seqlen)
        if n_win <= 0:
            raise SystemExit("calib stream shorter than one seqlen window")
        calib_w = calib[: n_win * args.seqlen].reshape(n_win, args.seqlen)
        fused = L.fuse_llama_params(fp_params)
        qparams, layers_bit = quantize_llama_gptq(
            fused, calib_w, cfg, candidate_bits=tuple(args.bits),
            groupsize=args.groupsize, sym=args.sym,
            act_order=args.act_order, verbose=not args.demo, device=dev)
        if args.save:
            save_quant_checkpoint(args.save, qparams, layers_bit, cfg,
                                  args.groupsize)
            result["checkpoint"] = args.save

    if qparams is not None:
        ppl = perplexity(qparams, toks, cfg, seqlen=args.seqlen,
                         verbose=True, device=dev)
        result["quant_ppl"] = round(ppl, 4)
        if layers_bit:
            result["layers_bit"] = {str(k): int(v)
                                    for k, v in layers_bit.items()}
            result["mean_bits"] = round(
                float(np.mean(list(layers_bit.values()))), 3)
        print("quant ppl = {:.4f}".format(ppl))

    if "fp_ppl" in result and "quant_ppl" in result:
        result["ppl_delta"] = round(result["quant_ppl"] - result["fp_ppl"], 4)

    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
