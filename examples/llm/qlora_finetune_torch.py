"""QLoRA finetune CLI on the PyTorch/CUDA port (the port's
examples/llm/qlora_finetune.py; reference: alpaca-qlora/finetune.py).

    python qlora_finetune_torch.py --ckpt gptq_ckpt --tokens data.npy \
        --r 8 --alpha 16 --steps 100

Backbone: a GPTQ checkpoint (frozen, packed); adapters: f32 LoRA on the
q/v projections, trained by qlora_train_step with AdamW (optax.adamw's
defaults). On the card the forward's packed matmuls run K8 and its
attention K10, the backward K11/K12 where the head dim allows. The
adapters are saved as ``layers.{i}.{name}.lora_A`` / ``lora_B`` in an npz,
the reference CLI's keys.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))

import argparse

import numpy as np
import torch

from sparsebit_tpu_torch.llm.convert import load_quant_checkpoint
from sparsebit_tpu_torch.llm.qlora import (
    adamw,
    extract_lora,
    qlora_train_step,
    wrap_llama_lora,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--tokens", default=None,
                    help=".npy int32 (N, S) training windows")
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--save", default="lora_adapters.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    params, cfg, _ = load_quant_checkpoint(args.ckpt, device=dev)
    lparams = wrap_llama_lora(params, r=args.r, alpha=args.alpha)
    lora = extract_lora(lparams)

    if args.tokens:
        data = np.load(args.tokens).astype(np.int32)
    else:
        print("[warn] no --tokens; random data (flow demo)")
        data = np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(64, min(128, cfg.max_seq_len))
        ).astype(np.int32)

    opt = adamw(lora, args.lr)
    losses = []
    for s in range(args.steps):
        idx = np.random.default_rng(s).integers(0, len(data),
                                                size=(args.batch,))
        batch = torch.as_tensor(data[idx], device=dev).long()
        lora, loss = qlora_train_step(lora, opt, lparams, batch, cfg)
        losses.append(float(loss))
        if s % 10 == 0:
            print("step {} loss {:.4f}".format(s, losses[-1]))

    flat = {
        "layers.{}.{}.{}".format(i, name, k): v.detach().cpu().numpy()
        for (i, name), ab in lora.items()
        for k, v in ab.items()
    }
    np.savez(args.save, **flat)
    print("saved adapters to", args.save)
    return losses


if __name__ == "__main__":
    main()
