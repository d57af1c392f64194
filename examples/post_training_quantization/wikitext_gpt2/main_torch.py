"""PTQ GPT-2 on a token stream with a perplexity eval, on the PyTorch port
(the port of ``main.py`` beside it; reference:
examples/post_training_quantization/wikitext/main.py): NLC layout, MSE
activation observers, an ACIQ-Laplace lm_head (qconfig.yaml).

Flow: QuantModel -> prepare_calibration -> --calib-windows windows of
--seqlen tokens -> calc_qparams -> perplexity over the stream's windows
with quantizers off (float) and on (int8). --tokens is a .npy int token
stream; without it a seeded random stream drives the flow. --ckpt loads
an npz of the JAX package's ``full_state_dict`` layout (the file main.py
loads), transposed on load. Runs on the card unless --device names
another device.

    python main_torch.py --tokens wikitext_tokens.npy [--ckpt gpt2.npz]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sparsebit_tpu_torch import QuantModel, parse_qconfig  # noqa: E402
from sparsebit_tpu_torch import resolve_device  # noqa: E402
from sparsebit_tpu_torch.models import create_model  # noqa: E402
from sparsebit_tpu_torch.nn import load_jax_state_dict  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


@torch.no_grad()
def ppl(model_fn, toks, seqlen, device):
    """exp of the mean next-token negative log-likelihood over the
    stream's whole windows of ``seqlen`` tokens."""
    total, count = 0.0, 0
    for i in range(len(toks) // seqlen):
        win = torch.from_numpy(toks[i * seqlen:(i + 1) * seqlen][None]).to(
            device)
        logp = torch.log_softmax(model_fn(win)[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, win[:, 1:, None].long()).sum()
        total += float(nll)
        count += win.shape[1] - 1
    return float(np.exp(total / count))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gpt2_small",
                    choices=["gpt2_small", "gpt2_tiny"])
    ap.add_argument("--qconfig", default=os.path.join(HERE, "qconfig.yaml"))
    ap.add_argument("--tokens", default=None, help=".npy int token stream")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--calib-windows", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = create_model(args.model, device=device)
    if args.ckpt:
        load_jax_state_dict(model, dict(np.load(args.ckpt)))
    model.eval()

    if args.tokens:
        toks = np.load(args.tokens).astype(np.int32)
    else:
        print("[warn] no --tokens; random stream (flow demo)")
        toks = np.random.default_rng(0).integers(
            0, model.wte.num_embeddings,
            size=(args.seqlen * (args.calib_windows + 2),)).astype(np.int32)

    def window(i):
        return torch.from_numpy(
            toks[i * args.seqlen:(i + 1) * args.seqlen][None]).to(device)

    qmodel = QuantModel(model, parse_qconfig(args.qconfig), (window(0),))
    qmodel.prepare_calibration()
    for i in range(args.calib_windows):
        qmodel(window(i))
    qmodel.calc_qparams()

    qmodel.set_quant(False, False)
    float_ppl = ppl(qmodel, toks, args.seqlen, device)
    print("float ppl: {:.3f}".format(float_ppl))
    qmodel.set_quant(True, True)
    int8_ppl = ppl(qmodel, toks, args.seqlen, device)
    print("int8 ppl:  {:.3f}".format(int8_ppl))
    return {"float_ppl": float_ppl, "int8_ppl": int8_ppl}


if __name__ == "__main__":
    main()
