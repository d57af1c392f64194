"""The port's LLM command-line tools (``examples/llm/*_torch.py``) in demo
mode on the CPU, as tests/test_llm.py runs the JAX package's: GPTQ
conversion, the checkpoint evaluation pipeline (its saved checkpoint
re-evaluates to the same perplexity within rtol 1e-4), quantized
generation from a converted checkpoint, and the accuracy fixture's record
written to a temporary path."""

import importlib
import json
import os
import sys

import numpy as np
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "llm")

torch.set_num_threads(1)


def _cli(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def test_eval_checkpoint_torch_demo(tmp_path):
    """GPTQ-convert the demo model, save, evaluate; the saved checkpoint
    re-evaluates to the same perplexity."""
    cli = _cli("eval_checkpoint_torch")
    out = str(tmp_path / "results.json")
    ckpt = str(tmp_path / "ckpt")
    res = cli.main(["--demo", "--out", out, "--save", ckpt, "--bits", "4",
                    "--seqlen", "32", "--device", "cpu"])
    assert "fp_ppl" in res and "quant_ppl" in res and "ppl_delta" in res
    assert res["mean_bits"] == 4.0
    with open(out) as f:
        assert json.load(f)["quant_ppl"] == res["quant_ppl"]
    res2 = cli.main(["--demo", "--ckpt", ckpt, "--skip-fp", "--seqlen", "32",
                     "--device", "cpu"])
    np.testing.assert_allclose(res2["quant_ppl"], res["quant_ppl"],
                               rtol=1e-4)


def test_gptq_convert_then_inference_torch(tmp_path):
    """gptq_convert_torch's demo (mixed 4/3-bit candidates) writes a
    checkpoint that gptq_inference_torch decodes."""
    ckpt = str(tmp_path / "ckpt")
    layers_bit = _cli("gptq_convert_torch").main(
        ["--bits", "4", "3", "--n-samples", "2", "--seqlen", "32",
         "--groupsize", "32", "--save", ckpt, "--device", "cpu"])
    assert len(layers_bit) == 2 * 7 and set(layers_bit.values()) <= {3, 4}
    assert os.path.exists(os.path.join(ckpt, "weights.npz"))
    out = _cli("gptq_inference_torch").main(
        ["--ckpt", ckpt, "--tokens", "4", "--device", "cpu"])
    assert tuple(out.shape) == (1, 4)
    assert bool(((out >= 0) & (out < 512)).all())


def test_accuracy_fixture_torch_writes_record(tmp_path):
    out = tmp_path / "ACCURACY_torch.json"
    out.write_text(json.dumps({"other": 1}))
    res = _cli("accuracy_fixture_torch").main(
        ["--steps", "10", "--bits", "4", "--device", "cpu", "--out",
         str(out)])
    rec = json.loads(out.read_text())
    assert rec["other"] == 1 and rec["llm_gptq"] == res
    assert res["device"] == "cpu" and res["train_steps"] == 10
    for key in ("ppl_float", "ppl_rtn_int4", "ppl_gptq_int4"):
        assert np.isfinite(res[key]) and res[key] > 1.0
