"""The port's LLM command-line tools (``examples/llm/*_torch.py``) in demo
mode on the CPU, as tests/test_llm.py runs the JAX package's: GPTQ
conversion, the checkpoint evaluation pipeline (its saved checkpoint
re-evaluates to the same perplexity within rtol 1e-4), quantized
generation from a converted checkpoint, the accuracy fixture's record
written to a temporary path, and QLoRA finetuning of a checkpoint with its
adapters saved and reloaded."""

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


def test_qlora_finetune_torch_saves_adapters(tmp_path):
    """qlora_finetune_torch on a tiny RTN INT4-g32 checkpoint written here
    and a seeded .npy of token windows: two AdamW steps, the adapters
    saved under the reference CLI's keys, reloaded into the wrapped model
    (inject_lora) they give the trained loss, below the untrained one on
    the first step's batch."""
    from sparsebit_tpu_torch.llm import llama as TL
    from sparsebit_tpu_torch.llm.convert import (
        load_quant_checkpoint, save_quant_checkpoint)
    from sparsebit_tpu_torch.llm.qlora import (
        extract_lora, inject_lora, qlora_loss_fn, wrap_llama_lora)
    from sparsebit_tpu_torch.llm.quant import QuantLinear

    cfg = TL.llama_tiny(dim=128, n_heads=2, n_kv_heads=2, ffn_dim=256,
                        vocab_size=256, max_seq_len=64, dtype="float32")
    params = TL.init_llama_params(cfg, device="cpu")
    q = TL.quantize_llama_params(params, lambda p, lin: QuantLinear.from_dense(
        lin.w, bits=4, groupsize=32))
    ckpt = str(tmp_path / "ckpt")
    layers_bit = {"layers.{}.{}".format(i, n): 4 for i in range(2)
                  for n in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")}
    save_quant_checkpoint(ckpt, q, layers_bit, cfg, 32)
    data = np.random.default_rng(3).integers(0, 256, (16, 17)).astype(
        np.int32)
    np.save(str(tmp_path / "tokens.npy"), data)
    out = str(tmp_path / "lora.npz")
    losses = _cli("qlora_finetune_torch").main(
        ["--ckpt", ckpt, "--tokens", str(tmp_path / "tokens.npy"),
         "--steps", "2", "--batch", "2", "--lr", "1e-2", "--save", out,
         "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    with np.load(out) as z:
        saved = dict(z)
    assert sorted(saved) == sorted(
        "layers.{}.{}.{}".format(i, n, k) for i in range(2)
        for n in ("wq", "wv") for k in ("lora_A", "lora_B"))
    lparams, cfg_l, _ = load_quant_checkpoint(ckpt, device="cpu")
    wrapped = wrap_llama_lora(lparams, r=8, alpha=16.0)
    lora = {key: {k: torch.from_numpy(saved["layers.{}.{}.{}".format(
        *key, k)]) for k in ("lora_A", "lora_B")}
        for key in extract_lora(wrapped)}
    assert all(bool(ab["lora_B"].abs().sum() > 0) for ab in lora.values())
    reloaded = inject_lora(wrapped, lora)
    assert reloaded["layers"][1]["wv"].lora_B is lora[(1, "wv")]["lora_B"]
    idx = np.random.default_rng(0).integers(0, len(data), size=(2,))
    with torch.no_grad():
        loss = float(qlora_loss_fn(lora, wrapped,
                                   torch.from_numpy(data[idx]).long(),
                                   cfg_l))
    assert np.isfinite(loss) and loss < losses[0]
