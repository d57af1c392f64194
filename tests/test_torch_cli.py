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
import pytest
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


def test_int8attn_longctx_torch_both_modes(tmp_path, monkeypatch):
    """int8attn_longctx_torch on --device cpu at a short context, both
    modes: --trained --write merges ``int8_attn_longctx`` (exp36's keys,
    the steps, the final train loss, the device) into --out and leaves the
    other records; the default (untrained, greedy) mode prints exp36's
    logit figures. The training windows (SEQLEN) and the stream (STREAM)
    are cut here to 31 and 3000 tokens; the record's S~2k figures come
    from the card."""
    cli = _cli("int8attn_longctx_torch")
    monkeypatch.setattr(cli, "SEQLEN", 31)
    monkeypatch.setattr(cli, "STREAM", 3000)
    out = tmp_path / "ACCURACY_torch.json"
    out.write_text(json.dumps({"llm_gptq": {"ppl_float": 2.0}}))
    small = ["--device", "cpu", "--ctx", "40", "--decode-steps", "4"]
    rec = cli.main(["--trained", "--write", "--out", str(out), "--steps",
                    "2"] + small)
    got = json.loads(out.read_text())
    assert got["llm_gptq"] == {"ppl_float": 2.0}
    assert got["int8_attn_longctx"] == rec
    for key in ("config", "context_positions", "ppl_f32_attention",
                "ppl_int8_attention", "rel_ppl_increase", "greedy_agree",
                "train_steps", "final_train_loss", "device"):
        assert key in rec, key
    assert rec["device"] == "cpu" and rec["train_steps"] == 2
    assert "3000-token Markov chain at seqlen 31" in rec["config"]
    assert rec["context_positions"] == "40..44 (teacher-forced)"
    assert rec["rel_ppl_increase"] == pytest.approx(
        rec["ppl_int8_attention"] / rec["ppl_f32_attention"] - 1)
    assert rec["greedy_agree"].endswith("/4")
    res = cli.main(small)
    assert set(res) == {"context", "logit_mae_mean", "logit_maxdiff_mean",
                        "logit_maxdiff_max", "greedy_agree",
                        "decisive_agree", "logit_scale_ref"}
    assert 0 <= res["logit_mae_mean"] <= res["logit_maxdiff_max"] < 1.0


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


def _basecase():
    path = os.path.join(os.path.dirname(EXAMPLES), "post_training_quantization",
                        "imagenet1k_basecase")
    sys.path.insert(0, path)
    try:
        return importlib.import_module("main_torch")
    finally:
        sys.path.pop(0)


def test_ptq_basecase_torch_demo(tmp_path):
    """The graph regime's PTQ basecase CLI on random tensors: resnet18 at
    224x224 through QuantModel, calibration and the fake-quant eval; a
    checkpoint in the JAX package's layout loads; mobilenet_v2 runs the
    same flow; --export writes the program and the sidecar."""
    cli = _basecase()
    res = cli.main(["--batch", "2", "--calib-batches", "1",
                    "--eval-samples", "4", "--device", "cpu"])
    assert set(res) == {"int8_acc"} and 0.0 <= res["int8_acc"] <= 1.0
    from sparsebit_tpu_torch.models import create_model

    m = create_model("resnet18", seed=1, device="cpu")
    sd = {}
    for path, mod in m.named_modules():
        for k, v in mod.leaf_state_dict().items():
            v = v.detach().numpy()
            if k == "weight" and v.ndim == 4:
                v = v.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            elif k == "weight" and path == "fc":
                v = v.T
            sd["{}.{}".format(path, k)] = v
    ckpt = str(tmp_path / "r18.npz")
    np.savez(ckpt, **sd)
    res = cli.main(["--batch", "2", "--calib-batches", "1", "--eval-samples",
                    "4", "--ckpt", ckpt, "--device", "cpu"])
    assert set(res) == {"float_acc", "int8_acc"}
    res = cli.main(["--model", "mobilenet_v2", "--batch", "2",
                    "--calib-batches", "1", "--eval-samples", "2",
                    "--device", "cpu"])
    assert 0.0 <= res["int8_acc"] <= 1.0
    out = tmp_path / "x"
    cli.main(["--batch", "2", "--calib-batches", "1", "--eval-samples", "2",
              "--export", str(out), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["model.pt2", "quant_meta.json",
                                       "quant_params.npz"]


def _example(rel):
    """An example CLI loaded from its file under a name of its own (every
    directory has a main_torch.py)."""
    import importlib.util

    path = os.path.join(os.path.dirname(EXAMPLES), rel)
    name = "example_" + rel.replace("/", "_").replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QAT = "quantization_aware_training/"
PTQ = "post_training_quantization/"


@pytest.mark.parametrize("yaml_name", ["qconfig_lsq.yaml",
                                       "qconfig_lsq_plus.yaml",
                                       "qconfig_pact.yaml",
                                       "qconfig_dorefa.yaml"])
def test_qat_resnet18_torch_demo(yaml_name, monkeypatch):
    """The resnet18 QAT CLI on each of its yamls, read without PyYAML (the
    card's machine has none): calibration, init_QAT, two steps."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(QAT + "imagenet1k_resnet18/main_torch.py")
    res = cli.main(["--qconfig", os.path.join(
        os.path.dirname(EXAMPLES), QAT, "imagenet1k_resnet18", yaml_name),
        "--batch", "2", "--img", "32", "--num-classes", "10",
        "--device", "cpu"])
    assert np.isfinite(res["loss"])


@pytest.mark.parametrize("yaml_name", ["qconfig_lsq.yaml",
                                       "qconfig_gelu_lsqplus.yaml"])
def test_qat_deit_torch_demo(yaml_name, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(QAT + "imagenet1k_deit/main_torch.py")
    res = cli.main(["--qconfig", os.path.join(
        os.path.dirname(EXAMPLES), QAT, "imagenet1k_deit", yaml_name),
        "--batch", "2", "--img", "32", "--device", "cpu"])
    assert np.isfinite(res["loss"]) and 0.0 <= res["top1"] <= 1.0


def test_qat_cifar10_resnet20_torch_demo():
    cli = _example(QAT + "cifar10_resnet20/main_torch.py")
    res = cli.main(["--samples", "4", "--batch", "2", "--device", "cpu"])
    assert np.isfinite(res["loss"])


def test_ptq_cifar10_resnet20_torch_demo(tmp_path):
    cli = _example(PTQ + "cifar10_resnet20/main_torch.py")
    out = tmp_path / "export"
    res = cli.main(["--calib-batches", "1", "--batch", "2", "--eval-samples",
                    "4", "--export", str(out), "--device", "cpu"])
    assert 0.0 <= res["int8_acc"] <= 1.0
    meta = json.loads((out / "quant_meta.json").read_text())
    assert "conv1" in meta["nodes"] and (out / "model.pt2").exists()


def test_ptq_deit_torch_demo(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(PTQ + "imagenet1k_deit/main_torch.py")
    res = cli.main(["--batch", "2", "--calib-batches", "1",
                    "--eval-samples", "2", "--img", "32", "--device", "cpu"])
    assert 0.0 <= res["int8_top1"] <= 1.0 and len(res["worst"]) == 5


def test_ptq_glue_cola_bert_torch_demo(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(PTQ + "glue_cola_bert/main_torch.py")
    res = cli.main(["--model", "bert_tiny", "--batch", "2",
                    "--calib-batches", "1", "--eval-samples", "4",
                    "--seqlen", "8", "--device", "cpu"])
    assert 0.0 <= res["int8_acc"] <= 1.0


def test_record_fixture_torch_writes_records(tmp_path, monkeypatch):
    """record_fixture_torch.py merges its records, each with the device,
    into the file (the fixtures cut to a few steps here)."""
    from sparsebit_tpu_torch.quantization.tools import fixture

    cli = _example(PTQ + "record_fixture_torch.py")
    small = dict(n_train=512, n_eval=128, batch=64)
    for name in ("run_vit_fixture", "run_bert_fixture",
                 "run_vit_qat_fixture"):
        fn = getattr(fixture, name)
        monkeypatch.setattr(fixture, name, lambda fn=fn, **kw: fn(
            **dict(kw, **small)))
    out = tmp_path / "ACCURACY_torch.json"
    out.write_text(json.dumps({"cnn_ptq": 1}))
    res = cli.main(["--steps", "2", "--qat-steps", "2", "--out", str(out),
                    "--device", "cpu"])
    rec = json.loads(out.read_text())
    assert set(rec) == {"cnn_ptq", "vit_ptq", "bert_ptq", "vit_qat"}
    for key in ("vit_ptq", "bert_ptq", "vit_qat"):
        assert rec[key] == res[key] and rec[key]["device"] == "cpu"
    assert rec["vit_qat"]["qat_steps"] == 2


def test_chip_smoke_basecase_qconfig_is_the_yaml(monkeypatch):
    """chip_smoke.py's graph paths and the basecase CLI read qconfig.yaml
    where PyYAML is not installed (the card's machine): with PyYAML
    hidden, the file parses to the config PyYAML gives."""
    import importlib.util

    from sparsebit_tpu_torch import parse_qconfig

    root = os.path.dirname(os.path.dirname(EXAMPLES))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    yaml_path = os.path.join(os.path.dirname(EXAMPLES),
                             "post_training_quantization",
                             "imagenet1k_basecase", "qconfig.yaml")
    assert os.path.samefile(smoke.BASECASE_QCONFIG, yaml_path)
    want = parse_qconfig(yaml_path)
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    assert parse_qconfig(yaml_path) == want


YAMLS = sorted(os.path.relpath(os.path.join(d, f), os.path.dirname(EXAMPLES))
               for d, _, fs in os.walk(os.path.dirname(EXAMPLES))
               for f in fs if f.endswith(".yaml"))


@pytest.mark.parametrize("rel", YAMLS)
def test_block_mappings_reads_what_pyyaml_reads_or_refuses(rel):
    """Without PyYAML the config loader reads each example yaml file to
    PyYAML's dict: the flat PTQ and pruning configs, the QAT and
    transformer configs, whose SPECIFIC is a block sequence of mappings
    with flow-sequence values, and the BEVDet QAT config, whose SPECIFIC
    is a multi-line flow sequence of one flow mapping
    (``SPECIFIC: [{ ... }]``)."""
    import yaml

    from sparsebit_tpu_torch.utils.config import block_mappings

    with open(os.path.join(os.path.dirname(EXAMPLES), rel)) as f:
        text = f.read()
    assert block_mappings(text) == (yaml.safe_load(text) or {})


def test_no_example_yaml_is_refused(monkeypatch):
    """With PyYAML hidden, ``load_yaml`` reads every yaml under
    examples/, the BEVDet QAT default (qconfig_lsq_4w4f.yaml) among
    them."""
    from sparsebit_tpu_torch.utils.config import load_yaml

    monkeypatch.setitem(sys.modules, "yaml", None)
    assert QAT + "nuscenes_bevdet/qconfig_lsq_4w4f.yaml" in YAMLS
    refused = []
    for rel in YAMLS:
        try:
            load_yaml(os.path.join(os.path.dirname(EXAMPLES), rel))
        except ValueError:
            refused.append(rel)
    assert refused == []


def test_block_mappings_reads_flow_sequences_of_mappings_as_pyyaml():
    """The multi-line flow form of SPECIFIC: ``key: [{`` ending a line,
    one ``key: value`` entry a line (quoted or plain keys, flow-sequence
    or scalar values, a trailing comma allowed), mappings separated by a
    ``}, {`` line, ``}]`` closing it; comments and blank lines inside."""
    import yaml

    from sparsebit_tpu_torch.utils.config import block_mappings

    text = ("W:\n  SPECIFIC: [{\n    \"img*.conv\": [\"QUANTIZER.BIT\", 8],"
            "\n    # 8-bit heads\n\n    '*_head': [QUANTIZER.BIT, 8],\n"
            "  }, {\n    fc: 4\n  }]\n  BIT: 4\nA:\n  SPECIFIC: [{\n  }]\n")
    assert block_mappings(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "A:\n  - 1\n", "A: [1, 2]\n", "A: &x 1\n", "A: |\n  t\n",
    "A: 1e-3\n", "A: 0x1f\n", "A:\n\tB: 1\n", "A: \"a\\\\nb\"\n",
    "A:\n    B: 1\n  C: 2\n", "A:\n  - x: [1,]\n",
    "A:\n  - x:\n      y: 1\n", "A:\n  - x: {a: 1}\n",
    "A:\n  - x: [[1]]\n", "A: [{x: 1}]\n", "A: [{\n  x: 1\n  y: 2\n}]\n",
    "A: [{\n  x: 1,\n", "A: [{\n  - x\n}]\n", "A:\n  - x: [{\n  }]\n",
    "A: [{\n  x: {a: 1},\n}]\n", "A: [{\n  x: a, b\n}]\n"])
def test_block_mappings_refuses_forms_outside_the_subset(text):
    from sparsebit_tpu_torch.utils.config import block_mappings

    with pytest.raises(ValueError):
        block_mappings(text)


def test_block_mappings_scalars_resolve_as_pyyaml():
    import yaml

    from sparsebit_tpu_torch.utils.config import block_mappings

    text = ("# c\nA:\n  B: 8 # bits\n  C: -0.5\n  D: 1.0e-3\n  E: true\n"
            "  F: Off\n  G: ~\n  H: 'it''s'\n  I: \"x # y\"\n  J:\nK: "
            "per-channel-symmetric\nL: NHWC\n")
    assert block_mappings(text) == yaml.safe_load(text)


def test_block_mappings_reads_sequences_of_mappings_as_pyyaml():
    """The SPECIFIC form: a block sequence of mappings, quoted or plain
    keys, flow sequences of plain and quoted scalars as values."""
    import yaml

    from sparsebit_tpu_torch.utils.config import block_mappings

    text = ("W:\n  SPECIFIC:\n    - \"*patch*\": [\"QUANTIZER.BIT\", \"8\"]\n"
            "      'h''d': [QUANTIZER.DISABLE, True, 8, -0.5]\n"
            "    - fc: []\n  BIT: 4\nA:\n  - x: 1\n")
    assert block_mappings(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", ["efficientnet_lite0", "regnetx_600mf"])
def test_ptq_basecase_torch_zoo_models(name):
    """The basecase CLI's other newly ported models, the same flow."""
    res = _basecase().main(["--model", name, "--batch", "2",
                            "--calib-batches", "1", "--eval-samples", "2",
                            "--device", "cpu"])
    assert 0.0 <= res["int8_acc"] <= 1.0


PRUNE = "pruning/"


def test_yaml_cases_cover_the_pruning_sconfigs():
    assert {PRUNE + d + "/sconfig.yaml" for d in (
        "structured_cifar10", "unstructured_cifar10", "structured_imagenet1k",
        "unstructured_bert", "unstructured_squad")} <= set(YAMLS)


def _dense(smodel, names):
    ops = dict(smodel.smodules())
    return all(bool((ops[n].w_mask == 1).all()) for n in names)


def test_prune_structured_cifar10_torch_demo(tmp_path, monkeypatch):
    """resnet20, structured l1norm 0.5 (sconfig read without PyYAML):
    only the classifier and each block's first conv lose channels; the
    exported program loads and equals the masked model."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(PRUNE + "structured_cifar10/main_torch.py")
    out = tmp_path / "export"
    res = cli.main(["--export", str(out), "--device", "cpu"])
    smodel = res["smodel"]
    assert 0.0 < res["sparsity"] < 0.5
    assert _dense(smodel, ["conv1", "layer1.0.conv2", "layer2.0.down_conv"])
    assert not _dense(smodel, ["layer2.1.conv1"])
    x = torch.randn(8, 32, 32, 3)  # the program's example batch
    prog = torch.export.load(str(out / "model.pt2")).module()
    with torch.no_grad():
        assert torch.equal(prog(x), smodel(x))


def test_prune_unstructured_cifar10_torch_demo(tmp_path):
    cli = _example(PRUNE + "unstructured_cifar10/main_torch.py")
    res = cli.main(["--ratio", "0.7", "--export", str(tmp_path / "e"),
                    "--device", "cpu"])
    assert abs(res["sparsity"] - 0.7) < 1e-3
    assert (tmp_path / "e" / "model.pt2").exists()


def test_prune_structured_imagenet1k_torch_demo(monkeypatch):
    """resnet18 with conv1 and fc dense (SPECIFIC with comment lines,
    read without PyYAML), one masked SGD step: the masks are unchanged
    and the pruned weights stay zero in effect."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(PRUNE + "structured_imagenet1k/main_torch.py")
    res = cli.main(["--img", "32", "--batch", "2", "--finetune-steps", "1",
                    "--lr", "0.1", "--device", "cpu"])
    smodel = res["smodel"]
    assert np.isfinite(res["loss"]) and 0.0 < res["sparsity"] < 0.5
    assert _dense(smodel, ["conv1", "fc", "layer1.0.conv2"])
    op = dict(smodel.smodules())["layer1.0.conv1"]
    pruned = op.w_mask == 0
    assert int(pruned.reshape(64, -1).all(1).sum()) == 32
    assert bool((op.module.weight * op.w_mask)[pruned].eq(0).all())


def test_prune_unstructured_bert_torch_demo():
    cli = _example(PRUNE + "unstructured_bert/main_torch.py")
    res = cli.main(["--dim", "32", "--ratio", "0.7", "--device", "cpu"])
    smodel = res["smodel"]
    assert _dense(smodel, ["classifier"])
    # 12 masked encoder linears at 0.7 and the dense pooler and classifier
    assert 0.6 < res["sparsity"] < 0.7


def test_prune_unstructured_squad_torch_demo():
    """bert_qa_tiny through the ratchet 0.2, 0.35, 0.5 (one step each);
    qa_outputs stays dense (SPECIFIC), the masks stay {0, 1}."""
    cli = _example(PRUNE + "unstructured_squad/main_torch.py")
    res = cli.main(["--batch", "2", "--steps", "3", "--ratio-steps", "1",
                    "--device", "cpu"])
    assert np.isfinite(res["loss"]) and 0.0 <= res["em"] <= 1.0
    assert res["sparsity"] == sorted(res["sparsity"]) and len(
        res["sparsity"]) == 3
    smodel = res["smodel"]
    assert _dense(smodel, ["qa_outputs"])
    for name, op in smodel.smodules():
        assert bool(((op.w_mask == 0) | (op.w_mask == 1)).all()), name
        if name != "qa_outputs":
            assert abs(float((op.w_mask == 0).float().mean()) - 0.5) < 1e-3


def test_ptq_wikitext_gpt2_torch_demo(tmp_path, monkeypatch):
    """gpt2_tiny on a seeded token stream (the yaml read without PyYAML):
    float and int8 perplexities; a checkpoint in the JAX package's layout
    (HWIO / (in, out) weights) loads and gives the model's own float
    perplexity."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(PTQ + "wikitext_gpt2/main_torch.py")
    args = ["--model", "gpt2_tiny", "--seqlen", "16", "--calib-windows",
            "2", "--device", "cpu"]
    res = cli.main(args)
    assert set(res) == {"float_ppl", "int8_ppl"}
    assert all(np.isfinite(v) and v > 1.0 for v in res.values())
    from sparsebit_tpu_torch.models import create_model

    m = create_model("gpt2_tiny", seed=0, device="cpu")
    sd = {}
    for path, mod in m.named_modules():
        for k, v in mod.leaf_state_dict().items():
            v = v.detach().numpy()
            sd["{}.{}".format(path, k)] = v.T if (
                k == "weight" and type(mod).__name__ == "Linear") else v
    ckpt = str(tmp_path / "gpt2.npz")
    np.savez(ckpt, **sd)
    res2 = cli.main(args + ["--ckpt", ckpt])
    assert res2 == res  # seed 0: the same weights either way


@pytest.mark.parametrize("name", ["yolov3_tiny", "yolov5n"])
def test_ptq_coco_yolo_torch_demo(name, monkeypatch):
    """The detection PTQ CLI (MSE observers, FUSE_BN; yaml read without
    PyYAML) on two of its small models at 64 x 64: the map shapes and the
    mean per-layer error of every quantized node (the other models'
    graphs and qparams: tests/test_torch_yolo.py)."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(PTQ + "coco_yolov3_tiny/main_torch.py")
    res = cli.main(["--model", name, "--imgsize", "64", "--batch", "1",
                    "--calib-batches", "1", "--device", "cpu"])
    n = 2 if name == "yolov3_tiny" else 3
    assert res["shapes"] == [(1, 2, 2, 255), (1, 4, 4, 255),
                             (1, 8, 8, 255)][:n]
    assert len(res["errors"]) > 10 and np.isfinite(res["mean_error"])
    assert res["mean_error"] > 0.0


@pytest.mark.parametrize("yaml_name", ["qconfig_lsq_4w4f.yaml",
                                       "qconfig_lsq_8w8f.yaml"])
def test_qat_nuscenes_bevdet_torch_demo(yaml_name, monkeypatch):
    """The BEVDet QAT CLI on both yamls read without PyYAML (the 4w4f
    default's multi-line flow SPECIFIC too): calibration, init_QAT, an
    epoch of Adam steps on the CenterPoint loss; the 4w4f overrides give
    the first conv, the depthnet input and the heads 8 bits."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cli = _example(QAT + "nuscenes_bevdet/main_torch.py")
    args = ["--batch", "4", "--device", "cpu"]
    if yaml_name != "qconfig_lsq_4w4f.yaml":
        args += ["--qconfig", os.path.join(os.path.dirname(EXAMPLES), QAT,
                                           "nuscenes_bevdet", yaml_name)]
    res = cli.main(args)
    assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
    ops = dict(res["qmodel"].qmodules())
    assert "view_transform" not in ops
    low = 8 if yaml_name == "qconfig_lsq_8w8f.yaml" else 4
    assert ops["bev_neck.conv"].weight_quantizer.bit == low
    for name in ("img_backbone.0.conv", "depthnet", "heatmap_head",
                 "box_head"):
        assert ops[name].input_quantizer.bit == 8, name


def test_tp_serve_demo_torch_matches_jax_demo():
    """tp_serve_demo_torch --tp 2 --device cpu (two spawned gloo ranks)
    decodes the tokens of the JAX demo's computation (tp_serve_demo.py:
    per-shard RTN INT4-g32 weights, prefill on the unsharded params, the
    cache sharded, greedy tp_decode_step) run here on the port demo's
    weights (llama_tiny widths, seed 0, the all-ones prompt)."""
    import jax
    import jax.numpy as jnp

    from sparsebit_tpu.llm import llama as JL
    from sparsebit_tpu.llm.decode import prefill
    from sparsebit_tpu.llm.kv_cache import init_kv_cache
    from sparsebit_tpu.llm.quant import DenseLinear as JDense
    from sparsebit_tpu.parallel.mesh import make_mesh
    from sparsebit_tpu.parallel.tp import (
        shard_kv_cache_tp, shard_llama_params_tp, tp_decode_step)
    from sparsebit_tpu_torch.llm.quant import DenseLinear

    cli = _cli("tp_serve_demo_torch")
    got = cli.main(["--tp", "2", "--tokens", "6", "--device", "cpu"])

    def to_jax(x):
        if isinstance(x, DenseLinear):
            return JDense(jnp.asarray(x.w.numpy()))
        if isinstance(x, dict):
            return {k: to_jax(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_jax(v) for v in x]
        return jnp.asarray(x.numpy())

    tcfg = cli.demo_config()
    cfg = JL.llama_tiny(**{f: getattr(tcfg, f) for f in (
        "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim",
        "max_seq_len", "dtype")})
    params = to_jax(cli.demo_params(tcfg, torch.device("cpu")))
    mesh = make_mesh(dp=1, tp=2)
    params_tp = shard_llama_params_tp(params, cfg, 2, bits=4, groupsize=32)
    logits, cache = prefill(params, jnp.ones((2, 5), jnp.int32),
                            init_kv_cache(cfg, 2, 32, quantized=True), cfg)
    cache = shard_kv_cache_tp(cache, mesh)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = []
    for _ in range(6):
        logits, cache = tp_decode_step(params_tp, tok, cache, cfg, mesh)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    assert jax.devices()[0].platform == "cpu"


# ---- data parallelism of the QAT and pruning CLIs under torchrun ------------

PRUNE_IMAGENET = "pruning/structured_imagenet1k/main_torch.py"
DP_CASES = {
    "resnet18_" + y[len("qconfig_"):-len(".yaml")]: (
        QAT + "imagenet1k_resnet18/main_torch.py",
        ["--qconfig", os.path.join(os.path.dirname(EXAMPLES), QAT,
                                   "imagenet1k_resnet18", y),
         "--num-classes", "10"])
    for y in ("qconfig_lsq.yaml", "qconfig_lsq_plus.yaml",
              "qconfig_pact.yaml", "qconfig_dorefa.yaml")}
DP_CASES["deit_lsq"] = (QAT + "imagenet1k_deit/main_torch.py",
                        ["--model", "deit_tiny"])
DP_CASES["prune_structured_imagenet1k"] = (
    PRUNE_IMAGENET, ["--finetune-steps", "1", "--lr", "0.1"])


def _rel(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_dp_cli_torchrun_matches_one_rank(case, tmp_path):
    """The CLI under ``python -m torch.distributed.run --nproc_per_node 2``
    with --device cpu (gloo) against its one-rank run on the same global
    batch of 4 rows, one step. With BatchNorm's statistics over the global
    batch, LSQ's gradient scale counting it and the gradients averaged
    over the ranks: the step's loss and the parameters the optimiser's
    first step finds (calibrated, QAT-initialised, broadcast) within 1e-5
    relative, their gradients within 5e-4 of each tensor's largest (f32
    sums over the batch in another order: up to 1.3e-4 through the
    pruning CLI's resnet18 and BatchNorm backward), and BatchNorm's running
    statistics after the step within 1e-5 relative. At this size no 4-bit
    activation of the one-rank run sits at a rounding tie that the split
    sums of BatchNorm's statistics tip over; at 224 x 224 one does, and
    chip_smoke.py's dpqat path holds the CLI against one process that sums
    as the ranks do instead (tests/test_torch_parallel.py holds BatchNorm
    over dp by itself on the CPU). The one-rank run is held to the JAX CLI
    by the tests above."""
    import pickle
    import subprocess

    from torch_dp_cli_worker import run_cli

    rel, extra = DP_CASES[case]
    cli = os.path.join(os.path.dirname(EXAMPLES), rel)
    rng = np.random.default_rng(0)
    data = tmp_path / "batch.npz"
    np.savez(data, x=rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
             y=rng.integers(0, 10, size=(4,)))
    argv = extra + ["--batch", "4", "--img", "32", "--data", str(data),
                    "--device", "cpu"]
    out = tmp_path / "rank"
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_dp_cli_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", worker, str(out), cli] + argv,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = run_cli(cli, argv)
    stats = [k for k in one["state"] if "running_" in k]
    assert stats or case.startswith("deit")  # deit has no BatchNorm
    for rank in (0, 1):
        with open("{}.{}".format(out, rank), "rb") as f:
            dp = pickle.load(f)
        assert abs(dp["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert len(dp["first_step"]) == len(one["first_step"])
        for i, ((p, g), (p1, g1)) in enumerate(zip(dp["first_step"],
                                                   one["first_step"])):
            assert _rel(p, p1) <= 1e-5, (i, _rel(p, p1))
            assert (g is None) == (g1 is None) or not np.any(g if g1 is None
                                                             else g1), i
            if g1 is not None and g is not None and np.any(g1):
                assert _rel(g, g1) <= 5e-4, (i, _rel(g, g1))
        for k in stats:
            assert _rel(dp["state"][k], one["state"][k]) <= 1e-5, k


DP_CLIS = sorted({rel for rel, _ in DP_CASES.values()})


class _DPAxis:
    def size(self):
        return 2


@pytest.mark.parametrize("rel", DP_CLIS)
def test_dp_cli_refuses_a_batch_the_ranks_do_not_split(rel, monkeypatch):
    """Fault F1 at the CLIs: with two data-parallel ranks (the mesh faked
    here) --batch 5 fails at start, before a model is built, with the
    numbers in the message, instead of reaching dp_shard_batch."""
    cli = _example(rel)
    monkeypatch.setattr(cli, "data_parallel_mesh",
                        lambda device: {"dp": _DPAxis()})
    monkeypatch.setattr(cli, "create_model", lambda *a, **k: pytest.fail(
        "built a model"))
    with pytest.raises(SystemExit, match="--batch 5 does not split over 2 "
                       "data-parallel ranks: give a multiple of 2"):
        cli.main(["--batch", "5", "--img", "32", "--device", "cpu"])


def test_dp_cli_torchrun_refuses_an_odd_batch(tmp_path):
    """The resnet18 QAT CLI under ``python -m torch.distributed.run
    --nproc_per_node 2`` with --batch 3: both ranks exit at start with the
    message (fault F1), no step runs."""
    import subprocess

    cli = os.path.join(os.path.dirname(EXAMPLES), QAT,
                       "imagenet1k_resnet18", "main_torch.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", cli, "--batch", "3", "--img", "32",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "--batch 3 does not split over 2 data-parallel ranks" in (
        proc.stdout + proc.stderr), proc.stderr[-3000:]


def test_dryrun_multichip_torch_on_four_cpu_ranks():
    """The port's dry run (__graft_entry__.dryrun_multichip's topologies)
    on four gloo ranks on the CPU: dp x tp x pp QLoRA, TP decode and the
    TP engine, dp x tp and dp x sp (both attentions) training steps, every
    loss finite and equal across the ranks; n % 4 != 0 is refused."""
    from sparsebit_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(4, device="cpu")
    assert [r["backend"] for r in res] == ["gloo"] * 4
    assert sorted(res[0]["losses"]) == [
        "dp x sp ring=False", "dp x sp ring=True", "dp x tp",
        "dp x tp x pp QLoRA"]
    assert res[0]["dp x tp x pp"] == (1, 2, 2)
    assert res[0]["losses"]["dp x sp ring=True"] == pytest.approx(
        res[0]["losses"]["dp x sp ring=False"], rel=1e-5)
    with pytest.raises(ValueError, match="% 4"):
        dryrun_multichip(6, device="cpu")
