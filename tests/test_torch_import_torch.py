"""The port's checkpoint importers (``models/import_torch.py``) against
the JAX package's and against Hugging Face, on the CPU.

- state dicts fabricated in torchvision's resnet18 layout (OIHW convs,
  ``downsample.{0,1}``, ``num_batches_tracked``), timm's DeiT layout and
  Hugging Face GPT-2's layout (``Conv1D`` weights (in, out), a separate
  ``lm_head``), seeded numpy: the same dict through the port's and the
  JAX package's importer gives outputs within 1e-4; the port keeps
  torchvision's conv layout, renames the downsample branch, transposes
  GPT-2's Conv1D weights and ties lm_head to wte; a dict that lacks a
  model key is refused;
- where ``transformers`` imports, gpt2_tiny and bert_tiny against HF's
  models on the same random weights within 2e-3, as
  tests/test_import_torch.py holds the JAX package's (skipped without
  it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsebit_tpu.models.import_torch as J
import sparsebit_tpu_torch.models.import_torch as T
from sparsebit_tpu.models import create_model as j_create_model
from sparsebit_tpu_torch.models import create_model as t_create_model

torch.set_num_threads(1)


def _torchvision_resnet18(rng):
    """A torchvision-layout resnet18 state dict, from the port model's
    names (the port holds torchvision's conv and linear layouts)."""
    sd = {}
    for path, m in t_create_model("resnet18", device="cpu").named_modules():
        t = type(m).__name__
        path = path.replace("down_conv", "downsample.0").replace(
            "down_bn", "downsample.1")
        if t in ("Conv2d", "Linear"):
            fan_in = int(np.prod(m.weight.shape[1:]))  # activations O(1)
            sd[path + ".weight"] = rng.normal(
                size=tuple(m.weight.shape), scale=fan_in ** -0.5).astype(
                    np.float32)
            if m.bias is not None:
                sd[path + ".bias"] = rng.normal(
                    size=m.bias.shape[0]).astype(np.float32)
        elif t == "BatchNorm2d":
            c = m.num_features
            sd[path + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sd[path + ".bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            sd[path + ".running_mean"] = rng.normal(0, 0.2, c).astype(
                np.float32)
            sd[path + ".running_var"] = rng.uniform(0.5, 2, c).astype(
                np.float32)
            sd[path + ".num_batches_tracked"] = np.int64(1)
    return sd


def test_resnet_importer_matches_jax():
    rng = np.random.default_rng(0)
    sd = _torchvision_resnet18(rng)
    assert "layer2.0.downsample.0.weight" in sd
    tm = T.load_resnet_from_torch(
        t_create_model("resnet18", device="cpu"), sd).eval()
    jm = J.load_resnet_from_torch(j_create_model("resnet18"), sd).eval()
    np.testing.assert_array_equal(tm.conv1.weight.detach().numpy(),
                                  sd["conv1.weight"])
    np.testing.assert_array_equal(
        tm.layer2[0].down_bn.running_var.numpy(),
        sd["layer2.0.downsample.1.running_var"])
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v: jm(v))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    del sd["layer1.0.bn1.running_mean"]
    with pytest.raises(KeyError):
        T.load_resnet_from_torch(t_create_model("resnet18", device="cpu"),
                                 sd)


def test_deit_importer_matches_jax():
    rng = np.random.default_rng(1)
    dim, depth = 192, 12

    def w(*shape):
        return rng.normal(size=shape, scale=0.02).astype(np.float32)

    sd = {"patch_embed.proj.weight": w(dim, 3, 16, 16),
          "patch_embed.proj.bias": w(dim), "cls_token": w(1, 1, dim),
          "pos_embed": w(1, 5, dim), "norm.weight": 1 + w(dim),
          "norm.bias": w(dim), "head.weight": w(1000, dim),
          "head.bias": w(1000), "head_dist.weight": w(1000, dim)}
    for i in range(depth):
        p = "blocks.{}.".format(i)
        for ln in ("norm1", "norm2"):
            sd[p + ln + ".weight"] = 1 + w(dim)
            sd[p + ln + ".bias"] = w(dim)
        for lin, (o, k) in (("attn.qkv", (3 * dim, dim)),
                            ("attn.proj", (dim, dim)),
                            ("mlp.fc1", (4 * dim, dim)),
                            ("mlp.fc2", (dim, 4 * dim))):
            sd[p + lin + ".weight"] = w(o, k)
            sd[p + lin + ".bias"] = w(o)
    tm = T.load_deit_from_timm(
        t_create_model("deit_tiny", img_size=32, device="cpu"), sd).eval()
    jm = J.load_deit_from_timm(j_create_model("deit_tiny", img_size=32),
                               sd).eval()
    np.testing.assert_array_equal(
        tm.blocks[0].attn.qkv.weight.detach().numpy(),
        sd["blocks.0.attn.qkv.weight"])
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v: jm(v))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _hf_gpt2_layout(rng, vocab=1024, dim=128, depth=2, n_pos=256):
    def w(*shape):
        return rng.normal(size=shape, scale=0.05).astype(np.float32)

    sd = {"transformer.wte.weight": w(vocab, dim),
          "transformer.wpe.weight": w(n_pos, dim),
          "transformer.ln_f.weight": 1 + w(dim),
          "transformer.ln_f.bias": w(dim), "lm_head.weight": w(vocab, dim)}
    for i in range(depth):
        p = "transformer.h.{}.".format(i)
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = 1 + w(dim)
            sd[p + ln + ".bias"] = w(dim)
        for conv1d, (k, o) in (("attn.c_attn", (dim, 3 * dim)),
                               ("attn.c_proj", (dim, dim)),
                               ("mlp.c_fc", (dim, 4 * dim)),
                               ("mlp.c_proj", (4 * dim, dim))):
            sd[p + conv1d + ".weight"] = w(k, o)  # Conv1D: (in, out)
            sd[p + conv1d + ".bias"] = w(o)
    return sd


def test_gpt2_importer_matches_jax():
    rng = np.random.default_rng(2)
    sd = _hf_gpt2_layout(rng)
    tm = T.load_gpt2_from_hf(t_create_model("gpt2_tiny", device="cpu"),
                             sd).eval()
    jm = J.load_gpt2_from_hf(j_create_model("gpt2_tiny"), sd).eval()
    np.testing.assert_array_equal(
        tm.blocks[1].c_fc.weight.detach().numpy(),
        sd["transformer.h.1.mlp.c_fc.weight"].T)
    np.testing.assert_array_equal(tm.lm_head.weight.detach().numpy(),
                                  sd["transformer.wte.weight"])
    ids = rng.integers(0, 1024, (2, 12)).astype(np.int32)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    want = np.asarray(jax.jit(lambda v: jm(v))(jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_gpt2_importer_against_hf():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPT2Config(
        vocab_size=1024, n_positions=256, n_embd=128, n_layer=2, n_head=2,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(cfg).eval()
    ours = T.load_gpt2_from_hf(t_create_model("gpt2_tiny", device="cpu"),
                               hf.state_dict()).eval()
    ids = torch.tensor([[3, 17, 91, 200, 4, 8]])
    with torch.no_grad():
        ref = hf(ids).logits.numpy()
        out = ours(ids.int()).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)


def test_bert_importer_against_hf():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=1024, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=512,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.BertForSequenceClassification(cfg).eval()
    ours = T.load_bert_from_hf(t_create_model("bert_tiny", device="cpu"),
                               hf.state_dict()).eval()
    ids = torch.tensor([[5, 9, 100, 30, 77, 2]])
    with torch.no_grad():
        ref = hf(ids).logits.numpy()
        out = ours(ids.int()).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)
