"""Import torch / Hugging Face checkpoints into the port's model zoo (port
of ``sparsebit_tpu/models/import_torch.py``).

The reference consumes torchvision / timm / transformers models directly.
The port's convs (OIHW) and linears ((out, in)) already hold PyTorch's
layouts, so an importer mostly renames keys: torchvision's
``downsample.{0,1}`` become ``down_conv`` / ``down_bn``; Hugging Face
GPT-2's ``Conv1D`` weights, stored (in, out), are transposed to (out,
in), and ``lm_head`` takes a copy of ``wte`` (tied). Activations stay
NHWC / NLC.

Each importer takes a state dict of torch tensors or numpy arrays (bring
your own checkpoint: ``torch.load(...)`` or an npz), needs neither
``transformers`` nor ``timm``, and copies the tensors onto the model's
own devices. Every parameter and buffer of the model must be in the
state dict, but for the buffers the model builds from its shape (GPT-2's
causal mask).
"""

import numpy as np
import torch


def _t(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float()
    return torch.from_numpy(np.asarray(v, np.float32))


def _load(model, flat, built=()):
    """``model.load_state_dict(flat)``: no key of ``flat`` may be unknown,
    and none of the model's may be missing but those ending in one of
    ``built``."""
    res = model.load_state_dict(flat, strict=False)
    missing = [k for k in res.missing_keys if not k.endswith(tuple(built))]
    if res.unexpected_keys or missing:
        raise KeyError("unexpected {}, missing {}".format(
            res.unexpected_keys, missing))
    return model


def _copy(sd, theirs, ours=None, keys=("weight", "bias")):
    """{ours.k: sd[theirs.k]} for the keys of ``keys`` that ``sd`` has."""
    ours = theirs if ours is None else ours
    return {"{}.{}".format(ours, k): _t(sd["{}.{}".format(theirs, k)])
            for k in keys if "{}.{}".format(theirs, k) in sd}


def load_resnet_from_torch(model, sd):
    """torchvision resnet{18,34,50} state_dict -> the port's ResNet.

    torchvision names: conv1/bn1/layerX.Y.{conv1,bn1,conv2,bn2,conv3,bn3,
    downsample.0,downsample.1}/fc; ours match but downsample ->
    down_conv/down_bn.
    """
    flat = {}
    for key, v in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        ours = key.replace("downsample.0", "down_conv").replace(
            "downsample.1", "down_bn")
        flat[ours] = _t(v)
    return _load(model, flat)


def load_gpt2_from_hf(model, sd):
    """HF GPT2LMHeadModel state_dict -> the port's GPT2Model.

    HF's Conv1D weights are (in, out): transposed to the port's (out, in).
    Names: transformer.{wte,wpe,h.N.*,ln_f}; ours: wte/wpe/blocks.N.*/ln_f;
    lm_head is wte (tied).
    """
    sd = {k[len("transformer."):] if k.startswith("transformer.") else k: v
          for k, v in sd.items()}
    flat = {"wte.weight": _t(sd["wte.weight"]),
            "wpe.weight": _t(sd["wpe.weight"])}
    n = 0
    while "h.{}.ln_1.weight".format(n) in sd:
        hf, ours = "h.{}.".format(n), "blocks.{}.".format(n)
        for ln in ("ln_1", "ln_2"):
            flat.update(_copy(sd, hf + ln, ours + ln))
        for conv1d, target in (("attn.c_attn", "attn.c_attn"),
                               ("attn.c_proj", "attn.c_proj"),
                               ("mlp.c_fc", "c_fc"),
                               ("mlp.c_proj", "c_proj")):
            flat[ours + target + ".weight"] = _t(
                sd[hf + conv1d + ".weight"]).T
            flat[ours + target + ".bias"] = _t(sd[hf + conv1d + ".bias"])
        n += 1
    flat.update(_copy(sd, "ln_f"))
    flat["lm_head.weight"] = flat["wte.weight"].clone()  # tied
    return _load(model, flat, built=("causal_bias",))


def load_deit_from_timm(model, sd):
    """timm / DeiT checkpoint -> the port's VisionTransformer. timm names:
    patch_embed.proj, cls_token, pos_embed, blocks.N.{norm1,attn.qkv,
    attn.proj,norm2,mlp.fc1,mlp.fc2}, norm, head: the port's; other keys
    (a distilled model's dist_token, head_dist) are left out."""
    flat = _copy(sd, "patch_embed.proj")
    flat.update({k: _t(sd[k]) for k in ("cls_token", "pos_embed")})
    n = 0
    while "blocks.{}.norm1.weight".format(n) in sd:
        for sub in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1",
                    "mlp.fc2"):
            flat.update(_copy(sd, "blocks.{}.{}".format(n, sub)))
        n += 1
    flat.update(_copy(sd, "norm"))
    flat.update(_copy(sd, "head"))
    return _load(model, flat)


def load_bert_from_hf(model, sd, classifier_key="classifier"):
    """HF BertForSequenceClassification -> the port's BertModel."""
    sd = {k[len("bert."):] if k.startswith("bert.") else k: v
          for k, v in sd.items()}
    emb = "embeddings."
    flat = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        flat.update(_copy(sd, emb + name, keys=("weight",)))
    flat.update(_copy(sd, emb + "LayerNorm", emb + "norm"))
    n = 0
    while "encoder.layer.{}.attention.self.query.weight".format(n) in sd:
        hf, ours = "encoder.layer.{}.".format(n), "encoder.{}.".format(n)
        for theirs, mine in (("attention.self.query", "attention.query"),
                             ("attention.self.key", "attention.key"),
                             ("attention.self.value", "attention.value"),
                             ("attention.output.dense", "attention.output"),
                             ("intermediate.dense", "intermediate"),
                             ("output.dense", "ffn_output"),
                             ("attention.output.LayerNorm", "norm1"),
                             ("output.LayerNorm", "norm2")):
            flat.update(_copy(sd, hf + theirs, ours + mine))
        n += 1
    flat.update(_copy(sd, "pooler.dense", "pooler"))
    flat.update(_copy(sd, classifier_key, "classifier"))
    return _load(model, flat)
