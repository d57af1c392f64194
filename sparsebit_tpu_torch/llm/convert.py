"""Carry parameters across from the JAX package, and the npz checkpoint
(port side of ``sparsebit_tpu/llm/convert.py``).

``params_from_numpy`` reads a tree of nested dicts and lists of numpy
arrays and plain metadata, so this module needs nothing of JAX:

- a QuantLinear is ``{"packed": {name: uint8 array}, "scales", "zeros",
  "bits", "groupsize", "out_features", "bias", "perm", "impl"}``, with
  ``"bwd_wq"`` and ``"bwd_scale"`` after the JAX package's
  ``prepare_backward``;
- a DenseLinear is ``{"w", "bias"}``;
- a LoraLinear (QLoRA) is ``{"base": a linear, "lora_A", "lora_B",
  "alpha", "dropout"}``;
- any other array is a plain tensor (norms, embeddings).

bf16 arrays travel as their ``uint16`` bit pattern: every uint16 array in
the tree is read back as bf16.

``save_quant_checkpoint`` / ``load_quant_checkpoint`` read and write the
reference's checkpoint contract (convert.py:171-312): ``weights.npz`` (float
leaves as f32, read back in ``cfg.dtype``; scales and zeros stay f32;
``.nout``, ``.perm`` and ``.bias`` per linear) beside ``quant_meta.json``
(the config, the groupsize and ``layers_bit``). The orbax format needs JAX
and is not read.
"""

import json
import os

import numpy as np
import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm import llama as L
from sparsebit_tpu_torch.llm.qlora import LoraLinear
from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear

_CONFIG_KEYS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                "ffn_dim", "max_seq_len", "rope_theta", "rms_eps", "dtype")


def _tensor(a, device):
    if a is None:
        return None
    a = np.require(a, requirements=["C", "W"])  # torch needs writable
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device):
    """Port parameters on ``device`` from a numpy tree (see module doc)."""
    if isinstance(tree, dict) and "packed" in tree:
        return QuantLinear(
            {k: _tensor(v, device) for k, v in tree["packed"].items()},
            _tensor(tree["scales"], device), _tensor(tree["zeros"], device),
            int(tree["bits"]), int(tree["groupsize"]),
            int(tree["out_features"]), _tensor(tree.get("bias"), device),
            _tensor(tree.get("perm"), device), tree.get("impl", "auto"),
            _tensor(tree.get("bwd_wq"), device),
            _tensor(tree.get("bwd_scale"), device),
        )
    if isinstance(tree, dict) and "lora_A" in tree:
        return LoraLinear(params_from_numpy(tree["base"], device),
                          _tensor(tree["lora_A"], device),
                          _tensor(tree["lora_B"], device),
                          float(tree.get("alpha", 16.0)),
                          float(tree.get("dropout", 0.0)))
    if isinstance(tree, dict) and set(tree) <= {"w", "bias"} and "w" in tree:
        return DenseLinear(_tensor(tree["w"], device),
                           _tensor(tree.get("bias"), device))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _tensor(tree, device)


def _npz_array(t):
    """A tensor as the npz stores it: integers as they are, floats as f32
    (bfloat16 has no stable npz encoding)."""
    a = t.detach().cpu()
    if a.is_floating_point():
        a = a.to(torch.float32)
    return a.numpy()


def save_quant_checkpoint(path, quant_params, layers_bit, cfg, groupsize,
                          fmt="npz"):
    """Write ``weights.npz`` + ``quant_meta.json`` under ``path``
    (convert.py:171-247); the JAX package loads it as its own. Returns
    path."""
    if fmt != "npz":
        raise ValueError("the port writes fmt='npz' only (orbax needs JAX)")
    os.makedirs(path, exist_ok=True)
    flat = {}

    def put(prefix, lin):
        if isinstance(lin, QuantLinear):
            for k, v in lin.packed.items():
                flat["{}.packed.{}".format(prefix, k)] = _npz_array(v)
            flat[prefix + ".scales"] = _npz_array(lin.scales)
            flat[prefix + ".zeros"] = _npz_array(lin.zeros)
            # scales may be padded (pallas_n_pad); keep the logical width
            flat[prefix + ".nout"] = np.asarray(lin.out_features, np.int64)
            if lin.perm is not None:
                flat[prefix + ".perm"] = _npz_array(lin.perm)
        else:
            flat[prefix + ".w"] = _npz_array(lin.w)
        if lin.bias is not None:
            flat[prefix + ".bias"] = _npz_array(lin.bias)

    flat["tok_embed"] = _npz_array(quant_params["tok_embed"])
    flat["norm"] = _npz_array(quant_params["norm"])
    for i, layer in enumerate(quant_params["layers"]):
        flat["layers.{}.attn_norm".format(i)] = _npz_array(layer["attn_norm"])
        flat["layers.{}.ffn_norm".format(i)] = _npz_array(layer["ffn_norm"])
        for name in L._LINEAR_NAMES:
            if name in layer:
                put("layers.{}.{}".format(i, name), layer[name])
    put("lm_head", quant_params["lm_head"])
    np.savez(os.path.join(path, "weights.npz"), **flat)
    meta = {
        "hyper_parameters": {
            "groupsize": groupsize,
            "config": {k: getattr(cfg, k) for k in _CONFIG_KEYS},
        },
        "layers_bit": layers_bit,
    }
    with open(os.path.join(path, "quant_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_quant_checkpoint(path, device=None):
    """Read a checkpoint written by either package (convert.py:250-312)
    onto ``device`` (the card unless the caller names another). Returns
    (params, cfg, layers_bit); every QuantLinear has impl "auto"."""
    device = resolve_device(device)
    if os.path.isdir(os.path.join(path, "weights_orbax")):
        raise ValueError("{} holds an orbax checkpoint, which needs JAX; "
                         "save it with fmt='npz'".format(path))
    with open(os.path.join(path, "quant_meta.json")) as f:
        meta = json.load(f)
    cfg = L.LlamaConfig(**meta["hyper_parameters"]["config"])
    gs = meta["hyper_parameters"]["groupsize"]
    layers_bit = meta["layers_bit"]
    with np.load(os.path.join(path, "weights.npz")) as npz:
        z = dict(npz)
    dt = cfg.torch_dtype

    def arr(key, dtype=None):
        t = torch.from_numpy(np.require(z[key], requirements=["C", "W"]))
        return t.to(device, dtype) if dtype is not None else t.to(device)

    def get_lin(prefix, bits):
        bias = arr(prefix + ".bias", dt) if prefix + ".bias" in z else None
        if bits is None:  # dense
            return DenseLinear(arr(prefix + ".w", dt), bias)
        packed = {k.split(".packed.")[1]: arr(k) for k in z
                  if k.startswith(prefix + ".packed.")}
        perm = arr(prefix + ".perm") if prefix + ".perm" in z else None
        nout = (int(z[prefix + ".nout"]) if prefix + ".nout" in z
                else int(z[prefix + ".scales"].shape[1]))
        return QuantLinear(packed, arr(prefix + ".scales"),
                           arr(prefix + ".zeros"), bits, gs, nout, bias,
                           perm)

    params = {"tok_embed": arr("tok_embed", dt), "norm": arr("norm", dt),
              "layers": []}
    for i in range(cfg.n_layers):
        layer = {
            "attn_norm": arr("layers.{}.attn_norm".format(i), dt),
            "ffn_norm": arr("layers.{}.ffn_norm".format(i), dt),
        }
        for name in L._LINEAR_NAMES:
            p = "layers.{}.{}".format(i, name)
            if any(f.startswith(p + ".") for f in z):
                layer[name] = get_lin(p, layers_bit.get(p))
        params["layers"].append(layer)
    params["lm_head"] = get_lin("lm_head", layers_bit.get("lm_head"))
    return params, cfg, layers_bit
