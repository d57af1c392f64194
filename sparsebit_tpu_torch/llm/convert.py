"""Layer-streaming GPTQ conversion, the npz checkpoint, and parameters
carried across from the JAX package (port of
``sparsebit_tpu/llm/convert.py``).

``quantize_llama_gptq`` runs the reference's llama_sequential
(convert.py:63-174) layer by layer: the inputs of each linear group are
taken from the float layer (``_layer_intermediates``, masked attention
scores as in the JAX package), their Hessians accumulated, every linear
GPTQ-solved (``llm/gptq.py``), and the calibration batches propagated
through the quantized layer, so that later layers calibrate against
quantized predecessors. One layer's Hessians are held at a time.

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
from sparsebit_tpu_torch.llm.gptq import (HessianAccumulator,
                                          gptq_quantize_mixed)
from sparsebit_tpu_torch.llm.qlora import LoraLinear
from sparsebit_tpu_torch.llm.quant import DenseLinear, QuantLinear

_CONFIG_KEYS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                "ffn_dim", "max_seq_len", "rope_theta", "rms_eps", "dtype")


def _layer_intermediates(layer, x, cfg, inv_freq, positions, mask):
    """The inputs of each linear group of one decoder layer
    (convert.py:34-54), fused wqkv/w13 or separate wq/wk/wv/w1/w3."""
    h1 = L.rms_norm(x, layer["attn_norm"], cfg.rms_eps)  # -> wq/wk/wv|wqkv
    B, S, _ = x.shape
    q, k, v = L.qkv_proj(layer, h1, cfg)
    q = L.apply_rope(q, positions, inv_freq)
    k = L.apply_rope(k, positions, inv_freq)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    attn = L.attention_scores(
        q, L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep), mask
    ).reshape(B, S, cfg.n_heads * cfg.head_dim)  # -> wo
    x2 = x + layer["wo"](attn)
    h2 = L.rms_norm(x2, layer["ffn_norm"], cfg.rms_eps)  # -> w1/w3|w13
    if "w13" in layer:
        g, u = torch.chunk(layer["w13"](h2), 2, dim=-1)
        ffn_mid = torch.nn.functional.silu(g) * u  # -> w2
    else:
        ffn_mid = torch.nn.functional.silu(layer["w1"](h2)) * layer["w3"](h2)
    return {"qkv": h1, "wo": attn, "ffn_in": h2, "w2": ffn_mid}


_GROUP_OF = {
    "wq": "qkv", "wk": "qkv", "wv": "qkv", "wqkv": "qkv",
    "wo": "wo", "w1": "ffn_in", "w3": "ffn_in", "w13": "ffn_in", "w2": "w2",
}


def quantize_llama_gptq(params, calib_tokens, cfg, candidate_bits=(4,),
                        groupsize=128, sym=False, percdamp=0.01,
                        loss_threshold=1e-3, batch_size=1,
                        quantize_lm_head=False, act_order=False,
                        verbose=True, *, device=None):
    """calib_tokens: (n_samples, seqlen) ints (the reference calibrates on
    128 x 2048 wikitext2 samples, convert.py:37). params lie on ``device``
    (default the card), where the whole conversion runs. Returns
    (quant_params, layers_bit).

    Each batch of ``batch_size`` samples gets positions of its own shape,
    so a last batch shorter than batch_size is calibrated as it is (the
    JAX package broadcasts one positions array of batch_size rows: fault
    R8). The propagation runs ``decoder_layer`` without a mask, i.e.
    ``causal_attention`` (K10 on the card), where the JAX package passes
    its mask (the masked scores): the same causal attention without the
    (S, S) scores."""
    dev = resolve_device(device)
    calib = torch.as_tensor(calib_tokens, device=dev).long()
    n, S = calib.shape
    inv_freq = L.rope_frequencies(cfg, device=dev)
    mask = L._causal_mask(S, dev)
    batches = [(b, min(b + batch_size, n)) for b in range(0, n, batch_size)]

    def positions(rows):
        return torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
            rows, S)

    inps = params["tok_embed"][calib]  # (n, S, D): layer 0's inputs
    new_params = dict(params)
    new_params["layers"] = []
    layers_bit = {}
    for li, layer in enumerate(params["layers"]):
        # Hessians of the four linear groups over the calibration batches
        accs = {
            "qkv": HessianAccumulator(cfg.dim, device=dev),
            "wo": HessianAccumulator(cfg.n_heads * cfg.head_dim, device=dev),
            "ffn_in": HessianAccumulator(cfg.dim, device=dev),
            "w2": HessianAccumulator(cfg.ffn_dim, device=dev),
        }
        for b0, b1 in batches:
            feats = _layer_intermediates(layer, inps[b0:b1], cfg, inv_freq,
                                         positions(b1 - b0), mask)
            for g, acc in accs.items():
                acc.add_batch(feats[g])
        del feats

        # GPTQ-solve each linear (fused or separate layout)
        new_layer = dict(layer)
        for name in [nm for nm in L._LINEAR_NAMES if nm in layer]:
            lin = layer[name]
            acc = accs[_GROUP_OF[name]]
            res = gptq_quantize_mixed(
                lin.w, acc.H, candidate_bits=candidate_bits,
                loss_threshold=loss_threshold, groupsize=groupsize, sym=sym,
                percdamp=percdamp, mean_x=acc.mean_x, bias=lin.bias,
                act_order=act_order)
            path = "layers.{}.{}".format(li, name)
            layers_bit[path] = res["bits"]
            new_layer[name] = QuantLinear.from_codes(
                res["codes"], res["scales"], res["zeros"], res["bits"],
                groupsize, bias=res.get("bias", lin.bias), perm=res["perm"])
            if verbose:
                print("[gptq] {} bits={} loss={:.3e}".format(
                    path, res["bits"], res["loss"]))
        del accs, res
        new_params["layers"].append(new_layer)

        # propagate: the quantized layer's outputs feed the next layer
        outs = torch.empty_like(inps)
        for b0, b1 in batches:
            outs[b0:b1] = L.decoder_layer(new_layer, inps[b0:b1], cfg,
                                          inv_freq, positions(b1 - b0),
                                          None)[0]
        inps = outs

    if quantize_lm_head:
        lin = params["lm_head"]
        acc = HessianAccumulator(cfg.dim, device=dev)
        acc.add_batch(L.rms_norm(inps, params["norm"], cfg.rms_eps))
        res = gptq_quantize_mixed(
            lin.w, acc.H, candidate_bits=candidate_bits,
            loss_threshold=loss_threshold, groupsize=groupsize, sym=sym,
            percdamp=percdamp, mean_x=acc.mean_x, bias=lin.bias)
        layers_bit["lm_head"] = res["bits"]
        new_params["lm_head"] = QuantLinear.from_codes(
            res["codes"], res["scales"], res["zeros"], res["bits"],
            groupsize, bias=res.get("bias", lin.bias))
    return new_params, layers_bit


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
