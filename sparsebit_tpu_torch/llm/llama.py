"""LLaMA building blocks (port of ``sparsebit_tpu/llm/llama.py``: config,
``rms_norm``, rope, ``repeat_kv``, ``attention_scores``, ``qkv_proj`` and
``_ffn_block``).

Parameters are plain dicts as in the JAX package: ``tok_embed`` (V, D),
``norm`` (D,), ``lm_head`` (a DenseLinear or QuantLinear) and ``layers``,
a list of per-layer dicts (or, after decode.stack_layers, one dict of
layer-stacked leaves). Activations are (B, S, D); attention heads
(B, S, H, hd).
"""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.dim // self.n_heads

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


def llama_7b():
    return LlamaConfig()


def llama_tiny(**kw):
    """Test-scale config."""
    d = dict(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=512, max_seq_len=256,
    )
    d.update(kw)
    return LlamaConfig(**d)


def rms_norm(x, weight, eps):
    """f32 normalisation cast back to x's dtype BEFORE the weight multiply
    (llama.py:104-106)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_frequencies(cfg, device=None):
    hd = cfg.head_dim
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (cfg.rope_theta ** exps)  # (hd/2,)


def apply_rope(x, positions, inv_freq):
    """x (B, S, H, hd); positions (B, S) int."""
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x, n_rep):
    """(B, S, n_kv, hd) -> (B, S, n_kv*n_rep, hd); kv head j serves query
    heads j*n_rep .. j*n_rep + n_rep - 1."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def attention_scores(q, k, v, mask):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd), mask broadcastable (B,1,Sq,Sk);
    f32 scores and mix, output in q's dtype. The scale is a multiply by
    the f32 reciprocal of sqrt(hd) (XLA's form of the reference's division
    by that constant) and the softmax is exp(s - max) / sum, as
    jax.nn.softmax."""
    hd = q.shape[-1]
    inv = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) * inv.to(q.device)
    scores = scores + mask
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def qkv_proj(layer, x, cfg):
    """(q, k, v) heads from a fused ``wqkv`` or separate wq/wk/wv."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    nq = cfg.n_heads * hd
    nkv = cfg.n_kv_heads * hd
    if "wqkv" in layer:
        qkv = layer["wqkv"](x)
        q = qkv[..., :nq].reshape(B, S, cfg.n_heads, hd)
        k = qkv[..., nq: nq + nkv].reshape(B, S, cfg.n_kv_heads, hd)
        v = qkv[..., nq + nkv:].reshape(B, S, cfg.n_kv_heads, hd)
    else:
        q = layer["wq"](x).reshape(B, S, cfg.n_heads, hd)
        k = layer["wk"](x).reshape(B, S, cfg.n_kv_heads, hd)
        v = layer["wv"](x).reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def _ffn_block(layer, x):
    if "w13" in layer:
        g, u = torch.chunk(layer["w13"](x), 2, dim=-1)
        return layer["w2"](torch.nn.functional.silu(g) * u)
    return layer["w2"](
        torch.nn.functional.silu(layer["w1"](x)) * layer["w3"](x))


_LINEAR_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wqkv", "w13")


def quantize_llama_params(params, quantize_fn, skip=("lm_head",)):
    """New params dict with every linear replaced by
    ``quantize_fn(path, lin)`` (path like "layers.3.wq")."""
    out = dict(params)
    out["layers"] = []
    for i, layer in enumerate(params["layers"]):
        new_layer = dict(layer)
        for name in _LINEAR_NAMES:
            if name in layer:
                new_layer[name] = quantize_fn(
                    "layers.{}.{}".format(i, name), layer[name])
        out["layers"].append(new_layer)
    if "lm_head" not in skip:
        out["lm_head"] = quantize_fn("lm_head", params["lm_head"])
    return out
