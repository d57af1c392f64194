"""Functional LLaMA (port of ``sparsebit_tpu/llm/llama.py``): configs,
``init_llama_params``, the building blocks, causal attention (flash on the
card), the decoder layer, the full-sequence forward (``llama_backbone``,
``llama_forward``, ``llama_loss``) and the parameter transforms.

Parameters are plain dicts as in the JAX package: ``tok_embed`` (V, D),
``norm`` (D,), ``lm_head`` (a DenseLinear or QuantLinear) and ``layers``,
a list of per-layer dicts (or, after decode.stack_layers, one dict of
layer-stacked leaves). Activations are (B, S, D); attention heads
(B, S, H, hd).
"""

import functools
from dataclasses import dataclass

import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm.quant import DenseLinear
from sparsebit_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention


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


def llama_13b():
    return LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                       ffn_dim=13824)


def llama_tiny(**kw):
    """Test-scale config."""
    d = dict(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=512, max_seq_len=256,
    )
    d.update(kw)
    return LlamaConfig(**d)


def init_llama_params(cfg, generator=None, scale=0.02, *, device=None):
    """Random weights in the JAX package's tree (llama.py:66-101): N(0,
    scale) linears and embedding drawn in f32 and cast to cfg.dtype, unit
    norms, an untied head. The draws come from ``generator`` (default: a
    generator on ``device`` seeded 0) on its own device, in the reference's
    order (per layer wq, wk, wv, wo, w1, w3, w2; then the embedding and the
    head); the tensors land on ``device`` (default the card)."""
    dev = resolve_device(device)
    g = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    dt = cfg.torch_dtype
    hd, n_kv = cfg.head_dim, cfg.n_kv_heads

    def normal(shape):
        x = torch.randn(shape, generator=g, device=g.device) * scale
        return x.to(device=dev, dtype=dt)

    def ones():
        return torch.ones((cfg.dim,), dtype=dt, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        wq = normal((cfg.dim, cfg.n_heads * hd))
        wk = normal((cfg.dim, n_kv * hd))
        wv = normal((cfg.dim, n_kv * hd))
        wo = normal((cfg.n_heads * hd, cfg.dim))
        w1 = normal((cfg.dim, cfg.ffn_dim))
        w3 = normal((cfg.dim, cfg.ffn_dim))
        w2 = normal((cfg.ffn_dim, cfg.dim))
        layers.append({
            "attn_norm": ones(), "wq": DenseLinear(wq),
            "wk": DenseLinear(wk), "wv": DenseLinear(wv),
            "wo": DenseLinear(wo), "ffn_norm": ones(),
            "w1": DenseLinear(w1), "w3": DenseLinear(w3),
            "w2": DenseLinear(w2),
        })
    tok_embed = normal((cfg.vocab_size, cfg.dim))
    lm_head = DenseLinear(normal((cfg.dim, cfg.vocab_size)))
    return {"tok_embed": tok_embed, "layers": layers, "norm": ones(),
            "lm_head": lm_head}


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


def _flash_ok(q):
    """The route to K10 (llama.py:145-152): q (B, S, H, hd) on the card
    with a head_dim K10 takes, at any S >= 1. The reference's S % 128 == 0
    and S >= 128 are the TPU kernel's block rule (fault R7), not a limit
    of the model: K10 masks a ragged last tile."""
    return q.device.type == "cuda" and q.shape[-1] in HEAD_DIMS


def causal_attention(q, k, v):
    """Causal self-attention for prefill and scoring (llama.py:155-178):
    q (B, S, H, hd), k/v (B, S, Hkv, hd) with Hkv dividing H (the
    reference's callers repeat the kv heads first; here K10 reads kv head
    h // n_rep itself and the masked branch repeats them). K10 where
    ``_flash_ok`` holds, over bf16 operands for a bf16 model and f32
    otherwise, as the reference; else the masked attention_scores."""
    B, S, H, hd = q.shape
    if _flash_ok(q):
        dt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
        out = flash_attention(
            q.transpose(1, 2).to(dt), k.transpose(1, 2).to(dt),
            v.transpose(1, 2).to(dt), sm_scale=float(hd) ** -0.5)
        return out.transpose(1, 2).to(q.dtype)
    n_rep = H // k.shape[2]
    return attention_scores(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                            _causal_mask(S, q.device))


@functools.lru_cache(maxsize=4)
def _causal_mask(S, device):
    """The masked branch's (1, 1, S, S) additive causal mask, built once a
    length and device rather than once a layer."""
    return torch.triu(torch.full((S, S), -1e9, dtype=torch.float32,
                                 device=device), diagonal=1)[None, None]


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


def _attn_block(layer, x, cfg, inv_freq, positions, mask, kv=None):
    """Returns (attn_out, (k, v) for the cache). Without a mask or past
    kv the attention is causal_attention (K10 on the card)."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(layer, x, cfg)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    k_all, v_all = kv if kv is not None else (k, v)
    if kv is None and mask is None:
        out = causal_attention(q, k_all, v_all)
    else:
        n_rep = cfg.n_heads // cfg.n_kv_heads
        out = attention_scores(q, repeat_kv(k_all, n_rep),
                               repeat_kv(v_all, n_rep), mask)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return layer["wo"](out), (k, v)


def decoder_layer(layer, x, cfg, inv_freq, positions, mask, kv=None):
    h, new_kv = _attn_block(
        layer, rms_norm(x, layer["attn_norm"], cfg.rms_eps), cfg, inv_freq,
        positions, mask, kv)
    x = x + h
    x = x + _ffn_block(layer, rms_norm(x, layer["ffn_norm"], cfg.rms_eps))
    return x, new_kv


def llama_backbone(params, tokens, cfg, return_kv=False):
    """tokens (B, S) int -> final-norm hidden states (B, S, D). Causal, no
    cache: every layer's attention is causal_attention (K10 on the card).
    Split from llama_forward so that evaluation applies the lm_head in
    sequence chunks (eval._window_nll_chunked)."""
    B, S = tokens.shape
    dev = tokens.device
    x = params["tok_embed"][tokens.long()]
    inv_freq = rope_frequencies(cfg, device=dev)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    kvs = []
    for layer in params["layers"]:
        x, kv = decoder_layer(layer, x, cfg, inv_freq, positions, None)
        if return_kv:
            kvs.append(kv)
    x = rms_norm(x, params["norm"], cfg.rms_eps)
    return (x, kvs) if return_kv else x


def llama_forward(params, tokens, cfg, return_kv=False):
    """tokens (B, S) int -> f32 logits (B, S, V). Causal, no cache."""
    if return_kv:
        x, kvs = llama_backbone(params, tokens, cfg, return_kv=True)
        return params["lm_head"](x).to(torch.float32), kvs
    x = llama_backbone(params, tokens, cfg)
    return params["lm_head"](x).to(torch.float32)


def llama_loss(params, tokens, cfg):
    """Mean next-token cross-entropy of tokens (B, S)."""
    logits = llama_forward(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return nll.mean()


def fuse_llama_params(params):
    """Dense wq/wk/wv -> wqkv and w1/w3 -> w13 (llama.py:285-316): the
    columns are concatenated, missing biases as zeros."""

    def cat(lins):
        w = torch.cat([lin.w for lin in lins], dim=1)
        if all(lin.bias is None for lin in lins):
            return DenseLinear(w)
        return DenseLinear(w, torch.cat([
            lin.bias if lin.bias is not None
            else torch.zeros((lin.w.shape[1],), dtype=w.dtype,
                             device=w.device) for lin in lins]))

    out = dict(params)
    out["layers"] = [{
        "attn_norm": layer["attn_norm"], "ffn_norm": layer["ffn_norm"],
        "wqkv": cat([layer["wq"], layer["wk"], layer["wv"]]),
        "wo": layer["wo"], "w13": cat([layer["w1"], layer["w3"]]),
        "w2": layer["w2"],
    } for layer in params["layers"]]
    return out


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
