"""Import HuggingFace LLaMA weights into the port's params (port of
``sparsebit_tpu/llm/import_hf.py``).

The state dict is mapped tensor by tensor into the functional tree. A
torch ``nn.Linear`` stores (out, in); this package uses (in, out) so that
the forward is ``x @ w``, hence the transpose. A state dict without
``lm_head.weight`` has a tied head: the embedding, transposed.

Works from a transformers model object, a local ``from_pretrained`` path,
or a raw state dict of tensors or numpy arrays. Nothing is downloaded;
``transformers`` is imported only to read a path.
"""

import numpy as np
import torch

from sparsebit_tpu_torch import resolve_device
from sparsebit_tpu_torch.llm.llama import LlamaConfig
from sparsebit_tpu_torch.llm.quant import DenseLinear


def _t(x, dtype, device):
    """x (a tensor or an array) through f32 to ``dtype`` on ``device``,
    as the JAX package converts it."""
    t = x.detach() if torch.is_tensor(x) else torch.from_numpy(
        np.require(x, requirements=["C", "W"]))
    return t.to(torch.float32).to(device=device, dtype=dtype)


def config_from_hf(hf_config):
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        ffn_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rms_eps=hf_config.rms_norm_eps,
    )


_HF_LINEAR = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w1": "mlp.gate_proj",
    "w3": "mlp.up_proj",
    "w2": "mlp.down_proj",
}


def params_from_state_dict(sd, cfg, dtype=None, *, device=None):
    """sd: a HF LlamaForCausalLM state dict (tensors or numpy arrays).
    Leaves in ``dtype`` (default cfg's) on ``device`` (default the
    card)."""
    dt = dtype or cfg.torch_dtype
    dev = resolve_device(device)

    def lin(prefix):
        w = _t(sd[prefix + ".weight"], dt, dev).t().contiguous()
        b = (_t(sd[prefix + ".bias"], dt, dev) if prefix + ".bias" in sd
             else None)
        return DenseLinear(w, b)

    layers = []
    for i in range(cfg.n_layers):
        p = "model.layers.{}.".format(i)
        layer = {
            "attn_norm": _t(sd[p + "input_layernorm.weight"], dt, dev),
            "ffn_norm": _t(sd[p + "post_attention_layernorm.weight"], dt,
                           dev),
        }
        for ours, theirs in _HF_LINEAR.items():
            layer[ours] = lin(p + theirs)
        layers.append(layer)
    embed = _t(sd["model.embed_tokens.weight"], dt, dev)
    return {
        "tok_embed": embed,
        "layers": layers,
        "norm": _t(sd["model.norm.weight"], dt, dev),
        "lm_head": (lin("lm_head") if "lm_head.weight" in sd
                    else DenseLinear(embed.t().contiguous())),
    }


def load_llama_from_hf(model_or_path, dtype=None, *, device=None):
    """Returns (params, cfg) from a transformers model instance or a
    local pretrained path (no downloads)."""
    if isinstance(model_or_path, str):
        from transformers import AutoConfig, AutoModelForCausalLM

        hf_cfg = AutoConfig.from_pretrained(model_or_path)
        model = AutoModelForCausalLM.from_pretrained(model_or_path)
    else:
        model = model_or_path
        hf_cfg = model.config
    cfg = config_from_hf(hf_cfg)
    return params_from_state_dict(model.state_dict(), cfg, dtype,
                                  device=device), cfg
