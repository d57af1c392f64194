"""The port's HF import (``sparsebit_tpu_torch/llm/import_hf.py``)
against the JAX package's, on the CPU.

- ``params_from_state_dict`` on a random state dict in HF names, built in
  memory as numpy arrays and as torch tensors, with its own head and with
  a tied one: every leaf equal to the JAX package's, bit for bit (both
  round f32 to the target dtype to nearest even);
- with ``transformers``: a ``LlamaForCausalLM`` built from a config in
  memory (GQA), its logits against the port's ``llama_forward`` over the
  imported f32 weights within rtol/atol 2e-3 (as tests/test_hf_import.py
  holds the JAX package), from the model object and from a directory
  written by ``save_pretrained``.
"""

import numpy as np
import pytest
import torch

from sparsebit_tpu.llm.import_hf import (
    params_from_state_dict as j_params_from_state_dict,
)
from sparsebit_tpu.llm.llama import LlamaConfig as JConfig
from sparsebit_tpu_torch.llm import llama as TL
from sparsebit_tpu_torch.llm.import_hf import (
    config_from_hf,
    load_llama_from_hf,
    params_from_state_dict,
)

from test_torch_engine import jax_tree_to_numpy
from test_torch_checkpoint import _assert_trees_equal, _port_tree

torch.set_num_threads(1)

DIMS = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=64)
HF_LINEARS = {"self_attn.q_proj": (64, 64), "self_attn.k_proj": (32, 64),
              "self_attn.v_proj": (32, 64), "self_attn.o_proj": (64, 64),
              "mlp.gate_proj": (128, 64), "mlp.up_proj": (128, 64),
              "mlp.down_proj": (64, 128)}


def _state_dict(tied, seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": a(96, 64), "model.norm.weight": a(64)}
    for i in range(2):
        p = "model.layers.{}.".format(i)
        sd[p + "input_layernorm.weight"] = a(64)
        sd[p + "post_attention_layernorm.weight"] = a(64)
        for name, shape in HF_LINEARS.items():
            sd[p + name + ".weight"] = a(*shape)
    if not tied:
        sd["lm_head.weight"] = a(96, 64)
    return sd


@pytest.mark.parametrize("tied", [False, True], ids=["head", "tied"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["numpy", "tensors"])
def test_params_from_state_dict_matches_jax(tied, dtype, as_tensors):
    sd = _state_dict(tied)
    ref = j_params_from_state_dict(sd, JConfig(**DIMS, dtype=dtype))
    if as_tensors:
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    cfg = TL.LlamaConfig(**DIMS, dtype=dtype)
    got = params_from_state_dict(sd, cfg, device="cpu")
    assert got["tok_embed"].dtype == getattr(torch, dtype)
    assert got["layers"][0]["wq"].w.is_contiguous()
    _assert_trees_equal(_port_tree(got), jax_tree_to_numpy(ref))
    # an explicit dtype wins over the config's
    f32 = params_from_state_dict(sd, cfg, torch.float32, device="cpu")
    assert f32["lm_head"].w.dtype == torch.float32
    if tied:
        np.testing.assert_array_equal(f32["lm_head"].w.numpy(),
                                      np.asarray(sd["model.embed_tokens"
                                                    ".weight"]).T)


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-6,
        attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.eval()
    return model


def test_hf_llama_logits_match(hf_model, tmp_path):
    ids = np.array([[3, 17, 91, 200, 4, 8, 42, 11]], dtype=np.int64)
    with torch.no_grad():
        ref = hf_model(torch.from_numpy(ids)).logits.numpy()
    cfg = config_from_hf(hf_model.config)
    assert (cfg.n_kv_heads, cfg.ffn_dim, cfg.rms_eps) == (2, 128, 1e-6)
    hf_model.save_pretrained(str(tmp_path))
    for source in (hf_model, str(tmp_path)):
        params, cfg = load_llama_from_hf(source, torch.float32, device="cpu")
        out = TL.llama_forward(params, torch.from_numpy(ids), cfg).numpy()
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)
