"""The npz checkpoint contract (weights.npz + quant_meta.json,
sparsebit_tpu/llm/convert.py:171-312) between the two packages: a
mixed-precision checkpoint (2/3/4/8-bit linears, an act-order perm, a
bias) written by the JAX package loads in the port with equal arrays and
matching logits, and one the port writes loads in the JAX package with
the same arrays.

Tolerance of the logits: ATOL 0.1 with equal argmax where the top-2
margin exceeds 2 * ATOL, as tests/test_torch_engine.py (bf16 activations,
f32 sums in another order); the arrays are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.llm import decode as JD
from sparsebit_tpu.llm import llama as JL
from sparsebit_tpu.llm.convert import load_quant_checkpoint as j_load
from sparsebit_tpu.llm.convert import save_quant_checkpoint as j_save
from sparsebit_tpu.llm.kv_cache import init_kv_cache as j_init
from sparsebit_tpu.llm.quant import QuantLinear as JQuant
from sparsebit_tpu_torch.llm import decode as TD
from sparsebit_tpu_torch.llm.convert import (
    load_quant_checkpoint,
    save_quant_checkpoint,
)
from sparsebit_tpu_torch.llm.kv_cache import init_kv_cache
from sparsebit_tpu_torch.llm.quant import QuantLinear

from test_torch_engine import jax_tree_to_numpy

torch.set_num_threads(1)

ATOL = 0.1
GS = 64
BITS = (2, 3, 4, 8)


def _mixed_model():
    """Tiny LLaMA whose linears cycle through 2/3/4/8 bits; layer 0's wq
    carries an act-order perm and layer 1's w2 a bias."""
    cfg = JL.llama_tiny(max_seq_len=64)
    params = JL.init_llama_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    layers_bit, count = {}, [0]

    def quantize(path, lin):
        bits = BITS[count[0] % len(BITS)]
        count[0] += 1
        K, N = lin.w.shape
        G = K // GS
        codes = rng.integers(0, 2 ** bits, (K, N))
        zeros = rng.integers(0, 2 ** bits, (G, N)).astype(np.float32)
        w_max = float(jnp.abs(lin.w.astype(jnp.float32)).max())
        scales = rng.uniform(0.2, 1.0, (G, N)).astype(np.float32) * (
            2 * w_max / 2 ** bits)
        perm = rng.permutation(K).astype(np.int32) \
            if path == "layers.0.wq" else None
        bias = jnp.asarray(rng.standard_normal(N) * 0.1, jnp.bfloat16) \
            if path == "layers.1.w2" else None
        layers_bit[path] = bits
        return JQuant.from_codes(
            jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(zeros),
            bits, GS, bias=bias,
            perm=None if perm is None else jnp.asarray(perm))

    return cfg, JL.quantize_llama_params(params, quantize), layers_bit


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg, qparams, layers_bit = _mixed_model()
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    j_save(path, qparams, layers_bit, cfg, GS)
    return path, layers_bit


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif a is None or isinstance(a, (int, str)):
        assert a == b
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _port_tree(params):
    """The port's params as the numpy tree jax_tree_to_numpy makes."""
    def conv(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    if isinstance(params, QuantLinear):
        return {"packed": {k: conv(v) for k, v in params.packed.items()},
                "scales": conv(params.scales), "zeros": conv(params.zeros),
                "bits": params.bits, "groupsize": params.groupsize,
                "out_features": params.out_features,
                "bias": conv(params.bias), "perm": conv(params.perm),
                "impl": params.impl}
    if hasattr(params, "w"):
        return {"w": conv(params.w), "bias": conv(params.bias)}
    if isinstance(params, dict):
        return {k: _port_tree(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_port_tree(v) for v in params]
    return conv(params)


def test_jax_checkpoint_loads_in_the_port(checkpoint):
    path, layers_bit = checkpoint
    jparams, jcfg, jbits = j_load(path)
    tparams, tcfg, tbits = load_quant_checkpoint(path, device="cpu")
    assert tbits == jbits == layers_bit
    assert {k: getattr(tcfg, k) for k in ("dim", "n_layers", "n_heads",
                                          "n_kv_heads", "ffn_dim",
                                          "vocab_size", "dtype")} == {
        k: getattr(jcfg, k) for k in ("dim", "n_layers", "n_heads",
                                      "n_kv_heads", "ffn_dim", "vocab_size",
                                      "dtype")}
    _assert_trees_equal(_port_tree(tparams), jax_tree_to_numpy(jparams))
    wq = tparams["layers"][0]["wq"]
    assert wq.perm is not None and tparams["layers"][1]["w2"].bias is not None
    assert {lin.bits for lyr in tparams["layers"] for lin in lyr.values()
            if isinstance(lin, QuantLinear)} == set(BITS)

    prompt = np.random.default_rng(2).integers(0, 512, (2, 8)).astype(
        np.int32)
    jl, jc = JD.prefill(jparams, jnp.asarray(prompt), j_init(jcfg, 2, 16),
                        jcfg)
    tl, tc = TD.prefill(tparams, torch.from_numpy(prompt).long(),
                        init_kv_cache(tcfg, 2, 16, device="cpu"), tcfg)
    rows = [(np.asarray(jl, np.float32), tl.numpy())]
    tok = rows[0][0].argmax(-1).astype(np.int32)
    jl, _ = JD.decode_step(jparams, jnp.asarray(tok), jc, jcfg)
    tl, _ = TD.decode_step(tparams, torch.from_numpy(tok), tc, tcfg)
    rows.append((np.asarray(jl, np.float32), tl.numpy()))
    for lj, lt in rows:
        np.testing.assert_allclose(lt, lj, atol=ATOL)
        top2 = np.sort(lj, -1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 2 * ATOL
        np.testing.assert_array_equal(lt.argmax(-1)[decisive],
                                      lj.argmax(-1)[decisive])


def test_port_checkpoint_loads_in_jax(checkpoint, tmp_path):
    path, layers_bit = checkpoint
    tparams, tcfg, _ = load_quant_checkpoint(path, device="cpu")
    out = str(tmp_path / "port_ckpt")
    save_quant_checkpoint(out, tparams, layers_bit, tcfg, GS)
    jparams, _, jbits = j_load(out)
    assert jbits == layers_bit
    _assert_trees_equal(jax_tree_to_numpy(jparams),
                        jax_tree_to_numpy(j_load(path)[0]))


def test_orbax_is_refused(tmp_path):
    (tmp_path / "weights_orbax").mkdir()
    with pytest.raises(ValueError):
        load_quant_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(ValueError):
        save_quant_checkpoint(str(tmp_path), {}, {}, None, GS, fmt="orbax")
