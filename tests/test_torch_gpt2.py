"""The port's GPT-2 (``models/gpt2.py``) against the JAX package's, on the
CPU, with the JAX model's weights carried across
(``nn.load_jax_state_dict``, the -1e9 causal-mask buffers too): gpt2_tiny
(2 blocks, width 128, vocab 1024).

- the logits within 1e-4 of JAX's; the traced graph equal to JAX's node
  by node (names, ops, edges, static arguments, shapes), the causal mask
  a buffer read plus a getitem that folds into the ``add`` node's
  constant, positions ``0..L-1`` a constant lookup;
- QuantModel with quantizers off within 1e-5 of the float model;
- the wikitext PTQ yaml (MSE activation observers, ACIQ-Laplace lm_head):
  every quantizer's scale within 1e-5 relative of JAX's (the ACIQ weight
  scale is a mean absolute deviation, a reduction), zero points, flags
  and bit widths equal;
- fault R13, pinned on both packages: the softmax input carries the
  -1e9 mask, so its per-tensor MSE quantizer spans ~1e9 and every
  unmasked score fake-quantizes to 0, which makes the quantized
  attention uniform over the causal prefix.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.models import create_model as j_create_model
from sparsebit_tpu.nn.graph import Tracer as JTracer
from sparsebit_tpu_torch.models import create_model as t_create_model
from sparsebit_tpu_torch.nn.graph import Tracer as TTracer
from test_torch_graph import carry, signature
from test_torch_quant_model import _jax_activations, both, calibrate, qparams

torch.set_num_threads(1)

WIKITEXT_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
    "post_training_quantization", "wikitext_gpt2", "qconfig.yaml")


def pair():
    jm = j_create_model("gpt2_tiny").eval()
    return jm, carry(jm, t_create_model("gpt2_tiny", device="cpu").eval())


def tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, shape).astype(
        np.int32)


def test_gpt2_tiny_forward_and_graph_match_jax():
    jm, tm = pair()
    ids = tokens((2, 24))
    want = np.asarray(jax.jit(lambda v: jm(v))(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 24, 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    jg = JTracer().trace(jm, (jnp.asarray(ids),))
    tg = TTracer().trace(tm, (torch.from_numpy(ids),))
    assert signature(tg) == signature(jg)
    for jn, tn in zip(jg.op_nodes, tg.op_nodes):
        assert tn.kwargs == {k: tuple(v) if isinstance(v, list) else v
                             for k, v in jn.kwargs.items()}, jn.name
        assert tuple(tn.out_aval.shape) == tuple(jn.out_aval.shape)
    with torch.no_grad():
        assert torch.equal(tg.run(None, torch.from_numpy(ids)),
                           torch.from_numpy(got))


def test_causal_mask_is_a_buffer_read_plus_getitem():
    """fx reads ``causal_bias`` (get_attr) and slices it by the traced
    length (getitem); the lowering folds both into the constant operand
    of the scores' ``add``, sliced to the traced length, as JAX's graph
    captures the sliced array. The mask is model state: in the state
    dict, carried from JAX, moved with the model."""
    from sparsebit_tpu_torch.nn.graph import _FxTracer

    jm, tm = pair()
    fx = _FxTracer([]).trace(tm)
    reads = [n for n in fx.nodes if n.op == "get_attr"
             and n.target == "blocks.0.attn.causal_bias"]
    assert len(reads) == 1
    assert [u.target.__name__ for u in reads[0].users] == ["getitem"]
    for L in (7, 24):
        tg = TTracer().trace(tm, (torch.from_numpy(tokens((1, L))),))
        add = tg.find_node("add_2")  # the first block's scores + mask
        mask = add.args[1]
        assert isinstance(mask, torch.Tensor) and mask.shape == (L, L)
        assert torch.equal(mask, tm.blocks[0].attn.causal_bias[:L, :L])
        assert float(mask[0, 1]) == -1e9 and float(mask[1, 0]) == 0.0
    np.testing.assert_array_equal(
        tm.blocks[1].attn.causal_bias.numpy(),
        np.asarray(jm.full_state_dict()["blocks.1.attn.causal_bias"]))
    assert "blocks.0.attn.causal_bias" in tm.state_dict()


def _qparams_within(jq, tq, rtol):
    jp, tp = qparams(jq), qparams(tq)
    assert list(tp) == list(jp)
    for key, (js, jz, *jflags) in jp.items():
        ts, tz, *tflags = tp[key]
        assert tflags == jflags, key
        np.testing.assert_allclose(ts, js, rtol=rtol, atol=0, err_msg=key)
        np.testing.assert_array_equal(tz, jz, err_msg=key)


@pytest.fixture(scope="module")
def wikitext_pair():
    """Both packages' QuantModels of gpt2_tiny on the wikitext yaml,
    calibrated on two 32-token windows, quantizers on."""
    jm, tm = pair()
    ids = [tokens((1, 32), seed=s) for s in (1, 2)]
    with torch.no_grad():
        float_out = tm(torch.from_numpy(ids[0])).numpy()
    jq, tq = both(jm, tm, ids[0], WIKITEXT_YAML)
    assert signature(tq.graph) == signature(jq.graph)
    with torch.no_grad():
        off = tq(torch.from_numpy(ids[0])).numpy()
    np.testing.assert_allclose(off, float_out, rtol=0, atol=1e-5)
    for q in (jq, tq):
        calibrate(q, ids)
        q.set_quant(True, True)
    return jq, tq, ids[0]


def test_gpt2_wikitext_qparams_match_jax(wikitext_pair):
    jq, tq, _ = wikitext_pair
    _qparams_within(jq, tq, rtol=1e-5)
    ops = dict(tq.qmodules())
    assert ops["lm_head"].weight_quantizer.observer.TYPE == "aciq"
    assert ops["blocks.0.attn.c_attn"].input_quantizer.observer.TYPE == "mse"


def _softmax_case(q, env, name):
    """(float input, fake-quantized input) of softmax node ``name``."""
    op = q.get_qmodule(name)
    x = env[q.graph.find_node(name).input_nodes[0].name]
    return np.asarray(x), np.asarray(op.input_quantizer(x))


def test_r13_mask_swamps_the_softmax_input_quantizer(wikitext_pair):
    """Fault R13, in both packages: the yaml's ``*softmax*`` override
    (``QUANTIZER.DISABLE``) is read by neither, so the softmax input, the
    scores plus the -1e9 mask, is quantized per tensor. Its range is
    ~1e9 wide: scale ~3.9e6, zero point 255, every unmasked score
    fake-quantizes to 0 and the masked ones stay ~-1e9, so the quantized
    softmax is uniform over the causal prefix."""
    jq, tq, ids = wikitext_pair
    env = _jax_activations(jq, ids)
    L = ids.shape[1]
    lower = np.tril(np.ones((L, L), bool))
    for name in ("softmax", "softmax_17"):  # the two blocks'
        qz = jq.get_qmodule(name).input_quantizer
        assert float(np.asarray(qz.scale).reshape(())) > 1e9 / 256
        assert float(np.asarray(qz.zero_point).reshape(())) == 255.0
        x, xq = _softmax_case(jq, env, name)
        assert np.abs(x[..., lower]).max() > 0.0
        assert np.all(xq[..., lower] == 0.0)
        assert np.all(xq[..., ~lower] < -9e8)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(xq), axis=-1))
        uniform = np.where(lower, 1.0 / np.arange(1, L + 1)[:, None], 0.0)
        np.testing.assert_allclose(probs, np.broadcast_to(uniform, x.shape),
                                   rtol=1e-6, atol=0)
        tqz = tq.get_qmodule(name).input_quantizer
        np.testing.assert_allclose(float(tqz.scale), float(
            np.asarray(qz.scale).reshape(())), rtol=1e-5)
        with torch.no_grad():
            txq = tqz(torch.from_numpy(x.copy())).numpy()
        assert np.all(txq[..., lower] == 0.0)
