"""The port's ImageNet CNNs of the PTQ basecase (mobilenet_v2,
efficientnet_lite0, regnetx_600mf) and the extractive-QA BERT
(bert_qa_tiny) against the JAX package's, on the CPU, with the JAX
models' weights carried across (``nn.load_jax_state_dict``; BatchNorm
state randomised so that it is no identity):

- the forward within 1e-4 of JAX's (convolutions summed in other
  orders), the traced graph equal to JAX's node by node;
- tests/test_quant_model.py's PTQ flow (test_imagenet_zoo_ptq_flow) on
  the three CNNs: quantizers off equal to the float model within 1e-4,
  the 8-bit relative MSE in JAX's bound (0, 5e-2), and every quantizer's
  qparams within 1e-5 relative of JAX's (zero points, flags and bit
  widths equal);
- structured pruning of mobilenet_v2 (depthwise convs, inverted-residual
  adds) against JAX: ``test_torch_sparse.py``'s node-by-node rule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.models import create_model as j_create_model
from sparsebit_tpu_torch.models import create_model as t_create_model
from test_torch_graph import carry, rand, randomize_bn, signature
from test_torch_quant_model import (
    assert_qparams_match,
    both,
    calibrate,
    cfg_dict,
    run,
)

CNNS = ["mobilenet_v2", "efficientnet_lite0", "regnetx_600mf"]


@functools.lru_cache(maxsize=None)
def cnn_pair(name):
    """The JAX model (built once a process: its initialisation compiles a
    kernel a layer shape) and the port's with its weights. Neither flow
    below changes a model's state."""
    jm = randomize_bn(j_create_model(name, num_classes=16).eval())
    tm = carry(jm, t_create_model(name, num_classes=16, device="cpu").eval())
    return jm, tm


@pytest.mark.parametrize("name", CNNS)
def test_cnn_ptq_flow_matches_jax(name):
    jm, tm = cnn_pair(name)
    x = rand((2, 64, 64, 3), seed=3)
    with torch.no_grad():
        float_out = tm(torch.from_numpy(x)).numpy()
    assert float_out.shape == (2, 16)
    # jitted: JAX compiles the model once instead of op by op
    want = np.asarray(jax.jit(lambda v: jm(v))(jnp.asarray(x)))
    np.testing.assert_allclose(float_out, want, rtol=0, atol=1e-4)
    jq, tq = both(jm, tm, x, cfg_dict())
    assert signature(tq.graph) == signature(jq.graph)
    np.testing.assert_allclose(run(tq, x), float_out, rtol=0, atol=1e-4)
    for q in (jq, tq):
        calibrate(q, [x])
        q.set_quant(True, True)
    assert_qparams_match(jq, tq, rtol=1e-5)
    got = run(tq, x)
    rel = np.mean((got - float_out) ** 2) / (np.mean(float_out ** 2) + 1e-12)
    assert 0 < rel < 5e-2


def test_bert_qa_tiny_matches_jax():
    jm = j_create_model("bert_qa_tiny").eval()
    tm = carry(jm, t_create_model("bert_qa_tiny", device="cpu").eval())
    ids = np.random.default_rng(4).integers(0, 1024, (2, 24)).astype(
        np.int32)
    js, je = jm(jnp.asarray(ids))
    with torch.no_grad():
        ts, te = tm(torch.from_numpy(ids))
    assert tuple(ts.shape) == tuple(te.shape) == (2, 24)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-4)


def test_mobilenet_v2_structured_pruning_matches_jax():
    from test_torch_sparse import assert_sparse_match, both_sparse

    jm, tm = cnn_pair("mobilenet_v2")
    x = rand((2, 32, 32, 3), seed=5)
    js, ts = both_sparse(jm, tm, x, "structure", 0.5)
    n_masked = assert_sparse_match(js, ts, x)
    # the projections feed the residual adds and keep every channel; the
    # expansions and the depthwise convs are pruned, their BatchNorms
    # masked
    dense = {n for n, op in ts.smodules()
             if op.HAS_WEIGHT and op.sparser.ratio == 0.0}
    assert "blocks.1.project" in dense and "blocks.2.project" in dense
    assert "blocks.1.body.0.conv" not in dense
    assert n_masked > 0
