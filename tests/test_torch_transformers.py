"""The port's transformer zoo (``models/vit.py``, ``models/bert.py``)
through QuantModel against the JAX package's, on the CPU, with the JAX
models' weights carried across (``nn.load_jax_state_dict``): a ViT of
width 48 with 2 blocks on 16 x 16 images (the fixture's) and bert_tiny.

- the traced graphs: the same ops in the same order under the same node
  names, so one yaml's ``*norm*`` / ``*softmax*`` overrides select the
  same nodes (BERT's position and token-type lookups read no input and
  fold into constants in both packages; ViT's cls_token and pos_embed
  are constants in both);
- the float forward within 1e-5 of JAX's, and the QuantModel with
  quantizers off within 1e-5 of the float model;
- W8A8 calibration (the DeiT yaml's scheme with MinMax observers, and
  the CoLA yaml's percentile observers): every quantizer's scale within
  1e-6 relative of JAX's (weight scales equal), zero points and flags
  equal. The yamls' ``*norm*`` / ``*softmax*`` overrides set
  ``QUANTIZER.DISABLE``, which neither package reads: those inputs are
  quantized in both (the flags compared here);
- every node, on JAX's inputs and qparams, within 1e-5 (relative to its
  largest output) of JAX's, as the resnet18 test of
  test_torch_quant_model.py holds it (end to end, rounding ties flip
  codes between two correct pipelines), QMatmul on 4-D (B, H, N, hd)
  inputs included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.models.bert import bert_tiny as j_bert_tiny
from sparsebit_tpu.models.vit import VisionTransformer as JViT
from sparsebit_tpu_torch.models.bert import bert_tiny as t_bert_tiny
from sparsebit_tpu_torch.models.vit import VisionTransformer as TViT
from sparsebit_tpu_torch.quantization.modules.matmul import MatMul as QMatmul
from test_torch_graph import carry, rand, signature
from test_torch_quant_model import (
    assert_layers_match,
    assert_qparams_match,
    both,
    calibrate,
    run,
)

torch.set_num_threads(1)


def transformer_cfg(a_observer="MINMAX"):
    return {
        "BACKEND": "virtual",
        "W": {"QSCHEME": "per-channel-symmetric",
              "QUANTIZER": {"TYPE": "uniform", "BIT": 8},
              "OBSERVER": {"TYPE": "MINMAX"}},
        "A": {"QSCHEME": "per-tensor-affine",
              "QUANTIZER": {"TYPE": "uniform", "BIT": 8},
              "OBSERVER": {"TYPE": a_observer, "LAYOUT": "NLC",
                           "PERCENTILE": {"ALPHA": 0.001}},
              "SPECIFIC": [{
                  "*norm*": ["QUANTIZER.DISABLE", "True"],
                  "*softmax*": ["QUANTIZER.DISABLE", "True"],
              }]},
    }


def pair(name):
    """(JAX model, port model with its weights, inputs, calibration
    inputs)."""
    if name == "vit":
        jm = JViT(img_size=16, patch_size=4, dim=48, depth=2, num_heads=2,
                  num_classes=10, key=jax.random.PRNGKey(3)).eval()
        tm = carry(jm, TViT(img_size=16, patch_size=4, dim=48, depth=2,
                            num_heads=2, num_classes=10).eval())
        return jm, tm, rand((4, 16, 16, 3), 1), [rand((4, 16, 16, 3), s)
                                                 for s in (2, 3)]
    jm = j_bert_tiny(key=jax.random.PRNGKey(4)).eval()
    tm = carry(jm, t_bert_tiny().eval())

    def ids(seed):
        return np.random.default_rng(seed).integers(
            0, 1024, size=(4, 12)).astype(np.int32)

    return jm, tm, ids(1), [ids(2), ids(3)]


@pytest.mark.parametrize("name", ["vit", "bert"])
def test_graph_and_float_forward_match_jax(name):
    jm, tm, x, _ = pair(name)
    with torch.no_grad():
        float_out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(float_out, np.asarray(jm(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    jq, tq = both(jm, tm, x, transformer_cfg())
    assert signature(tq.graph) == signature(jq.graph)
    for jn, tn in zip(jq.graph.op_nodes, tq.graph.op_nodes):
        assert type(tn.op).__name__ == type(jn.op).__name__, jn.name
        assert tuple(tn.out_aval.shape) == tuple(jn.out_aval.shape), jn.name
    np.testing.assert_allclose(run(tq, x), float_out, rtol=0, atol=1e-5)
    # the quantized attention: two QMatmuls on 4-D operands, a QIdentity
    # with an input quantizer on each operand edge
    mm = [n for n in tq.graph.op_nodes if isinstance(n.op, QMatmul)]
    assert len(mm) == 2 * 2
    for n in mm:
        assert len(n.out_aval.shape) == 4
        for p in n.input_nodes:
            assert "_identity" in p.name
            assert p.op.input_quantizer is not None


@pytest.mark.parametrize("name,a_observer", [
    ("vit", "MINMAX"), ("bert", "MINMAX"), ("vit", "PERCENTILE"),
    ("bert", "PERCENTILE")])
def test_w8a8_qparams_and_nodes_match_jax(name, a_observer):
    jm, tm, x, calib = pair(name)
    jq, tq = both(jm, tm, x, transformer_cfg(a_observer))
    for q in (jq, tq):
        calibrate(q, calib)
        q.set_quant(True, True)
    assert_qparams_match(jq, tq)
    got, want = run(tq, x), run(jq, x)
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    assert_layers_match(jq, tq, x)
