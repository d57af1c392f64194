"""The port's BEVDet-lite (``models/bevdet.py``) against the JAX
package's, on the CPU, with the JAX model's weights carried across
(``nn.load_jax_state_dict``; BatchNorm randomised), at
tests/test_bevdet.py's size: 4 cameras at 32 x 48, 6 classes.

- ``cell_ids`` bit-equal to JAX's (carried without a transpose);
- the lift-splat view transform within 1e-5 of the dense per-point
  oracle and of JAX's segment-sum, bit-equal on a second call; its
  backward gives each point its cell's gradient (0 in the drop cell);
- the model's maps within 1e-4 of JAX's, the traced graph equal to
  JAX's node by node, ``view_transform`` one unconverted float node,
  quantizers off within 1e-5 of float, the 8-bit heatmap's relative MSE
  in JAX's bound (0, 1e-3);
- the QAT CLI's ``centerpoint_loss`` equal to JAX's on the same maps,
  and LSQ 4-bit QAT steps (torch.optim.Adam) lowering it, as
  tests/test_bevdet.py's steps do;
- fault R14, pinned on the JAX side: the JAX CLI calls ``calc_qparams``
  and then ``init_QAT``, whose own ``calc_qparams`` finds the
  calibration gone and asserts.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu import QuantModel as JQuantModel
from sparsebit_tpu import parse_qconfig as j_parse
from sparsebit_tpu.models import create_model as j_create_model
from sparsebit_tpu.models.bevdet import LSSViewTransform as JLSS
from sparsebit_tpu_torch import QuantModel, parse_qconfig
from sparsebit_tpu_torch.models import create_model as t_create_model
from sparsebit_tpu_torch.models.bevdet import LSSViewTransform as TLSS
from sparsebit_tpu_torch.quantization.modules.base import QuantOpr
from test_torch_graph import carry, pair, rand, randomize_bn, signature
from test_torch_quant_model import both, calibrate, cfg_dict

torch.set_num_threads(1)

N_CAMS = 4
EXAMPLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
    "quantization_aware_training", "nuscenes_bevdet")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        "bevdet_" + name, os.path.join(EXAMPLE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(bit=8, qtype="uniform"):
    q = {"TYPE": qtype, "BIT": bit}
    return {"BACKEND": "virtual",
            "W": {"QSCHEME": "per-channel-symmetric", "QUANTIZER": dict(q),
                  "OBSERVER": {"TYPE": "MINMAX", "LAYOUT": "NHWC"}},
            "A": {"QSCHEME": "per-tensor-affine", "QUANTIZER": dict(q),
                  "OBSERVER": {"TYPE": "MINMAX", "LAYOUT": "NHWC"}}}


def test_cell_ids_bit_equal_jax():
    for args in ((2, (4, 6), 4, 3, (8, 8)), (4, (8, 12), 16, 32, (32, 32))):
        j, t = JLSS(*args), TLSS(*args, device="cpu")
        assert t.cell_ids.dtype == torch.int32
        np.testing.assert_array_equal(t.cell_ids.numpy(),
                                      np.asarray(j.cell_ids))


def _oracle(x, ids, B, D, C, G):
    """Explicit per-point accumulation (tests/test_bevdet.py's)."""
    depth = np.asarray(jax.nn.softmax(jnp.asarray(x[..., :D]), -1))
    feat = depth[..., :, None] * x[..., D:][..., None, :]
    flat = feat.reshape(B, -1, C)
    ref = np.zeros((B, G + 1, C), np.float32)
    for b in range(B):
        for p, cid in enumerate(ids):
            ref[b, cid] += flat[b, p]
    return ref[:, :-1]


def test_lss_pooling_matches_oracle_and_jax():
    D, C, Hb, Wb = 4, 3, 8, 8
    j = JLSS(2, (4, 6), D, C, (Hb, Wb))
    t = TLSS(2, (4, 6), D, C, (Hb, Wb), device="cpu")
    x = rand((2 * 2, 4, 6, D + C), seed=1)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t(xt)
    assert tuple(out.shape) == (2, Hb, Wb, C)
    assert torch.equal(t(xt), out)
    ids = t.cell_ids.numpy()
    ref = _oracle(x, ids, 2, D, C, Hb * Wb).reshape(2, Hb, Wb, C)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(jax.jit(lambda v: j(v))(jnp.asarray(x)))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    # backward of the pooling alone: each point takes its cell's gradient
    from sparsebit_tpu_torch.models.bevdet import lss_pool

    flat = torch.from_numpy(rand((2, ids.size, C), seed=2)).requires_grad_()
    g = torch.from_numpy(rand((2, Hb * Wb, C), seed=3))
    (lss_pool(flat, t.cell_ids, Hb * Wb) * g).sum().backward()
    gpad = torch.cat([g, torch.zeros(2, 1, C)], 1)
    assert torch.equal(flat.grad, gpad[:, torch.from_numpy(ids).long()])


def _bevdet_pair():
    kw = dict(n_cams=N_CAMS, num_classes=6, img_hw=(32, 48))
    jm = randomize_bn(j_create_model("bevdet_lite", **kw).eval())
    return jm, carry(jm, t_create_model("bevdet_lite", device="cpu",
                                        **kw).eval())


def test_bevdet_matches_jax_and_quant_flow():
    jm, tm = _bevdet_pair()
    np.testing.assert_array_equal(tm.view_transform.cell_ids.numpy(),
                                  np.asarray(jm.view_transform.cell_ids))
    x = rand((2 * N_CAMS, 32, 48, 3), seed=2)
    want = [np.asarray(m) for m in jax.jit(lambda v: jm(v))(jnp.asarray(x))]
    with torch.no_grad():
        got = [m.numpy() for m in tm(torch.from_numpy(x))]
    assert [g.shape for g in got] == [(2, 32, 32, 6), (2, 32, 32, 8)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    jq, tq = both(jm, tm, x, _cfg(8))
    assert signature(tq.graph) == signature(jq.graph)
    lss = [n for n in tq.graph.op_nodes if n.name == "view_transform"]
    assert len(lss) == 1 and lss[0].op is tm.view_transform
    assert not isinstance(lss[0].op, QuantOpr)
    with torch.no_grad():
        off = [m.numpy() for m in tq(torch.from_numpy(x))]
    for o, g in zip(off, got):
        np.testing.assert_allclose(o, g, rtol=0, atol=1e-5)
    calibrate(tq, [x])
    tq.set_quant(True, True)
    with torch.no_grad():
        hm_q = tq(torch.from_numpy(x))[0].numpy()
    rel = np.mean((hm_q - got[0]) ** 2) / np.mean(got[0] ** 2)
    assert 0 < rel < 1e-3, rel


def test_centerpoint_loss_matches_jax():
    j_loss = _example("main").centerpoint_loss
    t_loss = _example("main_torch").centerpoint_loss
    rng = np.random.default_rng(0)
    hm = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    box = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    hm_t = (rng.random(hm.shape) > 0.9).astype(np.float32)
    hm_t = np.maximum(hm_t, rng.random(hm.shape).astype(np.float32) * 0.5)
    box_t = rng.normal(size=box.shape).astype(np.float32)
    want = float(jax.jit(j_loss)((hm, box), (hm_t, box_t)))
    got = float(t_loss((torch.from_numpy(hm), torch.from_numpy(box)),
                       (torch.from_numpy(hm_t), torch.from_numpy(box_t))))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bevdet_qat_steps_decrease_loss():
    from sparsebit_tpu_torch.quantization.tools.qat import (
        init_qat_state, make_qat_step)

    loss_fn = _example("main_torch").centerpoint_loss
    tm = t_create_model("bevdet_lite", n_cams=N_CAMS, num_classes=6,
                        img_hw=(32, 48), device="cpu").eval()
    x = torch.from_numpy(rand((2 * N_CAMS, 32, 48, 3), seed=0))
    qm = QuantModel(tm, parse_qconfig(_cfg(4, "lsq")), (x,))
    qm.prepare_calibration()
    qm(x)
    qm.init_QAT()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        hm_q, box_q = qm(x)
    targets = (torch.from_numpy((rng.random(hm_q.shape) > 0.97).astype(
        np.float32)), torch.from_numpy(rng.normal(size=box_q.shape).astype(
            np.float32)))
    trainable, opt = init_qat_state(
        qm, lambda ps: torch.optim.Adam(ps, lr=5e-3))
    step = make_qat_step(qm, loss_fn, opt)
    qm.train()
    losses = [step(trainable, x, targets)[1].item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_r14_jax_cli_calibrates_twice():
    with open(os.path.join(EXAMPLE, "main.py")) as f:
        src = f.read()
    calc = src.index("qmodel.calc_qparams()")
    assert src.index("qmodel.init_QAT()", calc) > calc
    jm, _, shape = pair("resblock")
    x = rand(shape)
    jq = JQuantModel(jm, j_parse(cfg_dict()), (jnp.asarray(x),))
    jq.prepare_calibration()
    jq(jnp.asarray(x))
    jq.calc_qparams()
    with pytest.raises(AssertionError, match="prepare_calibration"):
        jq.init_QAT()
