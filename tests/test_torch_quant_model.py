"""The port's QuantModel (``sparsebit_tpu_torch/quantization``) against the
JAX package's, on the CPU, on seeded numpy inputs with the JAX models'
weights carried across; the cases of tests/test_quant_model.py:

- calibration in the four modes (asym x w_quant x a_quant): every
  quantizer's scale within 1e-6 relative of JAX's (weight scales equal:
  the same weights; activation ranges come from convolutions summed in
  another order, a few ulp), every zero point, enable and fake-fused flag
  equal, and the quantized outputs within 1e-5;
- the rewrite is the identity with quantizers off (atol 1e-4 against the
  float model, as the JAX test), QAdd's QIdentity inputs, FuseBN
  (fused weights within 1e-6 of JAX's, output within 1e-4 of the float
  model), BatchNorm tuning (the tuned, fused weights within 1e-5
  relative: batch statistics are reductions);
- resnet18 at num_classes=16 on 2x64x64x3 through the whole flow, with
  its graph and qparams held to JAX's, and every node, on JAX's inputs
  and qparams, within 1e-5 (relative to its largest output) of JAX's
  (``assert_layers_match`` says why not end to end);
- W/A.SPECIFIC overrides select the same nodes in both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsebit_tpu_torch.nn as tnn
from sparsebit_tpu import QuantModel as JQuantModel
from sparsebit_tpu import parse_qconfig as j_parse
from sparsebit_tpu.models import create_model as j_create_model
from sparsebit_tpu_torch import QuantModel as TQuantModel
from sparsebit_tpu_torch import parse_qconfig as t_parse
from sparsebit_tpu_torch.models import create_model as t_create_model
from sparsebit_tpu_torch.quantization.modules.math import QAdd
from sparsebit_tpu_torch.quantization.modules.normalization import (
    QBatchNorm2d,
)
from sparsebit_tpu_torch.quantization.modules.unary import QIdentity
from test_torch_graph import carry, pair, rand, randomize_bn, signature


def cfg_dict(layout="NHWC", **kw):
    cfg = {
        "BACKEND": "virtual",
        "W": {"QSCHEME": "per-channel-symmetric", "QUANTIZER": {"BIT": 8}},
        "A": {"QSCHEME": "per-tensor-affine", "QUANTIZER": {"BIT": 8},
              "OBSERVER": {"LAYOUT": layout}},
    }
    cfg.update(kw)
    return cfg


def both(jm, tm, x, cfg):
    """QuantModel of each package on the same model and example input."""
    jq = JQuantModel(jm, j_parse(cfg), (jnp.asarray(x),))
    tq = TQuantModel(tm, t_parse(cfg), (torch.from_numpy(x),))
    return jq, tq


def run(q, x):
    if isinstance(q, TQuantModel):
        with torch.no_grad():
            return q(torch.from_numpy(x)).numpy()
    return np.asarray(q(jnp.asarray(x)))


def calibrate(q, xs, *mode):
    q.prepare_calibration()
    for x in xs:
        q(torch.from_numpy(x) if isinstance(q, TQuantModel)
          else jnp.asarray(x))
    q.calc_qparams(*mode)


def qparams(q):
    """{(node, quantizer): (scale, zero point, enabled, fake-fused, bit)},
    the qparams flattened (the weight axis differs between the
    packages)."""
    out = {}
    for name, op in q.qmodules():
        for k in ("input_quantizer", "weight_quantizer"):
            qz = getattr(op, k)
            if qz is not None:
                out[(name, k)] = (
                    np.asarray(qz.scale, np.float32).reshape(-1),
                    np.asarray(qz.zero_point, np.float32).reshape(-1),
                    qz.is_enable, qz.fake_fused, qz.bit)
    return out


def assert_qparams_match(jq, tq, rtol=1e-6):
    jp, tp = qparams(jq), qparams(tq)
    assert list(tp) == list(jp)
    for key, (js, jz, *jflags) in jp.items():
        ts, tz, *tflags = tp[key]
        assert tflags == jflags, key
        np.testing.assert_allclose(ts, js, rtol=rtol, atol=0, err_msg=key)
        if key[1] == "weight_quantizer":
            np.testing.assert_array_equal(ts, js, err_msg=key)
        np.testing.assert_array_equal(tz, jz, err_msg=key)


@pytest.mark.parametrize("asym,w_quant,a_quant", [
    (False, False, False), (True, True, False), (True, False, True),
    (True, True, True)])
def test_calibration_modes_match_jax(asym, w_quant, a_quant):
    jm, tm, shape = pair("resblock")
    x = rand(shape)
    jq, tq = both(jm, tm, x, cfg_dict())
    for q in (jq, tq):
        calibrate(q, [x, rand(shape, seed=9)], asym, w_quant, a_quant)
        q.set_quant(w_quant=True, a_quant=True)
    assert_qparams_match(jq, tq)
    want = run(jq, x)
    got = run(tq, x)
    assert got.shape == (2, 4) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rewrite_is_identity_mhsa():
    jm, tm, shape = pair("mhsa")
    x = rand(shape, seed=5)
    with torch.no_grad():
        float_out = tm(torch.from_numpy(x)).numpy()
    jq, tq = both(jm, tm, x, cfg_dict(layout="NLC"))
    assert signature(tq.graph) == signature(jq.graph)
    np.testing.assert_allclose(run(tq, x), float_out, rtol=0, atol=1e-4)
    np.testing.assert_allclose(run(tq, x), run(jq, x), rtol=0, atol=1e-5)
    # and quantized: the matmuls' QIdentity inputs calibrate alike
    for q in (jq, tq):
        calibrate(q, [x])
        q.set_quant(True, True)
    assert_qparams_match(jq, tq)
    np.testing.assert_allclose(run(tq, x), run(jq, x), rtol=0, atol=1e-5)


def test_qadd_identity_insertion():
    jm, tm, shape = pair("resblock")
    x = rand(shape)
    a = cfg_dict()["A"]
    a["QADD"] = {"ENABLE_QUANT": True}
    jq, tq = both(jm, tm, x, cfg_dict(A=a))
    assert signature(tq.graph) == signature(jq.graph)
    add = [n for n in tq.graph.op_nodes if isinstance(n.op, QAdd)]
    assert len(add) == 1
    assert [type(p.op) for p in add[0].input_nodes] == [QIdentity, QIdentity]
    # disabled by default: no identities inserted
    jq2, tq2 = both(*pair("resblock")[:2], x, cfg_dict())
    assert signature(tq2.graph) == signature(jq2.graph)
    add2 = [n for n in tq2.graph.op_nodes if isinstance(n.op, QAdd)][0]
    assert not any(isinstance(p.op, QIdentity) for p in add2.input_nodes)


def _conv_weights(q):
    """{node: (weight in the JAX package's layout, bias)} of the convs and
    linears."""
    out = {}
    for name, op in q.qmodules():
        w = op.module._parameters.get("weight") if isinstance(
            op.module, tnn.Module) else op.module._params.get("weight")
        if w is None or op.weight_quantizer is None:
            continue
        b = (op.module.bias if isinstance(op.module, tnn.Module)
             else op.module._params.get("bias"))
        w = np.asarray(w.detach() if isinstance(w, torch.Tensor) else w)
        if isinstance(op.module, tnn.Conv2d):
            w = w.transpose(2, 3, 1, 0)
        elif isinstance(op.module, tnn.Linear):
            w = w.T
        b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b)
        out[name] = (w, b)
    return out


def test_fuse_bn_preserves_output():
    jm, tm, shape = pair("resblock")
    x = rand(shape)
    with torch.no_grad():
        float_out = tm(torch.from_numpy(x)).numpy()
    cfg = cfg_dict(SCHEDULE={"FUSE_BN": True, "BN_TUNING": False,
                             "DISABLE_UNNECESSARY_QUANT": True})
    jq, tq = both(jm, tm, x, cfg)
    assert not any(isinstance(n.op, QBatchNorm2d) for n in tq.graph.op_nodes)
    assert signature(tq.graph) == signature(jq.graph)
    jw, tw = _conv_weights(jq), _conv_weights(tq)
    assert list(tw) == list(jw)
    for k in jw:
        np.testing.assert_allclose(tw[k][0], jw[k][0], rtol=1e-6, atol=0)
        np.testing.assert_allclose(tw[k][1], jw[k][1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(run(tq, x), float_out, rtol=0, atol=1e-4)


def test_batchnorm_tuning_matches_jax():
    jm, tm, shape = pair("resblock")
    x = rand(shape)
    jq, tq = both(jm, tm, x, cfg_dict(SCHEDULE={"BN_TUNING": True,
                                                "FUSE_BN": True}))
    # BN_TUNING defers the fusion: the BN nodes are still there
    assert any(isinstance(n.op, QBatchNorm2d) for n in tq.graph.op_nodes)
    assert signature(tq.graph) == signature(jq.graph)
    for q in (jq, tq):
        calibrate(q, [x])
    before = tq.get_qmodule("bn1").module.running_mean.clone()
    for q in (jq, tq):
        with q.batchnorm_tuning():
            for seed in range(3):
                if isinstance(q, TQuantModel):
                    q(torch.from_numpy(rand(shape, seed)))
                else:
                    q(jnp.asarray(rand(shape, seed)))
    # the statistics moved, BN is fused away, quantization is off again
    assert not torch.equal(tm.bn1.running_mean, before)
    assert not any(isinstance(n.op, QBatchNorm2d) for n in tq.graph.op_nodes)
    assert signature(tq.graph) == signature(jq.graph)
    jw, tw = _conv_weights(jq), _conv_weights(tq)
    for k in jw:
        np.testing.assert_allclose(tw[k][0], jw[k][0], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tw[k][1], jw[k][1], rtol=1e-5, atol=1e-6)
    assert_qparams_match(jq, tq, rtol=1e-5)
    np.testing.assert_allclose(run(tq, x), run(jq, x), rtol=0, atol=1e-5)


def test_resnet18_flow_matches_jax():
    """test_imagenet_zoo_ptq_flow's rule on resnet18: the rewrite exact
    with quantizers off, w8a8 within (0, 5e-2) relative MSE, and every
    step held to JAX's."""
    jm = randomize_bn(j_create_model("resnet18", num_classes=16).eval())
    tm = carry(jm, t_create_model("resnet18", num_classes=16,
                                  device="cpu").eval())
    x = rand((2, 64, 64, 3), seed=3)
    with torch.no_grad():
        float_out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(float_out, np.asarray(jm(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    jq, tq = both(jm, tm, x, cfg_dict())
    assert signature(tq.graph) == signature(jq.graph)
    np.testing.assert_allclose(run(tq, x), float_out, rtol=0, atol=1e-4)
    for q in (jq, tq):
        calibrate(q, [x])
        q.set_quant(True, True)
    assert_qparams_match(jq, tq)
    got = run(tq, x)
    rel = np.mean((got - float_out) ** 2) / (np.mean(float_out ** 2) + 1e-12)
    assert 0 < rel < 5e-2
    assert_layers_match(jq, tq, x)


def _jax_activations(jq, x):
    """Every node's output of the JAX QuantModel, run op by op as its
    calibration runs it."""
    from sparsebit_tpu.nn.graph import Output, Placeholder, SymbolicTensor

    env, params = {}, jq.params()

    def value(a):
        if isinstance(a, SymbolicTensor):
            v = env[a.node.name]
            return v if a.index is None else v[a.index]
        return a

    for n in jq.graph.nodes:
        if isinstance(n.op, Placeholder):
            env[n.name] = jnp.asarray(x)
        elif not isinstance(n.op, Output):
            env[n.name] = n.op.execute(*[value(a) for a in n.args],
                                       params=params.get(n.name), **n.kwargs)
    return env


def assert_layers_match(jq, tq, x):
    """Node by node on JAX's inputs, with JAX's qparams: every output
    within 1e-5 of JAX's, relative to the node's largest output.

    End to end the quantized outputs of the two packages drift apart
    through deep graphs: the float activations differ by an ulp or so
    (convolutions summed in other orders), and where x / scale lies that
    close to k + 1/2 the two packages round to neighbouring codes, and the
    flipped code spreads through the next layers (resnet18: 1.7 % of
    layer1.0.conv2's outputs, 0.002 at the logits). Given the same inputs
    and the same qparams, every node must agree."""
    from sparsebit_tpu_torch.nn.graph import SymbolicTensor

    for name, op in tq.qmodules():
        jop = jq.get_qmodule(name)
        for k in ("input_quantizer", "weight_quantizer"):
            tqz, jqz = getattr(op, k), getattr(jop, k)
            if tqz is not None:
                tqz.scale = torch.from_numpy(np.array(jqz.scale)).reshape(
                    tqz.scale.shape)
                tqz.zero_point = torch.from_numpy(
                    np.array(jqz.zero_point)).reshape(tqz.zero_point.shape)
    env = _jax_activations(jq, x)

    def value(a):
        if isinstance(a, SymbolicTensor):
            v = env[a.node.name]
            v = v if a.index is None else v[a.index]
            return torch.from_numpy(np.array(v))
        return a

    with torch.no_grad():
        for n in tq.graph.op_nodes:
            got = n.op.execute(*[value(a) for a in n.args], **n.kwargs)
            want = np.asarray(env[n.name])
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=1e-5 * max(1.0, float(np.abs(want).max())),
                err_msg=n.name)


def test_specific_overrides_select_same_nodes():
    jm = j_create_model("resnet20").eval()
    tm = carry(jm, t_create_model("resnet20", device="cpu").eval())
    x = rand((2, 16, 16, 3), seed=2)
    cfg = cfg_dict()
    cfg["W"]["SPECIFIC"] = [{"layer2.*": ["QUANTIZER.BIT", 4],
                             "conv1": ["QSCHEME", "per-channel-affine"]}]
    cfg["A"]["SPECIFIC"] = [{"layer3.?.conv2": ["QUANTIZER.BIT", 6]}]
    jq, tq = both(jm, tm, x, cfg)
    tp = qparams(tq)
    assert {k: v[2:] for k, v in tp.items()} == {
        k: v[2:] for k, v in qparams(jq).items()}
    bits = {k: v[4] for k, v in tp.items()}
    assert bits[("layer2.0.conv1", "weight_quantizer")] == 4
    assert bits[("layer3.1.conv2", "input_quantizer")] == 6
    assert bits[("layer3.1.conv2", "weight_quantizer")] == 8
    assert not tq.get_qmodule("conv1").weight_quantizer.is_symmetric


def test_params_api_and_next_slice_stubs(tmp_path):
    """The params API; the error profiler and export, stubs until this
    slice, now answer (their parity is in test_torch_errors_profiler.py
    and test_torch_export.py)."""
    jm, tm, shape = pair("resblock")
    x = rand(shape)
    jq, tq = both(jm, tm, x, cfg_dict())
    for q in (jq, tq):
        calibrate(q, [x])
        q.set_quant(True, True)
    params = tq.params()
    assert {k: set(v) for k, v in params.items()} == {
        k: set(v) for k, v in jq.params().items()}
    assert set(params["conv1"]) == {
        "weight", "bias", "input_quantizer.scale",
        "input_quantizer.zero_point", "weight_quantizer.scale",
        "weight_quantizer.zero_point"}
    out = run(tq, x)
    # apply() with the collected state reproduces the call
    with torch.no_grad():
        np.testing.assert_array_equal(
            tq.apply(params, torch.from_numpy(x)).numpy(), out)
    assert "graph TD" in tq.dump_mermaid()
    assert "QConv2d" in tq.print_tabular()
    err = tq.get_quantization_error(torch.from_numpy(x))
    assert set(err) == set(jq.get_quantization_error(jnp.asarray(x)))
    assert all(v >= 0 for v in err.values())
    tq.export(str(tmp_path), torch.from_numpy(x))
    assert sorted(os.listdir(tmp_path)) == [
        "model.pt2", "quant_meta.json", "quant_params.npz"]
