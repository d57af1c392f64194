"""The port's INT8 deploy pass (``quantization/deploy.py``) on the CPU:

- tests/test_deploy.py's cases on the port: integer compute equal to the
  fake-quant forward within rtol/atol 2e-5 (f32 rounding only: the same
  math on another arithmetic path) with the QuantModel left as it was,
  for unsigned (per-tensor affine, shifted by -128) and signed
  (per-tensor symmetric) activation schemes and a grouped convolution;
  the deployed weights int8 buffers; an attention block with its Linears
  in int8 beside fake-quant matmuls and float softmax (relative error
  < 5e-3, as the JAX test);
- the port's deploy against the JAX package's on carried weights and
  qparams: the int8 weight matrices and correction terms equal (the JAX
  package's HWIO codes flattened in the im2col's order), the outputs
  within rtol/atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsebit_tpu.nn as jnn
import sparsebit_tpu_torch.nn as tnn
from sparsebit_tpu import QuantModel as JQuantModel
from sparsebit_tpu import parse_qconfig as j_parse
from sparsebit_tpu.quantization.deploy import deploy as j_deploy
from sparsebit_tpu_torch import QuantModel as TQuantModel
from sparsebit_tpu_torch import parse_qconfig as t_parse
from sparsebit_tpu_torch.quantization.deploy import (
    Int8Conv2d,
    Int8Linear,
    deploy,
)
from test_torch_graph import carry, rand

torch.set_num_threads(1)


class JNet(jnn.Module):
    """tests/test_deploy.py's Net."""

    def __init__(self, key):
        super().__init__()
        ks = jax.random.split(key, 3)
        self.conv1 = jnn.Conv2d(3, 16, 3, padding=1, key=ks[0])
        self.relu = jnn.ReLU()
        self.conv2 = jnn.Conv2d(16, 16, 3, stride=2, padding=1, key=ks[1])
        self.relu2 = jnn.ReLU()
        self.pool = jnn.AdaptiveAvgPool2d(1)
        self.flat = jnn.Flatten()
        self.fc = jnn.Linear(16, 10, key=ks[2])

    def forward(self, x):
        y = self.relu(self.conv1(x))
        y = self.relu2(self.conv2(y))
        return self.fc(self.flat(self.pool(y)))


class TNet(tnn.Module):
    def __init__(self, groups=1, generator=None):
        super().__init__()
        kw = dict(generator=generator)
        self.conv1 = tnn.Conv2d(3, 16, 3, padding=1, **kw)
        self.relu = tnn.ReLU()
        self.conv2 = tnn.Conv2d(16, 16, 3, stride=2, padding=1,
                                groups=groups, **kw)
        self.relu2 = tnn.ReLU()
        self.pool = tnn.AdaptiveAvgPool2d(1)
        self.flat = tnn.Flatten()
        self.fc = tnn.Linear(16, 10, **kw)

    def forward(self, x):
        y = self.relu(self.conv1(x))
        y = self.relu2(self.conv2(y))
        return self.fc(self.flat(self.pool(y)))


def cfg(a_scheme="per-tensor-affine", layout="NHWC"):
    return {"BACKEND": "tpu",
            "W": {"QSCHEME": "per-channel-symmetric",
                  "QUANTIZER": {"BIT": 8}},
            "A": {"QSCHEME": a_scheme, "QUANTIZER": {"BIT": 8},
                  "OBSERVER": {"LAYOUT": layout}}}


def calibrated(model, x, config):
    q = TQuantModel(model, t_parse(config), (x,))
    q.prepare_calibration()
    q(x)
    q.calc_qparams()
    q.set_quant(w_quant=True, a_quant=True)
    return q


@pytest.mark.parametrize("a_scheme,groups", [
    ("per-tensor-affine", 1), ("per-tensor-symmetric", 1),
    ("per-tensor-affine", 4)])
def test_deploy_matches_fake_quant(a_scheme, groups):
    x = torch.from_numpy(rand((4, 16, 16, 3)))
    model = TNet(groups, torch.Generator().manual_seed(1)).eval()
    q = calibrated(model, x, cfg(a_scheme))
    with torch.no_grad():
        fq = q(x)
    dm = deploy(q)
    out = dm(x)
    np.testing.assert_allclose(out.numpy(), fq.numpy(), rtol=2e-5,
                               atol=2e-5)
    # the QuantModel itself is untouched
    with torch.no_grad():
        assert torch.equal(q(x), fq)


def test_deploy_integer_path_really_int8():
    x = torch.from_numpy(rand((2, 8, 8, 3)))
    q = calibrated(TNet(generator=torch.Generator().manual_seed(1)).eval(),
                   x, cfg())
    dm = deploy(q)
    ops = [n.op for n in dm.graph.op_nodes
           if isinstance(n.op, (Int8Conv2d, Int8Linear))]
    assert len(ops) == 3
    assert all(op.wq.dtype == torch.int8 for op in ops)
    assert all(op.corr.dtype == torch.int32 for op in ops)


def test_deploy_transformer_block():
    """Linears go int8, matmul and softmax stay fake-quant and float."""
    from sparsebit_tpu_torch.models.vit import Attention

    x = torch.from_numpy(rand((2, 16, 64), seed=3))
    attn = Attention(64, num_heads=4,
                     generator=torch.Generator().manual_seed(4)).eval()
    q = calibrated(attn, x, cfg(layout="NLC"))
    with torch.no_grad():
        fq = q(x)
    out = deploy(q)(x)
    rel = float((out - fq).norm() / fq.norm())
    assert rel < 5e-3, rel
    n_int8 = sum(isinstance(n.op, Int8Linear)
                 for n in deploy(q).graph.op_nodes)
    assert n_int8 == 2  # qkv and proj


def test_deploy_matches_jax_deploy():
    x = rand((4, 16, 16, 3))
    jm = JNet(jax.random.PRNGKey(1)).eval()
    tm = carry(jm, TNet().eval())
    jq = JQuantModel(jm, j_parse(cfg()), (jnp.asarray(x),))
    jq.prepare_calibration()
    jq(jnp.asarray(x))
    jq.calc_qparams()
    jq.set_quant(w_quant=True, a_quant=True)
    tq = calibrated(tm, torch.from_numpy(x), cfg())
    # the JAX package's qparams in the port (its scales within 1e-6)
    for name, op in tq.qmodules():
        jop = jq.get_qmodule(name)
        for k in ("input_quantizer", "weight_quantizer"):
            t, j = getattr(op, k), getattr(jop, k)
            if t is not None:
                np.testing.assert_allclose(
                    t.scale.numpy().reshape(-1), np.asarray(j.scale).reshape(
                        -1), rtol=1e-6)
                t.scale = torch.from_numpy(np.array(j.scale)).reshape(
                    t.scale.shape)
                t.zero_point = torch.from_numpy(np.array(
                    j.zero_point)).reshape(t.zero_point.shape)
    jd, td = j_deploy(jq), deploy(tq)
    for jn, tn in zip(jd.graph.op_nodes, td.graph.op_nodes):
        assert jn.name == tn.name
        assert type(jn.op).__name__ == type(tn.op).__name__
        if isinstance(tn.op, (Int8Conv2d, Int8Linear)):
            jw = np.asarray(jn.op._buffers["wq"])
            np.testing.assert_array_equal(tn.op.wq.numpy(),
                                          jw.reshape(-1, jw.shape[-1]))
            np.testing.assert_array_equal(tn.op.corr.numpy(),
                                          np.asarray(jn.op._buffers["corr"]))
            assert tn.op.in_zp == int(jn.op.in_zp)
    np.testing.assert_allclose(td(torch.from_numpy(x)).numpy(),
                               np.asarray(jd(jnp.asarray(x))), rtol=2e-5,
                               atol=2e-5)
