"""The port's QAT step (``sparsebit_tpu_torch/quantization/tools/qat.py``)
against the JAX package's, on the CPU, with the JAX model's weights
carried across (``nn.load_jax_state_dict``):

- the cases of tests/test_qat.py on the port: LSQ, DoReFa weights with
  PACT activations, LSQ+; 30 Adam steps lower the loss by 10 % and a
  quantizer learnable moves;
- three steps through JAX's ``make_qat_step`` (optax.adam, jitted) and
  the port's (``torch.optim.Adam``) from the same weights and qparams
  (JAX's, carried into the port), LSQ and LSQ+: each step's loss within
  1e-5 relative, and every trainable after the steps within 1e-5
  relative or 1e-3 lr a step. The one exception is LSQ+'s activation
  zero points: their gradients are sums of a few out-of-range terms,
  1e-8 to 1e-6, the size of Adam's eps, where the jitted reference's
  last-place differences move each update by up to lr; they are held
  within lr a step, and their rounded values (what the forward reads)
  equal. PACT and DoReFa are left out of this comparison: under jit the
  reference's PACT scale, a division by a constant, becomes a multiply
  by its reciprocal (a code flips, the loss moves by 7e-4 from the first
  step), and DoReFa's tanh differs in the last place between the
  packages (the loss moves by 1e-4);
- ``commit_qat_params`` writes numpy values into the model's tensors,
  which stay the leaves the optimiser trains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparsebit_tpu.nn as jnn
import sparsebit_tpu_torch.nn as tnn
from sparsebit_tpu import QuantModel as JQuantModel
from sparsebit_tpu import parse_qconfig as j_parse
from sparsebit_tpu.quantization.tools import qat as JQAT
from sparsebit_tpu_torch import QuantModel as TQuantModel
from sparsebit_tpu_torch import parse_qconfig as t_parse
from sparsebit_tpu_torch.quantization.tools.qat import (
    commit_qat_params,
    cross_entropy,
    init_qat_state,
    make_qat_step,
    qat_parameters,
)
from test_torch_graph import carry

torch.set_num_threads(1)


class JTinyNet(jnn.Module):
    """tests/test_qat.py's TinyNet."""

    def __init__(self):
        super().__init__()
        ks = jax.random.split(jax.random.PRNGKey(0), 2)
        self.conv = jnn.Conv2d(3, 8, 3, padding=1, key=ks[0])
        self.relu = jnn.ReLU()
        self.pool = jnn.AdaptiveAvgPool2d(1)
        self.flat = jnn.Flatten()
        self.fc = jnn.Linear(8, 4, key=ks[1])

    def forward(self, x):
        return self.fc(self.flat(self.pool(self.relu(self.conv(x)))))


class TTinyNet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2d(3, 8, 3, padding=1)
        self.relu = tnn.ReLU()
        self.pool = tnn.AdaptiveAvgPool2d(1)
        self.flat = tnn.Flatten()
        self.fc = tnn.Linear(8, 4)

    def forward(self, x):
        return self.fc(self.flat(self.pool(self.relu(self.conv(x)))))


def qat_cfg(qtype):
    """tests/test_qat.py's config: PACT's alpha 1.0 so that the clip bites
    on the tiny net's activations; DoReFa weights pair with PACT
    activations, and "pact" is PACT activations over uniform weights."""
    return {
        "BACKEND": "virtual",
        "W": {"QSCHEME": "per-channel-symmetric",
              "QUANTIZER": {"TYPE": qtype if qtype != "pact" else "uniform",
                            "BIT": 4}},
        "A": {"QSCHEME": "per-tensor-affine",
              "QUANTIZER": {"TYPE": qtype if qtype != "dorefa" else "pact",
                            "BIT": 4, "PACT": {"ALPHA_VALUE": 1.0}},
              "OBSERVER": {"LAYOUT": "NHWC"}},
    }


def data():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=16)
    return x, y


def models(qtype):
    """(JAX QuantModel, port QuantModel), both through init_QAT on the same
    weights and batch."""
    x, _ = data()
    jm = JTinyNet().eval()
    tm = carry(jm, TTinyNet().eval())
    jq = JQuantModel(jm, j_parse(qat_cfg(qtype)), (jnp.asarray(x),))
    tq = TQuantModel(tm, t_parse(qat_cfg(qtype)), (torch.from_numpy(x),))
    jq.prepare_calibration()
    jq(jnp.asarray(x))
    jq.init_QAT()
    tq.prepare_calibration()
    tq(torch.from_numpy(x))
    tq.init_QAT()
    jq.train()
    tq.train()
    return jq, tq


def to_port(value, like, key):
    """A JAX package's array in the layout of the port's tensor ``like``:
    conv weights HWIO -> OIHW, linear (in, out) -> (out, in), per-channel
    qparams reshaped (the channel order is the same)."""
    v = np.asarray(value)
    if tuple(v.shape) == tuple(like.shape):
        return v
    if key == "weight":
        return v.transpose((3, 2, 0, 1) if v.ndim == 4 else (1, 0))
    return v.reshape(like.shape)


def port_tree(jtree, tq):
    cur = tq.trainable_params()
    return {n: {k: to_port(v, cur[n][k], k) for k, v in p.items()}
            for n, p in jtree.items()}


@pytest.mark.parametrize("qtype", ["lsq", "dorefa", "lsq+"])
def test_qat_trains(qtype):
    """tests/test_qat.py on the port: the loss falls by 10 % in 30 steps
    and a quantizer learnable moves (LSQ: the scales; DoReFa with PACT:
    alpha; LSQ+: scale and zero point)."""
    x, y = data()
    _, tq = models(qtype)
    trainable, opt = init_qat_state(
        tq, lambda ps: torch.optim.Adam(ps, lr=5e-3))
    step = make_qat_step(tq, cross_entropy, opt)
    quant = {(n, k): v.detach().clone() for n, p in trainable.items()
             for k, v in p.items() if "quantizer" in k}
    assert quant, "{} exposed no learnable quantizer params".format(qtype)
    if qtype == "lsq":
        assert any(k.endswith("quantizer.scale") for _, k in quant)
    losses = []
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(30):
        trainable, loss = step(trainable, xt, yt)
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.9, losses[::10]
    assert any(not torch.equal(v, trainable[n][k].detach())
               for (n, k), v in quant.items())


@pytest.mark.parametrize("qtype", ["lsq", "lsq+"])
def test_qat_steps_match_jax(qtype):
    x, y = data()
    jq, tq = models(qtype)
    lr = 5e-3
    opt = optax.adam(lr)
    jstep = JQAT.make_qat_step(jq, JQAT.cross_entropy, opt)
    jtrain, jstate = JQAT.init_qat_state(jq, opt)
    # the JAX package's weights and qparams in the port, then its step
    commit_qat_params(tq, port_tree(jtrain, tq))
    ttrain, topt = init_qat_state(tq, lambda ps: torch.optim.Adam(ps, lr=lr))
    assert sorted((n, k) for n, p in ttrain.items() for k in p) == sorted(
        (n, k) for n, p in jtrain.items() for k in p)
    tstep = make_qat_step(tq, cross_entropy, topt)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        jtrain, jstate, jloss = jstep(jtrain, jstate, jnp.asarray(x),
                                      jnp.asarray(y))
        ttrain, tloss = tstep(ttrain, xt, yt)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    want = port_tree(jtrain, tq)
    for n, p in ttrain.items():
        for k, v in p.items():
            got = v.detach().numpy()
            if k == "input_quantizer.zero_point":
                np.testing.assert_allclose(got, want[n][k], rtol=0,
                                           atol=3 * lr, err_msg=(n, k))
                np.testing.assert_array_equal(np.round(got),
                                              np.round(want[n][k]))
                continue
            np.testing.assert_allclose(got, want[n][k], rtol=1e-5,
                                       atol=3 * 1e-3 * lr, err_msg=(n, k))


def test_commit_qat_params_round_trip():
    """Values committed from numpy land in the model's own tensors: the
    same leaves, still trainable, read by the graph."""
    x, y = data()
    _, tq = models("lsq")
    before = tq.trainable_params()
    leaves = {(n, k): v for n, p in before.items() for k, v in p.items()}
    rng = np.random.default_rng(9)
    new = {n: {k: (v.detach().numpy() * (1 + 0.1 * rng.random(v.shape)))
               .astype(np.float32) for k, v in p.items()}
           for n, p in before.items()}
    commit_qat_params(tq, new)
    after = tq.trainable_params()
    for n, p in after.items():
        for k, v in p.items():
            assert v is leaves[(n, k)], (n, k)
            np.testing.assert_array_equal(v.detach().numpy(), new[n][k])
    params = qat_parameters(after)
    assert params and all(t.requires_grad and t.is_leaf for t in params)
    with torch.no_grad():
        np.testing.assert_array_equal(
            tq(torch.from_numpy(x)).numpy(),
            tq.apply(tq.params(), torch.from_numpy(x)).numpy())
    trainable, opt = init_qat_state(
        tq, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    scale = trainable["conv"]["weight_quantizer.scale"].detach().clone()
    make_qat_step(tq, cross_entropy, opt)(
        trainable, torch.from_numpy(x), torch.from_numpy(y))
    assert not torch.equal(scale, trainable["conv"]["weight_quantizer.scale"])
