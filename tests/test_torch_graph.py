"""The port's graph tracer and module zoo (``sparsebit_tpu_torch/nn``)
against the JAX package's, on the CPU, with the JAX models' weights
carried across (``nn.load_jax_state_dict``):

- the traced graphs of the residual CNN and the attention block of
  tests/test_quant_model.py: the same ops in the same order, every node
  under the same name (module nodes by their dotted path), the same
  input edges;
- ``Graph.run`` equal to the eager model, bit for bit, also on a clone;
  the port's forward within 1e-5 of JAX's (convolutions and products
  summed in other orders);
- ``SKIP_TRACE_MODULES`` making a container one opaque node;
- BatchNorm's training update (biased variance) against JAX's, within
  1e-6 relative (the mean and variance are reductions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsebit_tpu.nn as jnn
import sparsebit_tpu_torch.nn as tnn
from sparsebit_tpu.nn import functional as JF
from sparsebit_tpu.nn.graph import Tracer as JTracer
from sparsebit_tpu_torch.nn import functional as TF
from sparsebit_tpu_torch.nn.graph import Tracer as TTracer


# ---- the models of tests/test_quant_model.py, in both packages -------------


class JResBlockNet(jnn.Module):
    """conv-bn-relu, a residual add, pool and fc (test_quant_model.py:33)."""

    def __init__(self):
        super().__init__()
        ks = jax.random.split(jax.random.PRNGKey(7), 4)
        self.conv1 = jnn.Conv2d(3, 8, 3, padding=1, key=ks[0])
        self.bn1 = jnn.BatchNorm2d(8)
        self.relu = jnn.ReLU()
        self.conv2 = jnn.Conv2d(8, 8, 3, padding=1, key=ks[1])
        self.bn2 = jnn.BatchNorm2d(8)
        self.pool = jnn.AdaptiveAvgPool2d(1)
        self.flatten = jnn.Flatten()
        self.fc = jnn.Linear(8, 4, key=ks[2])

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        z = self.bn2(self.conv2(y)) + y
        return self.fc(self.flatten(self.pool(z)))


class TResBlockNet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 8, 3, padding=1)
        self.bn1 = tnn.BatchNorm2d(8)
        self.relu = tnn.ReLU()
        self.conv2 = tnn.Conv2d(8, 8, 3, padding=1)
        self.bn2 = tnn.BatchNorm2d(8)
        self.pool = tnn.AdaptiveAvgPool2d(1)
        self.flatten = tnn.Flatten()
        self.fc = tnn.Linear(8, 4)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        z = self.bn2(self.conv2(y)) + y
        return self.fc(self.flatten(self.pool(z)))


class JMHSA(jnn.Module):
    """The attention block of test_quant_model.py:86."""

    def __init__(self, dim=16, heads=2):
        super().__init__()
        ks = jax.random.split(jax.random.PRNGKey(3), 2)
        self.dim, self.heads = dim, heads
        self.qkv = jnn.Linear(dim, dim * 3, key=ks[0])
        self.softmax = jnn.Softmax(dim=-1)
        self.proj = jnn.Linear(dim, dim, key=ks[1])

    def forward(self, x):
        b, l, d = x.shape[0], x.shape[1], self.dim
        h = self.heads
        qkv = JF.permute(JF.reshape(self.qkv(x), (b, l, 3, h, d // h)),
                         (2, 0, 3, 1, 4))
        q, k, v = JF.getitem(qkv, 0), JF.getitem(qkv, 1), JF.getitem(qkv, 2)
        attn = self.softmax(
            JF.matmul(q, JF.transpose(k, -2, -1)) * (1.0 / (d // h) ** 0.5))
        out = JF.reshape(JF.transpose(JF.matmul(attn, v), 1, 2), (b, l, d))
        return self.proj(out)


class TMHSA(tnn.Module):
    """The same block on the port, written as PyTorch code: ``x.shape``
    reads, the port's helpers and a Python ``*``."""

    def __init__(self, dim=16, heads=2):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = tnn.Linear(dim, dim * 3)
        self.softmax = tnn.Softmax(dim=-1)
        self.proj = tnn.Linear(dim, dim)

    def forward(self, x):
        b, l, d = x.shape[0], x.shape[1], self.dim
        h = self.heads
        qkv = TF.permute(TF.reshape(self.qkv(x), (b, l, 3, h, d // h)),
                         (2, 0, 3, 1, 4))
        q, k, v = TF.getitem(qkv, 0), TF.getitem(qkv, 1), TF.getitem(qkv, 2)
        attn = self.softmax(
            TF.matmul(q, TF.transpose(k, -2, -1)) * (1.0 / (d // h) ** 0.5))
        out = TF.reshape(TF.transpose(TF.matmul(attn, v), 1, 2), (b, l, d))
        return self.proj(out)


def randomize_bn(jmodel, seed=11):
    """Non-trivial BatchNorm state (the defaults make BN the identity)."""
    rng = np.random.default_rng(seed)
    for _, m in jmodel.named_modules():
        if isinstance(m, jnn.BatchNorm2d):
            c = m.num_features
            m.load_state_dict({
                "weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.2, c).astype(np.float32),
                "running_mean": rng.normal(0, 0.2, c).astype(np.float32),
                "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32)})
    return jmodel


def carry(jmodel, tmodel):
    """The JAX model's weights into the port's model (numpy in between)."""
    sd = {k: np.asarray(v) for k, v in jmodel.full_state_dict().items()}
    tnn.load_jax_state_dict(tmodel, sd)
    return tmodel


def pair(name):
    if name == "resblock":
        j = randomize_bn(JResBlockNet().eval())
        return j, carry(j, TResBlockNet().eval()), (2, 8, 8, 3)
    j = JMHSA().eval()
    return j, carry(j, TMHSA().eval()), (2, 6, 16)


def rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def signature(graph):
    """(name, op class, input names) of every node, in order."""
    return [(n.name, type(n.op).__name__, [p.name for p in n.input_nodes])
            for n in graph.nodes]


@pytest.mark.parametrize("name", ["resblock", "mhsa"])
def test_traced_graph_matches_jax(name):
    jm, tm, shape = pair(name)
    x = rand(shape)
    jg = JTracer().trace(jm, (jnp.asarray(x),))
    tg = TTracer().trace(tm, (torch.from_numpy(x),))
    assert signature(tg) == signature(jg)
    # the ops' static arguments too (shapes folded from x.shape, dims)
    for jn, tn in zip(jg.op_nodes, tg.op_nodes):
        assert tn.kwargs == {k: tuple(v) if isinstance(v, list) else v
                             for k, v in jn.kwargs.items()}, jn.name
        assert tuple(tn.out_aval.shape) == tuple(jn.out_aval.shape)


@pytest.mark.parametrize("name", ["resblock", "mhsa"])
def test_graph_run_matches_eager_and_jax(name):
    jm, tm, shape = pair(name)
    x = rand(shape, seed=1)
    xt = torch.from_numpy(x)
    tg = TTracer().trace(tm, (xt,))
    with torch.no_grad():
        eager = tm(xt)
        assert torch.equal(tg.run(None, xt), eager)
        assert torch.equal(tg.clone().run(None, xt), eager)
        # replacements through params reach the op
        fc = "fc" if name == "resblock" else "proj"
        p = {fc: {"bias": tm.get_submodule(fc).bias + 1.0}}
        assert torch.allclose(tg.run(p, xt), eager + 1.0, atol=1e-6)
    want = np.asarray(jm(jnp.asarray(x)))
    np.testing.assert_allclose(eager.numpy(), want, rtol=0, atol=1e-5)


def test_params_round_trip_and_functional_lowering():
    """collect_params / load_params keep {node: {name: tensor}}; PyTorch
    spellings of the same ops (operator +, torch.cat, Tensor.view,
    F.relu, torch.flatten) lower to the JAX package's op-modules."""
    import torch.nn.functional as F

    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv = tnn.Conv2d(3, 4, 1)
            self.fc = tnn.Linear(5, 2)

        def forward(self, x):
            y = F.relu(self.conv(x))
            z = torch.cat([y, x[..., :1] * 2.0], dim=-1)
            z = z.view(z.shape[0], 4, -1).mean(dim=1)
            return self.fc(torch.flatten(z, 1))

    net = Net().eval()
    x = torch.from_numpy(rand((2, 2, 2, 3), seed=4))
    g = TTracer().trace(net, (x,))
    kinds = [type(n.op).__name__ for n in g.op_nodes]
    assert kinds == ["Conv2d", "ReLU", "GetItem", "Mul", "Concat", "Reshape",
                     "Mean", "Reshape", "Linear"], kinds
    with torch.no_grad():
        assert torch.equal(g.run(None, x), net(x))
    params = g.collect_params()
    assert set(params) == {"conv", "fc"}
    assert set(params["conv"]) == {"weight", "bias"}
    g.load_params({"fc": {"bias": torch.zeros(2)}})
    assert torch.equal(net.fc.bias.detach(), torch.zeros(2))


def test_skip_trace_modules_one_opaque_node():
    class Block(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv = tnn.Conv2d(4, 4, 3, padding=1)
            self.relu = tnn.ReLU()

        def forward(self, x):
            return self.relu(self.conv(x)) + x

    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.stem = tnn.Conv2d(3, 4, 1)
            self.block = Block()
            self.pool = tnn.AdaptiveAvgPool2d(1)

        def forward(self, x):
            return self.pool(self.block(self.stem(x)))

    net = Net().eval()
    x = torch.from_numpy(rand((2, 4, 4, 3), seed=2))
    traced = TTracer().trace(net, (x,))
    assert [n.name for n in traced.op_nodes] == [
        "stem", "block.conv", "block.relu", "add", "pool"]
    skipped = TTracer(["bl*"]).trace(net, (x,))
    assert [n.name for n in skipped.op_nodes] == ["stem", "block", "pool"]
    assert skipped.find_node("block").op is net.block
    with torch.no_grad():
        assert torch.equal(skipped.run(None, x), net(x))


def test_batchnorm_training_update_matches_jax():
    """The running statistics take the biased variance (jnp.var), unlike
    torch.nn.BatchNorm2d; evaluation is (x - mean) * rsqrt(var + eps) *
    weight + bias."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 5, 5, 6)) * 3 + 1).astype(np.float32)
    jbn, tbn = jnn.BatchNorm2d(6, momentum=0.3), tnn.BatchNorm2d(6,
                                                                 momentum=0.3)
    want = jbn.execute(jnp.asarray(x), training=True)
    got = tbn.execute(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(),
                                   np.asarray(jbn._buffers[k]), rtol=1e-6)
    var = x.reshape(-1, 6).var(axis=0)  # biased
    np.testing.assert_allclose(tbn.running_var.numpy(), 0.7 + 0.3 * var,
                               rtol=1e-5)
    x2 = torch.from_numpy(rng.normal(size=(2, 3, 3, 6)).astype(np.float32))
    np.testing.assert_allclose(
        tbn.execute(x2).detach().numpy(),
        np.asarray(jbn.execute(jnp.asarray(x2.numpy()))), rtol=0, atol=1e-6)
