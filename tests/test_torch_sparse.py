"""The port's pruning regime (``sparsebit_tpu_torch/sparse``) against the
JAX package's, on the CPU, on seeded inputs with the JAX models' weights
carried across (``nn.load_jax_state_dict``) and the JAX masks transposed
to the port's layouts (OIHW, (out, in)):

- ``parse_sconfig`` gives the same tree and refuses the same configs;
- every sparser's structured and unstructured masks on identical weights
  (l1norm, l2norm, slimming with a BatchNorm gamma and without, ratio 0,
  the ``n_prune >= n`` clamp); structured masks may differ only at a
  channel whose score lies within 1e-6 relative of the threshold (the
  per-channel sums run in another order over OIHW than over HWIO), and
  such a tie is named;
- the quantile helper equal to ``numpy.quantile(..., method="linear")``,
  also above 2^24 elements, where ``torch.quantile`` refuses;
- ``SparseModel`` on tests/test_sparse.py's SmallNet, on resnet20 and on
  bert_tiny: the same nodes left dense by the residual rule and by
  SPECIFIC, the masks per node, the BatchNorm channel masks, and the
  masked outputs within 1e-5;
- the random sparser's fraction and repeatability, the params round
  trip with masks, ``+=`` lowering to the Add the residual rule reads;
- a masked SGD step: no gradient reaches a mask and the pruned weights
  stay zero in effect; reference fault R11 pinned on the JAX side.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparsebit_tpu_torch.nn as tnn
from sparsebit_tpu.models import create_model as j_create_model
from sparsebit_tpu.sparse import SparseModel as JSparseModel
from sparsebit_tpu.sparse import parse_sconfig as j_parse
from sparsebit_tpu.sparse.sparsers import build_sparser as j_build_sparser
from sparsebit_tpu_torch import SparseModel as TSparseModel
from sparsebit_tpu_torch import parse_sconfig as t_parse
from sparsebit_tpu_torch.models import create_model as t_create_model
from sparsebit_tpu_torch.nn import functional as TF
from sparsebit_tpu_torch.sparse.sparsers import build_sparser as t_build_sparser
from sparsebit_tpu_torch.sparse.sparsers.base import quantile_linear
from test_sparse import SmallNet as JSmallNet
from test_torch_graph import carry, rand, randomize_bn

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "pruning")
SCONFIGS = ["structured_cifar10", "unstructured_cifar10",
            "structured_imagenet1k", "unstructured_bert", "unstructured_squad"]


class TSmallNet(tnn.Module):
    """tests/test_sparse.py's SmallNet on the port."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 16, 3, padding=1)
        self.bn1 = tnn.BatchNorm2d(16)
        self.relu = tnn.ReLU()
        self.conv2 = tnn.Conv2d(16, 16, 3, padding=1)
        self.bn2 = tnn.BatchNorm2d(16)
        self.pool = tnn.AdaptiveAvgPool2d(1)
        self.flat = tnn.Flatten()
        self.fc = tnn.Linear(16, 10)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = y + self.relu(self.bn2(self.conv2(y)))  # residual
        return self.fc(self.flat(self.pool(y)))


def sconfig(strategy, ratio, stype="l1norm", specific=None):
    return {"SPARSER": {"TYPE": stype, "STRATEGY": strategy, "RATIO": ratio,
                        "SPECIFIC": specific or []}}


def both_sparse(jm, tm, x, strategy, ratio, stype="l1norm", specific=None):
    """SparseModel of each package on the same model and example input."""
    cfg = sconfig(strategy, ratio, stype, specific)
    js = JSparseModel(jm, j_parse(cfg), (jnp.asarray(x),))
    ts = TSparseModel(tm, t_parse(cfg), (torch.from_numpy(x),))
    return js, ts


def _port_layout(mask):
    """A JAX mask in the port's weight layout."""
    m = np.asarray(mask)
    if m.ndim == 4:
        return m.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if m.ndim == 2:
        return m.T  # (in, out) -> (out, in)
    return m


def _ties(sparser, weight, got, want):
    """Channels whose structured masks differ, each held to lie within 1e-6
    relative of the threshold."""
    scores = sparser.channel_scores(weight.detach(), 0)
    n = scores.numel()
    thresh = torch.sort(scores).values[min(int(n * sparser.ratio), n - 1)]
    differ = np.nonzero((got != want).reshape(n, -1).any(1))[0]
    for c in differ:
        assert abs(float(scores[c] - thresh)) <= 1e-6 * abs(float(thresh)), (
            "channel {} differs away from the threshold".format(c))
    return list(differ)


def assert_sparse_match(js, ts, x, atol=1e-5):
    """Same SModules, dense nodes and sparser types; calc_params in both;
    masks per node equal (structured ties as the module docstring says,
    named on stdout, and the JAX masks then carried into the port);
    masked outputs within ``atol`` relative to the largest output.
    Returns the number of nodes with a zero in their mask."""
    jmods, tmods = dict(js.smodules()), dict(ts.smodules())
    assert list(tmods) == list(jmods)
    for name, top in tmods.items():
        jop = jmods[name]
        assert type(top).__name__ == type(jop).__name__, name
        if top.HAS_WEIGHT:
            assert top.sparser.TYPE == jop.sparser.TYPE, name
            assert top.sparser.ratio == jop.sparser.ratio, name
    js.calc_params()
    ts.calc_params()
    structured = ts.cfg.SPARSER.STRATEGY == "structure"
    masked, ties = 0, {}
    for name, top in tmods.items():
        jop = jmods[name]
        for k in ("w_mask", "b_mask", "ch_mask"):
            want = jop._buffers.get(k)
            got = getattr(top, k, None)
            if want is None:
                assert got is None, (name, k)
                continue
            want = _port_layout(want)
            got = got.numpy()
            assert got.shape == want.shape, (name, k)
            if not np.array_equal(got, want):
                assert structured and k == "w_mask", (name, k)
                ties[name] = _ties(top.sparser, top.module.weight, got,
                                   want)
            if k == "w_mask":
                masked += int((want == 0).any())
    if ties:
        print("structured ties at the threshold (node: channels): {}"
              .format(ties))
        for name in ties:
            jop, top = jmods[name], tmods[name]
            top.load_leaf_state_dict({
                k: torch.from_numpy(_port_layout(jop._buffers[k]))
                for k in ("w_mask", "b_mask") if jop._buffers.get(k)
                is not None})
        for name, top in tmods.items():
            if "ch_mask" in top._buffers:
                top.ch_mask = torch.from_numpy(
                    np.asarray(jmods[name]._buffers["ch_mask"]))
    want = js(jnp.asarray(x))
    with torch.no_grad():
        got = ts(torch.from_numpy(x))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=atol * max(1.0, np.abs(w).max()))
    return masked


# ---- the config tree --------------------------------------------------------


def _plain(cfg):
    return {k: _plain(v) if isinstance(v, dict) else v
            for k, v in cfg.items()}


@pytest.mark.parametrize("name", SCONFIGS)
def test_parse_sconfig_matches_jax(name, monkeypatch):
    """Each example sconfig, the port reading it without PyYAML."""
    path = os.path.join(EXAMPLES, name, "sconfig.yaml")
    want = _plain(j_parse(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert _plain(t_parse(path)) == want


@pytest.mark.parametrize("bad", [
    {"SPARSER": {"STRATEGY": "structured"}}, {"SPARSER": {"RATIO": 1.0}},
    {"SPARSER": {"RATIO": -0.1}}])
def test_parse_sconfig_refuses_what_jax_refuses(bad):
    with pytest.raises(AssertionError):
        j_parse(bad)
    with pytest.raises(AssertionError):
        t_parse(bad)


# ---- the sparsers -----------------------------------------------------------


def _sparsers(stype, strategy, ratio):
    cfg = sconfig(strategy, ratio, stype)
    return j_build_sparser(j_parse(cfg)), t_build_sparser(t_parse(cfg))


@pytest.mark.parametrize("strategy", ["structure", "unstructure"])
@pytest.mark.parametrize("stype,ratio", [
    ("l1norm", 0.5), ("l1norm", 0.0), ("l1norm", 1.0), ("l2norm", 0.3),
    ("slimming", 0.5), ("slimming_bn", 0.5), ("slimming_bn", 0.7)])
def test_sparser_masks_match_jax(stype, ratio, strategy):
    """On a conv (24 out channels) and a linear (10 outputs): ratio 1.0 is
    the clamp (set past the config's [0, 1) check, n_prune = n - 1)."""
    rng = np.random.default_rng(7)
    for w in (rng.normal(size=(3, 3, 8, 24)), rng.normal(size=(40, 10))):
        w = w.astype(np.float32)
        ch_axis = w.ndim - 1
        js, ts = _sparsers(stype.split("_")[0], strategy, min(ratio, 0.5))
        js.ratio = ts.ratio = ratio
        if stype == "slimming_bn":
            gamma = rng.uniform(0.2, 1.5, w.shape[-1]).astype(np.float32)
            js.set_bn_weight(jnp.asarray(gamma))
            ts.set_bn_weight(torch.from_numpy(gamma))
        jmask, jch = js.calc_mask(jnp.asarray(w), ch_axis)
        tw = torch.from_numpy(np.ascontiguousarray(_port_layout(w)))
        tmask, tch = ts.calc_mask(tw, 0)
        assert tmask.dtype == tw.dtype and tmask.shape == tw.shape
        got, want = tmask.numpy(), _port_layout(jmask)
        if strategy == "unstructure" or stype == "slimming_bn":
            np.testing.assert_array_equal(got, want)
        elif not np.array_equal(got, want):
            print("structured tie at the threshold: channels",
                  _ties(ts, tw, got, want))
        if strategy == "structure":
            n = w.shape[-1]
            kept = n - min(int(n * ratio), n - 1)
            assert int(tch.sum()) == kept  # no tie among random scores
            np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))
        else:
            assert tch is None and jch is None


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 2 ** 24 + 3])
def test_quantile_linear_matches_numpy(n):
    x = np.abs(np.random.default_rng(n).normal(size=n)).astype(np.float32)
    if n == 1000:
        x = np.round(x, 1)  # ties
    t = torch.from_numpy(x)
    qs = (0.0, 0.2, 0.35, 0.5, 0.7, 0.999) if n < 2 ** 24 else (0.2, 0.7)
    for q in qs:
        want = np.quantile(x, q, method="linear")
        got = quantile_linear(t, q)
        assert got.dtype == torch.float32
        assert got.item() == want, (n, q)


# ---- SparseModel against JAX ------------------------------------------------


def small_pair():
    jm = randomize_bn(JSmallNet(jax.random.PRNGKey(0)).eval())
    return jm, carry(jm, TSmallNet().eval())


@pytest.mark.parametrize("model", ["smallnet", "resnet20"])
@pytest.mark.parametrize("strategy,ratio", [("structure", 0.5),
                                            ("unstructure", 0.6)])
def test_sparse_model_matches_jax(model, strategy, ratio):
    if model == "smallnet":
        jm, tm = small_pair()
        x = rand((2, 8, 8, 3), seed=1)
    else:
        jm = randomize_bn(j_create_model("resnet20").eval())
        tm = carry(jm, t_create_model("resnet20", device="cpu").eval())
        x = rand((2, 32, 32, 3), seed=1)
    js, ts = both_sparse(jm, tm, x, strategy, ratio)
    dense = {n for n, op in ts.smodules()
             if op.HAS_WEIGHT and op.sparser.ratio == 0.0}
    assert dense == {n for n, op in js.smodules()
                     if op.HAS_WEIGHT and op.sparser.ratio == 0.0}
    if strategy == "structure":
        # every conv feeds an add, directly or through the skip: only the
        # classifier and (resnet20) each block's first conv are pruned
        pruned = {n for n, op in ts.smodules() if op.HAS_WEIGHT} - dense
        if model == "smallnet":
            assert pruned == {"fc"}
        else:
            assert pruned == {"fc"} | {"layer{}.{}.conv1".format(s, b)
                                       for s in (1, 2, 3) for b in range(3)}
    else:
        assert not dense
    assert assert_sparse_match(js, ts, x) > 0
    np.testing.assert_allclose(ts.sparsity(), js.sparsity(), rtol=0,
                               atol=1e-12)
    if strategy == "structure" and model == "resnet20":
        # a pruned channel is an exact zero in its BatchNorm's output
        bn = dict(ts.smodules())["layer1.0.bn1"]
        with torch.no_grad():
            out = bn.execute(torch.randn(2, 4, 4, 16))
        assert bool((out[..., bn.ch_mask == 0] == 0).all())
        assert int((bn.ch_mask == 0).sum()) == 8


def test_specific_overrides_and_slimming_match_jax():
    """tests/test_sparse.py's slimming + SPECIFIC case: fc on l2norm at
    0.2, the rest on slimming (the following BatchNorm's gamma)."""
    jm, tm = small_pair()
    x = rand((2, 8, 8, 3), seed=1)
    spec = [{"fc": ["TYPE", "l2norm", "RATIO", "0.2"],
             "conv*": ["RATIO", "0.25"]}]
    js, ts = both_sparse(jm, tm, x, "unstructure", 0.5, "slimming", spec)
    fc = dict(ts.smodules())["fc"]
    assert fc.sparser.TYPE == "l2norm" and fc.sparser.ratio == 0.2
    assert dict(ts.smodules())["conv2"].sparser.ratio == 0.25
    assert_sparse_match(js, ts, x)
    js, ts = both_sparse(jm, tm, x, "structure", 0.5, "slimming", spec)
    assert_sparse_match(js, ts, x)


def test_unstructured_bert_tiny_matches_jax():
    """tests/test_sparse.py's BERT case: encoder linears at 0.7,
    embeddings and the classifier dense through SPECIFIC."""
    jm = j_create_model("bert_tiny").eval()
    tm = carry(jm, t_create_model("bert_tiny", device="cpu").eval())
    ids = np.random.default_rng(1).integers(0, 1024, (2, 16)).astype(
        np.int32)
    spec = [{"*embed*": ["RATIO", "0.0"], "*classifier*": ["RATIO", "0.0"]}]
    js, ts = both_sparse(jm, tm, ids, "unstructure", 0.7, specific=spec)
    assert_sparse_match(js, ts, ids)
    seen = 0
    for name, op in ts.smodules():
        if "classifier" in name:
            assert bool((op.w_mask == 1).all())
        else:
            # within one element of 0.7 n, scores equal to the threshold
            # (kept) aside
            scores = op.module.weight.detach().abs()
            at = int((scores == quantile_linear(scores, 0.7)).sum())
            pruned = int((op.w_mask == 0).sum())
            assert abs(pruned - 0.7 * scores.numel()) <= 1 + at, name
            seen += 1
    assert seen == 2 * 6 + 1  # q, k, v, out, ffn in, ffn out; pooler


def test_iadd_lowers_to_the_add_the_residual_rule_reads():
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = tnn.Conv2d(3, 8, 1)
            self.conv2 = tnn.Conv2d(8, 8, 1)
            self.conv3 = tnn.Conv2d(8, 8, 1)

        def forward(self, x):
            y = self.conv1(x)
            y += self.conv2(y)
            return self.conv3(y)

    ts = TSparseModel(Net().eval(), t_parse(sconfig("structure", 0.5)),
                      (torch.randn(1, 4, 4, 3),))
    assert [type(n.op) for n in ts.graph.op_nodes].count(TF.Add) == 1
    ratios = {n: op.sparser.ratio for n, op in ts.smodules()}
    assert ratios == {"conv1": 0.0, "conv2": 0.0, "conv3": 0.5}


# ---- the port's own behaviour -----------------------------------------------


def test_random_sparser_fraction_and_repeatability():
    def masks():
        tm = t_create_model("resnet20", device="cpu").eval()
        ts = TSparseModel(tm, t_parse(sconfig("unstructure", 0.4, "random")),
                          (torch.randn(2, 16, 16, 3),))
        ts.calc_params()
        return ts, {n: op.w_mask.clone() for n, op in ts.smodules()
                    if op.HAS_WEIGHT}

    ts, a = masks()
    _, b = masks()
    assert list(a) == list(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n
        frac = float((a[n] == 0).float().mean())
        assert abs(frac - 0.4) <= 1.0 / a[n].numel() + 1e-9, (n, frac)
    assert abs(ts.sparsity() - 0.4) < 0.01
    ts2 = TSparseModel(t_create_model("resnet20", device="cpu").eval(),
                       t_parse(sconfig("structure", 0.5, "random")),
                       (torch.randn(2, 16, 16, 3),))
    ts2.calc_params()
    conv = dict(ts2.smodules())["layer2.0.conv1"]
    assert int((conv.w_mask.reshape(32, -1)[:, 0] == 0).sum()) == 16


def test_params_round_trip_with_masks():
    jm, tm = small_pair()
    x = rand((2, 8, 8, 3), seed=1)
    js, ts = both_sparse(jm, tm, x, "unstructure", 0.5)
    ts.calc_params()
    params = ts.params()
    assert {k: set(v) for k, v in params.items()} == {
        k: set(v) for k, v in js.params().items()}
    assert set(params["conv1"]) == {"weight", "bias", "w_mask", "b_mask"}
    assert set(params["bn1"]) >= {"ch_mask", "running_mean"}
    with torch.no_grad():
        out = ts(torch.from_numpy(x))
        np.testing.assert_array_equal(
            ts.apply(params, torch.from_numpy(x)).numpy(), out.numpy())
        # a mask in params overrides the buffer, as in the JAX package
        dense = {n: dict(p, w_mask=torch.ones_like(p["w_mask"]))
                 if "w_mask" in p else p for n, p in params.items()}
        assert not torch.equal(ts.apply(dense, torch.from_numpy(x)), out)
    saved = {n: {k: v.clone() for k, v in p.items()}
             for n, p in params.items()}
    fresh = TSparseModel(carry(jm, TSmallNet().eval()),
                         t_parse(sconfig("unstructure", 0.5)),
                         (torch.from_numpy(x),))
    fresh.load_params(saved)
    assert fresh.sparsity() == ts.sparsity()
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(x)).numpy(),
                                      out.numpy())


def test_masked_sgd_step_keeps_pruned_weights_zero():
    """The structured_imagenet1k CLI's finetune on resnet20: the masks are
    buffers, outside the optimizer; the pruned weights take no gradient
    and stay zero in effect; a step moves the kept weights."""
    torch.manual_seed(0)
    tm = t_create_model("resnet20", device="cpu")
    x = torch.randn(4, 16, 16, 3)
    ts = TSparseModel(tm.eval(), t_parse(sconfig("structure", 0.5)), (x,))
    ts.calc_params()
    masks = {n: op.w_mask.clone() for n, op in ts.smodules() if op.HAS_WEIGHT}
    params = list(tm.parameters())
    assert not any(op.w_mask is p for _, op in ts.smodules()
                   if op.HAS_WEIGHT for p in params)
    opt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    ts.train()
    for _ in range(2):
        loss = torch.nn.functional.cross_entropy(ts(x), torch.arange(4))
        opt.zero_grad()
        loss.backward()
        opt.step()
    conv = dict(ts.smodules())["layer1.0.conv1"]
    assert bool((conv.module.weight.grad[masks["layer1.0.conv1"] == 0]
                 == 0).all())
    for n, op in ts.smodules():
        if op.HAS_WEIGHT:
            assert op.w_mask.grad is None and not op.w_mask.requires_grad
            assert torch.equal(op.w_mask, masks[n]), n
            eff = op.module.weight * op.w_mask
            assert bool((eff[masks[n] == 0] == 0).all()), n
    assert float((conv.module.weight * conv.w_mask).detach().abs().sum()) > 0


def test_r11_adamw_decays_the_jax_masks():
    """Reference fault R11: examples/pruning/unstructured_squad/main.py
    finetunes the masks' params-pytree leaves under optax.adamw(lr), whose
    default weight decay of 1e-4 (mask None) decays every leaf; freezing
    the masks' gradients does not stop it, so a kept mask entry shrinks by
    lr * 1e-4 a step and the masks leave {0, 1}. The port's masks are
    buffers that no optimizer holds."""
    jm, tm = small_pair()
    x = rand((2, 8, 8, 3), seed=1)
    js, ts = both_sparse(jm, tm, x, "unstructure", 0.5)
    js.calc_params()
    params = js.params()
    opt = optax.adamw(3e-4)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(jnp.zeros_like, params)  # freeze_masks
    updates, _ = opt.update(grads, state, params)
    w_mask = np.asarray(optax.apply_updates(params, updates)["conv1"][
        "w_mask"])
    kept = w_mask[w_mask > 0]
    np.testing.assert_allclose(kept, 1 - 3e-4 * 1e-4, rtol=1e-7)
    assert not np.isin(w_mask, (0.0, 1.0)).all()
    ts.calc_params()
    opt_t = torch.optim.AdamW(tm.parameters(), lr=3e-4, weight_decay=1e-4)
    loss = ts(torch.from_numpy(x)).square().mean()
    loss.backward()
    opt_t.step()
    for _, op in ts.smodules():
        if op.HAS_WEIGHT:
            assert bool(((op.w_mask == 0) | (op.w_mask == 1)).all())
