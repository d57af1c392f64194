"""The port's graph-regime bottom layer (``sparsebit_tpu_torch/
quantization`` and ``utils``) against the JAX package's, on the CPU, on
the same seeded numpy inputs:

- ``fake_quant``'s forward bit for bit, per tensor, per channel (NCHW and
  out-channel weights) and group-wise, with round-half-even ties; its
  three gradients against ``jax.vjp``: gx elementwise, bit for bit; gs and
  gzp, sums over the broadcast elements, within the f32 bound of a sum of
  n terms in any order, n * 2^-24 * sum |term| (``_sum_bound``);
- ``grad_scale``, ``round_ste``, ``floor_ste``, ``quantize`` and
  ``dequantize``;
- each ported observer's qparams (minmax, mse, percentile,
  moving_average) per tensor and per channel, features in NCHW, NHWC and
  NLC and out-channel weights, over two observed batches, as
  tests/test_observers.py builds them: equal for minmax and percentile;
  mse within 1e-6 (its grid search takes the first of the least losses,
  and the losses are sums taken in another order); the EMA within 1e-6
  (XLA's CPU backend contracts the reference's ratio * m + (1 - ratio) *
  s into a fused multiply-add inside lax.scan, one rounding fewer than
  the products as written, which the port computes);
- each ported quantizer (uniform, lsq, lsq+, pact, dorefa) after
  calibration: qparams within 1e-6 (LSQ's and LSQ+'s means and std,
  DoReFa's tanh, are reductions or libm functions); from the same qparams
  the forward bit for bit, gx elementwise bit for bit (DoReFa's within
  the last places of tanh'), and the gradients of scale, zero point or
  alpha within the sum bound, as
  tests/test_fake_quant.py and tests/test_qat.py exercise them;
- ``parse_qconfig`` on a dict and on a yaml file (equal trees, equal to
  the JAX package's), the verify checks, QuantDescriptor's axes, and the
  registries as the JAX package's (aciq, kl_histogram and adaround
  build; kl_device is no observer type in either package)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.quantization import fake_quant as JF
from sparsebit_tpu.quantization.common import QuantTarget as JTarget
from sparsebit_tpu.quantization.observers import build_observer as j_observer
from sparsebit_tpu.quantization.quant_config import parse_qconfig as j_parse
from sparsebit_tpu.quantization.quant_descriptor import QuantDescriptor as JD
from sparsebit_tpu.quantization.quantizers import build_quantizer as j_quant
from sparsebit_tpu.utils.config import CfgNode as JCfg
from sparsebit_tpu_torch.quantization import fake_quant as TF
from sparsebit_tpu_torch.quantization.common import QuantTarget as TTarget
from sparsebit_tpu_torch.quantization.observers import (
    build_observer as t_observer,
)
from sparsebit_tpu_torch.quantization.quant_config import (
    parse_qconfig as t_parse,
)
from sparsebit_tpu_torch.quantization.quant_descriptor import (
    QuantDescriptor as TD,
)
from sparsebit_tpu_torch.quantization.quantizers import (
    build_quantizer as t_quant,
)
from sparsebit_tpu_torch.utils.config import CfgNode as TCfg


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


def _sum_bound(n, abs_sum):
    """|a - b| of two f32 sums of the same n terms in different orders:
    each is within n * 2^-24 * sum |term| of the exact sum."""
    return 2 * n * 2.0 ** -24 * abs_sum + 1e-30


# ---- fake_quant ----------------------------------------------------------

FQ_CASES = {
    # x shape, scale / zero-point shape, (qmin, qmax)
    "per-tensor": ((6, 32), (), (-128, 127)),
    "per-channel-nchw": ((2, 4, 3, 5), (1, 4, 1, 1), (0, 15)),
    "per-channel-weight": ((8, 20), (8, 1), (-8, 7)),
    "group-wise": ((4, 3, 16), (4, 3, 1), (0, 15)),
}


def _fq_inputs(name):
    shape, sshape, (qmin, qmax) = FQ_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    s = (rng.uniform(0.02, 0.2, sshape)).astype(np.float32)
    zp = (rng.integers(qmin, qmax + 1, sshape)
          + rng.uniform(-0.4, 0.4, sshape)).astype(np.float32)
    # exact ties k + 0.5 of x / s, which both packages round to even
    flat = x.reshape(-1)
    sb = np.broadcast_to(s, shape).reshape(-1)
    flat[:6] = (np.arange(6) - 2.5) * sb[:6]
    gy = rng.standard_normal(shape).astype(np.float32)
    return x, s, zp, qmin, qmax, gy


@pytest.mark.parametrize("name", sorted(FQ_CASES))
def test_fake_quant_forward_and_grads_match_jax(name):
    x, s, zp, qmin, qmax, gy = _fq_inputs(name)
    want, vjp = jax.vjp(lambda a, b, c: JF.fake_quant(a, b, c, qmin, qmax),
                        jnp.asarray(x), jnp.asarray(s), jnp.asarray(zp))
    jgx, jgs, jgz = vjp(jnp.asarray(gy))
    xt, st, zt = _t(x, True), _t(s, True), _t(zp, True)
    got = TF.fake_quant(xt, st, zt, qmin, qmax)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(_t(gy))
    assert np.array_equal(xt.grad.numpy(), np.asarray(jgx))
    assert xt.grad.shape == x.shape and st.grad.shape == s.shape
    # the elementwise terms: the same gradients with full-shape qparams
    sf = _t(np.broadcast_to(s, x.shape), True)
    zf = _t(np.broadcast_to(zp, x.shape), True)
    TF.fake_quant(_t(x), sf, zf, qmin, qmax).backward(_t(gy))
    n = x.size // max(s.size, 1)
    for g, j, terms in ((st.grad, jgs, sf.grad), (zt.grad, jgz, zf.grad)):
        abs_sum = TF._reduce_to_shape(terms.abs(), s.shape).numpy()
        err = np.abs(g.numpy() - np.asarray(j))
        assert np.all(err <= _sum_bound(n, abs_sum)), (name, err.max())
        ref = TF._reduce_to_shape(terms.double(), s.shape).numpy()
        assert np.allclose(g.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_grad_scale_and_ste_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(64) * 3).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 2.0]
    for tf, jf, slope in ((lambda v: TF.grad_scale(v, 0.25),
                           lambda v: JF.grad_scale(v, 0.25), 0.25),
                          (TF.round_ste, JF.round_ste, 1.0),
                          (TF.floor_ste, JF.floor_ste, 1.0)):
        xt = _t(x, True)
        got = tf(xt)
        want, jgrad = jax.value_and_grad(lambda v: jnp.sum(jf(v) * 3.0))(
            jnp.asarray(x))
        assert np.array_equal(got.detach().numpy(), np.asarray(jf(x)))
        (got * 3.0).sum().backward()
        assert np.array_equal(xt.grad.numpy(), np.asarray(jgrad))
        assert np.allclose(xt.grad.numpy(), 3.0 * slope)
    assert np.array_equal(TF.round_ste(_t(x)).numpy(), np.round(x))


def test_quantize_dequantize_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(96).astype(np.float32) * 3
    for s, zp, lo, hi in ((0.02, 0.0, -128, 127), (0.05, 7.4, 0, 15)):
        q = TF.quantize(_t(x), _t(s), _t(zp), lo, hi)
        jq = JF.quantize(jnp.asarray(x), jnp.asarray(s, jnp.float32),
                         jnp.asarray(zp, jnp.float32), lo, hi)
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                        np.asarray(jq))
        dq = TF.dequantize(q, _t(s), _t(zp))
        jdq = JF.dequantize(jq, jnp.asarray(s, jnp.float32),
                            jnp.asarray(zp, jnp.float32))
        assert np.array_equal(dq.numpy(), np.asarray(jdq))


# ---- observers -------------------------------------------------------------

def _cfg(cls, target, qscheme, observer="minmax", qtype="uniform", bit=8,
         layout="NCHW", alpha=0.001, ema=0.9, pact_alpha=10.0):
    cfg = cls({
        "TARGET": [target], "QSCHEME": qscheme,
        "QUANTIZER": {"TYPE": qtype, "BIT": bit, "GROUPSIZE": -1,
                      "PACT": {"ALPHA_VALUE": pact_alpha}},
        "OBSERVER": {"TYPE": observer, "PERCENTILE": {"ALPHA": alpha},
                     "MOVING_AVERAGE": {"EMA_RATIO": ema},
                     "ACIQ": {"DISTRIBUTION": "GAUS"}},
    })
    if target.name == "FEATURE":
        cfg.OBSERVER.LAYOUT = layout
    return cfg


def _both(target, qscheme, **kw):
    jc = _cfg(JCfg, getattr(JTarget, target), qscheme, **kw)
    tc = _cfg(TCfg, getattr(TTarget, target), qscheme, **kw)
    return jc, tc


FEATURE_SHAPES = {"NCHW": (2, 4, 3, 5), "NHWC": (2, 3, 5, 4),
                  "NLC": (2, 6, 4)}
OBS_CASES = (
    [(obs, "FEATURE", scheme, layout)
     for obs in ("minmax", "mse", "percentile")
     for scheme in ("per-tensor-affine", "per-channel-symmetric")
     for layout in FEATURE_SHAPES]
    + [(obs, "WEIGHT", scheme, None)
       for obs in ("minmax", "mse", "percentile")
       for scheme in ("per-channel-affine", "per-tensor-symmetric")]
    + [("moving_average", "FEATURE", "per-tensor-affine", layout)
       for layout in FEATURE_SHAPES])


@pytest.mark.parametrize("obs,target,scheme,layout", OBS_CASES,
                         ids=lambda v: str(v))
def test_observer_qparams_match_jax(obs, target, scheme, layout):
    rng = np.random.default_rng(len(obs) * 7 + len(scheme))
    shape = FEATURE_SHAPES[layout] if layout else (6, 40)
    batches = [(rng.standard_normal(shape) * rng.uniform(0.5, 3)
                + 0.3).astype(np.float32) for _ in range(2)]
    batches[1][..., 0] *= 8.0  # an outlier channel / tail
    jc, tc = _both(target, scheme, observer=obs, layout=layout or "NCHW",
                   alpha=0.05)
    jo, to = j_observer(jc, JD(jc)), t_observer(tc, TD(tc))
    for b in batches:
        jo.update(jnp.asarray(b))
        to.update(torch.from_numpy(b))
    js, jz = jo.calc_qparams()
    ts, tz = to.calc_qparams()
    assert tuple(ts.shape) == tuple(np.shape(js))
    if obs in ("mse", "moving_average"):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1.0)
        if obs == "moving_average":
            np.testing.assert_allclose(np.asarray(to.max_val),
                                       np.asarray(jo.max_val), rtol=1e-6)
    else:
        assert np.array_equal(ts.numpy(), np.asarray(js))
        assert np.array_equal(tz.numpy(), np.asarray(jz))
    if obs not in ("mse", "moving_average"):
        assert np.array_equal(np.asarray(to.max_val), np.asarray(jo.max_val))
        assert np.array_equal(np.asarray(to.min_val), np.asarray(jo.min_val))


def test_percentile_clips_an_outlier_and_sorts_past_2_pow_24():
    """As tests/test_observers.py: the outlier is clipped. The observer
    sorts (torch.quantile would refuse more than 2^24 elements)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.random(9999), [1000.0]]).astype(np.float32)
    jc, tc = _both("FEATURE", "per-tensor-affine", observer="percentile",
                   alpha=0.001)
    to = t_observer(tc, TD(tc))
    to.update(torch.from_numpy(x.reshape(1, 1, -1, 1)))
    mn, mx = to.calc_minmax()
    assert float(mx) < 100.0 and float(mn) == 0.0
    big = torch.zeros(2 ** 24 + 8)
    big[-1] = 5.0
    to.update(big.reshape(1, 1, -1, 1))
    assert float(to.calc_minmax()[1]) == 0.0


def test_mse_beats_or_ties_minmax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(10000), [50.0]]).astype(
        np.float32)

    def mse_of(observer):
        _, tc = _both("FEATURE", "per-tensor-symmetric", observer=observer)
        to = t_observer(tc, TD(tc))
        to.update(torch.from_numpy(x.reshape(1, 1, -1, 1)))
        s, z = to.calc_qparams()
        dq = TF.fake_quant(torch.from_numpy(x), s, z, -128, 127)
        return float(((dq - torch.from_numpy(x)) ** 2).mean())

    assert mse_of("mse") <= mse_of("minmax") + 1e-9


@pytest.mark.parametrize("name", ["aciq", "kl_histogram", "kl_device"])
def test_unported_observers_raise(name):
    """The registry as the JAX package's: aciq and kl_histogram build (the
    histogram observers are ported now; tests/test_torch_observers_kl.py
    holds their values), kl_device is the search module and no observer
    type, which both packages refuse alike."""
    jc, tc = _both("FEATURE", "per-tensor-affine", observer=name)
    if name == "kl_device":
        for build, desc in ((j_observer, JD), (t_observer, TD)):
            with pytest.raises(AssertionError, match="no observer named"):
                build(jc if build is j_observer else tc,
                      desc(jc if build is j_observer else tc))
        return
    assert t_observer(tc, TD(tc)).TYPE == j_observer(jc, JD(jc)).TYPE == name


def test_unported_quantizer_raises():
    """adaround builds for weights (ported now; tests/test_torch_adaround.py
    holds it to the JAX package's) and is refused for features, as in the
    JAX package."""
    jc, tc = _both("WEIGHT", "per-channel-symmetric", qtype="adaround")
    assert t_quant(tc).TYPE == j_quant(jc).TYPE == "adaround"
    jc, tc = _both("FEATURE", "per-tensor-affine", qtype="adaround")
    for build, c in ((j_quant, jc), (t_quant, tc)):
        with pytest.raises(AssertionError, match="only supports"):
            build(c)


@pytest.mark.parametrize("layout,axis", [("NCHW", 1), ("NLC", 2),
                                         ("NHWC", 3)])
def test_descriptor_axes_match_jax(layout, axis):
    for target, scheme in (("FEATURE", "per-tensor-affine"),
                           ("WEIGHT", "per-channel-symmetric")):
        jc, tc = _both(target, scheme, layout=layout, bit=4)
        jd, td = JD(jc), TD(tc)
        assert (td.ch_axis, td.bs_axis, td.qrange, td.is_perchannel,
                td.is_symmetric, repr(td)) == (
                    jd.ch_axis, jd.bs_axis, jd.qrange, jd.is_perchannel,
                    jd.is_symmetric, repr(jd))
        assert td.ch_axis == (axis if target == "FEATURE" else 0)
        td.set_symmetric(False)
        jd.set_symmetric(False)
        assert td.qrange == jd.qrange and td.scheme.name == jd.scheme.name


# ---- quantizers ------------------------------------------------------------

QUANT_CASES = {
    # qtype, target, qscheme, bit, data shape, learnables, pact alpha
    "uniform-weight": ("uniform", "WEIGHT", "per-channel-symmetric", 4,
                       (8, 3, 3, 4), ("scale", "zero_point"), 10.0),
    "uniform-feature": ("uniform", "FEATURE", "per-tensor-affine", 8,
                        (2, 4, 4, 8), ("scale", "zero_point"), 10.0),
    "lsq-weight": ("lsq", "WEIGHT", "per-channel-symmetric", 4,
                   (8, 3, 3, 4), ("scale",), 10.0),
    "lsq-feature": ("lsq", "FEATURE", "per-tensor-symmetric", 4,
                    (2, 4, 4, 8), ("scale",), 10.0),
    "lsq+-weight": ("lsq+", "WEIGHT", "per-channel-symmetric", 4,
                    (8, 3, 3, 4), ("scale",), 10.0),
    "lsq+-feature": ("lsq+", "FEATURE", "per-tensor-affine", 4,
                     (2, 4, 4, 8), ("scale", "zero_point"), 10.0),
    "pact-feature": ("pact", "FEATURE", "per-tensor-affine", 4,
                     (2, 4, 4, 8), ("alpha",), 1.0),
    "pact-signed": ("pact", "FEATURE", "per-tensor-symmetric", 4,
                    (2, 4, 4, 8), ("alpha",), 1.0),
    "dorefa-weight": ("dorefa", "WEIGHT", "per-channel-symmetric", 4,
                      (8, 3, 3, 4), (), 10.0),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantizer_forward_and_grads_match_jax(case):
    qtype, target, scheme, bit, shape, names, pact_alpha = QUANT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    calib = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)  # some clip
    gy = rng.standard_normal(shape).astype(np.float32)
    jc, tc = _both(target, scheme, qtype=qtype, bit=bit, layout="NHWC",
                   pact_alpha=pact_alpha)
    jq, tq = j_quant(jc), t_quant(tc)
    jq.update_observer(jnp.asarray(calib))
    tq.update_observer(torch.from_numpy(calib))
    js, jz = jq.calc_qparams()
    ts, tz = tq.calc_qparams()
    # LSQ's mean |x|, LSQ+'s mean and std and DoReFa's max |tanh| are
    # reductions (and tanh a libm function): within 1e-6; then both hold
    # the JAX package's qparams, so the rest compares one state
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                               rtol=1e-6)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz),
                               atol=1e-6)
    for k, v in (("scale", js), ("zero_point", jz)):
        t = getattr(tq, k)
        setattr(tq, k, _t(np.asarray(v), t.requires_grad))
    jq.enable_quant()
    tq.enable_quant()
    jp = jq.trainable_params()
    tp = tq.trainable_params()
    assert sorted(tp) == sorted(jp)
    for k in tp:
        assert tp[k].requires_grad and tp[k].is_leaf
    # uniform learns nothing: hold its gradients through params
    if qtype == "uniform":
        jp = {"scale": js, "zero_point": jz}
        tp = {k: _t(np.asarray(v), True) for k, v in jp.items()}
    want, vjp = jax.vjp(lambda a, p: jq(a, params=p), jnp.asarray(x), jp)
    jgx, jgp = vjp(jnp.asarray(gy))
    xt = _t(x, True)
    got = tq(xt, params=tp if qtype == "uniform" else None)
    assert np.array_equal(got.detach().numpy(), np.asarray(want)), case
    got.backward(_t(gy))
    if qtype == "dorefa":
        # tanh'(x) = 1 - tanh(x)^2 cancels where |tanh| nears 1, and the
        # two packages' tanh differ in the last place: 4 ulp(1) of the
        # derivative, over the detached max |tanh|
        m = float(np.abs(np.tanh(x)).max())
        tol = 4 * 2.0 ** -23 * np.abs(gy) / m
        assert np.all(np.abs(xt.grad.numpy() - np.asarray(jgx)) <= tol)
    else:
        assert np.array_equal(xt.grad.numpy(), np.asarray(jgx)), case
    lo, hi = tq.qdesc.qrange
    width = hi - lo + float(np.abs(np.asarray(jz)).max())
    for k in names:
        g, j = tp[k].grad.numpy(), np.asarray(jgp[k])
        assert g.shape == j.shape
        n = x.size // max(j.size, 1)
        bound = _sum_bound(n, np.abs(gy).sum() * max(width,
                                                     float(np.abs(js).max())))
        assert np.all(np.abs(g - j) <= bound), (case, k, g, j)
        assert np.any(g != 0), (case, k)


def test_lsq_scale_trains_with_torch_optim():
    """The learnable scale is a leaf an optimiser updates: ten Adam steps
    on the fake-quantization error lower it."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    _, tc = _both("WEIGHT", "per-channel-symmetric", qtype="lsq", bit=3)
    tq = t_quant(tc)
    tq.update_observer(w)
    tq.calc_qparams()
    tq.enable_quant()
    opt = torch.optim.Adam(list(tq.trainable_params().values()), lr=1e-2)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        loss = ((tq(w) - w) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0]


# ---- config ----------------------------------------------------------------

QCONFIG = {
    "BACKEND": "virtual",
    "W": {"QSCHEME": "per-channel-symmetric",
          "QUANTIZER": {"TYPE": "lsq", "BIT": 4},
          "OBSERVER": {"TYPE": "MSE"}},
    "A": {"QSCHEME": "per-tensor-affine",
          "QUANTIZER": {"TYPE": "pact", "BIT": 8,
                        "PACT": {"ALPHA_VALUE": 6.0}},
          "OBSERVER": {"TYPE": "PERCENTILE", "LAYOUT": "NLC",
                       "PERCENTILE": {"ALPHA": 0.01}}},
    "SCHEDULE": {"BN_TUNING": True},
}


def test_parse_qconfig_dict_and_yaml_match_jax(tmp_path):
    import yaml

    path = tmp_path / "qconfig.yaml"
    path.write_text(yaml.safe_dump(QCONFIG))
    t_dict, t_yaml = t_parse(QCONFIG), t_parse(str(path))
    j_dict = j_parse(QCONFIG)
    assert t_dict.to_dict() == t_yaml.to_dict() == j_dict.to_dict()
    assert t_dict.is_frozen() and t_dict.A.OBSERVER.LAYOUT == "NLC"
    assert t_parse({"W": {"QSCHEME": "per-channel-affine",
                          "QUANTIZER": {"BIT": 4}},
                    "A": {"QSCHEME": "per-tensor-affine",
                          "QUANTIZER": {"BIT": 8}}}).A.OBSERVER.LAYOUT \
        == "NHWC"
    assert yaml.safe_load(t_dict.dump()) == t_dict.to_dict()
    with pytest.raises(AttributeError):
        t_dict.BACKEND = "tpu"
    for bad in ({"W": {"QSCHEME": "per-channel-symmetric",
                       "QUANTIZER": {"BIT": 4}},
                 "A": {"QSCHEME": "per-tensor-affine",
                       "QUANTIZER": {"BIT": 8}}, "BACKEND": "tensorrt"},
                {"W": {"QSCHEME": "per-tensor-affine",
                       "QUANTIZER": {"BIT": 8}},
                 "A": {"QSCHEME": "per-tensor-affine",
                       "QUANTIZER": {"BIT": 8}}, "BACKEND": "tpu"},
                dict(QCONFIG, BACKEND="cuda")):
        for parse in (t_parse, j_parse):
            with pytest.raises((AssertionError, TypeError)):
                parse(bad)


def test_cfgnode_merge_from_list_matches_jax():
    for cls in (TCfg, JCfg):
        cfg = cls({"A": {"BIT": 8, "NAME": "x"}, "B": [1, 2]})
        cfg.merge_from_list(["A.BIT", "4", "A.NAME", "12", "C.D", "[3]"])
        assert cfg.to_dict() == {"A": {"BIT": 4, "NAME": "12"}, "B": [1, 2],
                                 "C": {"D": [3]}}
        clone = cfg.clone()
        clone.A.BIT = 2
        assert cfg.A.BIT == 4
