"""The port's histogram observers (aciq, kl_histogram and the KL search
on the data's device, ``observers/kl_device.py``) against the JAX
package's and the numpy oracle, on the CPU; the cases of
tests/test_observers.py:101-147 and more:

- aciq (gaus and laplace, per tensor and per channel, features and
  weights, symmetric and affine): min / max within 1e-6 relative of
  JAX's (means and extrema are reductions);
- the KL search: the same candidate width as the numpy oracle
  (``kl_thresholds``, float64) and as JAX's ``kl_thresholds_device``, so
  thresholds within 1e-5 relative (the bin width is float32 arithmetic);
- the kl_histogram observer per tensor and per channel: the JAX
  observer's min / max within 1e-5 relative;
- the registry: kl_device is the search module, not an observer type, in
  both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.quantization.common import QuantTarget as JTarget
from sparsebit_tpu.quantization.observers import build_observer as j_observer
from sparsebit_tpu.quantization.observers.kl_device import (
    kl_thresholds_device as j_kl_device,
)
from sparsebit_tpu.quantization.quant_descriptor import QuantDescriptor as JD
from sparsebit_tpu.utils.config import CfgNode as JCfg
from sparsebit_tpu_torch.quantization.common import QuantTarget as TTarget
from sparsebit_tpu_torch.quantization.observers import (
    build_observer as t_observer,
)
from sparsebit_tpu_torch.quantization.observers.kl_device import (
    device_histograms,
    kl_thresholds_device,
)
from sparsebit_tpu_torch.quantization.observers.kl_histogram import (
    kl_thresholds,
)
from sparsebit_tpu_torch.quantization.quant_descriptor import (
    QuantDescriptor as TD,
)
from sparsebit_tpu_torch.utils.config import CfgNode as TCfg


def build(name, qscheme="per-tensor-affine", target="FEATURE", bit=8,
          distribution="GAUS", layout="NCHW"):
    """The same observer config in both packages."""
    def cfg(Cfg, Target):
        return Cfg({
            "TARGET": [getattr(Target, target)], "QSCHEME": qscheme,
            "QUANTIZER": {"TYPE": "uniform", "BIT": bit, "GROUPSIZE": -1},
            "OBSERVER": {"TYPE": name, "LAYOUT": layout,
                         "ACIQ": {"DISTRIBUTION": distribution}}})

    jc, tc = cfg(JCfg, JTarget), cfg(TCfg, TTarget)
    return j_observer(jc, JD(jc)), t_observer(tc, TD(tc))


def observe(jo, to, arrays):
    for a in arrays:
        jo.update(jnp.asarray(a))
        to.update(torch.from_numpy(a))
    jmn, jmx = jo.calc_minmax()
    tmn, tmx = to.calc_minmax()
    return (np.asarray(jmn), np.asarray(jmx)), (tmn.numpy(), tmx.numpy())


ACIQ_CASES = {
    # qscheme, target, bit, distribution, data
    "gaus-tensor": ("per-tensor-symmetric", "FEATURE", 8, "GAUS", "normal"),
    "gaus-affine-relu": ("per-tensor-affine", "FEATURE", 4, "GAUS", "relu"),
    "laplace-tensor": ("per-tensor-affine", "FEATURE", 8, "LAPLACE",
                       "laplace"),
    "laplace-relu": ("per-tensor-affine", "FEATURE", 4, "LAPLACE", "relu"),
    "gaus-channel": ("per-channel-symmetric", "FEATURE", 8, "GAUS",
                     "normal"),
    "laplace-weight": ("per-channel-symmetric", "WEIGHT", 4, "LAPLACE",
                       "laplace"),
}


@pytest.mark.parametrize("name", sorted(ACIQ_CASES))
def test_aciq_matches_jax(name):
    qscheme, target, bit, dist, kind = ACIQ_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = (8, 16, 3, 3) if target == "WEIGHT" else (2, 8, 16, 16)
    x = rng.laplace(size=(2,) + shape) if kind == "laplace" else \
        rng.standard_normal((2,) + shape)
    if kind == "relu":
        x = np.maximum(x, 0)
    arrays = [a.astype(np.float32) for a in x]
    jo, to = build("aciq", qscheme, target, bit, dist)
    (jmn, jmx), (tmn, tmx) = observe(jo, to, arrays)
    np.testing.assert_allclose(tmx, jmx, rtol=1e-6)
    np.testing.assert_allclose(tmn, jmn, rtol=1e-6)
    assert np.all(tmx > 0) and np.all(tmx < np.abs(x).max() * 1.5)


def test_aciq_gaus_smaller_than_minmax_on_gaussian():
    x = np.random.RandomState(2).randn(1, 8, 32, 32).astype(np.float32)
    _, to = build("aciq", "per-tensor-symmetric")
    to.update(torch.from_numpy(x))
    mn, mx = to.calc_minmax()
    assert 0 < float(mx) < np.abs(x).max()


def _kl_cases():
    rng = np.random.RandomState(7)
    return [
        ("gauss", rng.randn(3, 4096).astype(np.float32)),
        ("laplace", rng.laplace(size=(2, 4096)).astype(np.float32)),
        ("outliers", np.concatenate(
            [rng.randn(1, 4000), 20 * rng.randn(1, 96)],
            axis=1).astype(np.float32)),
        ("relu", np.maximum(rng.randn(2, 4096), 0).astype(np.float32)),
    ]


@pytest.mark.parametrize("bit", [4, 8])
def test_kl_device_matches_numpy_oracle_and_jax(bit):
    for name, data in _kl_cases():
        ref = kl_thresholds(data, bit, bins=512)
        jax_th = np.asarray(j_kl_device(jnp.asarray(data), bit, bins=512))
        got = kl_thresholds_device(torch.from_numpy(data), bit,
                                   bins=512).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   err_msg="{} bit={}".format(name, bit))
        np.testing.assert_allclose(got, jax_th, rtol=1e-5,
                                   err_msg="{} bit={}".format(name, bit))


def test_device_histograms_match_numpy():
    data = np.random.RandomState(3).randn(3, 5000).astype(np.float32)
    amax = torch.from_numpy(np.abs(data).max(axis=1))
    got = device_histograms(torch.from_numpy(data), amax, 256).numpy()
    for c in range(3):
        want = np.histogram(data[c], bins=256,
                            range=(-amax[c].item(), amax[c].item()))[0]
        # the same bins up to values on a bin edge, which numpy's
        # (x - lo) * bins / span may put on the other side
        assert got[c].sum() == want.sum() == 5000
        assert np.abs(got[c] - want).sum() <= 4


def test_kl_histogram_per_tensor_matches_jax():
    x = np.random.RandomState(3).randn(20000).astype(np.float32)
    jo, to = build("kl_histogram", "per-tensor-symmetric")
    (jmn, jmx), (tmn, tmx) = observe(jo, to, [x.reshape(1, 1, -1, 1)])
    assert 1.0 < float(tmx) <= np.abs(x).max() + 1e-5
    assert float(tmn) == -float(tmx)
    np.testing.assert_allclose(tmx, jmx, rtol=1e-5)
    np.testing.assert_allclose(tmn, jmn, rtol=1e-5)
    # a half-range input keeps min at 0
    jo, to = build("kl_histogram", "per-tensor-affine")
    (jmn, jmx), (tmn, tmx) = observe(jo, to, [np.abs(x).reshape(1, 1, -1,
                                                                 1)])
    assert float(tmn) == 0.0 and float(jmn) == 0.0
    np.testing.assert_allclose(tmx, jmx, rtol=1e-5)


@pytest.mark.parametrize("target", ["WEIGHT", "FEATURE"])
def test_kl_histogram_per_channel_matches_jax(target):
    rng = np.random.RandomState(4)
    shape = (4, 4096) if target == "WEIGHT" else (1, 3, 48, 48)
    jo, to = build("kl_histogram", "per-channel-symmetric", target,
                   layout="NCHW")
    (jmn, jmx), (tmn, tmx) = observe(
        jo, to, [rng.randn(*shape).astype(np.float32)])
    assert tmx.shape == jmx.shape == ((4,) if target == "WEIGHT" else (3,))
    assert np.all(tmx > 0)
    np.testing.assert_allclose(tmx, jmx, rtol=1e-5)
    np.testing.assert_allclose(tmn, jmn, rtol=1e-5)


def test_kl_search_sparse_channels_follow_the_oracle():
    """64 values a channel over 2048 bins: candidate divergences tie to
    within float32 rounding. The port searches in float64 and picks the
    oracle's candidate; JAX's float32 search picks a neighbour on channel
    3 (2.1656 against the oracle's 2.1762), within 0.5 % of it."""
    w = np.random.RandomState(4).randn(4, 64).astype(np.float32)
    ref = kl_thresholds(w, 8, bins=2048)
    got = kl_thresholds_device(torch.from_numpy(w), 8).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    jax_th = np.asarray(j_kl_device(jnp.asarray(w), 8))
    np.testing.assert_allclose(got, jax_th, rtol=5e-3)


def test_kl_device_is_no_observer_type():
    for build_one in (lambda: build("kl_device")[0],
                      lambda: build("kl_device")[1]):
        with pytest.raises(AssertionError, match="no observer named"):
            build_one()
