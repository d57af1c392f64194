"""The port's AdaRound (``quantizers/adaround.py``) against the JAX
package's, on the CPU: ``reconstruct_qlayer`` on one 4-bit per-channel
linear layer, where the two packages' reconstruction losses are one
number (on a convolution the JAX package sums the pixels that the port,
as the reference, averages: reference fault R10, pinned below), with
N = 16 calibration samples <= the batch size 32, so that every
step sees the whole set and the sampling order cannot matter (a batch
mean over the same samples in another order). The first step's gradient
of v is within 2e-9 of JAX's, but Adam divides every gradient by its
running RMS, so where a gradient is near zero (the soft rounding near its
clip) last-place differences become differences of a fraction of the
step lr = 1e-3. After 20 steps (warm-up, then the round loss) v is held
within lr / 4 of JAX's, and the rounded weights are equal. Also: the quantizer through the port's
calibration (``W.QUANTIZER.TYPE = adaround``), where each layer's
reconstruction loss ends below the loss of rounding to nearest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsebit_tpu.nn as jnn
import sparsebit_tpu_torch.nn as tnn
from sparsebit_tpu import parse_qconfig as j_parse
from sparsebit_tpu.quantization.modules.conv import QConv2d as JQConv2d
from sparsebit_tpu.quantization.modules.linear import QLinear as JQLinear
from sparsebit_tpu.quantization.quantizers.adaround import (
    reconstruct_qlayer as j_reconstruct,
)
from sparsebit_tpu_torch import QuantModel
from sparsebit_tpu_torch import parse_qconfig as t_parse
from sparsebit_tpu_torch.quantization.modules.conv import QConv2d as TQConv2d
from sparsebit_tpu_torch.quantization.modules.linear import (
    QLinear as TQLinear,
)
from sparsebit_tpu_torch.quantization.quantizers import build_quantizer
from sparsebit_tpu_torch.quantization.quantizers.adaround import (
    reconstruct_qlayer as t_reconstruct,
    reconstruction_loss,
)
from test_torch_graph import carry

CFG = {
    "BACKEND": "virtual",
    "W": {"QSCHEME": "per-channel-symmetric",
          "QUANTIZER": {"TYPE": "adaround", "BIT": 4}},
    "A": {"QSCHEME": "per-tensor-affine", "QUANTIZER": {"BIT": 8},
          "OBSERVER": {"LAYOUT": "NHWC"}},
}


def _built(jmod, tmod, jcls, tcls):
    jop, top = jcls(jmod, j_parse(CFG)), tcls(tmod, t_parse(CFG))
    jop.build_quantizer(j_parse(CFG))
    top.build_quantizer(t_parse(CFG))
    jop.weight_quantizer.update_observer(jmod.weight)
    jop.weight_quantizer.calc_qparams()
    top.weight_quantizer.update_observer(tmod.weight.detach())
    top.weight_quantizer.calc_qparams()
    return jop, top


def _conv_layers():
    jconv = jnn.Conv2d(4, 8, 3, padding=1, key=jax.random.PRNGKey(5))
    tconv = carry(jconv, tnn.Conv2d(4, 8, 3, padding=1))
    return _built(jconv, tconv, JQConv2d, TQConv2d)


def _linear_layers():
    jlin = jnn.Linear(36, 8, key=jax.random.PRNGKey(5))
    tlin = carry(jlin, tnn.Linear(36, 8))
    return _built(jlin, tlin, JQLinear, TQLinear)


def test_reconstruct_qlayer_matches_jax():
    jop, top = _linear_layers()
    x = np.random.default_rng(0).normal(size=(16, 36)).astype(np.float32)
    jy = jop.module.execute(jnp.asarray(x))
    with torch.no_grad():
        ty = top.module.execute(torch.from_numpy(x))
    j_reconstruct(jop, jnp.asarray(x), jy, max_steps=20)
    t_reconstruct(top, torch.from_numpy(x), ty, max_steps=20)
    jv = np.asarray(jop.weight_quantizer.v).T  # (in, out) -> (out, in)
    tv = top.weight_quantizer.v.numpy()
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=0, atol=2.5e-4)
    # the hard rounding after training: the same weights
    jw = np.asarray(jop.weight_quantizer(jop.module.weight)).T
    with torch.no_grad():
        tw = top.weight_quantizer(top.module.weight).numpy()
    np.testing.assert_array_equal(tw, jw)
    assert not top.weight_quantizer.training


def test_reconstruction_loss_averages_pixels_r10():
    """Reference fault R10: on a convolution's (N, H, W, C) output the JAX
    package's reconstruction loss (adaround.py:95-97 there: |.|^2 summed
    over every non-batch axis, averaged over the batch) is H x W times
    the port's, the reference's ``sum(1).mean()`` (channels summed,
    samples and pixels averaged); on a linear layer's (N, C) output they
    are one number. The same layer's outputs in both packages, the
    prediction one fake-quantized at 4 bits (rtol 1e-5: f32 sums in
    other orders)."""
    x = np.random.default_rng(2).normal(size=(16, 6, 6, 4)).astype(
        np.float32)
    jop, top = _conv_layers()
    for q in (jop.weight_quantizer, top.weight_quantizer):
        q.enable_quant()
    jy = jop.module.execute(jnp.asarray(x))
    jpred = jop.execute(jnp.asarray(x))
    with torch.no_grad():
        ty = top.module.execute(torch.from_numpy(x))
        tpred = top.execute(torch.from_numpy(x))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=0,
                               atol=1e-5)
    jloss = float(jnp.mean(jnp.sum(jnp.abs(jpred - jy) ** 2,
                                   axis=tuple(range(1, jpred.ndim)))))
    tloss = float(reconstruction_loss(tpred, ty))
    assert tloss > 0
    np.testing.assert_allclose(jloss, tloss * 6 * 6, rtol=1e-5)
    z = np.random.default_rng(3).normal(size=(2, 16, 8)).astype(np.float32)
    a, b = torch.from_numpy(z[0]), torch.from_numpy(z[1])
    np.testing.assert_allclose(
        float(reconstruction_loss(a, b)),
        float(jnp.mean(jnp.sum(jnp.abs(z[0] - z[1]) ** 2, axis=1))),
        rtol=1e-6)


def test_adaround_quantizer_builds_and_is_weight_only():
    from sparsebit_tpu_torch.quantization.common import QuantTarget
    from sparsebit_tpu_torch.quantization.modules.base import (
        _quantizer_config,
    )

    cfg = t_parse(CFG)
    q = build_quantizer(_quantizer_config(cfg.W, QuantTarget.WEIGHT))
    assert q.TYPE == "adaround" and q.v is None
    a = _quantizer_config(cfg.A, QuantTarget.FEATURE)
    a.defrost()
    a.QUANTIZER.TYPE = "adaround"
    a.freeze()
    with pytest.raises(AssertionError, match="only supports to quant "
                                             "weights"):
        build_quantizer(a)


def test_adaround_calibration_beats_nearest_rounding():
    """Layerwise calibration with AdaRound weights: each conv's output
    error on its calibration inputs ends below rounding to nearest's."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(3)
            self.conv1 = tnn.Conv2d(3, 8, 3, padding=1, generator=g)
            self.relu = tnn.ReLU()
            self.conv2 = tnn.Conv2d(8, 8, 3, padding=1, generator=g)

        def forward(self, x):
            return self.conv2(self.relu(self.conv1(x)))

    net = Net().eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 6, 6, 3)).astype(np.float32))
    q = QuantModel(net, t_parse(CFG), (x,))
    q.prepare_calibration()
    q(x)
    q.calibration_runner.adaround_max_steps = 200
    q.calc_qparams()
    conv1 = q.get_qmodule("conv1")
    conv1.set_quant(w_quant=True)
    wq = conv1.weight_quantizer
    with torch.no_grad():
        want = net.conv1.execute(x)
        ada = conv1.module.execute(x, params={"weight": wq(net.conv1.weight)})
        nearest = torch.round(net.conv1.weight / wq.scale).clamp(-8, 7) \
            * wq.scale
        rtn = conv1.module.execute(x, params={"weight": nearest})
    assert ((ada - want) ** 2).sum() < ((rtn - want) ** 2).sum()
