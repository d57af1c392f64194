"""The port's YOLO family (``models/yolo.py``) against the JAX package's,
on the CPU, with the JAX models' weights carried across
(``nn.load_jax_state_dict``; BatchNorm state randomised so that it is no
identity), at tests/test_model_breadth.py's sizes: 4 classes, 64 x 64
images, yolov3_darknet21, yolov4_small, yolov5n and yolov3_tiny.

- the prediction maps of JAX's shapes ((1, 2, 2, 27), (1, 4, 4, 27),
  (1, 8, 8, 27); yolov3_tiny the first two) within 1e-4 of JAX's
  (convolutions summed in other orders), the traced graph equal to
  JAX's node by node (residual adds, route concats, SPP / SPPF maxpools,
  upsamples, Mish and SiLU), quantizers off within 1e-5 of the float
  model;
- yolov3_darknet21 through W8A8 MinMax calibration: every quantizer's
  qparams within 1e-5 relative of JAX's (weight scales equal), the
  relative MSE of each map in JAX's bound (0, 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsebit_tpu.models import create_model as j_create_model
from sparsebit_tpu_torch.models import create_model as t_create_model
from test_torch_graph import carry, rand, randomize_bn, signature
from test_torch_quant_model import (
    assert_qparams_match,
    both,
    calibrate,
    cfg_dict,
)

torch.set_num_threads(1)

SHAPES = {"yolov3_darknet21": 3, "yolov4_small": 3, "yolov5n": 3,
          "yolov3_tiny": 2}


def maps(q, x):
    with torch.no_grad():
        return [m.numpy() for m in q(torch.from_numpy(x))]


@pytest.mark.parametrize("name", list(SHAPES))
def test_yolo_matches_jax(name):
    jm = randomize_bn(j_create_model(name, num_classes=4).eval())
    tm = carry(jm, t_create_model(name, num_classes=4, device="cpu").eval())
    x = rand((1, 64, 64, 3), seed=1)
    want = [np.asarray(m) for m in jax.jit(lambda v: jm(v))(jnp.asarray(x))]
    got = maps(tm, x)
    assert [g.shape for g in got] == [(1, 2, 2, 27), (1, 4, 4, 27),
                                      (1, 8, 8, 27)][:SHAPES[name]]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    jq, tq = both(jm, tm, x, cfg_dict())
    assert signature(tq.graph) == signature(jq.graph)
    for off, g in zip(maps(tq, x), got):
        np.testing.assert_allclose(off, g, rtol=0, atol=1e-5)
    if name != "yolov3_darknet21":
        return
    for q in (jq, tq):
        calibrate(q, [x])
        q.set_quant(True, True)
    assert_qparams_match(jq, tq, rtol=1e-5)
    for qo, g in zip(maps(tq, x), got):
        rel = np.mean((qo - g) ** 2) / (np.mean(g ** 2) + 1e-9)
        assert 0 < rel < 1e-2, rel
