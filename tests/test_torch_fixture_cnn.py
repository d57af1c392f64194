"""The port's CNN accuracy fixture (``quantization/tools/fixture.py``)
on the CPU, against the JAX package's (tests/test_fixture_cnn.py):

- the synthetic shifted-template data bit-equal to the JAX package's;
- the three claims of tests/test_fixture_cnn.py on the port's own model,
  trained on the CPU at the CI settings (150 steps, 2048 / 1024): it
  learned (top-1 > 0.6), int8 PTQ costs < 2 points, w4a8 costs < 15
  points and does not beat w8a8 by more than 2;
- the JAX package's trained fixture weights carried across: the port's
  float and w8a8 top-1 within 2 of 1024 samples of the JAX package's on
  the same weights (near-tied logits may round either way).
"""

import numpy as np
import pytest
import torch

import sparsebit_tpu.quantization.tools.fixture as jfix
from sparsebit_tpu_torch.quantization.tools import fixture as tfix
from test_torch_graph import carry


@pytest.fixture(scope="module")
def port_results():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the trained model depends on the threads
    try:
        return tfix.run_cnn_fixture(steps=150, n_train=2048, n_eval=1024,
                                    device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_data_bit_equal_to_jax():
    for n, seed in ((64, 0), (32, 1)):
        jx, jy = jfix.make_shifted_template_data(n, seed=seed)
        tx, ty = tfix.make_shifted_template_data(n, seed=seed)
        assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_model_learned(port_results):
    assert port_results["acc_float"] > 0.6  # chance = 0.1


def test_int8_ptq_cost_small(port_results):
    f, q = port_results["acc_float"], port_results["acc_w8a8"]
    assert q > f - 0.02, "int8 top-1 {} vs float {}".format(q, f)


def test_w4_degrades_gracefully(port_results):
    f, q4 = port_results["acc_float"], port_results["acc_w4a8"]
    assert q4 > f - 0.15, "w4a8 top-1 {} vs float {}".format(q4, f)
    assert q4 <= port_results["acc_w8a8"] + 0.02


def test_jax_trained_weights_give_jax_accuracy(monkeypatch):
    captured = {}

    class Capturing(jfix.QuantModel):
        def __init__(self, model, config, example_inputs):
            captured["model"] = model
            super().__init__(model, config, example_inputs)

    monkeypatch.setattr(jfix, "QuantModel", Capturing)
    want = jfix.run_cnn_fixture(steps=150, n_train=2048, n_eval=1024,
                                bit_configs=((8, 8),))
    model = carry(captured["model"], tfix.FixtureCNN()).eval()
    x_tr, _ = tfix.make_shifted_template_data(2048, seed=0)
    x_ev, y_ev = tfix.make_shifted_template_data(1024, seed=1)
    from sparsebit_tpu_torch import QuantModel

    qmodel = QuantModel(model, tfix._ptq_cfg(),
                        (torch.from_numpy(x_tr[:128]),))
    got = {"acc_float": tfix._accuracy(qmodel, x_ev, y_ev, "cpu")}
    got.update(tfix.ptq_sweep(qmodel, x_tr, x_ev, y_ev, ((8, 8),), "cpu"))
    for k in ("acc_float", "acc_w8a8"):
        assert abs(got[k] - want[k]) * 1024 <= 2, (k, got[k], want[k])
