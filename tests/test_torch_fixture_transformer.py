"""The port's transformer accuracy fixtures
(``quantization/tools/fixture.py``: run_vit_fixture, run_bert_fixture,
run_vit_qat_fixture) on the CPU, holding the seven claims of
tests/test_fixture_transformer.py at its sizes, and the data generator
against the JAX package's:

- DeiT regime: a tiny ViT (patch conv, MHSA with F.matmul / softmax,
  LayerNorm, GELU on the NLC path) on patch-shifted templates: learned,
  w8a8 within 3 points of float, w4a8 within 15 and not above w8a8 + 2;
- CoLA regime: the zoo's BertModel on Markov-chain "grammaticality":
  learned, w8a8 within 3 points, w4a8 within 15;
- QAT: LSQ 4w4a through the quantized attention path recovers to an
  absolute 0.60 top-1 and 0.25 over the PTQ starting point (400 cosine
  steps).

The port trains its own models (torch.Generator seeds, torch.optim.Adam;
one CPU thread, since the thread count changes the training's rounding),
so the claims hold on the port's models, as the JAX test's on JAX's.
"""

import numpy as np
import pytest
import torch

from sparsebit_tpu.quantization.tools.fixture import (
    make_markov_lm_data as j_markov,
)
from sparsebit_tpu_torch.quantization.tools.fixture import (
    make_markov_lm_data,
    run_bert_fixture,
    run_vit_fixture,
    run_vit_qat_fixture,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vit_results():
    return run_vit_fixture(steps=150, n_train=2048, n_eval=512, device="cpu")


@pytest.fixture(scope="module")
def bert_results():
    return run_bert_fixture(steps=200, n_train=2048, n_eval=512,
                            device="cpu")


@pytest.fixture(scope="module")
def vit_qat_results():
    return run_vit_qat_fixture(steps=150, qat_steps=400, n_train=2048,
                               n_eval=512, device="cpu")


def test_markov_data_is_the_jax_packages():
    for a, b in zip(make_markov_lm_data(64, seed=3), j_markov(64, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_vit_learned(vit_results):
    assert vit_results["acc_float"] > 0.6  # chance = 0.1


def test_vit_int8_ptq_cost_small(vit_results):
    f, q = vit_results["acc_float"], vit_results["acc_w8a8"]
    assert q > f - 0.03, "int8 top-1 {} vs float {}".format(q, f)


def test_vit_w4_degrades_gracefully(vit_results):
    f, q4 = vit_results["acc_float"], vit_results["acc_w4a8"]
    assert q4 > f - 0.15, "w4a8 top-1 {} vs float {}".format(q4, f)
    assert q4 <= vit_results["acc_w8a8"] + 0.02


def test_bert_learned(bert_results):
    assert bert_results["acc_float"] > 0.7  # chance = 0.5


def test_bert_int8_ptq_cost_small(bert_results):
    f, q = bert_results["acc_float"], bert_results["acc_w8a8"]
    assert q > f - 0.03, "int8 acc {} vs float {}".format(q, f)


def test_bert_w4_degrades_gracefully(bert_results):
    f, q4 = bert_results["acc_float"], bert_results["acc_w4a8"]
    assert q4 > f - 0.15, "w4a8 acc {} vs float {}".format(q4, f)


def test_vit_qat_recovers_over_ptq(vit_qat_results):
    r = vit_qat_results
    assert r["acc_qat"] >= 0.60, r
    assert r["acc_qat"] >= r["acc_ptq"] + 0.25, r
