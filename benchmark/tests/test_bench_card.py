"""The controls on the card, at the cells' published widths cut to two
layers so that a test run holds them: the serving control (int4
activations and K/V) reads far above the program, the training control
(the backbone's forward on fp8 operands) above the program and the bf16
operands the configuration allows, and the training check catches half
the batch left out. The full-depth readings come from
``benchmark/calibrate.py``. Skips without a card."""

import time

import torch

from benchmark.calibrate import FAULTS, readings
from benchmark.lib import harness as H
from benchmark.tests.conftest import ROOT


def _ctx(cell, seed, faults=None, layers=2):
    man = H.Manifest(ROOT)
    w = man.cell(cell)
    mc = man.config(w["config"])
    mc["num_hidden_layers"] = layers
    return H.Run(cell, mc, man.traffic(w["traffic"]), man.limits(cell), seed,
                 2.0, False, torch.device("cuda"), time.perf_counter(), faults)


def test_serving_control_reads_far_above_the_program(cuda):
    line = readings(_ctx("mistral7b-w4g128-chat", 2 ** 31 + 101), True)
    assert line["control"]["served_logit_gap"] > \
        3 * line["program"]["served_logit_gap"]


def test_training_control_and_half_the_batch(cuda):
    cell, seed = "deepseek7b-w4g128-qlora", 2 ** 31 + 102
    sound = readings(_ctx(cell, seed), True)
    half = readings(_ctx(cell, seed, {"train_step": FAULTS["half"]}), False)
    # the program and the bf16 operands the configuration allows, against
    # the fp8 control one step below
    for number in ("grad_norm_gap", "grad_diff"):
        allowed = max(sound["program"][number],
                      sound["control_bf16"][number])
        assert sound["control_fp8"][number] > 2 * allowed, number
    assert half["program"]["grad_norm_gap"] > \
        10 * sound["program"]["grad_norm_gap"]
