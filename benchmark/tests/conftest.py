"""Shared fixtures of the benchmark's tests: tiny versions of the two
configurations and their traffic, run on the CPU through the program's
plain versions. Tests that need the card take the ``cuda`` fixture,
which skips without one (decided inside the fixture, so that every
worker collects the same tests). Run them all, the card's too where
there is one, with

    python -m pytest benchmark/tests -q

Nothing here imports JAX.
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"


def load(sub, name):
    return json.loads((BENCH / sub / (name + ".json")).read_text())


def tiny_chat():
    mc = load("configs", "mistral-7b-v0.3-w4g128")
    mc.update(hidden_size=256, num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, intermediate_size=512, vocab_size=512)
    tr = load("workloads", "chat-closed32")
    tr.update(clients=4, requests=64, block=8, warmup_requests=4,
              check_sample=3)
    tr["engine"].update(max_batch=4, max_len=256, chunk=4)
    tr["prompt_len"].update(median=24, min=8, max=96)
    tr["output_len"].update(median=8, min=4, max=32)
    return mc, tr


def tiny_qlora():
    mc = load("configs", "deepseek-llm-7b-base-w4g128-qlora")
    mc.update(hidden_size=256, num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=2, intermediate_size=512, vocab_size=512)
    tr = load("workloads", "sft-b16-s256")
    tr.update(batch=4, seq_len=33)
    return mc, tr


# limits at the tiny sizes: the program reads 0-0.03 (serving gap) and
# ~2e-5 / 1e-3 / 5e-3 / 0.024 (loss, gradient, change, gradient
# difference; the fp8 control 0.14) there
TINY_LIMITS = {"served_logit_gap": 0.3, "loss_gap": 2e-3,
               "grad_norm_gap": 0.02, "change_norm_gap": 0.05,
               "grad_diff": 0.08}


def tiny_run(kind, seed=1, seconds=2.0, faults=None, limits=TINY_LIMITS):
    from benchmark.lib.harness import Run

    mc, tr = tiny_chat() if kind == "chat" else tiny_qlora()
    return Run("tiny-" + kind, mc, tr, limits, seed, seconds, False,
               torch.device("cpu"), time.perf_counter(), faults)


@pytest.fixture
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
