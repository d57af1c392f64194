"""Whole runs of tiny cells on the CPU (the chip look skipped, the
program on its plain versions): a cell and a metric added as files
alone are found by name; a sound run comes out correct and a run with
the timed path broken underneath does not; the manifest keeps to its
contract."""

import json
import re
import shutil

import pytest
import torch

from benchmark.calibrate import FAULTS
from benchmark.lib import harness as H
from benchmark.tests.conftest import BENCH, ROOT, TINY_LIMITS, tiny_chat, \
    tiny_run

NEW_METRIC = '''"""Requests the window's check covers (a metric added as a file)."""


def read(run):
    return float(len(run.requests))
'''


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path, cpu_threads):
    """A copy of the benchmark's data with a new configuration, traffic,
    limits and metric written as files, and entries for them in the
    manifest: the harness loads and runs them with no edit to any file."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "workloads", "limits", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    mc, tr = tiny_chat()
    (bench / "configs" / "tiny.json").write_text(json.dumps(mc))
    (bench / "workloads" / "tiny-chat.json").write_text(json.dumps(tr))
    (bench / "limits" / "tiny.chat.json").write_text(json.dumps(
        {"served_logit_gap": TINY_LIMITS["served_logit_gap"]}))
    (bench / "metrics" / "requests_checked.serve.py").write_text(NEW_METRIC)
    data["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    data["workloads"].append({"name": "tiny.chat", "config": "tiny",
                              "traffic": "tiny-chat", "chips": 1,
                              "why": "test"})
    for m in data["end_to_end"]:
        if "workloads" in m and "mistral7b-w4g128-chat" in m["workloads"]:
            m["workloads"].append("tiny.chat")
    layer = data["per_layer"][0]["layer"]
    data["per_layer"].append({"name": "requests_checked.serve", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": layer, "moves": "serve_tok_s",
                              "workloads": ["tiny.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    man = H.Manifest(tmp_path, bench)
    cell = man.cell("tiny.chat")
    for traced in (False, True):
        ctx = H.Run("tiny.chat", man.config(cell["config"]),
                    man.traffic(cell["traffic"]), man.limits("tiny.chat"),
                    2 ** 31 + 17, 2.0, traced, torch.device("cpu"), 0.0)
        res = H.execute(man, ctx)
        assert res["correct"], res
        names = set(res["metrics"])
        if traced:
            assert names == {"requests_checked.serve"}
            assert res["metrics"]["requests_checked.serve"]["value"] > 0
        else:
            assert names == {"serve_tok_s", "ttft_p90_ms", "tpot_p90_ms",
                             "setup_s"}
        assert list(res)[-1] == "checks"


def _plant_token_fault(monkeypatch):
    from sparsebit_tpu_torch.llm import decode, serving

    real = decode.sample_logits_vec

    def altered(logits, temps, generator=None):
        tok = real(logits, temps, generator)
        return torch.where(torch.arange(len(tok)) == 0,
                           (tok + 1) % logits.shape[-1], tok)

    monkeypatch.setattr(decode, "sample_logits_vec", altered)
    monkeypatch.setattr(serving, "sample_logits_vec", altered)


def _plant_frozen_cache(monkeypatch):
    """Each decode step writes its K/V rows into copies: the slot cache
    keeps its state."""
    from sparsebit_tpu_torch.llm import decode

    real = decode._backbone_fused

    def frozen(layers, x, pos, k, v, ks, vs, *a, **kw):
        return real(layers, x, pos, k.clone(), v.clone(), ks.clone(),
                    vs.clone(), *a, **kw)

    monkeypatch.setattr(decode, "_backbone_fused", frozen)


@pytest.mark.parametrize("kind,fault", [
    ("chat", None), ("chat", "token"), ("chat", "frozen_cache"),
    ("qlora", None), ("qlora", "unchanged"), ("qlora", "half"),
    ("qlora", "loss")])
def test_sound_run_correct_and_broken_runs_not(kind, fault, monkeypatch,
                                               cpu_threads):
    if fault == "token":
        _plant_token_fault(monkeypatch)
    if fault == "frozen_cache":
        _plant_frozen_cache(monkeypatch)
    faults = {"train_step": FAULTS[fault]} if fault in FAULTS else {}
    ctx = tiny_run(kind, seed=2 ** 32 + 5, faults=faults)
    res = H.execute(H.Manifest(ROOT), ctx)
    print(kind, fault, res["checks"])
    # a fault passes no check that compared nothing
    assert kind != "chat" or ctx.requests, "the window finished no request"
    assert res["correct"] == (fault is None), res["checks"]


def test_a_check_that_compared_nothing_is_not_correct():
    """A serving window that finished no request leaves the check with no
    number: the run is not correct, and its line stays JSON."""
    import types

    class Loop:
        @staticmethod
        def sample(out, n, seed):
            return []

    ctx = types.SimpleNamespace(
        traffic={"loop": "serve", "check_sample": 3}, seed=1)
    numbers = H.check_numbers(ctx, Loop, [])
    assert not H.judge(numbers, {"served_logit_gap": 1.8})


def test_manifest_keeps_to_the_contract():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert data["paths"] == ["benchmark"]
    assert 1 <= data["run_seconds"] <= 51
    cells = 24
    total = (2 + 14 * cells) * (data["run_seconds"] + 60) + cells * 180 \
        + 1200
    assert total <= 43200
    configs = {c["name"] for c in data["configs"]}
    for c in data["configs"]:
        assert name.match(c["name"]) and c["reduced"] == []
        mc = json.loads((ROOT / c["file"]).read_text())
        assert mc["source"] == c["source"]
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for w in data["workloads"]:
        assert name.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "workloads" / (w["traffic"] + ".json")).is_file()
        assert (BENCH / "limits" / (w["name"] + ".json")).is_file()
    for m in data["end_to_end"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in data["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(data)) < 64 * 1024

