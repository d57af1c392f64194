"""The metrics' arithmetic: rates over the whole window and tails over
every request (a planted stall moves them), the roofline counts against
hand-worked figures, and the trace's busy and idle times."""

import numpy as np
import pytest
import torch

from benchmark.lib import roofline as R
from benchmark.lib import serve
from benchmark.lib.harness import BENCH, Manifest
from benchmark.lib.trace import Spans, breakdown, busy_s, device_time
from benchmark.tests.conftest import ROOT, load


class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


class _Req:
    def __init__(self, rid, prompt, n):
        self.rid, self.prompt, self.max_new = rid, prompt, n
        self.generated = []


class FakeEngine:
    """Slots of a continuous-batching engine whose every step takes
    ``step_s`` on the fake clock (``stall`` more on step ``stall_at``)
    and returns one token a busy slot; a new request's first token comes
    with the step that admits it."""

    def __init__(self, clock, slots=4, step_s=0.1, stall_at=None, stall=0.0):
        self.clock, self.step_s = clock, step_s
        self.stall_at, self.stall = stall_at, stall
        self.slots, self.queue = [None] * slots, []
        self.rid = self.n = 0

    def add_request(self, prompt, max_new_tokens, temperature):
        self.rid += 1
        self.queue.append(_Req(self.rid, prompt, max_new_tokens))
        return self.rid

    def step(self):
        self.n += 1
        self.clock.t += self.step_s + (self.stall if self.n == self.stall_at
                                       else 0.0)
        out = {}
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                self.slots[i] = s = self.queue.pop(0)
            if s is not None:
                s.generated.append(1)
                out[s.rid] = [1]
                if len(s.generated) >= s.max_new:
                    self.slots[i] = None
        return out


def _window(monkeypatch, stall):
    """A closed loop of 8 clients over the fake engine's 4 slots: 20
    warm-up steps, a 5 s window, the drain; returns the run's end-to-end
    metrics."""
    clock = _Clock()
    monkeypatch.setattr(serve.time, "perf_counter", clock)
    eng = FakeEngine(clock, stall_at=40 if stall else None, stall=stall)
    pool = [(np.zeros(8, np.int32), 6)] * 1000
    loop = serve.ClosedLoop(eng, pool, 8, Spans(False))
    loop.start()
    for _ in range(20):
        loop.step()
    loop.window = True
    t0 = clock.t
    while loop.step(stop_at=t0 + 5.0) < t0 + 5.0:
        pass
    t1 = clock.t
    while any(r.in_window for r in loop.inflight.values()):
        loop.step()

    class RunView:
        pass

    run = RunView()
    run.window_s = t1 - t0
    run.steps = [s for s in loop.steps if s[0] >= t0 and s[1] <= t1]
    run.requests = [r for r in loop.finished if r.in_window]
    man = Manifest(ROOT)
    return {m: man.reader(m)(run) for m in
            ("serve_tok_s", "ttft_p90_ms", "tpot_p90_ms")}, run


def test_planted_stall_lowers_rate_and_raises_tails(monkeypatch):
    base, run0 = _window(monkeypatch, 0.0)
    hit, run1 = _window(monkeypatch, 2.0)
    # 4 slots, one token each every 0.1 s: 40 tokens/s without the stall
    assert base["serve_tok_s"] == pytest.approx(40.0, rel=0.03)
    assert hit["serve_tok_s"] < 0.8 * base["serve_tok_s"]
    assert hit["ttft_p90_ms"] > base["ttft_p90_ms"]
    assert hit["tpot_p90_ms"] > base["tpot_p90_ms"]
    # every request sent in the window is in the tails, none left open
    assert all(r.done is not None for r in run1.requests)
    assert len(run1.requests) >= 4


def test_mistral_layer_bytes_by_hand():
    mc = load("configs", "mistral-7b-v0.3-w4g128")
    lins = R.serve_linears(mc)
    weights = sum(K * N for K, N in lins)
    assert weights == 218_103_808  # 218.1 M weights a layer
    assert sum(K * N // 2 for K, N in lins) == 109_051_904  # codes
    qp = sum(R.w4_bytes(K, N, 128, 2) for K, N in lins) - 109_051_904
    assert qp == 6_815_744  # bf16 scales and zeros: 6.8 MB
    # K1 over 100 prompt tokens of wqkv: operations and bytes
    ops, nb = R.k1_launch(100, 4096, 6144, 128)
    assert ops == {"int8": 2 * 100 * 4096 * 6144}
    assert nb == 4096 * 6144 // 2 + 2 * 32 * 6144 * 2 + 100 * 4096 \
        + 100 * 6144 * 2


def test_k4_step_by_hand():
    mc = load("configs", "mistral-7b-v0.3-w4g128")
    ops, nb = R.k4_step(mc, [0, 99])
    L, Hkv, hd, H = 32, 8, 128, 32
    kv = L * (1 + 100) * Hkv * (hd + 4) * 2 + L * 2 * Hkv * (hd + 4) * 2
    assert nb == 32 * (109_051_904 + 6_815_744) + kv + 2 * 2 * 4096 * 4
    assert ops["int8"] == 2 * 32 * 2 * 218_103_808
    assert ops["bf16"] == 4 * L * H * hd * 101
    # bytes bound it: ~3.7 GB of weights at 3.35 TB/s
    assert R.least_s(ops, nb) == pytest.approx(nb / 3.35e12)


def test_token_steps_count_only_the_tokens_a_slot_needs():
    # two slots before a chunk of 4: 10 rows needing 2 more tokens, 20
    # rows needing 9
    steps = list(serve.token_steps([([(10, 2), (20, 9)], 4)]))
    assert steps == [[10, 20], [11, 21], [22], [23]]
    assert list(serve.token_steps([([(5, 0)], 8)])) == []


class _Scripted:
    """An engine whose steps return scripted tokens."""

    def __init__(self, outs):
        self.outs = list(outs)
        self.rid = 0

    def add_request(self, prompt, max_new_tokens, temperature):
        self.rid += 1
        return self.rid

    def step(self):
        return self.outs.pop(0)


def test_work_follows_from_what_the_steps_returned():
    # request 1 (10-token prompt) is admitted in step 1 with two chunk
    # tokens after its first; request 2 (20 tokens) in step 2, which
    # also decodes request 1 (3 tokens so far: its next token is fed at
    # row 10 + 3 - 1)
    pool = [(np.zeros(10, np.int32), 5), (np.zeros(20, np.int32), 4)]
    loop = serve.ClosedLoop(_Scripted([{1: [7, 7, 7]},
                                       {1: [7, 7], 2: [7, 7, 7]}]),
                            pool, 2, Spans(False))
    loop.start()
    loop.step()
    loop.step()
    work = loop.window_work(0.0, float("inf"))
    assert work["admission"] == [[10], [20]]
    assert work["decode"] == [([(10, 2)], 2), ([(12, 2), (20, 2)], 2)]
    # request 1 holds its 5 tokens and is done, its client has sent its
    # next; request 2 is open
    assert [len(r.tokens) for r in loop.finished] == [5]
    assert sorted(len(r.tokens) for r in loop.inflight.values()) == [0, 3]


def test_work_matches_the_engine_on_a_tiny_run(cpu_threads):
    """The work the loop derives from its own records is what the
    engine's decode chunks were handed (read here from its internals)."""
    from benchmark.lib import traffic, weights
    from benchmark.tests.conftest import tiny_chat
    from sparsebit_tpu_torch.llm.serving import DecodeEngine

    mc, tr = tiny_chat()
    dev = torch.device("cpu")
    eng = tr["engine"]
    engine = DecodeEngine(
        weights.serving_params(weights.Maker(mc, 5, dev)),
        weights.llama_config(mc), max_batch=eng["max_batch"],
        max_len=eng["max_len"], eos_id=None, chunk=eng["chunk"], device=dev)
    seen = []
    real = engine._decode_chunk_call

    def chunk(temps, n):
        seen.append(sorted(
            (len(s.prompt) + len(s.generated) - 1,
             min(n, s.max_new_tokens - len(s.generated)))
            for s in engine.slots if s is not None
            and s.max_new_tokens > len(s.generated)))
        return real(temps, n)

    engine._decode_chunk_call = chunk
    pool = traffic.requests(tr, 5, mc["vocab_size"])
    loop = serve.ClosedLoop(engine, pool, tr["clients"], Spans(False))
    loop.start()
    for _ in range(12):
        loop.step()
    derived = [sorted(c) for c, _ in
               loop.window_work(0.0, float("inf"))["decode"]]
    assert derived == [s for s in seen if s]
    assert len(derived) >= 10


def test_k10_forward_by_hand():
    # the qlora cell's launch: B=16, S=256, 32 heads of 128
    ops, nb = R.k10_forward(16, 256, 32, 32, 128)
    assert ops == {"bf16": 2 * 2 * 32 * 128 * 16 * (256 * 257 // 2)}
    assert nb == 16 * 256 * 32 * 128 * 2 * 4 + 16 * 256 * 32 * 4
    # 8.6 GFLOP (8.7 us at 989 TFLOP/s) against 34.1 MB (10.2 us)
    assert R.least_s(ops, nb) == pytest.approx(nb / 3.35e12)


def test_qlora_step_by_hand():
    mc = load("configs", "deepseek-llm-7b-base-w4g128-qlora")
    ops, nb = R.train_step(mc, 16, 256, ["wq", "wv"], 8)
    per_layer = 4 * 4096 * 4096 + 3 * 4096 * 11008  # 202.4 M weights
    T = 16 * 256
    lora = 30 * 2 * 3 * 2 * T * 8 * (4096 + 4096)
    assert ops["f32"] == lora
    assert ops["int8"] == 30 * 2 * T * per_layer
    attn = 30 * 6 * 2 * 32 * 128 * 16 * (256 * 257 // 2)
    assert ops["bf16"] == 30 * 2 * T * per_layer + attn \
        + 2 * 2 * T * 4096 * 102400
    # operations bound it: the bf16 forward (5.0e13) at 989 TFLOP/s, the
    # int8 input gradients at 1979 TOP/s, attention, the head and the
    # adapters: ~0.085 s a step
    assert R.least_s(ops, nb) == pytest.approx(
        ops["f32"] / 67e12 + ops["int8"] / 1979e12 + ops["bf16"] / 989e12)
    assert 0.08 < R.least_s(ops, nb) < 0.09


def test_busy_idle_and_breakdown():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("a", 3.0, 4.0)]
    spans = Spans(True)
    spans.items = [("step", 0.0, 5.0), ("admission", 1.6, 2.9)]
    assert busy_s(ops, 0.0, 5.0) == pytest.approx(2.5)
    assert busy_s(ops, 0.25, 3.5) == pytest.approx(1.75)
    assert device_time(ops, {"a"}, 0.0, 5.0) == pytest.approx(2.0)
    assert device_time(ops, {"c"}, 0.0, 5.0) is None
    bd = breakdown(ops, spans.items, 0.0, 5.0)
    assert bd["device_ops"][0] == ["a", pytest.approx(2.0)]
    names = dict((k, v) for k, v in bd["idle_gaps"])
    assert names["admission"] == pytest.approx(1.5)  # 1.5 .. 3.0
    assert names["step"] == pytest.approx(1.0)  # 4.0 .. 5.0


def test_each_metric_has_a_reader():
    man = Manifest(ROOT)
    for kind in ("end_to_end", "per_layer"):
        for m in man.data[kind]:
            assert callable(man.reader(m["name"]))
            assert (BENCH / "metrics" / (m["name"] + ".py")).is_file()
