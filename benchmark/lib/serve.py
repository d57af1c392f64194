"""The serving loop: a closed loop of clients over the program's
``DecodeEngine``.

Each client sends its next request as soon as its last one has
finished. The loop runs from set-up through a warm-up of
``warmup_requests`` completed requests, then the window opens on it in
steady state and closes at the end of the first engine step that ends
``seconds`` after it opened. Requests sent inside the window are then
drained (nothing new is sent); their tokens after the close are not
counted, their latencies are. Every time is the host's clock when
``engine.step()`` returns the tokens.

The loop knows the engine by its public calls alone (``add_request``,
``step``, ``has_work``): with greedy decoding and no end token a request
is done when it holds its ``max_new`` tokens, and the work of each step
follows from what the step returned. A request whose first token the
step returned was admitted in it, with its whole prompt; each request's
other tokens of the step came from the step's decode chunk, which fed
the request's last token at cache row prompt + tokens before it - 1.
"""

import time

import numpy as np


class Request:
    __slots__ = ("prompt", "max_new", "sent", "first", "last", "tokens",
                 "in_window", "done")

    def __init__(self, prompt, max_new, sent, in_window):
        self.prompt, self.max_new, self.sent = prompt, max_new, sent
        self.in_window = in_window
        self.first = self.last = self.done = None
        self.tokens = []


class ClosedLoop:
    def __init__(self, engine, pool, clients, spans):
        self.engine, self.pool, self.clients = engine, pool, clients
        self.spans = spans
        self.next = 0
        self.inflight = {}
        self.finished = []
        self.steps = []  # (start, end, tokens returned)
        # (start, end, admitted prompt lengths, [(cache rows before the
        # chunk, tokens the chunk returned)] of each request in it)
        self.work = []
        self.sending = True
        self.window = False

    def send(self, now):
        prompt, n = self.pool[self.next % len(self.pool)]
        self.next += 1
        rid = self.engine.add_request(prompt, max_new_tokens=n,
                                      temperature=0.0)
        self.inflight[rid] = Request(prompt, n, now, self.window)

    def start(self):
        now = time.perf_counter()
        for _ in range(self.clients):
            self.send(now)

    def step(self, stop_at=None):
        t_a = time.perf_counter()
        with self.spans("step"):
            out = self.engine.step()
        t_b = time.perf_counter()
        n, admitted, chunk, done = 0, [], [], []
        for rid, toks in out.items():
            r = self.inflight[rid]
            before = len(r.tokens)
            if r.first is None:
                r.first = t_b
                admitted.append(len(r.prompt))
                before, toks_chunk = 1, len(toks) - 1
            else:
                toks_chunk = len(toks)
            if toks_chunk > 0:
                chunk.append((len(r.prompt) + before - 1, toks_chunk))
            r.last = t_b
            r.tokens.extend(toks)
            n += len(toks)
            if len(r.tokens) >= r.max_new:
                done.append(rid)
        self.steps.append((t_a, t_b, n))
        self.work.append((t_a, t_b, admitted, chunk))
        if stop_at is not None and t_b >= stop_at:
            self.sending = False
        for rid in done:
            r = self.inflight.pop(rid)
            r.done = t_b
            self.finished.append(r)
            if self.sending:
                self.send(t_b)
        return t_b

    def window_work(self, t0, t1):
        """The work of the steps inside [t0, t1]: the admission rounds'
        prompt lengths, and each decode chunk as (the requests' (cache
        rows before it, tokens it returned them), its token steps)."""
        steps = [w for w in self.work if w[0] >= t0 and w[1] <= t1]
        return {"admission": [w[2] for w in steps if w[2]],
                "decode": [(w[3], max(k for _, k in w[3]))
                           for w in steps if w[3]],
                "admission_steps": [(w[0], w[1]) for w in steps if w[2]]}


def admission_rounds(run):
    """Wall seconds of the traced window's admission rounds (the spans
    around the engine's ``_admit_all``) in the steps that admitted a
    request."""
    steps = run.work.get("admission_steps", [])
    return [b - a for name, a, b in run.spans.within(run.t0, run.t1)
            if name == "admission"
            and any(s <= a and b <= e for s, e in steps)]


def token_steps(decode):
    """The token steps of recorded chunks: for each, the cache rows before
    it of each request that needs that token (a request's tokens past its
    budget are computed and dropped: not work)."""
    for slots, n in decode:
        for t in range(n):
            ctx = [c + t for c, need in slots if t < need]
            if ctx:
                yield ctx


def run(ctx):
    """Set up, warm up, measure and drain one serving run; fills ``ctx``
    (benchmark.lib.harness.Run) and returns the check's inputs."""
    import torch

    from benchmark.lib import traffic, weights
    from benchmark.lib.trace import Tracer
    from sparsebit_tpu_torch.llm.serving import DecodeEngine

    mc, spec, dev = ctx.mc, ctx.traffic, ctx.device
    maker = weights.Maker(mc, ctx.seed, dev)
    cfg = weights.llama_config(mc)
    eng = spec["engine"]
    engine = DecodeEngine(
        weights.serving_params(maker), cfg, max_batch=eng["max_batch"],
        max_len=eng["max_len"], kv_quantized=eng["kv_cache"], eos_id=None,
        seed=ctx.seed, chunk=eng["chunk"],
        prefix_cache_size=eng["prefix_cache_size"], device=dev)
    pool = traffic.requests(spec, ctx.seed, mc["vocab_size"])
    if max(len(p) + n for p, n in pool) > eng["max_len"]:
        raise ValueError("a request does not fit its slot")
    loop = ClosedLoop(engine, pool, spec["clients"], ctx.spans)
    loop.start()
    while len(loop.finished) < spec["warmup_requests"]:
        loop.step()
    if ctx.traced:
        # the one span inside the engine: its admission round
        engine._admit_all = ctx.spans.wrap("admission", engine._admit_all)
    ctx.sync()
    ctx.open_window()
    loop.window = True
    with Tracer(ctx.traced and dev.type == "cuda") as tr:
        t0 = time.perf_counter()
        while True:
            t_b = loop.step(stop_at=t0 + ctx.seconds)
            if t_b >= t0 + ctx.seconds:
                break
        loop.window = False
        # the drain runs before the trace is read, which takes minutes:
        # the latencies of requests still open at the close count no
        # wait of the benchmark's own; a request the engine ends early
        # stays open and counts as failed
        while engine.has_work and any(r.in_window
                                      for r in loop.inflight.values()):
            loop.step()
    ctx.close_window(t0, t_b, tr.ops)
    ctx.memory_peak()
    # the window's work only: the drain's chunks are outside it
    ctx.work.update(loop.window_work(t0, t_b))
    ctx.steps = [s for s in loop.steps if s[0] >= t0 and s[1] <= t_b]
    ctx.requests = [r for r in loop.finished if r.in_window]
    open_ = sum(r.in_window for r in loop.inflight.values())
    ctx.attempted = len(ctx.requests) + open_
    ctx.failed = open_ + sum(len(r.tokens) != r.max_new
                             for r in ctx.requests)
    del engine, loop
    return ctx.requests


def sample(requests, n, seed):
    """The check's sample: the request with the most served tokens and
    n - 1 others drawn from the seed."""
    if not requests:
        return []
    order = sorted(range(len(requests)),
                   key=lambda i: (-len(requests[i].tokens), i))
    rest = order[1:]
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.permutation(len(rest))[:max(0, n - 1)]
    return [requests[order[0]]] + [requests[rest[i]] for i in sorted(pick)]


def reference_gaps(ctx, reqs, act_bits=8, kv_bits=8, frozen=False,
                   against=None):
    """For each sampled request, at each position whose logits chose a
    served token, the gap by which that token's logit lies below the
    reference's best. With ``against`` (another reference's logits), the
    token is that reference's first choice instead: a control or a fault
    planted in the reference. Returns (widest gap, the reference's
    logits)."""
    import torch

    from benchmark.lib import weights
    from benchmark.reference.decoder import ServeReference

    maker = weights.Maker(ctx.mc, ctx.seed, ctx.device)
    stacks = maker.stacks()
    ref = ServeReference(ctx.mc, maker.layer_weights(stacks), maker.embed(),
                         maker.head(), maker.norms(), maker.gs,
                         act_bits=act_bits, kv_bits=kv_bits, frozen=frozen)
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]),
                            device=ctx.device) for r in reqs]
    logits = ref.logits(seqs, [len(r.prompt) - 1 for r in reqs])
    del stacks
    if against is None:
        return _widest(logits, [torch.as_tensor(r.tokens, device=ctx.device)
                                for r in reqs]), logits
    return _widest(against, [lg.argmax(dim=-1) for lg in logits]), logits


def _widest(ref_logits, tokens):
    worst = 0.0
    for lg, t in zip(ref_logits, tokens):
        gap = lg.max(dim=-1).values - lg.gather(1, t.long()[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst
