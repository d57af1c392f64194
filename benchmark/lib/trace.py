"""Spans on the host clock and the device trace of the measured window.

``Spans`` records the benchmark's own spans, around the calls it makes
into the program, as (name, start, end) on the host clock. ``Tracer``
runs ``torch.profiler`` over the window with the device's activity alone
(the benchmark's copy of ``sparsebit_tpu_torch.utils.profiling.trace``),
and puts the device's operations on the host clock through a marker:
right after the profiler starts, the host waits for the device, reads
its clock and launches one small operation, the trace's first; its
device start is taken as that host time.
"""

import contextlib
import time


class Spans:
    def __init__(self, on):
        self.on = on
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def wrap(self, name, fn):
        def wrapped(*args, **kw):
            with self(name):
                return fn(*args, **kw)

        return wrapped

    def within(self, t0, t1):
        return [s for s in self.items if s[1] >= t0 and s[2] <= t1]


def short_name(name):
    """A kernel's name without its signature, template arguments and
    namespaces: ``void ns::k<4>(int)`` -> ``k``."""
    n = name.replace("(anonymous namespace)::", "").strip()
    if n.startswith("void "):
        n = n[5:]
    n = n.split("(")[0].split("<")[0].strip()
    return n.split("::")[-1].strip() or name[:60]


class Tracer:
    """``with Tracer(on) as tr: ...`` traces the block when ``on``;
    afterwards ``tr.ops`` lists the device operations as (short name,
    host start, host end) in seconds of ``time.perf_counter``."""

    def __init__(self, on):
        self.on = on
        self.ops = None
        self.marker_host = None

    def __enter__(self):
        if not self.on:
            return self
        import torch

        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter()
        torch.ones(1, device="cuda").add_(1)
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        dev = []
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((e.time_range.start, e.time_range.end, e.name))
        dev.sort()
        if not dev:
            self.ops = []
            return False
        base = dev[0][0]  # the marker
        self.ops = [(short_name(n), self.marker_host + (a - base) * 1e-6,
                     self.marker_host + (b - base) * 1e-6)
                    for a, b, n in dev[1:]]
        return False


def busy_intervals(ops, t0, t1):
    """The union of the operations' intervals clipped to [t0, t1], as a
    sorted list of disjoint (start, end)."""
    out = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(ops, t0, t1):
    return sum(b - a for a, b in busy_intervals(ops, t0, t1))


def device_time(ops, names, t0, t1):
    """Device seconds of the operations named ``names`` inside [t0, t1],
    or None when none of them ran."""
    hit = [(a, b) for n, a, b in ops if n in names and b > t0 and a < t1]
    if not hit:
        return None
    return sum(min(b, t1) - max(a, t0) for a, b in hit)


def breakdown(ops, spans, t0, t1, top=10):
    """The device operations that took most time, and the device's idle
    time by the innermost host span it fell in ("loop" outside every
    span): at most ``top`` of each, the largest first."""
    by_op = {}
    for n, a, b in ops:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            by_op[n] = by_op.get(n, 0.0) + (b - a)
    busy = busy_intervals(ops, t0, t1)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t1 > prev:
        gaps.append((prev, t1))
    by_span = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        name = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "loop"
        by_span[name] = by_span.get(name, 0.0) + (b - a)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}
