"""One run of one cell: the manifest and the files it names, the run's
state, its metrics, the check that decides ``correct``, and the result.

Everything that belongs to one configuration, traffic mix, metric or
cell is a file found by name (``BENCHMARK.json`` gives the names):

- ``<config file>``: the published config.json with ``quantization``
  (and, for training, ``qlora``) blocks;
- ``<bench>/workloads/<traffic>.json``: the mix, with its ``loop``
  (``serve`` or ``train``, modules of ``benchmark.lib``);
- ``<bench>/metrics/<metric>.py``: ``read(run)``, the metric's value or
  None when the run has nothing for it to read;
- ``<bench>/limits/<cell>.json``: the limit of each number the check
  compares.
"""

import importlib.util
import json
import math
import statistics
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


class Manifest:
    def __init__(self, root, bench=BENCH):
        self.root, self.bench = Path(root), Path(bench)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload {!r} in BENCHMARK.json".format(name))

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError("no config {!r} in BENCHMARK.json".format(name))

    def _json(self, sub, name):
        return json.loads((self.bench / sub / (name + ".json")).read_text())

    def traffic(self, name):
        return self._json("workloads", name)

    def limits(self, cell):
        return self._json("limits", cell)

    def metrics(self, cell, kind):
        """The ``kind`` ("end_to_end" or "per_layer") metrics this cell
        reports: those that list it, and those without a list that move
        an end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.data["end_to_end"]
               if cell in m.get("workloads", [cell])}
        out = []
        for m in self.data[kind]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def reader(self, metric):
        path = self.bench / "metrics" / (metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """The state of one run: what the run measured and recorded, on
    the host clock (``time.perf_counter``)."""

    def __init__(self, cell, mc, traffic, limits, seed, seconds, traced,
                 device, t_start, faults=None):
        from benchmark.lib.trace import Spans

        self.cell, self.mc, self.traffic, self.limits = cell, mc, traffic, \
            limits
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device, self.t_start = device, t_start
        self.faults = faults or {}
        self.spans = Spans(traced)
        self.work = {"admission": [], "decode": [], "train": 0}
        self.ops = None
        self.peak = 0
        self.steps, self.requests = [], []
        self.attempted = self.failed = 0

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()

    def open_window(self):
        self.setup_s = time.perf_counter() - self.t_start

    def close_window(self, t0, t1, ops):
        self.t0, self.t1, self.window_s, self.ops = t0, t1, t1 - t0, ops

    def memory_peak(self):
        if self.device.type == "cuda":
            import torch

            self.peak = torch.cuda.max_memory_allocated()


def _free():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def median_leaf_gap(prog, ref, keep):
    """Worst leaf of |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm(ref)), over the leaves in ``keep``."""
    pn = {k: float(prog[k].norm()) for k in keep}
    rn = {k: float(ref[k].norm()) for k in keep}
    med = statistics.median(rn.values()) if rn else float("nan")
    return max((abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep),
               default=float("nan"))


def median_leaf_diff(prog, ref, keep):
    """Worst leaf of norm(prog - ref) over max(norm(ref), the median
    leaf's norm(ref)), over the leaves in ``keep``."""
    rn = {k: float(ref[k].norm()) for k in keep}
    med = statistics.median(rn.values()) if rn else float("nan")
    return max((float((prog[k] - ref[k]).norm()) / max(rn[k], med)
                for k in keep), default=float("nan"))


def check_numbers(ctx, loop, out):
    """The numbers that decide ``correct``, by name (each has a limit in
    ``limits/<cell>.json``)."""
    if ctx.traffic["loop"] == "serve":
        reqs = loop.sample(out, ctx.traffic["check_sample"], ctx.seed)
        _free()
        if not reqs:
            # no request finished in the window: nothing was compared,
            # so there is no number, and the run is not correct
            return {"served_logit_gap": float("nan")}
        gap, _ = loop.reference_gaps(ctx, reqs)
        return {"served_logit_gap": gap}
    batches, lora0, losses, first, after = out
    _free()
    r_losses, r_first, r_after, r_gmax = loop.reference(ctx, batches, lora0)
    return train_gaps(losses, first, after, lora0, r_losses, r_first,
                      r_after, r_gmax)


def train_gaps(losses, first, after, lora0, r_losses, r_first, r_after,
               r_gmax):
    """The training cell's four numbers: the worst step's relative loss
    gap; by the worst leaf the gap of the first gradient's norm and of
    the change's norm over the checked steps; and by the worst leaf the
    norm of the first gradient's difference, which the gaps of norms
    miss where a gradient turns without growing. Leaves whose reference
    gradient stays under a thousandth of the median leaf's (nought to
    rounding, moved by AdamW's round-off alone) are left out."""
    med = statistics.median(r_gmax.values())
    moving = [k for k, g in r_gmax.items() if g >= 1e-3 * med]
    g1 = statistics.median(float(t.norm()) for t in r_first.values())
    first_keep = [k for k in moving if float(r_first[k].norm()) >= 1e-3 * g1]
    delta = {k: after[k] - lora0[k] for k in after}
    r_delta = {k: r_after[k] - lora0[k] for k in r_after}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                             r_losses)),
        "grad_norm_gap": median_leaf_gap(first, r_first, first_keep),
        "change_norm_gap": median_leaf_gap(delta, r_delta, moving),
        "grad_diff": median_leaf_diff(first, r_first, first_keep),
    }


def judge(numbers, limits):
    return all(v == v and v <= limits[k] for k, v in numbers.items())


def execute(man, ctx):
    """Drive the cell, read its metrics and check it. Returns the
    result's fields but ``device``'s name."""
    import importlib

    loop = importlib.import_module("benchmark.lib." + ctx.traffic["loop"])
    out = loop.run(ctx)
    metrics, other = {}, {}
    for kind in ("end_to_end", "per_layer"):
        for m in man.metrics(ctx.cell, kind):
            v = man.reader(m["name"])(ctx)
            if v is not None:
                traced_kind = kind == "per_layer"
                (metrics if traced_kind == ctx.traced else other)[
                    m["name"]] = {"value": v, "unit": m["unit"]}
    # the other kind's values, for standard error: a traced run's
    # end-to-end metrics show what the tracing costs
    ctx.other_metrics = {k: v["value"] for k, v in other.items()}
    numbers = check_numbers(ctx, loop, out)
    limits = {k: ctx.limits[k] for k in numbers}
    result = {"correct": judge(numbers, limits) and ctx.failed == 0,
              "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics}
    device = {"platform": "gpu", "count": 1, "memory_peak_bytes": ctx.peak}
    if ctx.traced and ctx.ops is not None:
        from benchmark.lib.trace import breakdown, busy_s

        device["busy_s"] = busy_s(ctx.ops, ctx.t0, ctx.t1)
        device["window_s"] = ctx.window_s
        result["breakdown"] = breakdown(ctx.ops, ctx.spans.items, ctx.t0,
                                        ctx.t1)
    result["device"] = device
    # a number that is not finite prints as null: the line stays JSON
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": limits[k]}
                        for k, v in numbers.items()}
    return result
