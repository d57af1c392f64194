"""Share of the traced training window in which no operation ran on the
device (%)."""

from benchmark.lib.trace import busy_s


def read(run):
    if not run.ops:
        return None
    return 100.0 * (1.0 - busy_s(run.ops, run.t0, run.t1) / run.window_s)
