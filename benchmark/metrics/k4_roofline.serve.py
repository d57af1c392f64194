"""K4 (``layers_fused_kernel``), one launch a decode token step: the
least time of the window's token steps (every layer's weights once, the
K/V rows each slot that needs the token really holds, or the
operations, whichever is longer) over K4's device time in the trace
(%)."""

from benchmark.lib.roofline import k4_step, least_s
from benchmark.lib.serve import token_steps
from benchmark.lib.trace import device_time

KERNELS = {"layers_fused_kernel"}


def read(run):
    if not run.ops or not run.work["decode"]:
        return None
    dev = device_time(run.ops, KERNELS, run.t0, run.t1)
    if not dev:
        return None
    least = sum(least_s(*k4_step(run.mc, ctx))
                for ctx in token_steps(run.work["decode"]))
    return 100.0 * least / dev
