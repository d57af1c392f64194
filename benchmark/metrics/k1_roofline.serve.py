"""K1 (``qmm_s4_kernel`` and its ``split_sum_kernel``) at admission: the
least time of the window's admission groups' K1 launches, from the real
prompt tokens (not the bucket), over K1's device time in the trace (%)."""

from benchmark.lib.roofline import k1_group, least_s
from benchmark.lib.trace import device_time

KERNELS = {"qmm_s4_kernel", "split_sum_kernel"}


def read(run):
    if not run.ops or not run.work["admission"]:
        return None
    dev = device_time(run.ops, KERNELS, run.t0, run.t1)
    if not dev:
        return None
    least = sum(least_s(*k1_group(run.mc, lens))
                for lens in run.work["admission"])
    return 100.0 * least / dev
