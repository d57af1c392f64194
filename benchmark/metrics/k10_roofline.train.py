"""K10 (``flash_fwd_sm90_kernel``, the bf16 causal flash forward with
its lse output), one launch a layer a training step: the least time of
the window's launches (the causal half of the two products, or q, k, v
read and o and the lse written once, whichever is longer) over K10's
device time in the trace (%)."""

from benchmark.lib.roofline import k10_forward, least_s, shapes
from benchmark.lib.trace import device_time

KERNELS = {"flash_fwd_sm90_kernel"}


def read(run):
    if not run.ops or not run.work["train"]:
        return None
    dev = device_time(run.ops, KERNELS, run.t0, run.t1)
    if not dev:
        return None
    D, L, H, Hkv, hd, F, V = shapes(run.mc)
    spec = run.traffic
    one = least_s(*k10_forward(spec["batch"], spec["seq_len"] - 1, H, Hkv,
                               hd))
    return 100.0 * run.work["train"] * L * one / dev
