"""The whole training step's share of the chip's peak: the steps of the
traced window times one step's least time (benchmark.lib.roofline.
train_step, at the configuration's arithmetic) over the window (%)."""

from benchmark.lib.roofline import least_s, train_step


def read(run):
    if not run.work["train"]:
        return None
    q, spec = run.mc["qlora"], run.traffic
    step = least_s(*train_step(run.mc, spec["batch"], spec["seq_len"] - 1,
                               q["targets"], q["r"]))
    return 100.0 * run.work["train"] * step / run.window_s
