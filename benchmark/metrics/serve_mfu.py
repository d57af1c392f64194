"""The whole serving step's share of the chip's peak: the least time of
all the window's admission prefills and decode token steps (each the
larger of its bytes over HBM and its operations over their peaks) over
the traced window (%)."""

from benchmark.lib.roofline import admission_group, decode_step, least_s
from benchmark.lib.serve import token_steps


def read(run):
    if not run.work["admission"] and not run.work["decode"]:
        return None
    least = sum(least_s(*admission_group(run.mc, lens))
                for lens in run.work["admission"])
    least += sum(least_s(*decode_step(run.mc, ctx))
                 for ctx in token_steps(run.work["decode"]))
    return 100.0 * least / run.window_s
