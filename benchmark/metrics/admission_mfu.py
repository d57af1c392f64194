"""The admission step's share of the chip's peak: the least time of the
window's admission prefills (K1's linears, attention over each real
prompt, the K/V rows written, the head on each last row) over the wall
time of the engine's admission rounds that admitted them (the
benchmark's spans around ``_admit_all``), in the traced window (%)."""

from benchmark.lib.roofline import admission_group, least_s
from benchmark.lib.serve import admission_rounds


def read(run):
    wall = sum(admission_rounds(run))
    if not wall or not run.work["admission"]:
        return None
    least = sum(least_s(*admission_group(run.mc, lens))
                for lens in run.work["admission"])
    return 100.0 * least / wall
