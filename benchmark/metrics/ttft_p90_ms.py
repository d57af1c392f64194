"""90th percentile, over every request sent inside the window, of the
time from its send to the engine step that returned its first token
(ms; linear between order statistics). Host clock."""

import numpy as np


def read(run):
    v = [(r.first - r.sent) * 1e3 for r in run.requests]
    return float(np.percentile(v, 90)) if v else None
