"""90th percentile, over every request sent inside the window, of
(last token's time - first token's time) / (tokens - 1) (ms; linear
between order statistics). Host clock."""

import numpy as np


def read(run):
    v = [(r.last - r.first) * 1e3 / (len(r.tokens) - 1)
         for r in run.requests if len(r.tokens) > 1]
    return float(np.percentile(v, 90)) if v else None
