"""Device ms a request of 3DSSD's stage after the backbone: the
`ssd3d.vote`, `ssd3d.cg` (candidate generation) and `ssd3d.head` spans of
the measured window, summed over the request. Nothing where the program
records no such span."""

import numpy as np


def read(trace):
    parts = [trace.spans.get(n)
             for n in ("ssd3d.vote", "ssd3d.cg", "ssd3d.head")]
    if not all(parts):
        return None
    return float(np.mean(np.sum(parts, 0)))
