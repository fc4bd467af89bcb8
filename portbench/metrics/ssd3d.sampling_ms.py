"""Device ms a request of 3DSSD's sampling: the `sample.dfps` and
`sample.ffps` spans (every D-FPS and F-FPS call of the three levels) of
the measured window, summed over the request. Nothing where the program
records no such span."""

import numpy as np


def read(trace):
    parts = [trace.spans.get(n) for n in ("sample.dfps", "sample.ffps")]
    if not all(parts):
        return None
    return float(np.mean(np.sum(parts, 0)))
