"""Device ms a request of Group-Free's parse: the `parse.decode`,
`parse.box_points` (the non-empty filter's point count) and `parse.nms`
spans of the measured window, summed over the request. Nothing where the
program records no such span."""

import numpy as np


def read(trace):
    parts = [trace.spans.get(n)
             for n in ("parse.decode", "parse.box_points", "parse.nms")]
    if not all(parts):
        return None
    return float(np.mean(np.sum(parts, 0)))
