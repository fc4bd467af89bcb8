"""Device ms a request of the program's fit of its raw scans
(data/kitti.py::fit_scene: the range crop, FPS of the point budget, the
gather and pad), the `data.fit` spans of the measured window summed over
the request's scans. Nothing where the program records no such span."""

import numpy as np


def read(trace):
    ms = trace.spans.get("data.fit")
    return float(np.mean(ms)) if ms else None
