"""Device ms of the detector's forward (models/, nn/) a request of the
measured window: CUDA events from the benchmark's forward pre/post hooks
on the detector."""

import numpy as np


def read(trace):
    ms = trace.spans.get("forward")
    return float(np.mean(ms)) if ms else None
