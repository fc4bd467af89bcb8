"""Device ms of box decode and class-aware NMS (eval/parse.py, ops/nms.py)
a request of the measured window: from the CUDA event at the detector's
forward end to the one recorded when the serving program returns."""

import numpy as np


def read(trace):
    ms = trace.spans.get("parse_nms")
    return float(np.mean(ms)) if ms else None
