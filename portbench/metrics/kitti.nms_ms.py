"""Device ms a request of the program's NMS (the `parse.nms` span: the
oriented BEV IoU, `parse.iou`, and the walk) over the measured window.
Nothing where the program records no such span."""

import numpy as np


def read(trace):
    ms = trace.spans.get("parse.nms")
    return float(np.mean(ms)) if ms else None
