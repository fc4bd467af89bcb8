"""Device ms a request of 3DSSD's NMS (the `parse.nms` span: the oriented
BEV IoU in each row box's frame, `parse.iou`, the walk and the top-100
cut) over the measured window. Nothing where the program records no such
span."""

import numpy as np


def read(trace):
    ms = trace.spans.get("parse.nms")
    return float(np.mean(ms)) if ms else None
