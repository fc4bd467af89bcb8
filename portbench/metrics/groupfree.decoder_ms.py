"""Device ms a request of Group-Free's decoder: the `groupfree.decoder`
span (the 12 layers with their position embeddings and stage box heads)
of the measured window. Nothing where the program records no such span."""

import numpy as np


def read(trace):
    ms = trace.spans.get("groupfree.decoder")
    return float(np.mean(ms)) if ms else None
