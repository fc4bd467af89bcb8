"""Device ms a request of Group-Free's attention: the `decoder.self_attn`
and `decoder.cross_attn` spans (each with its residual and LayerNorm) of
the measured window, summed over the request's 12 layers. Nothing where
the program records no such span."""

import numpy as np


def read(trace):
    parts = [trace.spans.get(n)
             for n in ("decoder.self_attn", "decoder.cross_attn")]
    if not all(parts):
        return None
    return float(np.mean(np.sum(parts, 0)))
