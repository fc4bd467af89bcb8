"""FPS (ops/cuda/fps.py, csrc/fps.cu) against its roofline on raw scans:
the least time (counts.fps_cost: n (m - 1) 10 fp32 operations, points,
mask and picks moved once) of a request's B1 calls (the forward's, at the
configuration's shapes) and B2 calls (one a scan's fit, n the points each
was given by the FPS wrapper's counter, padding included, over the
profiled window's requests), over the device time of the FPS kernel,
which both entries launch. Nothing where the profiled window's requests
differ in their B2 calls, or the trace's launches are not the calls
counted."""

from portbench.counts import fps_calls, fps_cost


def read(trace):
    points = trace.spans.get("fps_flat.points")
    launches = trace.spans.get("fps_flat.launches")
    if not points or len(points) != trace.units or len(set(launches)) != 1 \
            or not launches[0]:
        return None
    flat = [{"B": 1, "n": sum(points) / sum(launches), "m": trace.points}]
    calls = fps_calls(trace.model, trace.batch, trace.points) \
        + flat * launches[0]
    return trace.roofline(calls, fps_cost, ("fps_cluster_kernel",),
                          "fps_cluster_kernel")
