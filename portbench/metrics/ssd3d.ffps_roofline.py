"""3DSSD's feature-space FPS (ops/cuda/ffps.py, csrc/ffps.cu) against its
roofline: the least time (counts/ssd3d.py::ffps_cost: n d 3 (m - 1) fp32
operations, the points, mask and picks moved once) of a request's F-FPS
calls at the configuration's shapes, over the device time of the kernel
(`ffps_kernel`). Nothing where the profiled window's requests differ in
their launches by the wrapper's counter, or the trace's launches are not
the calls counted."""

from portbench.counts.ssd3d import ffps_calls, ffps_cost


def read(trace):
    launches = trace.spans.get("ffps.launches")
    if not launches or len(launches) != trace.units \
            or len(set(launches)) != 1:
        return None
    calls = ffps_calls(trace.model, trace.batch, trace.points)
    if launches[0] != len(calls):
        return None
    return trace.roofline(calls, ffps_cost, ("ffps_kernel",), "ffps_kernel")
