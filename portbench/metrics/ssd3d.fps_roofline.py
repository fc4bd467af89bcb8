"""3DSSD's D-FPS (B1: ops/cuda/fps.py, csrc/fps.cu) against its roofline:
the least time (counts.fps_cost: n (m - 1) 10 fp32 operations, points,
mask and picks moved once) of a request's D-FPS calls at the
configuration's shapes (counts/ssd3d.py::dfps_calls: SA1's, SA2's and
SA3's, each over its index range), over the device time of the FPS
kernel. Nothing where the trace's launches are not the calls counted."""

from portbench.counts import fps_cost
from portbench.counts.ssd3d import dfps_calls


def read(trace):
    return trace.roofline(dfps_calls(trace.model, trace.batch, trace.points),
                          fps_cost, ("fps_cluster_kernel",),
                          "fps_cluster_kernel")
