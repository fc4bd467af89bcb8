"""Group-Free's FPS (B1: ops/cuda/fps.py, csrc/fps.cu) against its
roofline: the least time (counts.fps_cost: n (m - 1) 10 fp32 operations,
points, mask and picks moved once) of a request's FPS calls at the
configuration's shapes (counts/groupfree.py::fps_calls: SA1-SA4; KPS
takes no FPS), over the device time of the FPS kernel. Nothing where the
trace's launches are not the calls counted."""

from portbench.counts import fps_cost
from portbench.counts.groupfree import fps_calls


def read(trace):
    return trace.roofline(fps_calls(trace.model, trace.batch, trace.points),
                          fps_cost, ("fps_cluster_kernel",),
                          "fps_cluster_kernel")
