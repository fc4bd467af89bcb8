"""FPS (ops/cuda/fps.py, csrc/fps.cu) against its roofline: the least time
of the traced window's FPS calls (counts.fps_cost: n (m - 1) 10 fp32
operations, points, mask and picks moved once) over the device time of
the FPS kernel. Nothing where the trace's launches are not the calls
counted."""

from portbench.counts import fps_calls, fps_cost


def read(trace):
    return trace.roofline(fps_calls(trace.model, trace.batch, trace.points),
                          fps_cost, ("fps_cluster_kernel",),
                          "fps_cluster_kernel")
