"""Ball query (ops/cuda/ball_query.py, csrc/ball_query.cu) against its
roofline: the least time of the traced window's ball queries (counts.
ball_query_cost: points, mask and centers read once, indices and counts
written once) over the device time of its kernels (the staging and the
scan). Nothing where the scans in the trace are not the calls counted."""

from portbench.counts import ball_query_calls, ball_query_cost


def read(trace):
    return trace.roofline(ball_query_calls(trace.model, trace.batch,
                                           trace.points), ball_query_cost,
                          ("stage_kernel", "ball_query_kernel"),
                          "ball_query_kernel")
