"""Group-Free's ball queries (ops/cuda/ball_query.py,
csrc/ball_query.cu) against their roofline: the least time
(counts.ball_query_cost: points, mask and centres read once, indices and
counts written once) of a request's ball queries (counts/groupfree.py::
ball_query_calls: SA1-SA4), over the device time of their kernels (the
staging and the scan). Nothing where the scans in the trace are not the
calls counted."""

from portbench.counts import ball_query_cost
from portbench.counts.groupfree import ball_query_calls


def read(trace):
    return trace.roofline(ball_query_calls(trace.model, trace.batch,
                                           trace.points), ball_query_cost,
                          ("stage_kernel", "ball_query_kernel"),
                          "ball_query_kernel")
