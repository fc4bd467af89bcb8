"""The scatter (ops/cuda/scatter.py, csrc/scatter.cu), the gathers'
backward, against its roofline: the least time of the traced window's
scatters (counts.scatter_cost: gradient rows and indices read once, the
output written once) over the scatter kernel's device time. Nothing where
the trace's launches are not the calls counted."""

from portbench.counts import scatter_calls, scatter_cost


def read(trace):
    return trace.roofline(scatter_calls(trace.model, trace.batch,
                                        trace.points), scatter_cost,
                          ("scatter_kernel",), "scatter_kernel")
