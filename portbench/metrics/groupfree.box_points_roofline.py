"""The point-count kernel (ops/cuda/box_points.py, csrc/box_points.cu)
against its roofline: the least time (counts/groupfree.py::
box_points_cost: B P N point-box tests of 9 fp32 operations, or one read
of each scene's points and mask and of the boxes and one write of the
counts, whichever bound is larger) of a request's count at the
configuration's shapes, over the device time of the kernel
(`box_points_kernel`). Nothing where the trace's launches are not one a
request."""

from portbench.counts.groupfree import box_points_calls, box_points_cost


def read(trace):
    return trace.roofline(box_points_calls(trace.model, trace.batch,
                                           trace.points), box_points_cost,
                          ("box_points_kernel",), "box_points_kernel")
