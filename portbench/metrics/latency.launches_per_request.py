"""Kernel launches a request of the serving entry (serving.py): the
kernels in the traced window over the requests completed in it."""


def read(trace):
    if not trace.units:
        return None
    return sum(n for _, n in trace.kernels.values()) / trace.units
