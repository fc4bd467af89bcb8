"""The share of the traced window (wall time, from its first host range to
the end of its last device op) in which no operation ran on the device."""


def read(trace):
    return trace.idle_share()
