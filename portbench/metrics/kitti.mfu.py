"""The serving program's share of the card's peak on fitted KITTI scans:
the matmul FLOPs of a scene (every Linear at the configuration's shapes,
2 a multiply-add) times the scenes a second of the measured window, over
the peak of the precision that torch's flags select (fp32 67 TFLOP/s)."""


def read(trace):
    return trace.mfu(1)
