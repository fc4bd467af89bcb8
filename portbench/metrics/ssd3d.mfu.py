"""The 3DSSD serving program's share of the card's peak: the matmul FLOPs
of a scene (counts/ssd3d.py: every Linear at the configuration's shapes,
2 a multiply-add) times the measured window's scenes a second, over the
peak of the precision that torch's flags select (fp32 67 TFLOP/s)."""

from portbench.counts import PEAK_FLOPS
from portbench.counts.ssd3d import forward_flops


def read(trace):
    if not trace.scenes_per_s:
        return None
    return 100.0 * forward_flops(trace.model) * trace.scenes_per_s \
        / PEAK_FLOPS[trace.precision]
