"""The Group-Free serving program's share of the card's peak: the matmul
FLOPs of a scene (counts/groupfree.py: every Linear and the attention's
Q K^T and A V at the configuration's shapes, 2 a multiply-add) times the
measured window's scenes a second, over the peak of the precision that
torch's flags select (fp32 67 TFLOP/s)."""

from portbench.counts import PEAK_FLOPS
from portbench.counts.groupfree import forward_flops


def read(trace):
    if not trace.scenes_per_s:
        return None
    return 100.0 * forward_flops(trace.model) * trace.scenes_per_s \
        / PEAK_FLOPS[trace.precision]
