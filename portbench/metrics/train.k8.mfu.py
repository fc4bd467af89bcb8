"""The train step's share of the card's peak: 3 x the forward's matmul
FLOPs a scene (forward, and the two products of the backward) times the
scenes a second of the measured window, over the peak of the precision
that torch's flags select (TF32 495 TFLOP/s where train.bf16_matmul is
on)."""


def read(trace):
    return trace.mfu(3)
