"""The whole frame's share of the H100's FP32 peak, in %."""


def read(t):
    return t.mfu("frame") if t.kind == "frame" else None
