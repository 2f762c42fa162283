"""The whole train step's share of the H100's FP32 peak, in %: the counted
operations of the traced steps over the traced window's time."""


def read(t):
    return t.mfu("step") if t.kind == "train" else None
