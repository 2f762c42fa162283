"""K1 (csrc/composite_fwd.cu) on frames: its roofline share, in %."""


def read(t):
    return t.roofline("k1", "k1") if t.kind == "frame" else None
