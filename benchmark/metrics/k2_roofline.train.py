"""K2 (csrc/composite_bwd.cu) in training: its roofline share, in %."""


def read(t):
    return t.roofline("k2", "k2") if t.kind == "train" else None
