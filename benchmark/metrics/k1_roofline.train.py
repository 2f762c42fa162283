"""K1 (csrc/composite_fwd.cu) in training: its roofline share, in %."""


def read(t):
    return t.roofline("k1", "k1") if t.kind == "train" else None
