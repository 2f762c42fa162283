"""K4 (csrc/shading.cu: forward, backward and fix-up) in stage-2 training:
their roofline share, in %."""


def read(t):
    return t.roofline("k4", "k4") if t.kind == "train" else None
