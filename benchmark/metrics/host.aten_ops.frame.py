"""The host's dispatch: aten ops a frame."""


def read(t):
    return t.aten_ops() / t.units if t.kind == "frame" and t.units else None
