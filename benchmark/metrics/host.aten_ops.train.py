"""The host's dispatch: aten ops a train step (every aten op the profiler
records, nested ones too)."""


def read(t):
    return t.aten_ops() / t.units if t.kind == "train" and t.units else None
