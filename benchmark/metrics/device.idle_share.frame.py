"""The device's idle share of a traced frame loop, in %."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.kind == "frame" else None
