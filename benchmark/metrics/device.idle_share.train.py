"""The device's idle share of a traced training window, in %: 1 - the union
of its activity intervals over the window."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.kind == "train" else None
