"""The backward's host time a train step: the whole of the program's
`train.backward` span (the host waits while autograd dispatches the
backward), mean over the traced steps.

None where the program keeps no such record (a program without the
tracer, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_ms("train.step", "train.backward", own=False)
