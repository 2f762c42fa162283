"""The host's waits for a device value a train step: what the program's
`host.syncs` counter counted inside each `train.step`, mean over the
traced steps.

None where the program keeps no such record (a program without the
tracer, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_count("train.step", "host.syncs")
