"""The host's waits for a device value a frame: what the program's
`host.syncs` counter counted inside each `render.view`, mean over the
traced frames.

None where the program keeps no such record (a program without the
tracer, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_count("render.view", "host.syncs")
