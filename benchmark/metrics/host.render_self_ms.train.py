"""The render's own host work a train step (features, the compositor's
wrapper, unpacking, surfaces): the self time of the program's
`render.view` span, mean over the traced steps.

None where the program keeps no such record (a program without the
tracer, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_ms("train.step", "render.view")
