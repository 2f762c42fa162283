"""The train shading's host time a step: the self time of the program's
`render.shading` span (K4's call in `models/render_neilf.py::render_view`),
mean over the traced steps.

None where the program keeps no such record (a program without the
tracer, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_ms("train.step", "render.shading")
