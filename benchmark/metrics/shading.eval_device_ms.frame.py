"""The eval shading's device time a frame: the interval between the CUDA
events of the program's `render.shading` span
(`models/render_neilf.py::_shade_points`), mean over the traced frames.

None where the program keeps no such record (a program without the
tracer, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_device_ms("render.view", "render.shading")
