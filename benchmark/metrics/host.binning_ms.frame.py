"""The binning's host time a frame, its wait for the pair count included:
the self time of the program's `render.binning` span
(`ops/tiles.py::bin_gaussians`), mean over the traced frames.

None where the program keeps no such record (a program without the
tracer, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_ms("render.view", "render.binning")
