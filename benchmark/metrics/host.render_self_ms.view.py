"""The render's own host work a scored view (features, the compositor's
wrapper, unpacking, surfaces, the env lookup): the self time of the
program's `render.view` span inside each `eval.view` unit
(`cli/eval_relighting_syn4.py::relight_view`), mean over the traced
units.

None where the program keeps no such record (a program without the
span, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_ms("eval.view", "render.view")
