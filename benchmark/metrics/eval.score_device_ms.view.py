"""The scoring's device time a scored view (PSNR, SSIM and LPIPS of the
PBR render and of the albedo, the roughness MSE): the interval between
the CUDA events of the program's `eval.score` span
(`cli/eval_relighting_syn4.py::relight_view`), mean over the traced
`eval.view` units.

None where the program keeps no such record (a program without the
span, or a run off the card)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_device_ms("eval.view", "eval.score")
