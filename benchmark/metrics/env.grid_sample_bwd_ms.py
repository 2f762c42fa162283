"""The env light's lookup (models/lights.py, F.grid_sample): device ms a
step of the kernels of grid_sample's backward, by name (cuDNN's
bilinear_sampler_bw or ATen's grid_sampler_2d_backward)."""


def read(t):
    if t.kind != "train" or not t.units:
        return None
    s = (t.device_s_matching("bilinear_sampler_bw")
         + t.device_s_matching("grid_sampler", "backward"))
    return 1e3 * s / t.units if s > 0 else None
