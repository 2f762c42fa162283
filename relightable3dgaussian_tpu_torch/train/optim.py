"""Per-field Adam (port of relightable3dgaussian_tpu/train/optim.py).

One `torch.optim.Adam` parameter group per `GaussianModel` field present,
each named after its field, with the JAX package's learning rates
(`learning_rates`): xyz follows `expon_lr` and is set before every step.
betas (0.9, 0.999) and eps 1e-15; torch's update
lr/bc1 · m / (sqrt(v)/sqrt(bc2) + eps) is the JAX package's `adam_step`, and
a separate Adam over the env map (`make_env_optimizer`) is its
`array_adam_step`. Densification replaces parameters and re-keys the
optimizer's state (models/gaussians.py). `start_state` writes Adam's state
explicitly (torch creates it lazily at the first step), for the stage-2
restart: zero moments for every field, the step count carried over.
"""
from __future__ import annotations

import torch

from ..models.gaussians import GaussianModel
from ..models.lights import DirectLightMap
from ..utils.lr_schedule import expon_lr
from .config import OptimizationConfig

BETAS = (0.9, 0.999)
EPS = 1e-15


def learning_rates(opt: OptimizationConfig, step: int,
                   spatial_lr_scale: float) -> dict[str, float]:
    """Per-field learning rates at `step`; a negative light_rest_lr or
    visibility_rest_lr means 1/20 of its base rate."""
    light_rest = (opt.light_rest_lr if opt.light_rest_lr >= 0
                  else opt.light_lr / 20.0)
    vis_rest = (opt.visibility_rest_lr if opt.visibility_rest_lr >= 0
                else opt.visibility_lr / 20.0)
    return {
        "xyz": expon_lr(step, opt.position_lr_init * spatial_lr_scale,
                        opt.position_lr_final * spatial_lr_scale,
                        opt.position_lr_max_steps),
        "normal": opt.normal_lr,
        "shs_dc": opt.sh_lr,
        "shs_rest": opt.sh_lr / 20.0,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
        "opacity": opt.opacity_lr,
        "base_color": opt.base_color_lr,
        "roughness": opt.roughness_lr,
        "incidents_dc": opt.light_lr,
        "incidents_rest": light_rest,
        "visibility_dc": opt.visibility_lr,
        "visibility_rest": vis_rest,
    }


def make_optimizer(model: GaussianModel, opt: OptimizationConfig,
                   spatial_lr_scale: float) -> torch.optim.Adam:
    """Adam with one group per field, at the learning rates of step 0."""
    lrs = learning_rates(opt, 0, spatial_lr_scale)
    return torch.optim.Adam(
        [{"params": [getattr(model, k)], "lr": lrs[k], "name": k}
         for k in model.fields], lr=0.0, betas=BETAS, eps=EPS)


def make_env_optimizer(env: DirectLightMap,
                       opt: OptimizationConfig) -> torch.optim.Adam:
    """Adam over the raw env map at env_lr."""
    return torch.optim.Adam([env.env], lr=opt.env_lr, betas=BETAS, eps=EPS)


def start_state(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Set every parameter's Adam state: zero moments, step count `step`."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p] = {
                "step": torch.tensor(float(step), dtype=torch.float32),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}


def set_learning_rates(optimizer: torch.optim.Optimizer,
                       lrs: dict[str, float]) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lrs[group["name"]]
