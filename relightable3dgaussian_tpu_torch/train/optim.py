"""Per-field Adam (port of relightable3dgaussian_tpu/train/optim.py, stage-1 fields).

One `torch.optim.Adam` parameter group per `GaussianModel` field, each named
after its field, with the JAX package's learning rates (`learning_rates`):
xyz follows `expon_lr` and is set before every step. betas (0.9, 0.999) and
eps 1e-15; torch's update lr/bc1 · m / (sqrt(v)/sqrt(bc2) + eps) is the JAX
package's `adam_step`. Densification replaces parameters and re-keys the
optimizer's state (models/gaussians.py).
"""
from __future__ import annotations

import torch

from ..models.gaussians import FIELDS, GaussianModel
from ..utils.lr_schedule import expon_lr
from .config import OptimizationConfig

BETAS = (0.9, 0.999)
EPS = 1e-15


def learning_rates(opt: OptimizationConfig, step: int,
                   spatial_lr_scale: float) -> dict[str, float]:
    """Per-field learning rates of the stage-1 fields at `step`."""
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
    }


def make_optimizer(model: GaussianModel, opt: OptimizationConfig,
                   spatial_lr_scale: float) -> torch.optim.Adam:
    """Adam with one group per field, at the learning rates of step 0."""
    lrs = learning_rates(opt, 0, spatial_lr_scale)
    return torch.optim.Adam(
        [{"params": [getattr(model, k)], "lr": lrs[k], "name": k}
         for k in FIELDS], lr=0.0, betas=BETAS, eps=EPS)


def set_learning_rates(optimizer: torch.optim.Optimizer,
                       lrs: dict[str, float]) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lrs[group["name"]]
