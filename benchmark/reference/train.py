"""The reference's train step: its own render and loss, autograd, a plain
Adam and the densification statistics, after the port's `train/stage1.py`,
`train/stage2.py`, `train/optim.py` and `models/gaussians.py`.

Adam is written out as torch's: m ← β1 m + (1 − β1) g, v ← β2 v + (1 − β2) g²,
p ← p − lr / (1 − β1^t) · m / (√v / √(1 − β2^t) + ε), with β (0.9, 0.999)
and ε 1e-15 (the port's `train/optim.py`). Every field steps, a field the
loss does not reach with a zero gradient. Imports nothing of the port.
"""
from __future__ import annotations

import math

import torch

from .render import render_view, stage1_loss

BETAS = (0.9, 0.999)
EPS = 1e-15
STATS = ("max_radii2d", "xyz_grad_accum", "normal_grad_accum", "denom",
         "weights_accum")


def expon_lr(step, lr_init: float, lr_final: float, max_steps: int) -> float:
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    t = min(max(float(step) / max_steps, 0.0), 1.0)
    return math.exp(math.log(max(lr_init, 1e-30)) * (1 - t)
                    + math.log(max(lr_final, 1e-30)) * t)


def learning_rates(opt: dict, step: int, spatial_lr_scale: float) -> dict:
    """Per-field learning rates at `step` (a negative rest rate is 1/20 of
    its base rate)."""
    light_rest = (opt["light_rest_lr"] if opt["light_rest_lr"] >= 0
                  else opt["light_lr"] / 20.0)
    vis_rest = (opt["visibility_rest_lr"] if opt["visibility_rest_lr"] >= 0
                else opt["visibility_lr"] / 20.0)
    return {
        "xyz": expon_lr(step, opt["position_lr_init"] * spatial_lr_scale,
                        opt["position_lr_final"] * spatial_lr_scale,
                        opt["position_lr_max_steps"]),
        "normal": opt["normal_lr"], "shs_dc": opt["sh_lr"],
        "shs_rest": opt["sh_lr"] / 20.0, "scaling": opt["scaling_lr"],
        "rotation": opt["rotation_lr"], "opacity": opt["opacity_lr"],
        "base_color": opt["base_color_lr"], "roughness": opt["roughness_lr"],
        "incidents_dc": opt["light_lr"], "incidents_rest": light_rest,
        "visibility_dc": opt["visibility_lr"], "visibility_rest": vis_rest,
        "env": opt["env_lr"],
    }


class Adam:
    """Adam over named leaves, state zero at `step` (the port's
    `start_state` carries a step count into stage 2)."""

    def __init__(self, params: dict, step: int = 0):
        self.params = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = {k: step for k in params}

    @torch.no_grad()
    def step(self, grads: dict, lrs: dict) -> None:
        b1, b2 = BETAS
        for k, p in self.params.items():
            g = grads[k]
            self.t[k] += 1
            t = self.t[k]
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            denom = self.v[k].sqrt() / math.sqrt(1 - b2 ** t) + EPS
            p -= lrs[k] / (1 - b1 ** t) * self.m[k] / denom


def zero_stats(P: int, like: torch.Tensor) -> dict:
    return {k: torch.zeros((P,), dtype=like.dtype, device=like.device)
            for k in STATS}


@torch.no_grad()
def add_stats(stats: dict, m2d_grad, normal_grad, weights, radii,
              image_wh) -> None:
    """One view's densification statistics (gaussians.py:242-268): the
    pixel-mean gradient scaled by (W/2, H/2), the normal gradient's norm,
    the visible count, the blend weights and the max radius."""
    vis = (radii > 0).to(m2d_grad.dtype)
    ndc = torch.tensor([0.5 * image_wh[0], 0.5 * image_wh[1]],
                       dtype=m2d_grad.dtype, device=m2d_grad.device)
    stats["weights_accum"] += weights
    stats["xyz_grad_accum"] += vis * torch.linalg.norm(m2d_grad * ndc, dim=-1)
    stats["normal_grad_accum"] += vis * torch.linalg.norm(normal_grad, dim=-1)
    stats["denom"] += vis
    torch.maximum(stats["max_radii2d"], vis * radii.to(m2d_grad.dtype),
                  out=stats["max_radii2d"])


def grads_or_zeros(loss: torch.Tensor, params: dict, extra=()) -> list:
    """d loss / d (params, extra), zeros where the loss does not reach."""
    leaves = list(params.values()) + list(extra)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, got)]


def stage1_step(params: dict, adam: Adam, stats: dict, view, iteration: int,
                *, cfg, opt: dict, spatial_lr_scale: float,
                bg: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One stage-1 step in place; returns (loss, the gradients Adam got)."""
    m2d = torch.zeros((params["xyz"].shape[0], 2), dtype=bg.dtype,
                      device=bg.device, requires_grad=True)
    results = render_view(params, view.cam, cfg, bg, m2d)
    loss = stage1_loss(view.image, view.image_mask, results, opt, iteration)
    *g, g_m2d = grads_or_zeros(loss, params, (m2d,))
    grads = dict(zip(params, g))
    lrs = learning_rates(opt, iteration, spatial_lr_scale)
    adam.step(grads, lrs)
    add_stats(stats, g_m2d, grads["normal"], results["weights"][:, 0].detach(),
              results["radii"], (cfg.width, cfg.height))
    return loss.detach(), grads
