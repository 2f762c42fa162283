"""Stage-2 (NeILF / PBR) training (port of relightable3dgaussian_tpu/train/stage2.py).

`setup_stage2` bootstraps a stage-1 model: zero PBR parameters, visibility
traced once (kernel K3 on the card) and a learnable env map. `train_step`
optimises the gaussians and the env map against the dual (SH render + PBR
render) photometric loss: forward (`render_neilf`, with K4 shading and K1
splatting on the card), backward (K4-bwd, K2), the per-field Adam and the
env map's Adam, then the densification statistics. Every field steps, as
the JAX package's `adam_step` steps every leaf: a field no loss reached
(the normals, the visibility SH) gets a zero gradient, not none.
`run_training_schedule` is the JAX host loop, continuing the iteration
count from `first_iter`. `finetune_visibility` comes with the CLI path that
calls it.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..models import gaussians as G
from ..models.lights import DirectLightMap
from ..models.render import ViewInputs
from ..models.render_neilf import (VisibilityCache, render_neilf,
                                   update_visibility)
from ..ops.config import RasterConfig
from .config import OptimizationConfig
from .optim import learning_rates, set_learning_rates
from .stage1 import (StepTimer, backward_or_zero_grads, densify_step,
                     reset_opacity_step)


def setup_stage2(model: G.GaussianModel, sample_num: int,
                 env_resolution: int = 16, light_init: float = 3.0,
                 generator: torch.Generator | None = None
                 ) -> tuple[VisibilityCache, DirectLightMap]:
    """Add zero PBR parameters to `model` (in place), trace its visibility
    at `sample_num` samples per point, and make the env light
    [env_resolution, 2·env_resolution, 3] from `generator` (on the model's
    device). Returns (visibility cache, env light)."""
    G.add_pbr_params(model)
    vis = update_visibility(model, sample_num)
    env = DirectLightMap(env_resolution, light_init, generator,
                         device=model.xyz.device)
    return vis, env


def train_step(model: G.GaussianModel, optimizer: torch.optim.Optimizer,
               env: DirectLightMap, env_optimizer: torch.optim.Optimizer,
               vis: VisibilityCache, view: ViewInputs, iteration: int, *,
               cfg: RasterConfig, opt: OptimizationConfig,
               spatial_lr_scale: float,
               timer: StepTimer | None = None) -> dict[str, Any]:
    """One optimisation step in place; returns the metrics: the loss terms
    of `tb_dict` (psnr, psnr_pbr, ...) and "loss", "light_mean" (tensors),
    "n_active" and "num_rendered"."""
    dev = model.xyz.device
    if timer is not None:
        timer.mark("start")
    bg = (torch.ones(3, device=dev) if cfg.white_background
          else torch.zeros(3, device=dev))
    m2d = torch.zeros((model.num_points, 2), device=dev, requires_grad=True)
    optimizer.zero_grad(set_to_none=True)
    env_optimizer.zero_grad(set_to_none=True)
    results = render_neilf(view, model, cfg, bg, env, vis, opt,
                           is_training=True, mean2d_offset=m2d)
    loss = results["loss"]
    if timer is not None:
        timer.mark("forward")
    backward_or_zero_grads(loss, model, m2d)
    if env.env.grad is None:
        env.env.grad = torch.zeros_like(env.env)
    if timer is not None:
        timer.mark("backward")

    set_learning_rates(optimizer,
                       learning_rates(opt, iteration, spatial_lr_scale))
    optimizer.step()
    env_optimizer.step()
    G.add_densification_stats(model, m2d.grad, model.normal.grad,
                              results["weights"][:, 0].detach(),
                              results["radii"], (cfg.width, cfg.height))
    if timer is not None:
        timer.mark("end")
    metrics = {k: v.detach() for k, v in results["tb_dict"].items()}
    metrics["loss"] = loss.detach()
    metrics["light_mean"] = results["env"].detach().mean()
    metrics["n_active"] = model.num_points
    metrics["num_rendered"] = results["num_rendered"]
    return metrics


def run_training_schedule(model: G.GaussianModel,
                          optimizer: torch.optim.Optimizer,
                          env: DirectLightMap,
                          env_optimizer: torch.optim.Optimizer,
                          vis: VisibilityCache, views: Sequence[ViewInputs],
                          *, cfg: RasterConfig, opt: OptimizationConfig,
                          spatial_lr_scale: float, extent: float,
                          generator: torch.Generator, first_iter: int = 0,
                          callback: Callable[[int, dict], None] | None = None,
                          seed: int = 0, timer: StepTimer | None = None
                          ) -> VisibilityCache:
    """Train in place for steps first_iter + 1 to `opt.iterations`, with the
    camera order of the JAX host loop (a numpy permutation of the views
    from `seed`, popped from its end) and its gates: densify every
    `densification_interval` steps after `densify_from_iter` and before
    `densify_until_iter` (usually passed already when stage 2 starts), and
    reset opacities every `opacity_reset_interval` steps before it. A
    densify resizes the model, so the visibility cache is traced anew for
    it (the JAX package keeps its per-slot entries, stale for new points).
    `generator` draws the split noise; `callback(iteration, metrics)` sees
    each step's metrics, with "densify" after a densify step. Returns the
    visibility cache the last step used."""
    rng = np.random.default_rng(seed)
    stack: list[int] = []
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if not stack:
            stack = list(rng.permutation(len(views)))
        view = views[stack.pop()]
        metrics = train_step(model, optimizer, env, env_optimizer, vis, view,
                             iteration, cfg=cfg, opt=opt,
                             spatial_lr_scale=spatial_lr_scale, timer=timer)
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0):
                size_thresh = (20.0 if iteration > opt.opacity_reset_interval
                               else float("inf"))
                gn_thresh = (opt.densify_grad_normal_threshold
                             if iteration > opt.normal_densify_from_iter
                             else 99999.0)
                metrics["densify"] = densify_step(
                    model, optimizer, generator, gn_thresh, size_thresh,
                    extent, opt=opt)
                vis = update_visibility(model, vis.visibility.shape[1])
            if iteration % opt.opacity_reset_interval == 0:
                reset_opacity_step(model, optimizer)
        if callback is not None:
            callback(iteration, metrics)
    return vis
