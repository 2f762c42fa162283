"""The reference's data-parallel stage-1 step: one step over a batch of
views, one a rank, combined as the port's data parallelism combines them
(parallel/data_parallel.py): each view's loss and gradients taken alone
from the same parameters, its densification statistics from its own
gradients, summed over the views (the maximum of the radii), and one Adam
step on the mean of the gradients; the step's loss is the mean of the
views'. Built on `train.py`; imports nothing of the port.
"""
from __future__ import annotations

import torch

from .render import render_view, stage1_loss
from .train import Adam, add_stats, grads_or_zeros, learning_rates


def stage1_dp_step(params: dict, adam: Adam, stats: dict, views,
                   iteration: int, *, cfg, opt: dict, spatial_lr_scale: float,
                   bg: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One step in place over `views`; returns (the mean loss, the mean
    gradients Adam got)."""
    losses, total = [], None
    for view in views:
        m2d = torch.zeros((params["xyz"].shape[0], 2), dtype=bg.dtype,
                          device=bg.device, requires_grad=True)
        results = render_view(params, view.cam, cfg, bg, m2d)
        loss = stage1_loss(view.image, view.image_mask, results, opt,
                           iteration)
        *g, g_m2d = grads_or_zeros(loss, params, (m2d,))
        grads = dict(zip(params, g))
        add_stats(stats, g_m2d, grads["normal"],
                  results["weights"][:, 0].detach(), results["radii"],
                  (cfg.width, cfg.height))
        total = grads if total is None else {k: total[k] + grads[k]
                                             for k in total}
        losses.append(loss.detach())
    mean = {k: v / len(views) for k, v in total.items()}
    adam.step(mean, learning_rates(opt, iteration, spatial_lr_scale))
    return torch.stack(losses).mean(), mean
