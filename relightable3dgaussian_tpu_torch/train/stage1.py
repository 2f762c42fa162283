"""Stage-1 training (port of relightable3dgaussian_tpu/train/stage1.py).

`train_step` is one optimisation step on one view: forward (render and
`calculate_loss`), backward (kernel K2 on the card), Adam with the per-field
learning rates, then the densification statistics from `mean2d_offset.grad`,
`normal.grad`, the forward's blend weights and the radii. Given a group of
ranks (parallel/data_parallel.py), each rank's view is combined with the
others' between the backward and Adam. `densify_step` and
`reset_opacity_step` resize or reset the model and re-key the optimizer.
`run_training_schedule` is the host loop of the JAX package: the same
numpy-permutation camera order from `seed` and the same densify and
opacity-reset schedule, on one rank or a view a rank of a group (it is
`cli.train`'s stage-1 loop). The JAX CLI's TPU-only parts (binning re-plans,
capacity growth, the overflow streak) have no counterpart: the port sizes
its buffers per call and never drops a pair.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from ..models import gaussians as G
from ..models.render import ViewInputs, render
from ..ops.config import RasterConfig
from ..utils import trace
from .config import OptimizationConfig
from .optim import learning_rates, set_learning_rates


class StepTimer:
    """CUDA events at the phase boundaries of each train step ("start",
    "forward", "backward", "end"); read after a synchronize. The events
    around a phase are also the device events of its span
    (`train.forward`, `train.backward`, `train.optimizer`)."""

    PHASE_START = {"forward": "start", "backward": "forward",
                   "end": "backward"}

    def __init__(self):
        self.steps: list[dict[str, torch.cuda.Event]] = []

    def mark(self, name: str, span=trace.NULL) -> None:
        """Record the event `name`; the phase that ends there gives `span`
        its events."""
        if name == "start":
            self.steps.append({})
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        step = self.steps[-1]
        step[name] = event
        if name in self.PHASE_START:
            span.events(step[self.PHASE_START[name]], event)

    def split_ms(self) -> list[dict[str, float]]:
        """Per step: forward, backward, optimizer (Adam and stats), total."""
        return [{"forward": s["start"].elapsed_time(s["forward"]),
                 "backward": s["forward"].elapsed_time(s["backward"]),
                 "optimizer": s["backward"].elapsed_time(s["end"]),
                 "total": s["start"].elapsed_time(s["end"])}
                for s in self.steps]


def backward_or_zero_grads(loss: torch.Tensor, model: G.GaussianModel,
                           mean2d_offset: torch.Tensor) -> None:
    """loss.backward(), then a zero gradient for every field (and for the
    mean2d offset) the loss did not reach, as the JAX package's gradient of
    a step is zero there: every field steps, and Adam's moments decay.
    A view in which nothing is rendered reaches no field at all; on the CPU
    its loss then has no graph, and no backward runs."""
    if loss.requires_grad:
        loss.backward()
    for p in [getattr(model, k) for k in model.fields] + [mean2d_offset]:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def train_step(model: G.GaussianModel, optimizer: torch.optim.Optimizer,
               view: ViewInputs, iteration: int, *, cfg: RasterConfig,
               opt: OptimizationConfig, spatial_lr_scale: float,
               timer: StepTimer | None = None, group=None) -> dict[str, Any]:
    """One optimisation step in place; returns the metrics: the loss terms
    of `tb_dict` and "loss" (tensors), "n_active" and "num_rendered"
    (the step's binned pairs). With `group` (a `parallel.data_parallel.
    Group`, each rank holding the same model and its own view), the view's
    densification contributions are combined over the ranks, the gradients
    and the loss terms averaged (`data_parallel.reduce_step`)."""
    with trace.span("train.step", unit=True):
        dev = model.xyz.device
        if timer is not None:
            timer.mark("start")
        with trace.span("train.forward") as sp:
            bg = (torch.ones(3, device=dev) if cfg.white_background
                  else torch.zeros(3, device=dev))
            m2d = torch.zeros((model.num_points, 2), device=dev,
                              requires_grad=True)
            optimizer.zero_grad(set_to_none=True)
            results = render(view, model, cfg, bg, opt, is_training=True,
                             iteration=iteration, mean2d_offset=m2d)
            loss = results["loss"]
            if timer is not None:
                timer.mark("forward", sp)
        with trace.span("train.backward") as sp:
            backward_or_zero_grads(loss, model, m2d)
            if timer is not None:
                timer.mark("backward", sp)
        with trace.span("train.optimizer") as sp:
            contribs = view_contribs(model, m2d, results, cfg, group)
            set_learning_rates(optimizer,
                               learning_rates(opt, iteration, spatial_lr_scale))
            optimizer.step()
            G.apply_stat_contribs(model, contribs)
            if timer is not None:
                timer.mark("end", sp)
        metrics = {k: v.detach() for k, v in results["tb_dict"].items()}
        metrics["loss"] = loss.detach()
        return step_metrics(metrics, model, results, group)


def view_contribs(model: G.GaussianModel, m2d: torch.Tensor,
                  results: dict[str, Any], cfg: RasterConfig, group,
                  extra_grads: tuple[torch.Tensor, ...] = ()
                  ) -> G.StatContribs:
    """The view's densification contributions, from the gradients of its
    backward; with `group`, combined over the ranks, and the model's
    gradients (and `extra_grads`) averaged over them, in place."""
    contribs = G.densification_contribs(
        m2d.grad, model.normal.grad, results["weights"][:, 0].detach(),
        results["radii"], (cfg.width, cfg.height))
    if group is None:
        return contribs
    from ..parallel.data_parallel import reduce_step
    grads = [getattr(model, k).grad for k in model.fields]
    return reduce_step(group, grads + list(extra_grads), contribs)


def step_metrics(metrics: dict[str, Any], model: G.GaussianModel,
                 results: dict[str, Any], group) -> dict[str, Any]:
    """The step's metrics with "n_active" and "num_rendered" (this rank's);
    with `group`, the tensors averaged over the ranks."""
    if group is not None:
        from ..parallel.data_parallel import mean_metrics
        metrics = mean_metrics(metrics, group)
    metrics["n_active"] = model.num_points
    metrics["num_rendered"] = results["num_rendered"]
    return metrics


def densify_step(model: G.GaussianModel, optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, grad_normal_threshold: float,
                 max_screen_size: float, extent: float, *,
                 opt: OptimizationConfig) -> G.DensifyStats:
    """densify_and_prune with the training loop's thresholds."""
    return G.densify_and_prune(
        model, optimizer, generator,
        grad_threshold=opt.densify_grad_threshold,
        grad_normal_threshold=grad_normal_threshold, min_opacity=0.005,
        extent=extent, max_screen_size=max_screen_size,
        percent_dense=opt.percent_dense)


def reset_opacity_step(model: G.GaussianModel,
                       optimizer: torch.optim.Optimizer) -> None:
    G.reset_opacity(model, optimizer)


def view_batches(n_views: int, size: int, seed: int) -> Iterator[list[int]]:
    """The views of each step, one a rank: `size` indices a step, popped
    from the end of a numpy permutation of the `n_views` views from
    `seed`, renewed when empty (the JAX package's camera order; one rank
    draws one a step)."""
    rng = np.random.default_rng(seed)
    stack: list[int] = []
    while True:
        batch = []
        for _ in range(size):
            if not stack:
                stack = list(rng.permutation(n_views))
            batch.append(stack.pop())
        yield batch


def run_training_schedule(model: G.GaussianModel,
                          optimizer: torch.optim.Optimizer,
                          views: Sequence[ViewInputs], *, cfg: RasterConfig,
                          opt: OptimizationConfig, spatial_lr_scale: float,
                          extent: float, generator: torch.Generator,
                          callback: Callable[[int, dict], None] | None = None,
                          seed: int = 0, timer: StepTimer | None = None,
                          group=None, first_iter: int = 0) -> None:
    """Train `model` in place for steps `first_iter` + 1 to
    `opt.iterations`.

    Cameras are drawn as the JAX package draws them (`view_batches`): a
    numpy permutation of the views from `seed`, popped from its end,
    renewed when empty; with `group` (a `parallel.data_parallel.Group`,
    every rank holding the same model) each step draws one view a rank and
    this rank trains on the rank-th, its step combined with the others'
    (`train_step`). Densify every `densification_interval` steps after
    `densify_from_iter` and before `densify_until_iter` (the world-size
    prune on after the first opacity reset, the normal-gradient threshold
    after `normal_densify_from_iter`), and reset opacities every
    `opacity_reset_interval` steps (and at `densify_from_iter` on a white
    background). There is no SH warm-up: the reference starts at the
    maximum degree. `generator` draws the split noise (the same seed on
    every rank); `callback(iteration, metrics)` sees each step's metrics,
    with "densify" after a densify step.
    """
    size, rank = (1, 0) if group is None else (group.size, group.rank)
    batches = view_batches(len(views), size, seed)
    for iteration in range(first_iter + 1, opt.iterations + 1):
        view = views[next(batches)[rank]]
        metrics = train_step(model, optimizer, view, iteration, cfg=cfg,
                             opt=opt, spatial_lr_scale=spatial_lr_scale,
                             timer=timer, group=group)
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
            if iteration % opt.opacity_reset_interval == 0 or (
                    cfg.white_background
                    and iteration == opt.densify_from_iter):
                reset_opacity_step(model, optimizer)
        if callback is not None:
            callback(iteration, metrics)
