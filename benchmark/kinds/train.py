"""Training traffic: a closed loop of train steps, one view a step, drawn as
the program's `run_training_schedule` draws them from the training views,
through that schedule itself (`train/stage1.py` or `train/stage2.py` by the
configuration's `stage`), stopped from its callback when the window ends.

Set-up makes the inputs from the seed, builds the program's model and
optimizer once, and drives them through the schedule's first
`warm_steps` steps, reading the first `check_steps` for the check: each
step's loss, Adam's first moment after step 1 (the first gradient) and the
parameters and statistics after the last. The window continues that same
object. The check runs the reference over the same views from the same
starting parameters.

Traffic keys: warm_steps, check_steps, trace_steps (steps in a traced
window).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import checks, work
from ..harness import Window, phase
from ..reference.train import STATS
from ..trace import TraceData, from_profiler
from . import common


class _Stop(Exception):
    """Raised from the schedule's callback to end it."""


class RecordingViews(list):
    """The training views, noting each index the schedule asks for."""

    def __init__(self, items):
        super().__init__(items)
        self.asked: list[int] = []

    def __getitem__(self, i):
        self.asked.append(int(i))
        return super().__getitem__(i)


def setup(ctx):
    from relightable3dgaussian_tpu_torch.models import gaussians as G
    from relightable3dgaussian_tpu_torch.models.render import ViewInputs
    from relightable3dgaussian_tpu_torch.train import optim
    from relightable3dgaussian_tpu_torch.train.config import OptimizationConfig

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    s = common.inputs(ctx, with_images=True)
    opt_keys = {f.name for f in dataclasses.fields(OptimizationConfig)}
    opt = OptimizationConfig(**{k: v for k, v in c.items() if k in opt_keys})
    model = G.GaussianModel(**{k: v.clone() for k, v in s.fields.items()})
    st = common.State(ctx=ctx, inputs=s, opt=opt)
    st.model = model
    zeros1 = torch.zeros((1, c["height"], c["width"]), device=dev)
    zeros3 = torch.zeros((3, c["height"], c["width"]), device=dev)
    st.views = RecordingViews([
        ViewInputs(cam=cam, image=img, image_mask=mask, depth=zeros1,
                   normal=zeros3)
        for cam, (img, mask) in zip(common.program_cameras(ctx, s.cams),
                                    s.images)])
    if c["stage"] == 2:
        from relightable3dgaussian_tpu_torch.models.lights import DirectLightMap
        from relightable3dgaussian_tpu_torch.models.render_neilf import (
            update_visibility)
        G.add_pbr_params(model)
        st.vis = update_visibility(model, c["sample_num"])
        st.extra["vis_values"] = st.vis.visibility
        st.env = DirectLightMap.from_raw(s.env_raw.clone())
        st.optimizer = optim.make_optimizer(model, opt, s.extent)
        optim.start_state(st.optimizer, c["first_iter"])
        st.env_optimizer = optim.make_env_optimizer(st.env, opt)
    else:
        st.optimizer = optim.make_optimizer(model, opt, s.extent)
    st.split_gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    common.sync(dev)
    phase("model, optimizer" + (", visibility" if st.vis else ""))
    _first_steps(st, tr["warm_steps"], tr["check_steps"])
    common.sync(dev)
    phase(f"first {tr['warm_steps']} steps")
    return st


def _schedule(st, callback, timer=None) -> None:
    c = st.ctx.config
    kw = dict(cfg=common.program_raster_config(c), opt=st.opt,
              spatial_lr_scale=st.inputs.extent, extent=st.inputs.extent,
              generator=st.split_gen, callback=callback,
              seed=st.ctx.seed, timer=timer)
    try:
        if c["stage"] == 2:
            from relightable3dgaussian_tpu_torch.train import stage2
            stage2.run_training_schedule(
                st.model, st.optimizer, st.env, st.env_optimizer, st.vis,
                st.views, first_iter=c["first_iter"], **kw)
        else:
            from relightable3dgaussian_tpu_torch.train import stage1
            stage1.run_training_schedule(st.model, st.optimizer, st.views,
                                         **kw)
    except _Stop:
        pass


def _leaves(st) -> dict:
    """The program's parameters as named leaves (the env map as "env")."""
    out = {k: getattr(st.model, k) for k in st.model.fields}
    if st.env is not None:
        out["env"] = st.env.env
    return out


def _first_moments(st) -> dict:
    """Adam's first moment of each leaf (zeros where Adam kept none)."""
    def moment(opt, p):
        return opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
    out = {k: moment(st.optimizer, getattr(st.model, k))
           for k in st.model.fields}
    if st.env is not None:
        out["env"] = moment(st.env_optimizer, st.env.env)
    return out


def _first_steps(st, warm: int, check: int) -> None:
    """Drive the schedule through its first `warm` steps, reading the
    first `check`: the loss of each, the first gradient (Adam's first
    moment after step 1 over 1 - beta1) and the parameters and densification
    statistics after step `check`, before step `check + 1` runs."""
    from relightable3dgaussian_tpu_torch.train.optim import BETAS
    losses, n = [], 0
    st.prog = {}

    def callback(iteration, metrics):
        nonlocal n
        n += 1
        if n <= check:
            losses.append(metrics["loss"])
            st.iterations.append(iteration)
        if n == 1:
            st.prog["grads"] = {k: v / (1 - BETAS[0]) for k, v in
                                _first_moments(st).items()}
        if n == check:
            st.prog["params"] = {k: v.detach().clone()
                                 for k, v in _leaves(st).items()}
            st.prog["stats"] = {k: getattr(st.model, k).clone()
                                for k in STATS}
        if n >= warm:
            raise _Stop

    _schedule(st, callback)
    st.check_views = st.views.asked[:check]
    st.prog["losses"] = [float(x) for x in losses]


def window(st, seconds: float, trace: bool) -> Window:
    tr = st.ctx.traffic
    n, asked0 = 0, len(st.views.asked)
    timer = snaps = prof = None
    if trace:
        from relightable3dgaussian_tpu_torch.train.stage1 import StepTimer
        snaps = [common.geometry(st.model)]
        timer = StepTimer() if st.ctx.device.type == "cuda" else None
        prof = common.profiler()
        prof.start()
    common.sync(st.ctx.device)
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def callback(iteration, metrics):
        nonlocal n
        n += 1
        if trace:
            if n >= tr["trace_steps"]:
                raise _Stop
            snaps.append(common.geometry(st.model))
        elif time.perf_counter() >= t_end:
            raise _Stop

    _schedule(st, callback, timer)
    common.sync(st.ctx.device)
    window_s = time.perf_counter() - t0
    win = Window(units=n, window_s=window_s,
                 end_to_end={"train_views_per_s": n / window_s})
    if trace:
        prof.stop()
        device, host = from_profiler(prof)
        views = st.views.asked[asked0:asked0 + n]
        win.trace = TraceData(
            kind="train", units=n, window_s=window_s, device=device,
            host=host, step_split=timer.split_ms() if timer else [],
            work=[_step_work(st, g, v) for g, v in zip(snaps, views)])
    return win


def _step_work(st, geometry: dict, view: int) -> dict:
    """The counted work of one train step on its own inputs: the reference
    walk's pairs on the step's geometry and camera."""
    c = st.ctx.config
    P = geometry["xyz"].shape[0]
    pairs, walked, blended = common.walk_counts(st, geometry, view)
    A = 9 if c["stage"] == 1 else 3 + common.stage2_train_width(st.opt) + 2
    tiles = common.raster_config(c).num_tiles
    S = c.get("sample_num", 0) if c["stage"] == 2 else 0
    n_params = sum(v.numel() for v in _leaves(st).values())
    out = {"k1": work.k1_work(P, pairs, tiles, A, walked, blended),
           "k2": work.k2_work(P, pairs, tiles, A, walked, blended),
           "step": (0, work.step_ops(
               P, n_params, walked, blended, A, c["height"], c["width"],
               ssim_channels=3 if c["stage"] == 1 else 6,
               edge_channels=3 if c["stage"] == 1 else 0, S=S))}
    if S:
        out["k4"] = work.k4_work(P, S)
    return out


def release(st) -> None:
    st.model = st.optimizer = st.env = st.env_optimizer = None
    st.views = st.vis = None
    common.free(st.ctx.device)


def readings(st, control: bool = False) -> dict:
    """The reference's readings over the check steps, in float64, or in
    the control's precision (float32 with TF32) with `control`."""
    from ..reference import train as R
    c, s = st.ctx.config, st.inputs
    dtype = torch.float32 if control else torch.float64
    with common.precision(control):
        params = {k: v.to(dtype).clone().requires_grad_(True)
                  for k, v in s.start.items()}
        if c["stage"] == 2:
            return common.stage2_reference(st, params, dtype)
        adam = R.Adam(params)
        stats = R.zero_stats(params["xyz"].shape[0], params["xyz"])
        cams = common.reference_cameras(st.ctx, s.cams, dtype)
        bg = torch.zeros(3, dtype=dtype, device=st.ctx.device)
        opt = dataclasses.asdict(st.opt)
        out = {"losses": []}
        for j, (v, it) in enumerate(zip(st.check_views, st.iterations)):
            img, mask = s.images[v]
            view = common.RefView(cams[v], img.to(dtype), mask.to(dtype))
            loss, grads = R.stage1_step(
                params, adam, stats, view, it, cfg=common.raster_config(c),
                opt=opt, spatial_lr_scale=s.extent, bg=bg)
            out["losses"].append(float(loss))
            if j == 0:
                out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        out["params"] = {k: v.detach() for k, v in params.items()}
        out["stats"] = stats
        return out


def compare(st, ref: dict, side: dict) -> dict:
    start = {k: v.double() for k, v in st.inputs.start.items()}
    change = lambda d: {k: d["params"][k].double() - start[k] for k in start}
    numbers = checks.train_numbers(dict(side, change=change(side)),
                                   dict(ref, change=change(ref)))
    if "vis" in ref:
        numbers["vis"] = common.vis_gap(side["vis"], ref["vis"])
    return numbers


def program_side(st) -> dict:
    if st.ctx.config["stage"] == 2:
        return dict(st.prog, vis=common.program_vis(st))
    return st.prog


def check(st) -> dict:
    return compare(st, readings(st), program_side(st))
