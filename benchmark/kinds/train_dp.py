"""Data-parallel training traffic: `cli.train --n_devices N`'s stage-1
loop, a closed loop of steps over `ranks` ranks, one process a card,
each step one view a rank, through the program's own schedule
(`train/stage1.py::run_training_schedule(group=...)`): every rank holds
the model, renders its view of the step's batch, and the ranks combine
their densification statistics and average their gradients over NCCL
(gloo on the CPU) before each Adam step (`parallel/data_parallel.py`).

The harness's process is rank 0 (`parallel.PeerRanks` starts ranks
1..N-1 beside it), so that the harness's memory reading and profiler see
rank 0's card and steps; every wait of the group is bounded by
`timeout_s`, and a rank that fails or stalls ends the run with an error.
Every rank makes the same inputs from the seed on its own card; rank 0's
replica is broadcast. Set-up drives the schedule through its first
`warm_steps` steps on every rank, rank 0 reading the first
`check_steps`: the loss (the mean over the ranks), the first gradient
(Adam's first moment after step 1 over 1 - beta1, the ranks' mean), the
parameters and the statistics after the last; the rate of the warm
steps' second half on the host's clock sets the window's number of
steps, which rank 0 broadcasts before the window (no collective or sync
is added to a step).
The window runs that many steps of the schedule on every rank; its time
is rank 0's. `train_views_per_s` counts the views of every rank. After
the window every rank's replica digest is gathered.

The check runs the reference's data-parallel step
(`reference/train_dp.py`) over the same batches from the same start, and
counts the replicas apart from rank 0's.

Traffic keys: ranks, warm_steps, check_steps, trace_steps, timeout_s (the
group's whole life), collective_timeout_s.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import torch

from ..harness import Window, phase
from ..reference.train import STATS
from ..trace import TraceData, from_profiler
from . import common, train


def _devices(ctx) -> list:
    """One device a rank: the CPU, or card r (cards shared round-robin
    where there are fewer cards than ranks)."""
    n = ctx.traffic["ranks"]
    if ctx.device.type != "cuda":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", r % torch.cuda.device_count())
            for r in range(n)]


def _rank_state(ctx, group):
    """Every rank's state: the seed's inputs on its device, the model and
    its optimizer (rank 0's replica broadcast), and the views."""
    from relightable3dgaussian_tpu_torch.models import gaussians as G
    from relightable3dgaussian_tpu_torch.models.render import ViewInputs
    from relightable3dgaussian_tpu_torch.parallel import replicate
    from relightable3dgaussian_tpu_torch.train import optim
    from relightable3dgaussian_tpu_torch.train.config import OptimizationConfig

    c, dev = ctx.config, ctx.device
    if c["stage"] != 1 or c["densify_until_iter"] > 0:
        raise ValueError("train_dp: stage-1 steps past densification")
    s = common.inputs(ctx, with_images=True)
    keys = {f.name for f in dataclasses.fields(OptimizationConfig)}
    opt = OptimizationConfig(**{k: v for k, v in c.items() if k in keys})
    st = common.State(ctx=ctx, inputs=s, opt=opt)
    st.model = G.GaussianModel(**{k: v.clone() for k, v in s.fields.items()})
    st.optimizer = optim.make_optimizer(st.model, opt, s.extent)
    replicate(group, st.model, st.optimizer)
    zeros1 = torch.zeros((1, c["height"], c["width"]), device=dev)
    zeros3 = torch.zeros((3, c["height"], c["width"]), device=dev)
    st.views = train.RecordingViews([
        ViewInputs(cam=cam, image=img, image_mask=mask, depth=zeros1,
                   normal=zeros3)
        for cam, (img, mask) in zip(common.program_cameras(ctx, s.cams),
                                    s.images)])
    st.split_gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    st.extra["group"] = group
    return st


def _steps(st, n: int, callback=None, timer=None) -> None:
    """`n` steps of the schedule from its start (every rank alike)."""
    from relightable3dgaussian_tpu_torch.train import stage1
    c, done = st.ctx.config, [0]

    def each(iteration, metrics):
        if callback is not None:
            callback(iteration, metrics)
        done[0] += 1
        if done[0] >= n:
            raise train._Stop

    try:
        stage1.run_training_schedule(
            st.model, st.optimizer, st.views,
            cfg=common.program_raster_config(c), opt=st.opt,
            spatial_lr_scale=st.inputs.extent, extent=st.inputs.extent,
            generator=st.split_gen, callback=each, seed=st.ctx.seed,
            timer=timer, group=st.extra["group"])
    except train._Stop:
        pass


def _window_steps(group, n: int) -> int:
    """Rank 0's `n`, on every rank (one broadcast)."""
    from relightable3dgaussian_tpu_torch.parallel import data_parallel as dp
    t = torch.tensor([n], dtype=torch.int64, device=group.device)
    dp.broadcast_([t], group)
    return int(t)


def _digests(st) -> list[str]:
    """Every rank's replica digest, rank 0 first (one gather)."""
    import torch.distributed as dist
    from relightable3dgaussian_tpu_torch.parallel import data_parallel as dp
    group = st.extra["group"]
    out = [None] * group.size
    dist.all_gather_object(out, dp.replica_digest(st.model, st.optimizer))
    return out


def _peer(group, ctx) -> str:
    """A rank past rank 0: set-up, the warm steps, the window's steps as
    rank 0 names them, the digests. Returns its digest."""
    st = _rank_state(dataclasses.replace(ctx, device=group.device), group)
    _steps(st, ctx.traffic["warm_steps"])
    _steps(st, _window_steps(group, 0))
    common.sync(group.device)
    return _digests(st)[group.rank]


def setup(ctx):
    from relightable3dgaussian_tpu_torch.parallel import PeerRanks
    tr, dev = ctx.traffic, ctx.device
    if dev.type == "cuda":      # built once here; the other ranks load them
        from relightable3dgaussian_tpu_torch.ops import _build
        _build.prebuild()
    peers = PeerRanks(_peer, _devices(ctx), ctx, timeout_s=tr["timeout_s"],
                      collective_timeout_s=tr["collective_timeout_s"])
    group = peers.__enter__()
    try:
        phase(f"{group.size} ranks joined")
        st = _rank_state(ctx, group)
        st.extra["peers"] = peers
        common.sync(dev)
        phase("inputs, model, optimizer on every rank")
        _first_steps(st, tr["warm_steps"], tr["check_steps"])
        common.sync(dev)
        phase(f"first {tr['warm_steps']} steps")
    except BaseException:
        peers.__exit__(*sys.exc_info())
        raise
    return st


def _first_steps(st, warm: int, check: int) -> None:
    """The first `warm` steps, reading the first `check` (see above), and
    the host's rate over their second half."""
    from relightable3dgaussian_tpu_torch.train.optim import BETAS
    from relightable3dgaussian_tpu_torch.train.stage1 import view_batches
    losses, stamps = [], []

    def callback(iteration, metrics):
        n = len(stamps) + 1
        if n <= check:
            losses.append(metrics["loss"])
            st.iterations.append(iteration)
        if n == 1:
            st.prog["grads"] = {k: v / (1 - BETAS[0]) for k, v in
                                train._first_moments(st).items()}
        if n == check:
            st.prog["params"] = {k: v.detach().clone()
                                 for k, v in train._leaves(st).items()}
            st.prog["stats"] = {k: getattr(st.model, k).clone()
                                for k in STATS}
        stamps.append(time.perf_counter())

    _steps(st, warm, callback)
    batches = view_batches(len(st.views), st.extra["group"].size,
                           st.ctx.seed)
    st.check_views = [next(batches) for _ in range(check)]
    st.prog["losses"] = [float(x) for x in losses]
    half = max(check, warm // 2)      # the warm steps' second half
    st.extra["rate"] = (warm - half) / max(stamps[-1] - stamps[half - 1],
                                           1e-9)


def window(st, seconds: float, trace: bool) -> Window:
    tr, dev = st.ctx.traffic, st.ctx.device
    group = st.extra["group"]
    try:
        n = tr["trace_steps"] if trace else max(1, round(seconds *
                                                          st.extra["rate"]))
        n = _window_steps(group, n)
        asked0 = len(st.views.asked)
        timer = snaps = prof = None
        if trace:
            from relightable3dgaussian_tpu_torch.train.stage1 import StepTimer
            snaps = [common.geometry(st.model)]
            timer = StepTimer() if dev.type == "cuda" else None
            prof = common.profiler()
            prof.start()
        callback = ((lambda it, m: snaps.append(common.geometry(st.model)))
                    if trace else None)
        common.sync(dev)
        t0 = time.perf_counter()
        _steps(st, n, callback, timer)
        common.sync(dev)
        window_s = time.perf_counter() - t0
        win = Window(units=n, window_s=window_s, end_to_end={
            "train_views_per_s": n * group.size / window_s})
        if trace:
            prof.stop()
            device, host = from_profiler(prof)
            views = st.views.asked[asked0:asked0 + n]
            win.trace = TraceData(
                kind="train", units=n, window_s=window_s, device=device,
                host=host, step_split=timer.split_ms() if timer else [],
                work=[train._step_work(st, g, v)
                      for g, v in zip(snaps, views)])
        digests = _digests(st)
        st.extra["apart"] = sum(d != digests[0] for d in digests)
    except BaseException:
        st.extra.pop("peers").__exit__(*sys.exc_info())
        raise
    return win


def release(st) -> None:
    """Leave the group (rank 0 first) and wait for the other ranks' ends."""
    peers = st.extra.pop("peers", None)
    if peers is not None:
        peers.__exit__(None, None, None)
    st.model = st.optimizer = st.views = None
    st.extra.pop("group", None)
    common.free(st.ctx.device)


def readings(st, control: bool = False) -> dict:
    """The reference's readings over the check steps' batches, in float64,
    or in the control's precision (float32 with TF32) with `control`."""
    from ..reference import train as R
    from ..reference.train_dp import stage1_dp_step
    c, s = st.ctx.config, st.inputs
    dtype = torch.float32 if control else torch.float64
    with common.precision(control):
        params = {k: v.to(dtype).clone().requires_grad_(True)
                  for k, v in s.start.items()}
        adam = R.Adam(params)
        stats = R.zero_stats(params["xyz"].shape[0], params["xyz"])
        cams = common.reference_cameras(st.ctx, s.cams, dtype)
        bg = torch.zeros(3, dtype=dtype, device=st.ctx.device)
        opt = dataclasses.asdict(st.opt)
        out = {"losses": []}
        for j, (batch, it) in enumerate(zip(st.check_views, st.iterations)):
            views = [common.RefView(cams[v], s.images[v][0].to(dtype),
                                    s.images[v][1].to(dtype)) for v in batch]
            loss, grads = stage1_dp_step(
                params, adam, stats, views, it, cfg=common.raster_config(c),
                opt=opt, spatial_lr_scale=s.extent, bg=bg)
            out["losses"].append(float(loss))
            if j == 0:
                out["grads"] = {k: g.detach().clone()
                                for k, g in grads.items()}
        out["params"] = {k: v.detach() for k, v in params.items()}
        out["stats"] = stats
        return out


def compare(st, ref: dict, side: dict) -> dict:
    numbers = train.compare(st, ref, side)
    if "apart" in side:
        numbers["replicas_apart"] = float(side["apart"])
    return numbers


def program_side(st) -> dict:
    return dict(st.prog, apart=st.extra["apart"])


def check(st) -> dict:
    return compare(st, readings(st), program_side(st))
