"""The data-parallel stage-1 schedule on the CPU, without the JAX package
(a spawned rank imports this module): `run_training_schedule(group=...)`
on two gloo ranks against the benchmark's plain data-parallel step
(`benchmark/reference/train_dp.py`, which imports nothing of the port),
its camera draw, `cli.train`'s stage-1 loop going through it, and
`parallel.PeerRanks` (the caller as rank 0): its happy path, and a rank
that fails or stalls ending the run within its time limit, also through
the CLIs' `run_ranks`."""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import checks, scene
from benchmark.kinds.common import RefView
from benchmark.reference import train as R
from benchmark.reference.camera import make_camera_params as ref_camera
from benchmark.reference.config import RasterConfig as RefRasterConfig
from benchmark.reference.train_dp import stage1_dp_step
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.models.render import ViewInputs
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.parallel import spawn
from relightable3dgaussian_tpu_torch.parallel import data_parallel as dp
from relightable3dgaussian_tpu_torch.train import optim, stage1
from relightable3dgaussian_tpu_torch.train.config import (
    STAGE1_NERF_SYNTHETIC, OptimizationConfig)

ROOT = Path(__file__).resolve().parents[1]
SIZE, P, VIEWS, STEPS, FOVX = 32, 300, 6, 3, 0.6911
SEED = 11


def opt_config() -> OptimizationConfig:
    """STAGE1_NERF_SYNTHETIC past densification."""
    keys = {f.name for f in dataclasses.fields(OptimizationConfig)}
    return OptimizationConfig(**{k: v for k, v in dict(
        STAGE1_NERF_SYNTHETIC, densify_until_iter=0).items() if k in keys})


def inputs() -> tuple[dict, list, list, float]:
    """(raw fields, cameras (R, T), images (rgb, mask), extent): the
    benchmark's seeded spheres at a small size."""
    gen = torch.Generator().manual_seed(SEED)
    fields = scene.make_points(P, gen, "cpu")
    cams = scene.hemisphere_cameras(VIEWS, 4.0)
    images = [scene.ground_truth(c, SIZE, SIZE, FOVX, "cpu") for c in cams]
    return fields, cams, images, scene.extent(cams)


def dp_rank(group, steps: int) -> dict:
    """A rank of the test: `steps` steps of the schedule over the group
    from the seeded inputs; the mean losses, the first mean gradient
    (Adam's first moment after step 1 over 1 - beta1), the parameters and
    the statistics after the last step."""
    fields, cams, images, extent = inputs()
    opt = opt_config()
    model = G.GaussianModel(**{k: v.clone() for k, v in fields.items()})
    optimizer = optim.make_optimizer(model, opt, extent)
    z = torch.zeros((3, SIZE, SIZE))
    views = [ViewInputs(make_camera_params(Rm, T, SIZE, SIZE, fovx=FOVX,
                                           fovy=FOVX, device="cpu"),
                        img, mask, z[:1], z) for (Rm, T), (img, mask)
             in zip(cams, images)]
    out = {"losses": []}

    class Stop(Exception):
        pass

    def callback(iteration, metrics):
        out["losses"].append(float(metrics["loss"]))
        if iteration == 1:
            out["grads"] = {k: optimizer.state[getattr(model, k)]["exp_avg"]
                            .numpy() / (1 - optim.BETAS[0])
                            for k in model.fields}
        if iteration == steps:
            raise Stop

    try:
        stage1.run_training_schedule(
            model, optimizer, views, cfg=RasterConfig(SIZE, SIZE), opt=opt,
            spatial_lr_scale=extent, extent=extent,
            generator=torch.Generator().manual_seed(SEED + 1),
            callback=callback, seed=SEED, group=group)
    except Stop:
        pass
    out["params"] = {k: getattr(model, k).detach().numpy()
                     for k in model.fields}
    out["stats"] = {k: getattr(model, k).numpy() for k in R.STATS}
    out["digest"] = dp.replica_digest(model, optimizer)
    return out


def reference(ranks: int, steps: int) -> dict:
    """The reference's data-parallel steps in float64 over the batches
    the schedule draws (`view_batches`, one view a rank)."""
    fields, cams, images, extent = inputs()
    params = {k: v.double().requires_grad_(True) for k, v in fields.items()}
    adam = R.Adam(params)
    stats = R.zero_stats(P, params["xyz"])
    batches = stage1.view_batches(VIEWS, ranks, SEED)
    out = {"losses": []}
    for it in range(1, steps + 1):
        views = []
        for v in next(batches):
            cam = ref_camera(*cams[v], SIZE, SIZE, fovx=FOVX, fovy=FOVX,
                             device="cpu")
            views.append(RefView(type(cam)(*(x.double() for x in cam)),
                                 images[v][0].double(), images[v][1].double()))
        loss, grads = stage1_dp_step(
            params, adam, stats, views, it, cfg=RefRasterConfig(SIZE, SIZE),
            opt=dataclasses.asdict(opt_config()), spatial_lr_scale=extent,
            bg=torch.zeros(3, dtype=torch.float64))
        out["losses"].append(float(loss))
        if it == 1:
            out["grads"] = grads
    out["params"] = {k: v.detach() for k, v in params.items()}
    out["stats"] = stats
    out["start"] = {k: v.double() for k, v in fields.items()}
    return out


def test_view_batches_are_the_jax_draw():
    """One rank draws the schedule's old order (a permutation popped from
    its end, renewed when empty); N ranks draw N views a step from the same
    stream, rank r training on the r-th."""
    rng = np.random.default_rng(4)
    stack, want = [], []
    for _ in range(11):
        if not stack:
            stack = list(rng.permutation(5))
        want.append(stack.pop())
    one = stage1.view_batches(5, 1, 4)
    assert [next(one)[0] for _ in range(11)] == want
    two = stage1.view_batches(5, 2, 4)
    assert sum((next(two) for _ in range(5)), []) == want[:10]


def test_two_ranks_train_as_the_reference_data_parallel_step():
    """run_training_schedule(group=...) on two gloo ranks, against the
    reference's float64 step over the same batches: the mean losses, the
    first mean gradient, the change and the combined statistics, each by
    the benchmark's measures (`benchmark/checks.py`), within ~10x what
    float32 against float64 reads here through the projection, the walk
    and the backward (loss 1.0e-6, grad 1.3e-5, change 4.1e-6, stats
    3.0e-8); the replicas bitwise equal."""
    ranks = spawn(dp_rank, ["cpu", "cpu"], STEPS, timeout_s=300)
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    ref = reference(2, STEPS)
    prog = {k: ({n: torch.as_tensor(v) for n, v in ranks[0][k].items()}
                if isinstance(ranks[0][k], dict) else ranks[0][k])
            for k in ("losses", "grads", "params", "stats")}
    change = lambda d: {k: d["params"][k].double() - ref["start"][k]  # noqa
                        for k in ref["start"]}
    got = checks.train_numbers(dict(prog, change=change(prog)),
                               dict(ref, change=change(ref)))
    assert got["loss"] < 1e-5 and got["grad"] < 1.5e-4, got
    assert got["change"] < 4e-5 and got["stats"] < 3e-7, got
    # one rank would have trained on one view a step: the pair is no
    # single-view step
    one = reference(1, 1)
    assert not math.isclose(one["losses"][0], ref["losses"][0], rel_tol=1e-6)


def test_the_cli_stage1_loop_is_the_schedule(monkeypatch):
    """cli.train's stage-1 loop hands its group, first step, timer and
    camera seed (0) to `run_training_schedule`, its callback behind the
    collapse guard."""
    from relightable3dgaussian_tpu_torch.cli import train as cli_train
    seen = {}

    def schedule(model, optimizer, views, **kw):
        seen.update(kw)

    monkeypatch.setattr(stage1, "run_training_schedule", schedule)
    model = G.GaussianModel(**inputs()[0])
    group = dp.Group((torch.device("cpu"),) * 2, 1, "gloo")
    opt = opt_config()
    cli_train._run_stage1({"model": model, "optimizer": None}, [], None, opt,
                          1.0, 1.0, 7, lambda i, m: None, None, "timer",
                          group=group)
    assert (seen["group"], seen["first_iter"], seen["seed"],
            seen["timer"]) == (group, 7, 0, "timer")


def test_the_collapse_guard_stops_a_bleeding_run():
    from relightable3dgaussian_tpu_torch.cli.train import (ModelCollapseError,
                                                           collapse_guard)
    opt = OptimizationConfig(opacity_reset_interval=3000)
    calls = []
    guarded = collapse_guard(lambda i, m: calls.append(i), 1000, opt)
    d = lambda n: {"densify": G.DensifyStats(0, 0, 0, n)}  # noqa: E731
    guarded(3100, d(900))
    guarded(3200, {})
    with pytest.raises(ModelCollapseError, match="900 -> 300"):
        guarded(3300, d(300))
    assert calls == [3100, 3200]
    collapse_guard(lambda i, m: None, 1000, opt, 0)(3300, d(1))


# PeerRanks: each case in a process of its own, since a peer that leaves
# rank 0 blocked where no interrupt reaches it ends rank 0's process.
PEER_CASE = textwrap.dedent("""
    import sys, time
    sys.path[:0] = [{root!r}, {tests!r}]
    import torch
    from relightable3dgaussian_tpu_torch.parallel import PeerRanks
    from test_torch_dp_schedule import peer

    if __name__ == "__main__":
        peers = PeerRanks(peer, ["cpu"] * 3, {mode!r}, timeout_s={timeout},
                          collective_timeout_s=120, grace_s=5)
        try:
            with peers as group:
                mine = peer(group, {mode!r})
            print("RESULT", mine, peers.results)
        except Exception as e:
            print("ERROR", type(e).__name__, str(e).splitlines()[0])
""")


def peer(group, mode: str) -> float:
    """A rank's part of a PeerRanks case: an all_reduce of its rank + 1;
    rank 1 raises first with "fail" and sleeps 600 s with "stall"."""
    if group.rank == 1 and mode == "fail":
        raise ValueError("rank 1 fails")
    if group.rank == 1 and mode == "stall":
        time.sleep(600)
    t = torch.full((2,), float(group.rank + 1))
    dp.all_reduce_(t, group)
    return float(t[0])


def run_peer_case(mode: str, timeout: float) -> tuple[subprocess.
                                                      CompletedProcess, float]:
    code = PEER_CASE.format(root=str(ROOT), tests=str(ROOT / "tests"),
                            mode=mode, timeout=timeout)
    t0 = time.monotonic()
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240)
    return done, time.monotonic() - t0


def test_peer_ranks_with_the_caller_as_rank_0():
    done, _ = run_peer_case("ok", 120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "RESULT 6.0 [6.0, 6.0]" in done.stdout, done.stdout


@pytest.mark.parametrize("mode,why", [
    ("fail", "RuntimeError rank 1 of 3 failed"),
    ("stall", "TimeoutError 3 ranks of peer not done within 20")])
def test_a_failed_or_stalled_peer_ends_the_run_in_time(mode, why):
    """A peer that raises ends the run at once; one that never reaches the
    collective, at the group's time limit (20 s here), long before the
    collective's own (120 s) or the peer's sleep (600 s). Either way with
    an error: raised in rank 0, or, where rank 0 is blocked past the
    grace, its process ended with exit code 1."""
    done, took = run_peer_case(mode, 20)
    assert why in done.stdout or (
        done.returncode == 1 and "did not leave its work" in done.stderr), (
        done.stdout, done.stderr[-2000:])
    assert took < 20 + 5 + 60, took     # the limit, the grace, start-up


RUN_RANKS_CASE = textwrap.dedent("""
    import argparse, sys
    sys.path[:0] = [{root!r}, {tests!r}]
    from relightable3dgaussian_tpu_torch.cli import run_ranks
    from test_torch_dp_schedule import cli_rank

    if __name__ == "__main__":
        try:
            run_ranks(cli_rank, argparse.Namespace(n_devices=2, fail=True),
                      "cpu")
        except Exception as e:
            print("ERROR", type(e).__name__, str(e).splitlines()[0])
""")


def cli_rank(args, device, group) -> tuple:
    """A CLI's rank function under `run_ranks`: (its process id, its rank,
    an all_reduce of rank + 1). With `args.fail` rank 1 raises while rank
    0 works on in short steps (each a point where an interrupt lands)."""
    if args.fail and group.rank == 1:
        raise ValueError("rank 1 fails")
    if args.fail:
        for _ in range(1200):
            time.sleep(0.1)
    t = torch.full((2,), float(group.rank + 1))
    dp.all_reduce_(t, group)
    return os.getpid(), group.rank, float(t[0])


def test_run_ranks_is_rank_0_in_the_caller():
    """The CLIs' launcher runs rank 0 in the calling process and returns
    its result; the caller's thread count is given back."""
    from relightable3dgaussian_tpu_torch.cli import run_ranks
    threads = torch.get_num_threads()
    got = run_ranks(cli_rank, argparse.Namespace(n_devices=2, fail=False),
                    "cpu")
    assert got == (os.getpid(), 0, 3.0)
    assert torch.get_num_threads() == threads


def test_a_failed_rank_ends_run_ranks_at_once():
    """A rank past rank 0 that raises ends the CLI's run with its error
    while rank 0 still works (its work would last 120 s)."""
    code = RUN_RANKS_CASE.format(root=str(ROOT), tests=str(ROOT / "tests"))
    t0 = time.monotonic()
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240)
    took = time.monotonic() - t0
    assert "ERROR RuntimeError rank 1 of 2 failed" in done.stdout, (
        done.stdout, done.stderr[-2000:])
    assert took < 60, took          # start-up of two processes, no more
