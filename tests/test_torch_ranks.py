"""The port's groups of ranks without the JAX package: the rank functions
the multi-process tests spawn (test_torch_parallel.py, test_torch_cuda.py),
and the tests of the group machinery that need no reference.
`parallel.spawn` pickles a function by its module, and a spawned rank
imports that module: this one imports torch, pytest and the port only, so
a rank never imports jax or the JAX package. Inputs arrive as numpy arrays
and paths; results go back as numpy arrays."""
from __future__ import annotations

import time

import pytest
import torch
import torch.distributed as dist

from relightable3dgaussian_tpu_torch.cli.arguments import rank_devices
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.models import render_neilf
from relightable3dgaussian_tpu_torch.models.lights import DirectLightMap
from relightable3dgaussian_tpu_torch.models.render import ViewInputs
from relightable3dgaussian_tpu_torch.ops import ray_trace
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.parallel import data_parallel as dp
from relightable3dgaussian_tpu_torch.parallel import make_group, spawn
from relightable3dgaussian_tpu_torch.parallel import (make_dp_train_step,
                                                      make_dp_train_step_stage2,
                                                      replicate)
from relightable3dgaussian_tpu_torch.parallel.point_sharded import (
    make_sharded_shading, make_sharded_trace, shard_points)
from relightable3dgaussian_tpu_torch.train import checkpoint, stage1
from relightable3dgaussian_tpu_torch.train.config import OptimizationConfig


def view_inputs(view: dict, device) -> ViewInputs:
    """A view from {"R", "T", "size", "fov", "image", "mask"}."""
    n = view["size"]
    cam = make_camera_params(view["R"], view["T"], n, n, fovx=view["fov"],
                             fovy=view["fov"], device=device)
    z = torch.zeros((3, n, n), device=device)
    return ViewInputs(cam, torch.as_tensor(view["image"], device=device),
                      torch.as_tensor(view["mask"], device=device),
                      z[:1].clone(), z)


def state_arrays(model, optimizer, env=None) -> dict:
    """The model's fields, statistics and gradients, Adam's moments and
    step, and the env map, as numpy arrays."""
    out = {f"params.{k}": getattr(model, k).detach().cpu().numpy()
           for k in model.fields}
    out.update({f"grad.{k}": getattr(model, k).grad.cpu().numpy()
                for k in model.fields})
    out.update({f"stats.{k}": getattr(model, k).cpu().numpy()
                for k in G.STATS})
    for g in optimizer.param_groups:
        state = optimizer.state[g["params"][0]]
        out[f"mu.{g['name']}"] = state["exp_avg"].cpu().numpy()
        out[f"nu.{g['name']}"] = state["exp_avg_sq"].cpu().numpy()
        out[f"step.{g['name']}"] = float(state["step"])
    if env is not None:
        out["env"] = env.env.detach().cpu().numpy()
        out["grad.env"] = env.env.grad.cpu().numpy()
    return out


def run_jobs(group, jobs: list):
    """Each (name, args) of `jobs` as name(group, *args) in turn, one spawn
    for them all; returns their results."""
    return [globals()[name](group, *args) for name, args in jobs]


AUDITED = ("all_reduce", "broadcast", "broadcast_object_list",
           "all_gather_object")


def audited_jobs(group, jobs: list):
    """run_jobs with every torch.distributed collective of AUDITED wrapped
    to record its operand: (results, records), one record a call with the
    job, the call, the operand's dtype, device, contiguity and shape, and
    an all_reduce's op ("sum", "max" or another's name)."""
    records, real = [], {name: getattr(dist, name) for name in AUDITED}
    job = [None]

    def wrap(name):
        def call(*args, **kwargs):
            rec = {"job": job[0], "call": name}
            t = args[0] if args else kwargs.get("tensor")
            if isinstance(t, torch.Tensor):
                rec.update(dtype=t.dtype, device=str(t.device),
                           contiguous=t.is_contiguous(), shape=tuple(t.shape))
            if name == "all_reduce":
                op = kwargs.get("op", args[1] if len(args) > 1
                                else dist.ReduceOp.SUM)
                rec["op"] = {dist.ReduceOp.SUM: "sum",
                             dist.ReduceOp.MAX: "max"}.get(op, str(op))
            records.append(rec)
            return real[name](*args, **kwargs)
        return call

    for name in AUDITED:
        setattr(dist, name, wrap(name))
    try:
        results = []
        for name, args in jobs:
            job[0] = name
            results.append(globals()[name](group, *args))
    finally:
        for name in AUDITED:
            setattr(dist, name, real[name])
    return results, records


def dp_stage1(group, path: str, opt_kw: dict, lr_scale: float, size: int,
              batches: list, iteration: int, densify: dict | None = None):
    """From the train state in `path`, one data-parallel step of each batch
    of views (one view a rank), each from the state afresh; where `densify`
    gives thresholds, the last batch's step starts from zero statistics and
    a densify follows it. Returns the state after each batch's step (and
    the densify's stats)."""
    opt = OptimizationConfig(**opt_kw)
    cfg = RasterConfig(size, size)
    step = make_dp_train_step(group, cfg=cfg, opt=opt,
                              spatial_lr_scale=lr_scale)
    results = []
    for batch in batches:
        _, model, optimizer = checkpoint.load_train_state(
            path, opt, lr_scale, device=group.device)
        replicate(group, model, optimizer)
        if densify is not None and batch is batches[-1]:
            model.reset_stats()
        metrics = step(model, optimizer,
                       [view_inputs(v, group.device) for v in batch],
                       iteration)
        out = state_arrays(model, optimizer)
        out["loss"] = float(metrics["loss"])
        results.append(out)
    if densify is not None:
        gen = torch.Generator(device=group.device).manual_seed(5)
        stats = stage1.densify_step(model, optimizer, gen, opt=opt,
                                    **densify)
        results.append({"densify": tuple(stats), **{
            f"params.{k}": getattr(model, k).detach().cpu().numpy()
            for k in model.fields}})
    return results


def dp_steps(group, path: str, opt_kw: dict, lr_scale: float, size: int,
             batches: list, iteration: int) -> list[str]:
    """From the train state in `path`, replicated from rank 0, one
    data-parallel step of each batch of views in turn (one view a rank);
    returns every rank's replica digest after each step
    (parallel.check_replicas, which raises where they are apart)."""
    opt = OptimizationConfig(**opt_kw)
    _, model, optimizer = checkpoint.load_train_state(
        path, opt, lr_scale, device=group.device)
    replicate(group, model, optimizer)
    step = make_dp_train_step(group, cfg=RasterConfig(size, size), opt=opt,
                              spatial_lr_scale=lr_scale)
    digests = []
    for i, batch in enumerate(batches):
        step(model, optimizer, [view_inputs(v, group.device) for v in batch],
             iteration + i)
        digests.append(dp.check_replicas(group, model, optimizer))
    return digests


def dp_stage2(group, path: str, env_path: str, vis: tuple, opt_kw: dict,
              lr_scale: float, size: int, batch: list, iteration: int):
    """One data-parallel stage-2 step from the state in `path` and
    `env_path` under the visibility cache `vis` (numpy arrays)."""
    opt = OptimizationConfig(**opt_kw)
    _, model, optimizer = checkpoint.load_train_state(
        path, opt, lr_scale, device=group.device)
    _, env, env_optimizer = checkpoint.load_env_checkpoint(
        env_path, opt, device=group.device)
    replicate(group, model, optimizer, env, env_optimizer)
    cache = render_neilf.VisibilityCache(
        *(torch.as_tensor(x, device=group.device) for x in vis))
    step = make_dp_train_step_stage2(group, cfg=RasterConfig(size, size),
                                     opt=opt, spatial_lr_scale=lr_scale)
    metrics = step(model, optimizer, env, env_optimizer, cache,
                   [view_inputs(v, group.device) for v in batch], iteration)
    out = state_arrays(model, optimizer, env)
    out["loss"] = float(metrics["loss"])
    return out


def sharded(group, shading: dict, trace: dict, model_fields: dict,
            sample_num: int):
    """The point-sharded shading (both forms on the largest multiple of the
    ranks of the points, and through `render_neilf._shade_points` on all of
    them), the ray-sharded trace of the given rays and of a model's
    visibility (`update_visibility`), and this rank's share of the shading
    inputs."""
    dev = group.device
    x = {k: torch.as_tensor(v, device=dev) for k, v in shading.items()}
    env = DirectLightMap.from_raw(x.pop("env"))
    args = (x["base"], x["rough"], x["normals"], x["view"], x["incidents"],
            env, x["vis"], x["dirs"], x["areas"])
    out = {}
    # the sharded functions take a multiple of the ranks; _shade_points pads
    even = args[0].shape[0] - args[0].shape[0] % group.size
    cut = [a if a is env else a[:even] for a in args]
    with torch.no_grad():
        out["pbr"], out["diffuse"] = make_sharded_shading(group)(*cut)
        full = make_sharded_shading(group, full_extras=True)
        out["full_pbr"], extras = full(*cut)
        out.update({f"full.{k}": v for k, v in extras.items()})
        cache = render_neilf.VisibilityCache(x["vis"], x["dirs"], x["areas"])
        out["eval_pbr"], eval_extras = render_neilf._shade_points(
            *args[:5], env, cache, sharded_shading=full)
        out.update({f"eval.{k}": v for k, v in eval_extras.items()})
        out["share"] = shard_points(x["base"][:even], group)

        t = {k: torch.as_tensor(v, device=dev) for k, v in trace.items()}
        bvh = ray_trace.build_bvh(t["xyz"], t["scaling"], t["rot"], t["op"],
                                  t["nrm"])
        tracer = make_sharded_trace(group)
        out["trace"], out["overflow"] = tracer(
            bvh, t["rays_o"], t["rays_d"], with_overflow=True,
            max_clusters=8, max_supers=4)
        out["last_stats"] = dict(tracer.last_stats)
        model = G.GaussianModel.from_numpy(model_fields, device=dev)
        out["visibility"] = render_neilf.update_visibility(
            model, sample_num, sharded_trace=tracer).visibility
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def fail_on_rank(group, rank: int):
    """Raise on `rank`; the others wait in a collective."""
    if group.rank == rank:
        raise ValueError(f"rank {rank} fails")
    dp.all_reduce_(torch.ones(1), group)


def stall_on_rank(group, rank: int, seconds: float):
    """`rank` sleeps `seconds` before its collective; the others wait in
    theirs."""
    if group.rank == rank:
        time.sleep(seconds)
    dp.all_reduce_(torch.ones(1), group)


def test_sharded_shading_refuses_training():
    group = make_group(["cpu"])
    from relightable3dgaussian_tpu_torch.parallel.point_sharded import \
        make_sharded_shading
    with pytest.raises(ValueError, match="eval path"):
        render_neilf.render_view(None, None, None, None, None, None, True,
                                 sharded_shading=make_sharded_shading(group))


def test_share_needs_a_multiple_of_the_ranks():
    from relightable3dgaussian_tpu_torch.parallel.point_sharded import \
        shard_points
    group = dp.Group((torch.device("cpu"),) * 2, 1, "gloo")
    assert torch.equal(shard_points(torch.arange(6), group),
                       torch.arange(3, 6))
    with pytest.raises(ValueError, match="multiple"):
        shard_points(torch.arange(5), group)


def test_backend_follows_the_device_layout():
    assert dp.choose_backend(["cpu", "cpu"]) == "gloo"
    assert dp.choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert dp.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert dp.choose_backend(["cuda", "cuda:1"]) == "nccl"
    with pytest.raises(ValueError):
        dp.choose_backend(["cpu", "cuda:0"])


def test_a_failed_rank_fails_spawn():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn(fail_on_rank, ["cpu", "cpu"], 1, timeout_s=120)


def test_a_stalled_rank_fails_spawn_within_the_collective_timeout():
    """A rank that does not reach a collective: the one waiting in it fails
    after the group's collective timeout (5 s here), and spawn with it,
    long before the stalled rank would arrive (120 s)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        spawn(stall_on_rank, ["cpu", "cpu"], 1, 120.0, timeout_s=110,
              collective_timeout_s=5)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("n,count", [(2, 2), (2, 4), (4, 4), (4, 8)])
def test_rank_devices_give_each_rank_its_card(monkeypatch, n, count):
    """--n_devices n on a machine of `count` cards: rank r on cuda:r, so
    the group's backend is NCCL."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    devices = rank_devices(n, torch.device("cuda"))
    assert devices == [torch.device("cuda", r) for r in range(n)]
    assert dp.choose_backend(devices) == "nccl"


@pytest.mark.parametrize("n", [2, 4])
def test_rank_devices_refuse_more_ranks_than_cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=f"--n_devices {n} requested but "
                                         "only 1 CUDA"):
        rank_devices(n, torch.device("cuda"))


@pytest.mark.parametrize("operand,why", [
    (lambda: torch.ones(3, dtype=torch.bool), "bool"),
    (lambda: torch.ones(3, 2).t(), "contiguous: False"),
    (lambda: torch.ones(3, device="meta"), "on meta")])
def test_nccl_collectives_refuse_what_nccl_cannot_take(operand, why):
    """Under NCCL an operand must be a contiguous tensor of NCCL_DTYPES on
    the rank's device: all_reduce_ raises before the collective (a gloo
    group takes them)."""
    group = dp.Group((torch.device("cpu"),) * 2, 0, "nccl")
    with pytest.raises(ValueError, match=why):
        dp.all_reduce_(operand(), group)
    dp._check_operand(torch.ones(3), group)
    dp._check_operand(operand(), dp.Group(group.devices, 0, "gloo"))
