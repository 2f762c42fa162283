"""The port's multi-GPU training and evaluation (parallel/) against the JAX
package's two-device CPU mesh, on the CPU.

Each multi-process case spawns two gloo ranks (`parallel.spawn`) running a
function of tests/test_torch_ranks.py (which imports only the port), with
a 120 s limit, so a hang fails. One data-parallel step is held to
tests/test_torch_train.py's tolerances: the loss rtol 1e-4, gradients 1e-3
of each field's largest entry, the updated parameters 0.01 of each learning
rate, the statistics 1e-4 of their largest entry (denom and the radii
exactly). The replicas must be bitwise equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models import gaussians as jax_gaussians
from relightable3dgaussian_tpu.models.lights import DirectLightParams
from relightable3dgaussian_tpu.models.lights import init_direct_light
from relightable3dgaussian_tpu.models.lights import query_light as jax_query
from relightable3dgaussian_tpu.models.render import ViewInputs as JaxViewInputs
from relightable3dgaussian_tpu.models.render_neilf import (
    VisibilityCache as JaxVisibilityCache)
from relightable3dgaussian_tpu.models.render_neilf import (
    _shade_points as jax_shade_points)
from relightable3dgaussian_tpu.ops import camera as jax_camera
from relightable3dgaussian_tpu.ops import ray_trace as jax_rt
from relightable3dgaussian_tpu.parallel import make_dp_train_step as jax_dp
from relightable3dgaussian_tpu.parallel import (
    make_dp_train_step_stage2 as jax_dp2)
from relightable3dgaussian_tpu.parallel import make_mesh
from relightable3dgaussian_tpu.parallel import replicate as jax_replicate
from relightable3dgaussian_tpu.parallel import shard_views as jax_shard_views
from relightable3dgaussian_tpu.parallel.data_parallel import stack_views
from relightable3dgaussian_tpu.parallel.point_sharded import (
    make_sharded_shading as jax_sharded_shading)
from relightable3dgaussian_tpu.parallel.point_sharded import (
    make_sharded_trace as jax_sharded_trace)
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu.train import config as jax_config_mod
from relightable3dgaussian_tpu.train import optim as jax_optim
from relightable3dgaussian_tpu.utils import graphics as jax_graphics
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.models import render_neilf
from relightable3dgaussian_tpu_torch.models.lights import DirectLightMap
from relightable3dgaussian_tpu_torch.models.render import render
from relightable3dgaussian_tpu_torch.ops import ray_trace
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.parallel import (make_dp_train_step,
                                                      make_group, spawn)
from relightable3dgaussian_tpu_torch.train import checkpoint, optim, stage1
from relightable3dgaussian_tpu_torch.train.config import OptimizationConfig
from relightable3dgaussian_tpu_torch.parallel import data_parallel as dp
import test_torch_ranks as torch_ranks
from test_torch_ops import SIZE, jax_config, t
from test_torch_ray_trace import shell_scene, surface_rays
from test_torch_stage2 import FIRST_ITER, JAX_OPT, N, S, jax_cfg, jax_params
from test_torch_stage2 import OPT as OPT2
from test_torch_stage2 import SPATIAL_LR_SCALE as LR2
from test_torch_stage2 import views as stage2_views
from test_torch_train import OPT, SPATIAL_LR_SCALE, jax_view

SPAWN_TIMEOUT_S = 120
CPU2 = ["cpu", "cpu"]
DENSIFY = dict(grad_normal_threshold=1e-4, max_screen_size=20.0, extent=4.0)


def rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def view_pair(angle: float, seed: int):
    """A view from a camera turned `angle` about y, 4 from the origin, with
    a seeded smooth ground truth (residuals nowhere exactly 0): the JAX
    ViewInputs and the dict torch_ranks.view_inputs takes."""
    R, T = rot_y(angle), np.array([0.0, 0.0, 4.0])
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    a, b = np.random.default_rng(seed).uniform(0.2, 0.6, 2)
    gt = np.stack([a + 0.4 * xx, b + 0.3 * yy, 0.7 - 0.3 * xx * yy]
                  ).astype(np.float32)
    mask = np.ones((1, SIZE, SIZE), np.float32)
    z = np.zeros((3, SIZE, SIZE), np.float32)
    cam = jax_camera.make_camera_params(R, T, SIZE, SIZE, fovx=0.9, fovy=0.9)
    return (JaxViewInputs(cam, jnp.asarray(gt), jnp.asarray(mask),
                          jnp.asarray(z[:1]), jnp.asarray(z)),
            dict(R=R, T=T, size=SIZE, fov=0.9, image=gt, mask=mask))


@pytest.fixture(scope="module")
def jax_dp_step():
    return jax_dp(make_mesh(jax.devices()[:2]), cfg=jax_config(3),
                  opt=jax_config_mod.OptimizationConfig(**OPT),
                  spatial_lr_scale=SPATIAL_LR_SCALE)


@pytest.fixture(scope="module")
def stage1_state(tmp_path_factory, jax_dp_step):
    """A JAX stage-1 train state after 3 two-device steps on two views
    (Adam's moments not zero), saved as a checkpoint, and its 4th step."""
    params, aux, active, _, _ = jax_view()
    views = [view_pair(0.0, 1), view_pair(0.6, 2)]
    mesh = make_mesh(jax.devices()[:2])
    state = jax_replicate((params, aux, jax_optim.init_adam(params)), mesh)
    batch = jax_shard_views(stack_views([v for v, _ in views]), mesh)
    for it in (1, 2, 3):
        *state, _ = jax_dp_step(*state, batch, jnp.asarray(it))
    path = str(tmp_path_factory.mktemp("dp") / "chkpnt3.npz")
    jax_checkpoint.save_checkpoint(path, 3, params=state[0], aux=state[1],
                                   opt_state=state[2])
    step4 = jax_dp_step(*state, batch, jnp.asarray(4))
    return dict(path=path, active=active, views=views, step4=step4)


def stage2_view_dict():
    """test_torch_stage2's view as torch_ranks takes it."""
    _, view_t = stage2_views()
    return dict(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), size=SIZE,
                fov=0.9, image=view_t.image.numpy(),
                mask=view_t.image_mask.numpy())


@pytest.fixture(scope="module")
def stage2_state(tmp_path_factory):
    """test_torch_stage2's model with a seeded visibility cache and env map,
    after 2 two-device stage-2 steps on its view twice (Adam's moments not
    zero), saved with its env-light file; the 3rd step."""
    params = jax_params()
    rng = np.random.default_rng(23)
    dirs, areas = jax_graphics.fibonacci_sphere_sampling(
        jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32)), S)
    vis = JaxVisibilityCache(
        visibility=jnp.asarray(rng.uniform(size=(N, S, 1)).astype(np.float32)),
        incident_dirs=dirs, incident_areas=areas)
    env = DirectLightParams(env=jnp.asarray(
        rng.uniform(size=(8, 16, 3)).astype(np.float32)))
    mesh = make_mesh(jax.devices()[:2])
    step = jax_dp2(mesh, cfg=jax_cfg(3), opt=JAX_OPT, spatial_lr_scale=LR2)
    state = jax_replicate((
        params, jax_gaussians.init_aux(N, N),
        jax_optim.init_adam(params).replace(
            count=jnp.asarray(FIRST_ITER, jnp.int32)),
        env, jax_optim.init_array_adam(env.env), vis), mesh)
    view_j, _ = stage2_views()
    batch = jax_shard_views(stack_views([view_j] * 2), mesh)
    for it in (FIRST_ITER + 1, FIRST_ITER + 2):
        *head, _ = step(*state, batch, jnp.asarray(it))
        state = (*head, state[5])
    d = tmp_path_factory.mktemp("dp2")
    path, env_path = str(d / "chkpnt.npz"), str(d / "env_light_chkpnt.npz")
    jax_checkpoint.save_checkpoint(path, FIRST_ITER + 2, params=state[0],
                                   aux=state[1], opt_state=state[2])
    jax_checkpoint.save_checkpoint(env_path, FIRST_ITER + 2, env=state[3],
                                   env_state=state[4])
    return dict(path=path, env_path=env_path, aux=state[1],
                vis=tuple(np.asarray(x) for x in vis[:3]),
                step3=step(*state, batch, jnp.asarray(FIRST_ITER + 3)))


@pytest.fixture(scope="module")
def ranks(stage1_state, stage2_state):
    """One spawn of two gloo ranks for every multi-process case: a stage-1
    step on the two views, one on the first view twice followed by a
    densify; a stage-2 step on its view twice; the sharded shading and
    trace."""
    v0, v1 = (v for _, v in stage1_state["views"])
    view2 = stage2_view_dict()
    xyz, scaling, rot, op, nrm = shell_scene(3, 1024)
    rays_o, rays_d = surface_rays(xyz, nrm, 64, 8)
    trace = dict(xyz=xyz, scaling=scaling, rot=rot, op=op, nrm=nrm,
                 rays_o=rays_o, rays_d=rays_d)
    model = {k: np.asarray(v) for k, v in vars(jax_params()).items()}
    jobs = [
        ("dp_stage1", (stage1_state["path"], OPT, SPATIAL_LR_SCALE, SIZE,
                       [[v0, v1], [v0, v0]], 4, DENSIFY)),
        ("dp_stage2", (stage2_state["path"], stage2_state["env_path"],
                       stage2_state["vis"], dict(vars(OPT2)), LR2, SIZE,
                       [view2, view2], FIRST_ITER + 3)),
        ("sharded", (shading_inputs(), trace, model, S))]
    (r0, audit0), (r1, audit1) = spawn(torch_ranks.audited_jobs, CPU2, jobs,
                                       timeout_s=SPAWN_TIMEOUT_S)
    out = {name: (a, b) for (name, _), a, b in zip(jobs, r0, r1)}
    out["audit"] = (audit0, audit1)
    return out


def test_every_collective_operand_is_one_nccl_takes(ranks):
    """Every collective the spawn above made (data-parallel stage-1 steps
    with replicate and a densify, a stage-2 step, the sharded shading and
    trace and update_visibility through it), recorded on each rank: a
    tensor operand is contiguous, on the rank's device and of a type NCCL
    reduces; an all_reduce sums or takes the max, and the max is taken
    once a data-parallel step, of the radii (float32 [P]); both ranks made
    the same calls in the same order."""
    audit0, audit1 = ranks["audit"]
    assert [(r["job"], r["call"], r.get("shape"), r.get("op"))
            for r in audit0] == [(r["job"], r["call"], r.get("shape"),
                                  r.get("op")) for r in audit1]
    for rec in audit0 + audit1:
        if "dtype" in rec:
            assert rec["dtype"] in dp.NCCL_DTYPES, rec
            assert rec["contiguous"] and rec["device"] == "cpu", rec
        if rec["call"] == "all_reduce":
            assert rec["op"] in ("sum", "max"), rec
    jobs = {r["job"] for r in audit0}
    assert jobs == {"dp_stage1", "dp_stage2", "sharded"}
    for job, steps in (("dp_stage1", 2), ("dp_stage2", 1)):
        maxes = [r for r in audit0 if r["job"] == job and r.get("op") == "max"]
        assert len(maxes) == steps, maxes
        assert all(r["dtype"] == torch.float32 and len(r["shape"]) == 1
                   for r in maxes)
        assert any(r["call"] == "broadcast" for r in audit0
                   if r["job"] == job)            # replicate
    assert any(r["call"] == "all_reduce" for r in audit0
               if r["job"] == "sharded")


@pytest.fixture(scope="module")
def dp_stage1_ranks(ranks):
    return ranks["dp_stage1"]


def port_views(stage1_state):
    return [torch_ranks.view_inputs(v, "cpu")
            for _, v in stage1_state["views"]]


def hand_combination(path, views, iteration=4):
    """Each view's gradients and statistics alone at the same state, the
    gradients averaged, the statistics summed (radii: max), one Adam step."""
    opt = OptimizationConfig(**OPT)
    cfg = RasterConfig(SIZE, SIZE)
    grads, contribs = [], []
    for v in views:
        _, model, _ = checkpoint.load_train_state(path, opt, SPATIAL_LR_SCALE,
                                                  device="cpu")
        m2d = torch.zeros((model.num_points, 2), requires_grad=True)
        res = render(v, model, cfg, torch.zeros(3), opt, is_training=True,
                     iteration=iteration, mean2d_offset=m2d)
        stage1.backward_or_zero_grads(res["loss"], model, m2d)
        grads.append({k: getattr(model, k).grad for k in model.fields})
        contribs.append(G.densification_contribs(
            m2d.grad, model.normal.grad, res["weights"][:, 0].detach(),
            res["radii"], (SIZE, SIZE)))
    _, model, optimizer = checkpoint.load_train_state(
        path, opt, SPATIAL_LR_SCALE, device="cpu")
    for k in model.fields:
        getattr(model, k).grad = sum(g[k] for g in grads) / len(grads)
    optim.set_learning_rates(optimizer, optim.learning_rates(
        opt, iteration, SPATIAL_LR_SCALE))
    optimizer.step()
    G.apply_stat_contribs(model, G.StatContribs(
        *(sum(c[i] for c in contribs) for i in range(4)),
        radii=torch.stack([c.radii for c in contribs]).amax(0)))
    return torch_ranks.state_arrays(model, optimizer)


def assert_state_close(got: dict, want: dict, iteration: int, rows=None,
                       grads: bool = True):
    """Parameters within 0.01 of each learning rate, gradients within 1e-3
    and statistics within 1e-4 of their largest entry, denom and radii
    exactly; `rows` picks the active rows of a padded JAX state."""
    rows = slice(None) if rows is None else rows
    lrs = optim.learning_rates(OptimizationConfig(**OPT), iteration,
                               SPATIAL_LR_SCALE)
    for key, w in want.items():
        kind, name = key.split(".")
        w = np.asarray(w)[rows]
        g = got[key]
        if kind == "params":
            np.testing.assert_allclose(g, w, atol=0.01 * lrs[name], rtol=0,
                                       err_msg=key)
        elif kind == "grad" and grads:
            scale = np.abs(w).max()
            np.testing.assert_allclose(g / scale, w / scale, atol=1e-3,
                                       err_msg=key)
        elif kind == "stats" and name in ("denom", "max_radii2d"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif kind == "stats":
            scale = np.abs(w).max()
            np.testing.assert_allclose(g / scale, w / scale, atol=1e-4,
                                       err_msg=key)


def assert_replicas_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dp_replicas_are_bitwise_equal(dp_stage1_ranks):
    r0, r1 = dp_stage1_ranks
    for a, b in zip(r0, r1):
        assert_replicas_equal(a, b)


def test_dp_step_equals_the_hand_combination(stage1_state, dp_stage1_ranks):
    got = dp_stage1_ranks[0][0]
    want = hand_combination(stage1_state["path"], port_views(stage1_state))
    assert_state_close(got, {k: v for k, v in want.items()
                             if k.split(".")[0] in ("params", "grad", "stats")},
                       4)
    for k in want:
        if k.startswith("step."):
            assert got[k] == want[k] == 4


def test_dp_step_matches_jax_two_device_mesh(stage1_state, dp_stage1_ranks):
    p, a, _, metrics = stage1_state["step4"]
    got = dp_stage1_ranks[0][0]
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-4)
    want = {f"params.{k}": getattr(p, k) for k in G.FIELDS}
    want.update({f"stats.{k}": getattr(a, k) for k in G.STATS})
    assert_state_close(got, want, 4, rows=stage1_state["active"])


def test_dp_densify_after_accumulation(stage1_state, dp_stage1_ranks):
    """Two ranks on the same view from zero statistics: the statistics are
    twice one view's (radii: the same), and densify decides from
    accum/denom, so it clones, splits and prunes as from one view's
    statistics doubled."""
    *_, twice, dens = dp_stage1_ranks[0]
    opt = OptimizationConfig(**OPT)
    _, model, optimizer = checkpoint.load_train_state(
        stage1_state["path"], opt, SPATIAL_LR_SCALE, device="cpu")
    model.reset_stats()
    stage1.train_step(model, optimizer, port_views(stage1_state)[0], 4,
                      cfg=RasterConfig(SIZE, SIZE), opt=opt,
                      spatial_lr_scale=SPATIAL_LR_SCALE)
    for k in G.STATS:
        one = getattr(model, k).numpy()
        want = one if k == "max_radii2d" else 2 * one
        np.testing.assert_allclose(twice[f"stats.{k}"], want, rtol=1e-6,
                                   atol=0, err_msg=k)
        if k != "max_radii2d":
            getattr(model, k).mul_(2)
    stats = stage1.densify_step(
        model, optimizer, torch.Generator().manual_seed(5), opt=opt,
        **DENSIFY)
    assert dens["densify"] == tuple(stats)
    assert stats.n_cloned + stats.n_split > 0
    for k in model.fields:
        np.testing.assert_allclose(dens[f"params.{k}"],
                                   getattr(model, k).detach().numpy(),
                                   atol=1e-6, err_msg=k)


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_dp_one_rank_is_the_single_device_trainer(stage1_state,
                                                  deterministic):
    """A group of one rank (no process group) over 12 steps with densifies
    after steps 7 and 11 and an opacity reset after 13: exactly the
    single-device trainer's state. (Both in torch's deterministic mode: the
    CPU backward's scatter-adds sum in a thread-dependent order, so without
    it not even two single-device runs agree bitwise at ~1k points.)"""
    opt = OptimizationConfig(**OPT)
    cfg = RasterConfig(SIZE, SIZE)
    group = make_group(["cpu"])
    assert group.size == 1 and group.backend is None
    step = make_dp_train_step(group, cfg=cfg, opt=opt,
                              spatial_lr_scale=SPATIAL_LR_SCALE)
    runs = []
    for use_dp in (False, True):
        _, model, optimizer = checkpoint.load_train_state(
            stage1_state["path"], opt, SPATIAL_LR_SCALE, device="cpu")
        gen = torch.Generator().manual_seed(0)
        views = port_views(stage1_state)
        losses = []
        for it in range(4, 16):
            view = views[it % 2]
            if use_dp:
                m = step(model, optimizer, [view], it)
            else:
                m = stage1.train_step(model, optimizer, view, it, cfg=cfg,
                                      opt=opt,
                                      spatial_lr_scale=SPATIAL_LR_SCALE)
            losses.append(float(m["loss"]))
            if it in (7, 11):
                stage1.densify_step(model, optimizer, gen, opt=opt,
                                    grad_normal_threshold=99999.0,
                                    max_screen_size=20.0, extent=4.0)
            if it == 13:
                stage1.reset_opacity_step(model, optimizer)
        runs.append((losses, torch_ranks.state_arrays(model, optimizer)))
    (l1, s1), (l2, s2) = runs
    assert l1 == l2
    assert_replicas_equal(s1, s2)
    assert s1["params.xyz"].shape[0] != stage1_state["active"].sum()


def test_dp_stage2_matches_jax(stage2_state, ranks):
    """Two ranks on the same view against the JAX two-device stage-2 step:
    the env map's gradient averaged with the model's, the statistics grown
    by twice one view's, the replicas bitwise equal."""
    r0, r1 = ranks["dp_stage2"]
    assert_replicas_equal(r0, r1)
    p, a, _, e, _, metrics = stage2_state["step3"]
    np.testing.assert_allclose(r0["loss"], float(metrics["loss"]), rtol=1e-4)
    lrs = optim.learning_rates(OPT2, FIRST_ITER + 3, LR2)
    for k in G.FIELDS + G.PBR_FIELDS:
        np.testing.assert_allclose(r0[f"params.{k}"],
                                   np.asarray(getattr(p, k)),
                                   atol=0.01 * lrs[k], rtol=0, err_msg=k)
        assert r0[f"step.{k}"] == FIRST_ITER + 3
    np.testing.assert_allclose(r0["env"], np.asarray(e.env),
                               atol=0.01 * OPT2.env_lr, rtol=0)
    np.testing.assert_array_equal(r0["stats.denom"], np.asarray(a.denom))
    grown = r0["stats.denom"] - np.asarray(stage2_state["aux"].denom)
    assert set(np.unique(grown)) <= {0.0, 2.0} and grown.max() == 2.0
    assert np.abs(r0["grad.env"]).max() > 0


# ---------------------------------------------------------------------------
# point- and ray-sharded stage-2 evaluation
# ---------------------------------------------------------------------------

def unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def shading_inputs(n: int = 61, s: int = 16):
    """tests/test_parallel.py's shading case in numpy: 61 points (not a
    multiple of the ranks), 16 samples, an 8x16 env map."""
    rng = np.random.default_rng(8)
    normals = unit(rng, (n, 3))
    dirs, areas = jax_graphics.fibonacci_sphere_sampling(normals, s)
    return dict(base=rng.uniform(size=(n, 3)).astype(np.float32),
                rough=rng.uniform(0.1, 0.9, (n, 1)).astype(np.float32),
                normals=normals, view=unit(rng, (n, 3)),
                incidents=(rng.normal(size=(n, 16, 3)) * 0.1
                           ).astype(np.float32),
                vis=rng.uniform(size=(n, s, 1)).astype(np.float32),
                dirs=np.asarray(dirs), areas=np.asarray(areas),
                env=np.asarray(init_direct_light(8, 0.5).env))


@pytest.fixture(scope="module")
def sharded_ranks(ranks):
    """The sharded job: the shading of 61 points (test_parallel.py's case in
    numpy), the trace of its escalation scene's surface rays, and the
    visibility of test_torch_stage2's model."""
    xyz, scaling, rot, op, nrm = shell_scene(3, 1024)
    rays_o, rays_d = surface_rays(xyz, nrm, 64, 8)
    return dict(ranks=ranks["sharded"], shading=shading_inputs(),
                trace=dict(xyz=xyz, scaling=scaling, rot=rot, op=op, nrm=nrm,
                           rays_o=rays_o, rays_d=rays_d),
                model={k: np.asarray(v)
                       for k, v in vars(jax_params()).items()})


def even(x: dict) -> dict:
    """The shading inputs' first 60 points: what the sharded functions
    take directly (a multiple of the ranks)."""
    return {k: (v if k == "env" else v[:60]) for k, v in x.items()}


def test_sharded_shading_matches_jax_and_the_unsharded_port(sharded_ranks):
    """Within 1e-6 of the unsharded port (the same per-point arithmetic on
    a share) and of JAX's two-device sharded shading within the eval
    shading's parity bounds (tests/test_torch_shading.py: rtol 1e-4, atol
    1e-5)."""
    x = even(sharded_ranks["shading"])
    r0, r1 = sharded_ranks["ranks"]
    assert_replicas_equal(*({k: v for k, v in r.items() if k != "share"}
                            for r in (r0, r1)))
    np.testing.assert_array_equal(r0["share"], x["base"][:30])
    np.testing.assert_array_equal(r1["share"], x["base"][30:])
    env = DirectLightParams(env=jnp.asarray(x["env"]))
    args = [jnp.asarray(x[k]) for k in ("base", "rough", "normals", "view",
                                        "incidents")]
    mesh = make_mesh(jax.devices()[:2])
    pbr, diffuse = jax_sharded_shading(mesh)(*args, env, *(
        jnp.asarray(x[k]) for k in ("vis", "dirs", "areas")))
    np.testing.assert_allclose(r0["pbr"], pbr, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r0["diffuse"], diffuse, rtol=1e-4, atol=1e-5)
    ref = rendering_equation_port(x)
    np.testing.assert_allclose(r0["pbr"], ref[0].numpy(), atol=1e-6)
    for k in ("diffuse_light", "specular", "incident_lights",
              "local_incident_lights", "global_incident_lights"):
        np.testing.assert_allclose(r0[f"full.{k}"], ref[1][k].numpy(),
                                   atol=1e-6, err_msg=k)


def rendering_equation_port(x):
    """The unsharded port's eval shading (`_shade_points`)."""
    env = DirectLightMap.from_raw(t(x["env"]))
    cache = render_neilf.VisibilityCache(t(x["vis"]), t(x["dirs"]),
                                         t(x["areas"]))
    with torch.no_grad():
        return render_neilf._shade_points(
            t(x["base"]), t(x["rough"]), t(x["normals"]), t(x["view"]),
            t(x["incidents"]), env, cache)


def test_sharded_eval_shading_matches_jax_shade_points(sharded_ranks):
    """`_shade_points` with the sharded shading against the JAX package's
    with its two-device one, on 61 points (both pad to the ranks), every
    reduced extra (rtol 1e-4, atol 1e-5); and within 1e-6 of the unsharded
    port's."""
    x = sharded_ranks["shading"]
    r0 = sharded_ranks["ranks"][0]
    env = DirectLightParams(env=jnp.asarray(x["env"]))
    vis = JaxVisibilityCache(visibility=jnp.asarray(x["vis"]),
                             incident_dirs=jnp.asarray(x["dirs"]),
                             incident_areas=jnp.asarray(x["areas"]))
    fn = jax_sharded_shading(make_mesh(jax.devices()[:2]), full_extras=True)
    pbr, ex = jax_shade_points(*(jnp.asarray(x[k]) for k in (
        "base", "rough", "normals", "view", "incidents")), env, vis,
        sharded_shading=fn)
    np.testing.assert_allclose(r0["eval_pbr"], pbr, rtol=1e-4, atol=1e-5)
    for k in ("diffuse_light", "specular"):
        np.testing.assert_allclose(r0[f"eval.{k}"], ex[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k in ("incident_lights", "local_incident_lights",
              "global_incident_lights"):
        np.testing.assert_allclose(r0[f"eval.{k}"], np.asarray(ex[k]).mean(-2),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(jax_query(env, jnp.asarray(x["dirs"])).mean()) > 0
    ref_pbr, ref_ex = rendering_equation_port(x)
    np.testing.assert_allclose(r0["eval_pbr"], ref_pbr.numpy(), atol=1e-6)
    for k, v in ref_ex.items():
        np.testing.assert_allclose(r0[f"eval.{k}"], v.numpy(), atol=1e-6,
                                   err_msg=k)


def test_sharded_trace_matches_jax_and_one_launch(sharded_ranks):
    """Each ray's visibility bitwise the unsharded trace's (a ray's T does
    not depend on which rays it is traced with), within 2e-3 of JAX's
    two-device trace at caps that hold every cluster; no overflow, no
    retrace round."""
    tr = sharded_ranks["trace"]
    r0 = sharded_ranks["ranks"][0]
    bvh = ray_trace.build_bvh(*(t(tr[k]) for k in ("xyz", "scaling", "rot",
                                                   "op", "nrm")))
    whole = ray_trace.trace_visibility(bvh, t(tr["rays_o"]), t(tr["rays_d"]))
    np.testing.assert_array_equal(r0["trace"], whole.numpy())
    assert not r0["overflow"].any() and r0["overflow"].dtype == np.int32
    assert r0["last_stats"] == {"rounds": 0, "retraced_rays": 0}
    jax_bvh = jax_rt.build_bvh(*(tr[k] for k in ("xyz", "scaling", "rot",
                                                 "op", "nrm")))
    # caps at the cluster and super counts: one exact pass, no escalation
    fn = jax_sharded_trace(make_mesh(jax.devices()[:2]), adaptive=False,
                           ray_chunk=64)
    want = fn(jax_bvh, jnp.asarray(tr["rays_o"]), jnp.asarray(tr["rays_d"]),
              max_clusters=jax_bvh.cluster_lo.shape[0],
              max_supers=jax_bvh.super_lo.shape[0])
    np.testing.assert_allclose(r0["trace"], np.asarray(want), atol=2e-3)
    assert 0.02 < (r0["trace"] < 0.9).mean() < 0.98


def test_sharded_update_visibility_is_the_unsharded_one(sharded_ranks):
    """update_visibility through the ray-sharded trace (P·S = 2400 rays,
    padded to the ranks where odd) equals the one-launch trace bitwise."""
    model = G.GaussianModel.from_numpy(sharded_ranks["model"], device="cpu")
    want = render_neilf.update_visibility(model, S).visibility.numpy()
    np.testing.assert_array_equal(sharded_ranks["ranks"][0]["visibility"],
                                  want)
    assert 0 < (want > 0).mean() < 1
