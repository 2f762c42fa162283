"""The port's stage 2 (PBR) against the JAX package's, on the CPU.

Visibility, the stage-2 render (train and eval) and one whole train step
start from the same state in both packages: a JAX stage-2 training state
saved in the named-npz format (with its env-light file beside it) and the
JAX visibility cache handed to both. Tolerances are stated at each
comparison.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models import gaussians as jax_gaussians
from relightable3dgaussian_tpu.models import render_neilf as jax_neilf
from relightable3dgaussian_tpu.models.lights import DirectLightParams
from relightable3dgaussian_tpu.models.render import ViewInputs as JaxViewInputs
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu.train import config as jax_config_mod
from relightable3dgaussian_tpu.train import optim as jax_optim
from relightable3dgaussian_tpu.train import stage2 as jax_stage2
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.models import render_neilf
from relightable3dgaussian_tpu_torch.models.render import ViewInputs
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.train import checkpoint, optim, stage2
from relightable3dgaussian_tpu_torch.train.config import (
    STAGE2_NERF_SYNTHETIC, ModelConfig, OptimizationConfig, PipelineConfig)
from relightable3dgaussian_tpu_torch.utils import trace
from test_torch_ops import SIZE, cameras, jax_config, t

N, S = 300, 8
OPT = OptimizationConfig(**STAGE2_NERF_SYNTHETIC)
JAX_OPT = jax_config_mod.OptimizationConfig(**STAGE2_NERF_SYNTHETIC)
SPATIAL_LR_SCALE = 1.3
FIRST_ITER = 30_000        # stage 2 continues stage 1's count


def test_stage2_config_is_the_jax_one():
    assert STAGE2_NERF_SYNTHETIC == jax_config_mod.STAGE2_NERF_SYNTHETIC
    assert (ModelConfig().env_resolution
            == jax_config_mod.ModelConfig().env_resolution == 16)
    assert (PipelineConfig().sample_num
            == jax_config_mod.PipelineConfig().sample_num == 64)
    assert render_neilf.train_feature_dim(OPT) == jax_neilf.train_feature_dim(
        JAX_OPT) == 3
    assert render_neilf.EVAL_FEATURE_DIM == jax_neilf.EVAL_FEATURE_DIM
    assert render_neilf.TRAIN_FEATURE_DIM == jax_neilf.TRAIN_FEATURE_DIM
    full = dataclasses.replace(OPT, lambda_depth_var=1.0,
                               lambda_light_smooth=1.0,
                               lambda_base_color_smooth=1.0,
                               lambda_roughness_smooth=1.0)
    assert render_neilf.train_feature_channels(full) == \
        jax_neilf.train_feature_channels(dataclasses.replace(
            JAX_OPT, lambda_depth_var=1.0, lambda_light_smooth=1.0,
            lambda_base_color_smooth=1.0, lambda_roughness_smooth=1.0))


@pytest.mark.parametrize("rest", [(0.0001, 0.0025), (-1.0, -1.0)])
def test_pbr_learning_rates_match_jax(rest):
    """Every field's rate, the negative-rest fallbacks (1/20 of the base
    rate) included."""
    kw = dict(STAGE2_NERF_SYNTHETIC, light_rest_lr=rest[0],
              visibility_rest_lr=rest[1])
    got = optim.learning_rates(OptimizationConfig(**kw), 31_000, 2.0)
    want = jax_optim.learning_rates(jax_config_mod.OptimizationConfig(**kw),
                                    31_000, 2.0)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-5), k


# ---------------------------------------------------------------------------
# a JAX stage-2 state, every row active (the capacity is the point count, so
# both packages take the Morton box of the same points)
# ---------------------------------------------------------------------------

def jax_params():
    rng = np.random.default_rng(21)
    f32 = np.float32
    n = N
    return jax_gaussians.GaussianParams(
        xyz=jnp.asarray(rng.uniform(-1.0, 1.0, (n, 3)).astype(f32)),
        normal=jnp.asarray(rng.normal(size=(n, 3)).astype(f32)),
        shs_dc=jnp.asarray(rng.normal(size=(n, 1, 3)).astype(f32)),
        shs_rest=jnp.asarray((rng.normal(size=(n, 15, 3)) * 0.1).astype(f32)),
        scaling=jnp.asarray(np.log(rng.uniform(0.03, 0.15, (n, 3))).astype(f32)),
        rotation=jnp.asarray(rng.normal(size=(n, 4)).astype(f32)),
        opacity=jnp.asarray(rng.normal(0.5, 1.5, (n, 1)).astype(f32)),
        base_color=jnp.asarray(rng.normal(size=(n, 3)).astype(f32)),
        roughness=jnp.asarray(rng.normal(size=(n, 1)).astype(f32)),
        incidents_dc=jnp.asarray((rng.normal(size=(n, 1, 3)) * 0.5).astype(f32)),
        incidents_rest=jnp.asarray((rng.normal(size=(n, 15, 3)) * 0.1).astype(f32)),
        visibility_dc=jnp.asarray(rng.normal(size=(n, 1, 1)).astype(f32)),
        visibility_rest=jnp.asarray(rng.normal(size=(n, 15, 1)).astype(f32)))


def jax_cfg(feature_dim: int):
    return dataclasses.replace(jax_config(3), feature_dim=feature_dim)


def views():
    """A view and its ground truth: a smooth colour ramp, so the residuals
    are nowhere exactly 0."""
    cam_j, cam_t = cameras()
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    gt = np.stack([0.2 + 0.5 * xx, 0.3 + 0.4 * yy, 0.6 - 0.3 * xx * yy])
    mask = np.ones((1, SIZE, SIZE), np.float32)
    z = np.zeros((3, SIZE, SIZE), np.float32)
    return (JaxViewInputs(cam_j, jnp.asarray(gt), jnp.asarray(mask),
                          jnp.asarray(z[:1]), jnp.asarray(z)),
            ViewInputs(cam_t, t(gt), t(mask), t(z[:1]), t(z)))


def port_vis(vis) -> render_neilf.VisibilityCache:
    return render_neilf.VisibilityCache(
        t(vis.visibility), t(vis.incident_dirs), t(vis.incident_areas))


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    """Two JAX stage-2 train steps from a fresh stage-2 start (so Adam's
    moments are not zero), saved as a checkpoint and its env-light file;
    the third step and the gradients of its loss."""
    params = jax_params()
    aux = jax_gaussians.init_aux(N, N)
    vis = jax_neilf.update_visibility(params, aux.active, S)
    env = DirectLightParams(env=jnp.asarray(
        np.random.default_rng(22).uniform(size=(8, 16, 3)).astype(np.float32)))
    opt_state = jax_optim.init_adam(params).replace(
        count=jnp.asarray(FIRST_ITER, jnp.int32))
    env_state = jax_optim.init_array_adam(env.env)
    view_j, view_t = views()
    kw = dict(cfg=jax_cfg(3), opt=JAX_OPT, spatial_lr_scale=SPATIAL_LR_SCALE)
    for it in (FIRST_ITER + 1, FIRST_ITER + 2):
        params, aux, opt_state, env, env_state, _ = jax_stage2.train_step(
            params, aux, opt_state, env, env_state, vis, view_j,
            jnp.asarray(it), **kw)
    d = tmp_path_factory.mktemp("state")
    path = str(d / "chkpnt30002.npz")
    jax_checkpoint.save_checkpoint(path, FIRST_ITER + 2, params=params,
                                   aux=aux, opt_state=opt_state)
    env_path = str(d / "env_light_chkpnt30002.npz")
    jax_checkpoint.save_checkpoint(env_path, FIRST_ITER + 2, env=env,
                                   env_state=env_state)

    def loss_fn(p, e, m2d):
        return jax_neilf.render_neilf(
            view_j, p, aux.active, kw["cfg"], jnp.zeros(3), e, vis, JAX_OPT,
            is_training=True, mean2d_offset=m2d)["loss"]

    grads = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(
        params, env, jnp.zeros((N, 2)))
    step = jax_stage2.train_step(params, aux, opt_state, env, env_state, vis,
                                 view_j, jnp.asarray(FIRST_ITER + 3), **kw)
    return dict(path=path, env_path=env_path, params=params, aux=aux,
                opt_state=opt_state, env=env, env_state=env_state, vis=vis,
                grads=grads, step=step, view_t=view_t, view_j=view_j)


@pytest.fixture(scope="module")
def port_step(jax_state):
    """The port's third step from the files the JAX state was saved to."""
    it, model, optimizer = checkpoint.load_train_state(
        jax_state["path"], OPT, SPATIAL_LR_SCALE, device="cpu")
    it_env, env, env_optimizer = checkpoint.load_env_checkpoint(
        jax_state["env_path"], OPT, device="cpu")
    assert it == it_env == FIRST_ITER + 2
    before = (trace.counter("k4.launches"), trace.counter("k4.bwd_launches"))
    metrics = stage2.train_step(
        model, optimizer, env, env_optimizer, port_vis(jax_state["vis"]),
        jax_state["view_t"], FIRST_ITER + 3, cfg=RasterConfig(SIZE, SIZE),
        opt=OPT, spatial_lr_scale=SPATIAL_LR_SCALE)
    assert (trace.counter("k4.launches"), trace.counter("k4.bwd_launches")) == before
    return model, optimizer, env, env_optimizer, metrics


def test_update_visibility_matches_jax():
    """The Fibonacci samples to 2e-6 and the traced visibility to 2e-3 (the
    JAX tracer's tolerance, tests/test_ray_trace.py) on the same model."""
    params = jax_params()
    want = jax_neilf.update_visibility(params, jnp.ones(N, bool), S)
    model = G.GaussianModel.from_numpy(
        {k: np.asarray(v) for k, v in vars(params).items()}, device="cpu")
    before = trace.counter("k3.launches")
    got = render_neilf.update_visibility(model, S)
    assert trace.counter("k3.launches") == before
    np.testing.assert_allclose(got.incident_dirs.numpy(), want.incident_dirs,
                               atol=2e-6, rtol=0)
    np.testing.assert_array_equal(got.incident_areas.numpy(),
                                  want.incident_areas)
    v = got.visibility.numpy()
    np.testing.assert_allclose(v, want.visibility, atol=2e-3, rtol=0)
    assert 0.05 < (v == 0).mean() < 0.95, "the cloud must occlude"


def render_pair(jax_state, is_training: bool):
    """JAX's and the port's render_neilf of the saved state, the same
    visibility cache in both."""
    _, model = checkpoint.load_checkpoint(jax_state["path"], device="cpu")
    _, env, _ = checkpoint.load_env_checkpoint(jax_state["env_path"], OPT,
                                               device="cpu")
    fd = 3 if is_training else jax_neilf.EVAL_FEATURE_DIM
    want = jax.jit(jax_neilf.render_neilf, static_argnums=(3, 7),
                   static_argnames=("is_training",))(
        jax_state["view_j"], jax_state["params"], jax_state["aux"].active,
        jax_cfg(fd), jnp.zeros(3), jax_state["env"], jax_state["vis"],
        JAX_OPT, is_training=is_training)
    with torch.no_grad():
        got = render_neilf.render_neilf(
            jax_state["view_t"], model, RasterConfig(SIZE, SIZE),
            torch.zeros(3), env, port_vis(jax_state["vis"]), OPT,
            is_training=is_training)
    return got, want


def test_render_neilf_train_matches_jax(jax_state):
    """The train render: images 2e-5 (the rasterizer's tolerance), the
    per-point diffuse light rtol 1e-4 / atol 1e-5 (the shading's), the loss
    terms rtol 1e-4."""
    got, want = render_pair(jax_state, True)
    assert "visibility" not in got and "base_color" not in got
    for k in ("render", "pbr", "opacity"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=2e-5,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(got["diffuse_light"].numpy(),
                               want["diffuse_light"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["env"].numpy(), want["env"], rtol=1e-6)
    assert got["num_rendered"] == int(want["num_rendered"]) > 0
    for k, v in want["tb_dict"].items():
        np.testing.assert_allclose(float(got["tb_dict"][k]), float(v),
                                   rtol=1e-4, err_msg=k)


def test_render_neilf_eval_matches_jax(jax_state):
    """The eval render, 27 feature channels (A = 32): sRGB maps 1e-4 where
    the opacity is at least 0.05 (the maps are divided by it and sRGB's
    slope is up to 12.92), the environment background 1e-5."""
    got, want = render_pair(jax_state, False)
    ok = np.asarray(want["opacity"])[0] >= 0.05
    assert ok.sum() > 1000
    for k in ("pbr", "base_color", "diffuse", "specular", "lights",
              "local_lights", "global_lights", "roughness", "visibility",
              "normal", "pbr_env", "render_env"):
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy()[:, ok],
                                   np.asarray(want[k])[:, ok], atol=1e-4,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(got["env_only"].numpy(), want["env_only"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["render"].numpy(), want["render"],
                               atol=2e-5, rtol=0)


def test_train_step_loss_matches_jax(jax_state, port_step):
    *_, metrics = port_step
    want = jax_state["step"][-1]
    np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("psnr", "psnr_pbr", "light_mean", "loss_light",
              "loss_env_smooth", "l1_pbr", "ssim_pbr"):
        np.testing.assert_allclose(float(metrics[k]), float(want[k]),
                                   rtol=1e-4, err_msg=k)
    assert metrics["n_active"] == int(want["n_active"]) == N


def test_train_step_gradients_match_jax(jax_state, port_step):
    """Every field's gradient and the env map's to 1e-4 of its largest
    entry (sums over pixels and samples in another order); the normals and
    the visibility SH get zeros, as in the JAX step."""
    model, _, env, _, _ = port_step
    g_params, g_env = jax_state["grads"]
    for k in model.fields:
        w = np.asarray(getattr(g_params, k))
        g = getattr(model, k).grad.numpy()
        if k in ("normal", "visibility_dc", "visibility_rest"):
            assert np.abs(w).max() == 0.0 and np.abs(g).max() == 0.0, k
            continue
        scale = np.abs(w).max()
        assert scale > 0, k
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-4, err_msg=k)
    w = np.asarray(g_env.env)
    np.testing.assert_allclose(env.env.grad.numpy() / np.abs(w).max(),
                               w / np.abs(w).max(), atol=1e-4)


def test_train_step_adam_update_matches_jax(jax_state, port_step):
    """The updated parameters and env map agree to 1% of each learning
    rate (Adam divides by sqrt(nu)), the step counts carry on."""
    model, optimizer, env, env_optimizer, _ = port_step
    new_params, _, new_opt, new_env, new_env_state, _ = jax_state["step"]
    lrs = jax_optim.learning_rates(JAX_OPT, FIRST_ITER + 3, SPATIAL_LR_SCALE)
    for g in optimizer.param_groups:
        k = g["name"]
        assert g["lr"] == pytest.approx(float(lrs[k]), rel=1e-5), k
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(getattr(new_params, k)),
                                   atol=0.01 * float(lrs[k]), rtol=0,
                                   err_msg=k)
        assert float(optimizer.state[g["params"][0]]["step"]) == int(
            new_opt.count) == FIRST_ITER + 3
    np.testing.assert_allclose(env.env.detach().numpy(),
                               np.asarray(new_env.env), atol=0.01 * OPT.env_lr,
                               rtol=0)
    assert float(env_optimizer.state[env.env]["step"]) == int(
        new_env_state.count) == 3


def test_train_step_densification_stats_match_jax(jax_state, port_step):
    model, *_ = port_step
    new_aux = jax_state["step"][1]
    for k in G.STATS:
        w = np.asarray(getattr(new_aux, k))
        g = getattr(model, k).numpy()
        if k in ("denom", "max_radii2d"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "normal_grad_accum":
            assert np.abs(g).max() == np.abs(w).max() == 0.0
        else:
            np.testing.assert_allclose(g / np.abs(w).max(),
                                       w / np.abs(w).max(), atol=1e-4,
                                       err_msg=k)


def test_stage2_adam_start(tmp_path):
    """From a stage-1 train state: zero moments for every field, PBR fields
    included, and the stage-1 step count carried over, as cli/train.py
    restarts Adam (explicit state: torch would create it lazily)."""
    rng = np.random.default_rng(30)
    d = {k: np.asarray(v) for k, v in vars(jax_params()).items()
         if k in G.FIELDS}
    model = G.GaussianModel.from_numpy(d, device="cpu")
    assert not model.has_pbr
    o1 = optim.make_optimizer(model, OPT, 1.0)
    for g in o1.param_groups:
        p = g["params"][0]
        o1.state[p] = {"step": torch.tensor(1234.0),
                       "exp_avg": t(rng.normal(size=p.shape).astype(np.float32)),
                       "exp_avg_sq": torch.ones_like(p)}
    path = str(tmp_path / "chkpnt1234.npz")
    checkpoint.save_checkpoint(path, 1234, model, o1)
    it, model, o1 = checkpoint.load_train_state(path, OPT, 1.0,
                                                device="cpu")
    G.add_pbr_params(model)
    assert model.has_pbr and model.fields == G.FIELDS + G.PBR_FIELDS
    o2 = optim.make_optimizer(model, OPT, 1.0)
    optim.start_state(o2, int(o1.state[o1.param_groups[0]["params"][0]]["step"]))
    assert [g["name"] for g in o2.param_groups] == list(model.fields)
    for g in o2.param_groups:
        st = o2.state[g["params"][0]]
        assert float(st["step"]) == 1234.0 == it
        assert st["exp_avg"].shape == g["params"][0].shape
        assert float(st["exp_avg"].abs().max()) == 0.0
        assert float(st["exp_avg_sq"].abs().max()) == 0.0
    # the first stage-2 step bias-corrects with the carried count (1235),
    # as JAX's adam_step does from count 1234
    for k in model.fields:
        getattr(model, k).grad = torch.ones_like(getattr(model, k))
    before = model.base_color.detach().clone()
    o2.step()
    lr = optim.learning_rates(OPT, 0, 1.0)["base_color"]
    b1, b2 = optim.BETAS
    want = lr * (0.1 / (1 - b1 ** 1235)) / (np.sqrt(0.001 / (1 - b2 ** 1235)))
    np.testing.assert_allclose((before - model.base_color.detach()).numpy(),
                               want, rtol=1e-5)


def test_pbr_checkpoint_round_trip_jax_port_jax(jax_state, tmp_path):
    """A JAX stage-2 state (PBR fields and their moments) loads in the port
    and the port's file restores in JAX's load_checkpoint; the env file
    too, both ways."""
    it, model, optimizer = checkpoint.load_train_state(
        jax_state["path"], OPT, SPATIAL_LR_SCALE, device="cpu")
    assert model.has_pbr
    out = str(tmp_path / "chkpnt30002.npz")
    checkpoint.save_checkpoint(out, it, model, optimizer)
    params, opt_state = jax_state["params"], jax_state["opt_state"]
    template = jax_gaussians.add_pbr_params(jax_gaussians.create_from_pcd(
        jnp.zeros((1, 3)), jnp.full((1, 3), 0.5), jnp.asarray([[0.0, 0, 1]]),
        capacity=N)[0])
    it2, restored = jax_checkpoint.load_checkpoint(
        out, params=template, aux=jax_gaussians.init_aux(N, 0),
        opt_state=jax_optim.init_adam(template))
    assert it2 == it == FIRST_ITER + 2
    for k in G.FIELDS + G.PBR_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(restored["params"], k)),
                                      np.asarray(getattr(params, k)), err_msg=k)
        for mine, theirs in ((restored["opt_state"].mu, opt_state.mu),
                             (restored["opt_state"].nu, opt_state.nu)):
            np.testing.assert_array_equal(np.asarray(getattr(mine, k)),
                                          np.asarray(getattr(theirs, k)),
                                          err_msg=k)
    assert int(restored["opt_state"].count) == int(opt_state.count)

    files = set(np.load(jax_state["env_path"]).files)
    assert files == {"__iteration__", "env.env", "env_state.mu",
                     "env_state.nu", "env_state.count"}
    it3, env, env_opt = checkpoint.load_env_checkpoint(jax_state["env_path"],
                                                       OPT, device="cpu")
    env_out = checkpoint.env_checkpoint_path(out)
    assert env_out == str(tmp_path / "env_light_chkpnt30002.npz")
    checkpoint.save_env_checkpoint(env_out, it3, env, env_opt)
    e0 = DirectLightParams(env=jnp.zeros((8, 16, 3)))
    _, r = jax_checkpoint.load_checkpoint(
        env_out, env=e0, env_state=jax_optim.init_array_adam(e0.env))
    np.testing.assert_array_equal(np.asarray(r["env"].env),
                                  np.asarray(jax_state["env"].env))
    for f in ("mu", "nu", "count"):
        np.testing.assert_array_equal(
            np.asarray(getattr(r["env_state"], f)),
            np.asarray(getattr(jax_state["env_state"], f)), err_msg=f)


def test_stage1_file_loads_without_pbr(tmp_path):
    """A stage-1 file's zero-width PBR leaves are ignored, and the port's
    stage-1 file has them, zero-width, for JAX's stage-1 template."""
    d = {k: np.asarray(v) for k, v in vars(jax_params()).items()
         if k in G.FIELDS}
    path = str(tmp_path / "chkpnt1.npz")
    checkpoint.save_checkpoint(path, 1,
                               G.GaussianModel.from_numpy(d, device="cpu"))
    with np.load(path) as f:
        assert f["params.base_color"].shape == (0, 3)
    _, model = checkpoint.load_checkpoint(path, device="cpu")
    assert not model.has_pbr and model.fields == G.FIELDS


def test_densify_keeps_pbr_rows_aligned():
    """Clones and split children carry their parent's PBR rows, pruned rows
    drop theirs, new rows get zero moments."""
    params = jax_params()
    d = {k: np.asarray(v) for k, v in vars(params).items()}
    model = G.GaussianModel.from_numpy(d, device="cpu")
    opt = optim.make_optimizer(model, OPT, 1.0)
    optim.start_state(opt, 5)
    tag = torch.arange(N, dtype=torch.float32)
    with torch.no_grad():
        model.roughness[:, 0] = tag          # each row names its parent
        model.xyz_grad_accum.fill_(1.0)
        model.denom.fill_(1.0)
        model.weights_accum.fill_(1.0)
        model.opacity[:10] = -10.0           # pruned
    noise = torch.zeros((G.N_SPLIT, N, 3))
    stats = G.densify_and_prune_with_noise(
        model, opt, noise, grad_threshold=1e-3, grad_normal_threshold=1e9,
        min_opacity=0.005, extent=1.0, max_screen_size=float("inf"),
        percent_dense=0.1)
    assert stats.n_pruned == 10 and stats.n_active == model.num_points
    assert model.roughness.shape == (model.num_points, 1)
    for k in G.PBR_FIELDS:
        assert getattr(model, k).shape[0] == model.num_points, k
    parent = model.roughness[:, 0].long()
    big = np.asarray(jax_gaussians.get_scaling(params)).max(-1) > 0.1
    keep = np.arange(N) >= 10
    expect = np.concatenate([np.arange(N)[keep], np.arange(N)[keep & ~big],
                             np.arange(N)[keep & big]])
    np.testing.assert_array_equal(parent.numpy(), expect)
    np.testing.assert_array_equal(model.base_color.detach().numpy(),
                                  d["base_color"][expect])
    assert [g["name"] for g in opt.param_groups] == list(model.fields)


def toy_views(size: int):
    """tests/test_stage2.py's toy: 40 points uniform in [-0.7, 0.7]³ with
    +z normals, a grey 0.4 ground truth seen from z = 3.5."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.7, 0.7, (40, 3)).astype(np.float32)
    from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
    cam = make_camera_params(np.eye(3), np.array([0.0, 0.0, 3.5]), size, size,
                             fovx=0.9, fovy=0.9, device="cpu")
    z = torch.zeros((3, size, size))
    return pts, ViewInputs(cam, torch.full((3, size, size), 0.4), z[:1] + 1,
                           z[:1], z)


def test_toy_stage2_run_raises_pbr_psnr():
    """tests/test_stage2.py::test_train_steps_improve_pbr_psnr on the port:
    set-up from a stage-1 model, 30 steps through run_training_schedule,
    the PBR PSNR of the last 5 steps above the first 5 by more than 0.5 dB."""
    size = 32
    pts, view = toy_views(size)
    model = G.create_from_pcd(t(pts), torch.full((40, 3), 0.5),
                              torch.tensor([[0.0, 0, 1]]).repeat(40, 1))
    vis, env = stage2.setup_stage2(model, 16, env_resolution=8, light_init=1.0,
                                   generator=torch.Generator().manual_seed(0))
    assert vis.visibility.shape == (40, 16, 1)
    opt = OptimizationConfig(lambda_light=0.01, lambda_env_smooth=0.01,
                             iterations=30, densify_until_iter=0)
    optimizer = optim.make_optimizer(model, opt, 1.0)
    optim.start_state(optimizer, 0)
    psnr = []
    stage2.run_training_schedule(
        model, optimizer, env, optim.make_env_optimizer(env, opt), vis,
        [view], cfg=RasterConfig(size, size, sh_degree=0), opt=opt,
        spatial_lr_scale=1.0, extent=2.0, generator=torch.Generator(),
        callback=lambda it, m: psnr.append(float(m["psnr_pbr"])))
    assert len(psnr) == 30 and np.isfinite(psnr).all()
    assert np.mean(psnr[-5:]) > np.mean(psnr[:5]) + 0.5, psnr


def test_schedule_continues_the_count_with_the_jax_gates(monkeypatch):
    """Steps first_iter + 1 .. iterations, the JAX camera order from `seed`,
    densify (then a re-trace of the cache) and reset iterations as the JAX
    host loop gates them (no white-background reset in stage 2)."""
    opt = OptimizationConfig(iterations=60, densify_from_iter=5,
                             densify_until_iter=50, densification_interval=10,
                             opacity_reset_interval=15)
    calls, seen = [], []
    monkeypatch.setattr(stage2, "train_step",
                        lambda *a, **kw: seen.append((a[6], a[5])) or {})
    monkeypatch.setattr(stage2, "densify_step",
                        lambda *a, **kw: calls.append(("densify", a[3], a[4])))
    monkeypatch.setattr(stage2, "reset_opacity_step",
                        lambda *a: calls.append(("reset",)))
    vis = render_neilf.VisibilityCache(torch.zeros((1, 4, 1)), None, None)
    monkeypatch.setattr(stage2, "update_visibility",
                        lambda m, s: calls.append(("trace", s)) or vis)
    out = stage2.run_training_schedule(
        None, None, None, None, vis, list(range(6)),
        cfg=RasterConfig(8, 8, white_background=True), opt=opt,
        spatial_lr_scale=1.0, extent=1.0, generator=None, first_iter=20,
        seed=3)
    rng, stack, order = np.random.default_rng(3), [], []
    for _ in range(40):
        if not stack:
            stack = list(rng.permutation(6))
        order.append(stack.pop())
    assert [v for _, v in seen] == order
    assert [it for it, _ in seen] == list(range(21, 61))
    # densify at 30 and 40 (before 50), resets at 30 and 45
    assert calls == [("densify", 2e-9, 20.0), ("trace", 4), ("reset",),
                     ("densify", 2e-9, 20.0), ("trace", 4), ("reset",)]
    assert out is vis
