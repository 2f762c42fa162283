"""The port's `prune_only`, the model's covariance and visibility getters,
`Camera`'s pose properties and `MetricsLogger.image` against the JAX
package's, on the CPU, from the same seeded numpy inputs.

`prune_only`: the JAX package zeroes the pruned rows of its padded arrays
and clears their `active` bit; the port removes them. Both keep the
survivors in slot order, so the port's rows are compared with JAX's active
rows in order: the selection exactly (rtol 0, atol 0), the values to 1e-6.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models import gaussians as jax_gaussians
from relightable3dgaussian_tpu.scene import cameras as jax_cameras
from relightable3dgaussian_tpu.utils import logging as jax_logging
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.scene import cameras
from relightable3dgaussian_tpu_torch.train.config import OptimizationConfig
from relightable3dgaussian_tpu_torch.train.optim import make_optimizer
from relightable3dgaussian_tpu_torch.utils import logging as port_logging
from test_torch_densify import jax_train_state, port_state
from test_torch_ops import t

PRUNE = dict(min_opacity=0.005, extent=2.0)


def prune_terms(params, aux, active, max_screen_size: float) -> dict:
    """Each of prune_only's four terms on the active rows."""
    op = np.asarray(jax_gaussians.get_opacity(params))[:, 0]
    max_scale = np.asarray(jax_gaussians.get_scaling(params)).max(-1)
    return {"opacity": (op < PRUNE["min_opacity"])[active],
            "weights": (np.asarray(aux.weights_accum) < G.WEIGHTS_PRUNE)[active],
            "screen": (np.asarray(aux.max_radii2d) > max_screen_size)[active],
            "world": ((max_scale > 0.1 * PRUNE["extent"])
                      & (max_screen_size < np.inf))[active]}


@pytest.mark.parametrize("max_screen_size", [math.inf, 20.0])
def test_prune_only_matches_jax(tmp_path, max_screen_size):
    """The survivors (JAX's new active rows), their parameters, Adam
    moments and kept statistics; weights_accum zeroed; the count; every
    group's step kept. Each of the four terms prunes some rows (the
    screen-size and world-size terms only with a finite max_screen_size)."""
    params, aux, opt_state, active = jax_train_state(11)
    terms = prune_terms(params, aux, active, max_screen_size)
    for name, hit in terms.items():
        fires = name in ("opacity", "weights") or max_screen_size < math.inf
        assert (int(hit.sum()) > 0) == fires, name
    _, new_aux, (mu, nu), want_n = jax_gaussians.prune_only(
        params, aux, (opt_state.mu, opt_state.nu),
        max_screen_size=max_screen_size, **PRUNE)
    model, optimizer = port_state(tmp_path, params, aux, opt_state)

    got_n = G.prune_only(model, optimizer, max_screen_size=max_screen_size,
                         **PRUNE)

    keep = np.asarray(new_aux.active)
    assert got_n == int(want_n) == int(np.any(list(terms.values()), 0).sum())
    assert model.num_points == int(keep.sum()) == int(active.sum()) - got_n
    np.testing.assert_allclose(model.xyz.detach().numpy(),
                               np.asarray(params.xyz)[keep], rtol=0, atol=0)
    for g in optimizer.param_groups:
        name, param = g["name"], g["params"][0]
        assert param is getattr(model, name)
        np.testing.assert_allclose(param.detach().numpy(),
                                   np.asarray(getattr(params, name))[keep],
                                   rtol=0, atol=1e-6, err_msg=name)
        state = optimizer.state[param]
        assert float(state["step"]) == 37
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            np.testing.assert_allclose(
                state[key].numpy(), np.asarray(getattr(tree, name))[keep],
                rtol=0, atol=1e-6, err_msg=f"{name} {key}")
    for k in G.STATS:
        np.testing.assert_allclose(getattr(model, k).numpy(),
                                   np.asarray(getattr(new_aux, k))[keep],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert float(model.weights_accum.abs().max()) == 0.0
    assert float(model.max_radii2d.max()) > 0.0


def test_prune_only_before_any_step_and_the_step_after(tmp_path):
    """An optimizer with no state yet (no field stepped) survives the prune
    with none; the next step moves every field of the pruned model."""
    params, aux, opt_state, _ = jax_train_state(12)
    model, _ = port_state(tmp_path, params, aux, opt_state)
    optimizer = make_optimizer(model, OptimizationConfig(), 1.0)
    n = model.num_points
    pruned = G.prune_only(model, optimizer, max_screen_size=20.0, **PRUNE)
    assert 0 < pruned < n and model.num_points == n - pruned
    assert len(optimizer.state) == 0
    before = {k: getattr(model, k).detach().clone() for k in G.FIELDS}
    for g in optimizer.param_groups:
        assert g["params"][0] is getattr(model, g["name"])
        g["params"][0].grad = torch.ones_like(g["params"][0])
        g["lr"] = 0.01
    optimizer.step()
    for k in G.FIELDS:
        assert optimizer.state[getattr(model, k)]["exp_avg"].shape[0] == n - pruned
        assert float((getattr(model, k).detach() - before[k]).abs().min()) > 0, k


# the getters

def pbr_params(seed: int):
    """jax_train_state's params with random PBR fields, and the active mask."""
    params, _, _, active = jax_train_state(seed)
    rng = np.random.default_rng(seed)
    c = params.capacity
    pbr = {k: jnp.asarray(rng.normal(size=(c,) + shape).astype(np.float32))
           for k, shape in G.PBR_SHAPES.items()}
    return params.replace(**pbr), active


def test_getters_match_jax():
    """get_visibility_shs and inverse_roughness exactly as JAX's (a concat,
    and one sigmoid inverse of the same float32 values: 1e-6); the packed
    covariance at a scaling modifier of 1.3 as test_torch_dense's
    covariance3d_packed (rtol 1e-6, atol 1e-7); its inverse to 1e-6 of
    each point's largest entry: entries reach ~1e6 where a scale is ~1e-3,
    and float32 products of 1/s² summed in another order cancel in the
    small off-diagonal ones."""
    params, active = pbr_params(13)
    model = G.GaussianModel.from_numpy(
        {k: np.asarray(getattr(params, k)) for k in G.FIELDS + G.PBR_FIELDS},
        active, device="cpu")
    assert model.has_pbr
    np.testing.assert_array_equal(
        model.get_visibility_shs.detach().numpy(),
        np.asarray(jax_gaussians.get_visibility_shs(params))[active])
    y = np.random.default_rng(14).uniform(0.1, 0.98, (50, 1)).astype(np.float32)
    np.testing.assert_allclose(G.inverse_roughness(t(y)).numpy(),
                               jax_gaussians.inverse_roughness(jnp.asarray(y)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        model.get_covariance(1.3).detach().numpy(),
        np.asarray(jax_gaussians.get_covariance(params, 1.3))[active],
        rtol=1e-6, atol=1e-7)
    inv = model.get_inverse_covariance(1.3).detach().numpy()
    want = np.asarray(jax_gaussians.get_inverse_covariance(params, 1.3))[active]
    row_max = np.abs(want).max(-1, keepdims=True)
    np.testing.assert_allclose(inv / row_max, want / row_max, rtol=0,
                               atol=1e-6)
    assert model.get_covariance().shape == (int(active.sum()), 6)


# Camera's pose properties

CAMERA_CASES = {
    "fov": dict(fovx=0.9, fovy=0.7),
    "intrinsics": dict(fovx=None, fovy=None, fx=410.5, fy=395.25, cx=161.0,
                       cy=118.5),
    "translated_scaled": dict(fovx=1.1, fovy=0.8,
                              trans=np.array([0.3, -0.2, 0.5]), scale=1.7),
}


@pytest.mark.parametrize("case", CAMERA_CASES)
def test_camera_pose_properties_match_jax(case):
    """world_view_transform, c2w, camera_center and intrinsics() of a
    seeded pose, from the FoV and from fx, fy, cx, cy, to 1e-6."""
    rng = np.random.default_rng(15)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    kw = dict(uid=3, R=q, T=rng.normal(size=3), width=320, height=240,
              **CAMERA_CASES[case])
    want, got = jax_cameras.Camera(**kw), cameras.Camera(**kw)
    for name in ("world_view_transform", "c2w", "camera_center"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.intrinsics(), want.intrinsics(),
                               rtol=1e-6, atol=1e-6)
    assert got.intrinsics().dtype == np.float32
    assert got.world_view_transform.shape == got.c2w.shape == (4, 4)


# MetricsLogger.image

class StubWriter:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step):
        self.images.append((tag, np.array(img), step))

    def close(self):
        pass


def test_metrics_logger_image_matches_jax(tmp_path):
    """The writer gets JAX's call: the tag, the image clipped to [0, 1] and
    the step, from numpy or a tensor; without TensorBoard nothing happens."""
    img = np.random.default_rng(16).normal(0.5, 1.0, (3, 8, 6)).astype(np.float32)
    loggers = []
    for package, sub in ((jax_logging, "jax"), (port_logging, "port")):
        logger = package.MetricsLogger(str(tmp_path / sub),
                                       use_tensorboard=False)
        logger._tb = StubWriter()
        loggers.append(logger)
    jax_logger, port_logger = loggers
    jax_logger.image(7, "train/render", img)
    port_logger.image(7, "train/render", img)
    port_logger.image(8, "train/render", torch.from_numpy(img))
    (tag, want, step), = jax_logger._tb.images
    assert (tag, step) == ("train/render", 7)
    assert want.min() == 0.0 and want.max() == 1.0
    for (got_tag, got, got_step), s in zip(port_logger._tb.images, (7, 8)):
        assert (got_tag, got_step) == (tag, s)
        np.testing.assert_array_equal(got, want)
    silent = port_logging.MetricsLogger(str(tmp_path / "none"),
                                        use_tensorboard=False)
    silent.image(1, "x", img)
    for logger in (*loggers, silent):
        logger.close()
