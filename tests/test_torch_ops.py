"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same seeded numpy inputs go through each JAX function and its port
counterpart. The compositor reference is `ops/composite.py::composite`, which
is what the JAX `rasterize` runs off the TPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.ops import RasterConfig as JaxRasterConfig
from relightable3dgaussian_tpu.ops import camera as jax_camera
from relightable3dgaussian_tpu.ops import composite as jax_composite
from relightable3dgaussian_tpu.ops import projection as jax_projection
from relightable3dgaussian_tpu.ops import surface as jax_surface
from relightable3dgaussian_tpu.ops import tiles as jax_tiles
from relightable3dgaussian_tpu.utils import graphics as jax_graphics
from relightable3dgaussian_tpu.utils import quaternions as jax_quat
from relightable3dgaussian_tpu.utils import sh as jax_sh
from relightable3dgaussian_tpu_torch.ops import camera, composite, composite_cuda
from relightable3dgaussian_tpu_torch.ops import projection, surface, tiles
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.utils import graphics, quaternions, sh, trace

SIZE = 64
N = 300


def share_cpu_threads() -> int:
    """Gives torch's intra-op pool this process's share of the cores,
    cpu_count // PYTEST_XDIST_WORKER_COUNT (1 without pytest-xdist), as
    parallel/data_parallel.py gives CPU ranks theirs: pytest-xdist's workers
    run side by side, and each torch pool the size of the machine contends
    for every core. Called on import, so every test file of the port that
    runs torch on the CPU imports this module."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(threads)
    return threads


share_cpu_threads()


def random_scene(seed: int, n: int = N, deg: int = 0, spread: float = 1.2):
    """Seeded numpy scene on the pattern of test_rasterizer_parity.random_scene:
    (means, scales, unit quaternions, opacity [n, 1], shs [n, (deg+1)², 3],
    features [n, 5])."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = rng.uniform(-spread, spread, (n, 3)).astype(f32)
    scales = rng.uniform(0.02, 0.15, (n, 3)).astype(f32)
    rots = rng.normal(size=(n, 4)).astype(f32)
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    opacity = rng.uniform(0.2, 0.95, (n, 1)).astype(f32)
    colors = rng.uniform(size=(n, 3)).astype(f32)
    shs = np.zeros((n, (deg + 1) ** 2, 3), f32)
    shs[:, 0] = (colors - 0.5) / jax_sh.C0
    shs[:, 1:] = rng.normal(size=(n, (deg + 1) ** 2 - 1, 3)) * 0.1
    features = (rng.normal(size=(n, 5)) * 0.5).astype(f32)
    return means, scales, rots, opacity, shs, features


def jax_config(deg: int) -> JaxRasterConfig:
    """A budget no 300-gaussian 64x64 scene can overflow: 16 tiles per
    gaussian is the whole grid, and 32 chunks x 32 cover 1024 pairs a tile."""
    return JaxRasterConfig(height=SIZE, width=SIZE, feature_dim=5,
                           sh_degree=deg, buffer_multiple=16,
                           max_tiles_per_gaussian=16, chunk=32,
                           max_chunks_per_tile=32)


def cameras(size: int = SIZE):
    args = (np.eye(3), np.array([0.0, 0.0, 4.0]), size, size)
    return (jax_camera.make_camera_params(*args, fovx=0.9, fovy=0.9),
            camera.make_camera_params(*args, fovx=0.9, fovy=0.9,
                                      device="cpu"))


def t(x):
    return torch.from_numpy(np.array(x))


def jax_prep(deg: int, seed: int = 0):
    """JAX preprocess with opacity (the rasterizer's call), as numpy."""
    means, scales, rots, opacity, shs, _ = random_scene(seed, deg=deg)
    cam_j, _ = cameras()
    prep = jax.jit(lambda: jax_projection.preprocess(
        means, scales, rots, shs, None, cam_j, jax_config(deg),
        opacity=opacity[:, 0]))()
    return prep, opacity[:, 0]


def to_torch_prep(prep) -> projection.Preprocessed:
    return projection.Preprocessed(*(t(x) for x in prep))


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    rng = np.random.default_rng(deg)
    coeffs = rng.normal(size=(50, 3, 25)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = np.asarray(jax_sh.eval_sh(deg, coeffs, dirs))
    got = sh.eval_sh(deg, t(coeffs), t(dirs)).numpy()
    # float32 sums of up to 25 terms taken in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sh_rgb_conversions():
    rgb = np.random.default_rng(1).uniform(size=(20, 3)).astype(np.float32)
    np.testing.assert_allclose(sh.rgb_to_sh(t(rgb)).numpy(),
                               np.asarray(jax_sh.rgb_to_sh(rgb)), rtol=1e-6)
    assert sh.C0 == jax_sh.C0


@pytest.mark.parametrize("modifier", [1.0, 0.7])
def test_build_covariance(modifier):
    rng = np.random.default_rng(2)
    scales = rng.uniform(0.01, 0.3, (100, 3)).astype(np.float32)
    quats = rng.normal(size=(100, 4)).astype(np.float32)   # unnormalized
    want = np.asarray(jax_quat.build_covariance(scales, quats, modifier))
    got = quaternions.build_covariance(t(scales), t(quats), modifier)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(quaternions.strip_symmetric(got).numpy(),
                               np.asarray(jax_quat.strip_symmetric(want)),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        quaternions.quaternion_to_rotmat(
            quaternions.normalize_quaternion(t(quats))).numpy(),
        np.asarray(jax_quat.quaternion_to_rotmat(
            jax_quat.normalize_quaternion(quats))), atol=1e-6)


def test_inverse_sigmoid():
    x = np.linspace(0.01, 0.99, 50, dtype=np.float32)
    np.testing.assert_allclose(quaternions.inverse_sigmoid(t(x)).numpy(),
                               np.asarray(jax_quat.inverse_sigmoid(x)),
                               rtol=1e-6, atol=1e-6)


def test_graphics_helpers_match():
    rng = np.random.default_rng(3)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T = rng.normal(size=3)
    for kw in ({}, {"translate": np.array([0.1, -0.2, 0.3]), "scale": 1.5}):
        np.testing.assert_array_equal(graphics.world_to_view(R, T, **kw),
                                      jax_graphics.world_to_view(R, T, **kw))
    np.testing.assert_array_equal(graphics.projection_matrix(0.01, 100, 0.9, 0.7),
                                  jax_graphics.projection_matrix(0.01, 100, 0.9, 0.7))
    np.testing.assert_array_equal(
        graphics.projection_matrix_center_shift(0.01, 100, 30, 34, 70, 72, 64, 60),
        jax_graphics.projection_matrix_center_shift(0.01, 100, 30, 34, 70, 72, 64, 60))
    assert graphics.fov2focal(0.9, 800) == jax_graphics.fov2focal(0.9, 800)
    assert graphics.focal2fov(700, 800) == jax_graphics.focal2fov(700, 800)


@pytest.mark.parametrize("intrinsics", [False, True])
def test_make_camera_params(intrinsics):
    R = np.linalg.qr(np.random.default_rng(4).normal(size=(3, 3)))[0]
    T = np.array([0.2, -0.1, 3.5])
    kw = (dict(fx=70.0, fy=72.0, cx=30.0, cy=33.0) if intrinsics
          else dict(fovx=0.9, fovy=0.8))
    want = jax_camera.make_camera_params(R, T, 64, 60, **kw)
    got = camera.make_camera_params(R, T, 64, 60, **kw, device="cpu")
    for name in camera.CameraParams._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


# ---------------------------------------------------------------------------
# projection and binning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deg", [0, 3])
@pytest.mark.parametrize("with_opacity", [False, True])
def test_preprocess(deg, with_opacity):
    means, scales, rots, opacity, shs, _ = random_scene(0, deg=deg)
    cam_j, cam_t = cameras()
    op = opacity[:, 0] if with_opacity else None
    want = jax.jit(lambda: jax_projection.preprocess(
        means, scales, rots, shs, None, cam_j, jax_config(deg), opacity=op))()
    got = projection.preprocess(
        t(means), t(scales), t(rots), t(shs), cam_t,
        RasterConfig(SIZE, SIZE, sh_degree=deg),
        opacity=None if op is None else t(op))
    for name in ("radius", "rect_min", "rect_max", "tiles_touched"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.tiles_touched.sum()) > N
    np.testing.assert_allclose(got.mean2d.numpy(), want.mean2d, atol=1e-4)
    np.testing.assert_allclose(got.depth.numpy(), want.depth, rtol=1e-6)
    np.testing.assert_allclose(got.conic.numpy(), want.conic, rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got.rgb.numpy(), want.rgb, atol=1e-6)


def test_compute_cov2d():
    means, scales, rots, *_ = random_scene(1)
    cam_j, cam_t = cameras()
    cov3d = jax_quat.build_covariance(scales, rots)
    want = np.asarray(jax_projection.compute_cov2d(means, cov3d, cam_j))
    got = projection.compute_cov2d(t(means), t(cov3d), cam_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("deg", [0, 3])
def test_bin_gaussians(deg):
    prep, op = jax_prep(deg)
    cfg_j = jax_config(deg)
    want = jax.jit(lambda: jax_tiles.bin_gaussians(prep, cfg_j, op))()
    assert int(want.overflow_pairs) == 0 and int(want.overflow_chunks) == 0
    got = tiles.bin_gaussians(to_torch_prep(prep),
                              RasterConfig(SIZE, SIZE, sh_degree=deg), t(op))
    n = int(want.num_rendered)
    assert got.num_rendered == n > 0
    np.testing.assert_array_equal(got.tile_start.numpy(), want.tile_start)
    np.testing.assert_array_equal(got.tile_end.numpy(), want.tile_end)
    # identical (tile, depth)-ordered pair lists
    np.testing.assert_array_equal(got.sorted_ids.numpy(),
                                  np.asarray(want.sorted_gauss)[:n])


def test_bin_gaussians_cull_only_drops_invisible_pairs():
    """Without opacity every rect tile is emitted; the cull only removes."""
    prep, op = jax_prep(0)
    cfg = RasterConfig(SIZE, SIZE, sh_degree=0)
    full = tiles.bin_gaussians(to_torch_prep(prep), cfg)
    culled = tiles.bin_gaussians(to_torch_prep(prep), cfg, t(op))
    assert full.num_rendered == int(np.asarray(prep.tiles_touched).sum())
    assert 0 < culled.num_rendered <= full.num_rendered


# ---------------------------------------------------------------------------
# compositor (plain version of kernel K1)
# ---------------------------------------------------------------------------

def composite_inputs(deg: int = 0, seed: int = 0):
    prep, op = jax_prep(deg, seed)
    feats = random_scene(seed, deg=deg)[5]
    P = op.shape[0]
    attrs = np.concatenate([np.asarray(prep.rgb), feats,
                            np.asarray(prep.depth)[:, None],
                            np.ones((P, 1), np.float32)], axis=1)
    cfg_j = jax_config(deg)
    binning_j = jax.jit(lambda: jax_tiles.bin_gaussians(prep, cfg_j, op))()
    binning_t = tiles.bin_gaussians(to_torch_prep(prep),
                                    RasterConfig(SIZE, SIZE, sh_degree=deg),
                                    t(op))
    return (prep, op, attrs, cfg_j, binning_j, binning_t)


@pytest.fixture(scope="module")
def comp_inputs():
    return composite_inputs()


@pytest.fixture(scope="module")
def jax_comp(comp_inputs):
    prep, op, attrs, cfg_j, binning_j, _ = comp_inputs
    return jax.jit(lambda: jax_composite.composite(
        binning_j, prep.mean2d, prep.conic, jnp.asarray(op),
        jnp.asarray(attrs), cfg_j))()


@pytest.mark.parametrize("batch_elements", [1 << 24, 256 * 40])
def test_composite_matches_jax(comp_inputs, jax_comp, batch_elements,
                               monkeypatch):
    """256*40 elements per batch splits the tiles into many batches."""
    monkeypatch.setattr(composite, "BATCH_ELEMENTS", batch_elements)
    prep, op, attrs, _, _, binning_t = comp_inputs
    got = composite.composite(binning_t, t(prep.mean2d), t(prep.conic), t(op),
                              t(attrs), RasterConfig(SIZE, SIZE))
    np.testing.assert_allclose(got.image.numpy(), jax_comp.image, atol=2e-5)
    np.testing.assert_allclose(got.weights.numpy(), jax_comp.weights,
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(got.n_contrib.numpy(), jax_comp.n_contrib)
    assert int(got.n_contrib.max()) > 5


def test_composite_without_weights(comp_inputs):
    prep, op, attrs, _, _, binning_t = comp_inputs
    cfg = RasterConfig(SIZE, SIZE)
    full = composite.composite(binning_t, t(prep.mean2d), t(prep.conic), t(op),
                               t(attrs), cfg)
    bare = composite.composite(binning_t, t(prep.mean2d), t(prep.conic), t(op),
                               t(attrs), RasterConfig(SIZE, SIZE,
                                                      compute_weights=False))
    assert float(bare.weights.abs().max()) == 0.0
    assert torch.equal(full.image, bare.image)
    assert torch.equal(full.n_contrib, bare.n_contrib)


def test_composite_gradients_match_jax(comp_inputs):
    prep, op, attrs, cfg_j, binning_j, binning_t = comp_inputs
    g_img = np.random.default_rng(5).normal(
        size=(cfg_j.num_tiles, 256, attrs.shape[1])).astype(np.float32)

    def f(mean2d, conic, opacity, at):
        return jax_composite.composite(binning_j, mean2d, conic, opacity, at,
                                       cfg_j).image

    _, vjp = jax.vjp(f, prep.mean2d, prep.conic, jnp.asarray(op),
                     jnp.asarray(attrs))
    want = jax.jit(vjp)(jnp.asarray(g_img))
    inputs = [t(x).requires_grad_() for x in
              (prep.mean2d, prep.conic, op, attrs)]
    out = composite.composite(binning_t, *inputs, RasterConfig(SIZE, SIZE))
    (out.image * t(g_img)).sum().backward()
    for name, x, w in zip(["mean2d", "conic", "opacity", "attrs"], inputs, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-8
        # relative to the largest entry: sums over pixels in another order
        np.testing.assert_allclose(x.grad.numpy() / scale, w / scale,
                                   atol=1e-4, err_msg=name)


def test_tiles_to_image_crops_like_jax():
    cfg_j = JaxRasterConfig(height=40, width=56)
    buf = np.random.default_rng(6).normal(
        size=(cfg_j.num_tiles, 256, 3)).astype(np.float32)
    want = np.asarray(jax_composite.tiles_to_image(buf, cfg_j))
    got = composite.tiles_to_image(t(buf), RasterConfig(40, 56)).numpy()
    np.testing.assert_array_equal(got, want)


def test_composite_wrapper_runs_plain_version_on_cpu(comp_inputs):
    prep, op, attrs, _, _, binning_t = comp_inputs
    cfg = RasterConfig(SIZE, SIZE)
    before = trace.counter("k1.launches")
    args = (binning_t, t(prep.mean2d), t(prep.conic), t(op), t(attrs), cfg)
    got = composite_cuda.composite(*args)
    want = composite.composite(*args)
    assert trace.counter("k1.launches") == before
    assert torch.equal(got.image, want.image)
    assert torch.equal(got.weights, want.weights)


def test_composite_wrapper_rejects_mixed_devices(comp_inputs):
    prep, op, attrs, _, _, binning_t = comp_inputs
    with pytest.raises(ValueError, match="expected all on CPU or all on CUDA"):
        composite_cuda.composite(binning_t, t(prep.mean2d), t(prep.conic),
                                 t(op), t(attrs).to("meta"),
                                 RasterConfig(SIZE, SIZE))


# ---------------------------------------------------------------------------
# surface
# ---------------------------------------------------------------------------

def test_pseudo_normal_from_depth():
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    depth = (4.0 + 0.3 * np.sin(xx / 9.0) + 0.2 * np.cos(yy / 7.0)
             + 0.01 * xx).astype(np.float32)
    cam_j, cam_t = cameras()
    s_j, n_j = jax_surface.pseudo_normal_from_depth(depth, cam_j)
    s_t, n_t = surface.pseudo_normal_from_depth(t(depth), cam_t)
    np.testing.assert_allclose(s_t.numpy(), s_j, atol=1e-5)
    np.testing.assert_allclose(n_t.numpy(), n_j, atol=1e-4)
    assert np.allclose(np.linalg.norm(n_t.numpy(), axis=0), 1.0, atol=1e-5)
