"""The port's dense oracle, its precomputed rasterizer inputs and the
reference-API facade against the JAX package's, on the CPU.

Tolerances are tests/test_rasterizer_parity.py's: colour and opacity 2e-5,
depth 1e-4, features 5e-5, weights rtol and atol 1e-3, pseudo-normal 1e-3,
`n_contrib` equal on >= 99.9% of pixels, radii equal, gradients 2e-3 of each
field's largest entry. The JAX oracle walks the depth-sorted gaussians in a
`lax.scan`; the port's takes the transmittance as a cumulative product and
the blend as one matrix product, so the two round the same float32 sums in
another order: the port's oracle is held to JAX's under the same bounds
(and, in float64, the float32 oracle to it by 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models.render import render_view as jax_render_view
from relightable3dgaussian_tpu.ops import covariance3d_packed as jax_cov_packed
from relightable3dgaussian_tpu.ops import make_camera_params as jax_make_camera
from relightable3dgaussian_tpu.ops import rasterize_dense as jax_dense
from relightable3dgaussian_tpu.ops.rasterize import rasterize as jax_rasterize
from relightable3dgaussian_tpu.raster import (
    GaussianRasterizationSettings as JaxSettings)
from relightable3dgaussian_tpu.raster import GaussianRasterizer as JaxRasterizer
from relightable3dgaussian_tpu.raster import mark_visible as jax_mark_visible
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu.utils import quaternions as jax_quat
from relightable3dgaussian_tpu_torch import ops as port_ops
from relightable3dgaussian_tpu_torch.models import render as port_render
from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.rasterize import rasterize
from relightable3dgaussian_tpu_torch.ops.rasterize_dense import rasterize_dense
from relightable3dgaussian_tpu_torch.raster import (
    GaussianRasterizationSettings, GaussianRasterizer, mark_visible)
from relightable3dgaussian_tpu_torch.train import checkpoint
from relightable3dgaussian_tpu_torch.utils import quaternions
from test_torch_ops import SIZE, cameras, jax_config, random_scene, t
from test_torch_rasterize import jax_model, well_conditioned

BG = np.array([0.1, 0.2, 0.3], np.float32)
CFG = RasterConfig(SIZE, SIZE, sh_degree=0)
FIELDS = ("means", "scales", "opacity", "shs", "features")


def assert_forward_close(got, want, exact_counts: bool = False):
    """The parity bounds, on RasterOut fields given as numpy arrays."""
    np.testing.assert_allclose(got.color, want.color, atol=2e-5)
    np.testing.assert_allclose(got.opacity, want.opacity, atol=2e-5)
    np.testing.assert_allclose(got.depth, want.depth, atol=1e-4)
    np.testing.assert_allclose(got.feature, want.feature, atol=5e-5)
    np.testing.assert_allclose(got.weights, want.weights, atol=1e-3,
                               rtol=1e-3)
    agree = (np.asarray(got.n_contrib) == np.asarray(want.n_contrib)).mean()
    assert agree == 1.0 if exact_counts else agree > 0.999
    np.testing.assert_array_equal(got.radii, want.radii)


def numpy_out(out):
    return type(out)(*(x.detach().numpy() if isinstance(x, torch.Tensor)
                       else x for x in out))


def loss_of(out, target):
    """The parity test's loss: colour MSE plus the features' variance."""
    return ((out.color - target) ** 2).mean() + out.feature.var()


@pytest.fixture(scope="module")
def scene():
    return random_scene(0)


@pytest.fixture(scope="module")
def jax_dense_out(scene):
    cam_j, _ = cameras()
    return jax.jit(lambda *a: jax_dense(
        *a, cam=cam_j, cfg=jax_config(0), bg_color=jnp.asarray(BG)))(*scene)


@pytest.fixture(scope="module")
def port_dense_out(scene):
    _, cam_t = cameras()
    return rasterize_dense(*(t(x) for x in scene), cam=cam_t, cfg=CFG,
                           bg_color=t(BG))


def test_dense_oracle_matches_jax(jax_dense_out, port_dense_out):
    want, got = jax_dense_out, numpy_out(port_dense_out)
    assert_forward_close(got, want)
    np.testing.assert_allclose(got.final_T, want.final_T, atol=2e-5)
    ok = well_conditioned(np.asarray(want.n_contrib) > 0)
    np.testing.assert_allclose(got.pseudo_normal[:, ok],
                               np.asarray(want.pseudo_normal)[:, ok],
                               atol=1e-3)
    assert got.num_rendered == int(want.num_rendered) > 0
    assert float(want.opacity.max()) > 0.5


def test_dense_oracle_in_float64_bounds_its_float32_rounding(port_dense_out,
                                                             scene):
    _, cam_t = cameras()
    exact = rasterize_dense(*(t(x).double() for x in scene), cam=cam_t,
                            cfg=CFG, bg_color=t(BG))
    assert exact.color.dtype == torch.float64
    for name in ("color", "opacity", "feature", "final_T"):
        np.testing.assert_allclose(getattr(port_dense_out, name).numpy(),
                                   getattr(exact, name).numpy(), atol=1e-5,
                                   err_msg=name)


def dense_grads(raster, scene, cam, cfg, bg, target):
    means, scales, rots, opacity, shs, features = scene
    return jax.grad(lambda m, s, o, sh_, ft: loss_of(raster(
        m, s, rots, o, sh_, ft, cam=cam, cfg=cfg, bg_color=bg), target),
        argnums=(0, 1, 2, 3, 4))(means, scales, opacity, shs, features)


def port_grads(raster, scene, cam):
    xs = [t(x).requires_grad_(True) for x in scene]
    out = raster(*xs, cam=cam, cfg=CFG, bg_color=t(BG))
    loss_of(out, torch.zeros((3, SIZE, SIZE))).backward()
    return [x.grad.numpy() for i, x in enumerate(xs) if i != 2]


def assert_grads_close(got, want):
    for name, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-8
        np.testing.assert_allclose(g / scale, w / scale, atol=2e-3,
                                   err_msg=name)
        assert np.isfinite(g).all(), name


def test_dense_oracle_gradients_match_jax(scene):
    cam_j, cam_t = cameras()
    want = jax.jit(lambda: dense_grads(
        jax_dense, scene, cam_j, jax_config(0), jnp.asarray(BG),
        jnp.zeros((3, SIZE, SIZE))))()
    assert_grads_close(port_grads(rasterize_dense, scene, cam_t), want)


# the port's tiled rasterizer against the port's oracle, as
# test_rasterizer_parity's TestForwardParity and TestGradientParity

def test_tiled_forward_matches_the_dense_oracle(scene, port_dense_out):
    _, cam_t = cameras()
    tiled = rasterize(*(t(x) for x in scene), cam=cam_t, cfg=CFG,
                      bg_color=t(BG))
    dense = numpy_out(port_dense_out)
    assert_forward_close(numpy_out(tiled), dense)
    ok = well_conditioned(dense.n_contrib > 0)
    np.testing.assert_allclose(tiled.pseudo_normal.numpy()[:, ok],
                               dense.pseudo_normal[:, ok], atol=1e-3)
    assert int((dense.n_contrib > 0).sum()) > 500


def test_tiled_gradients_match_the_dense_oracle(scene):
    _, cam_t = cameras()
    assert_grads_close(port_grads(rasterize, scene, cam_t),
                       port_grads(rasterize_dense, scene, cam_t))


# precomputed colours and covariances

def precomputed_arg(scene, precomp: str):
    """(the port's argument, JAX's) for `precomp`: colours [P, 3]; the
    packed covariance [P, 6] (JAX takes its unpacked [P, 3, 3]); JAX's full
    [P, 3, 3] as it is, symmetric or with its upper triangle moved by up to
    20% (not symmetric)."""
    means, scales, rots, *_ = scene
    rng = np.random.default_rng(3)
    if precomp == "colors":
        colors = rng.uniform(size=(means.shape[0], 3)).astype(np.float32)
        return colors, colors
    packed = np.asarray(jax_cov_packed(scales * 1.3, rots))
    full = np.array(jax_quat.unpack_symmetric(packed))
    if precomp == "cov3d":
        return packed, full
    if precomp == "cov3d_nonsymmetric":
        upper = np.triu(np.ones((3, 3), bool), 1)
        full = np.where(upper, full * rng.uniform(0.8, 1.2, full.shape),
                        full).astype(np.float32)
    return full, full


@pytest.mark.parametrize("precomp", ["colors", "cov3d", "cov3d_full",
                                     "cov3d_nonsymmetric"])
def test_precomputed_inputs_match_jax(scene, precomp):
    """`colors_precomp` [P, 3] and `cov3d_precomp` against JAX `rasterize`
    with the same values, and their gradients: the packed [P, 6] (JAX takes
    the full [P, 3, 3], which `unpack_symmetric` gives) and JAX's own full
    [P, 3, 3] given to both unchanged, its gradient entry by entry; a full
    one that is not symmetric renders as JAX renders it, not as its
    symmetric part does."""
    cam_j, cam_t = cameras()
    arg, jax_arg = precomputed_arg(scene, precomp)
    key = "colors_precomp" if precomp == "colors" else "cov3d_precomp"

    def jax_loss(a, *xs):
        out = jax_rasterize(*xs, cam=cam_j, cfg=jax_config(0),
                            bg_color=jnp.asarray(BG), **{key: a})
        return loss_of(out, 0.0), out

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(jax_arg), *scene)
    x = t(arg).requires_grad_(True)
    got = rasterize(*(t(v) for v in scene), cam=cam_t, cfg=CFG,
                    bg_color=t(BG), **{key: x})
    loss_of(got, 0.0).backward()
    assert_forward_close(numpy_out(got), want, exact_counts=True)
    want_g = np.asarray(want_g)
    if precomp == "cov3d":    # d/d(packed) from d/d(full): off-diagonals twice
        want_g = np.array(jax_quat.strip_symmetric(
            want_g + np.swapaxes(want_g, -1, -2)))
        want_g[:, [0, 3, 5]] /= 2
    assert x.grad.shape == want_g.shape
    scale = np.abs(want_g).max()
    assert scale > 0
    np.testing.assert_allclose(x.grad.numpy() / scale, want_g / scale,
                               atol=2e-3)
    # the values computed inside give the same render
    inside = rasterize(*(t(v) for v in scene), cam=cam_t, cfg=CFG,
                       bg_color=t(BG))
    assert not np.allclose(inside.color.numpy(), got.color.detach().numpy())
    if precomp == "cov3d_nonsymmetric":
        sym = rasterize(*(t(v) for v in scene), cam=cam_t, cfg=CFG,
                        bg_color=t(BG),
                        cov3d_precomp=t((arg + arg.swapaxes(-1, -2)) / 2))
        assert not np.allclose(sym.color.numpy(), got.color.detach().numpy())


def test_get_covariance_renders_as_the_scales_and_rotations(scene):
    """GaussianModel.get_covariance() straight into `rasterize` gives the
    render of the model's scales and rotations, bitwise, and gradients
    reach it; a transposed view of the full matrix renders the same."""
    means, scales, rots, opacity, shs, features = scene
    P = means.shape[0]
    model = GaussianModel(
        xyz=t(means), normal=torch.zeros((P, 3)), shs_dc=t(shs[:, :1]),
        shs_rest=t(shs[:, 1:]), scaling=torch.log(t(scales)),
        rotation=t(rots), opacity=quaternions.inverse_sigmoid(t(opacity)))
    _, cam_t = cameras()
    common = dict(cam=cam_t, cfg=CFG, bg_color=t(BG))
    args = (model.xyz, None, None, model.get_opacity, model.get_shs,
            t(features))
    want = rasterize(model.xyz, model.get_scaling, model.get_rotation,
                     *args[3:], **common)
    cov = model.get_covariance().detach().requires_grad_(True)
    got = rasterize(*args, cov3d_precomp=cov, **common)
    full = quaternions.unpack_symmetric(cov.detach())
    view = rasterize(*args, cov3d_precomp=full.transpose(-1, -2), **common)
    assert not full.transpose(-1, -2).is_contiguous()
    for name in ("color", "opacity", "depth", "feature", "weights", "radii"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(view, name), getattr(want, name)), name
    loss_of(got, 0.0).backward()
    assert cov.grad.shape == (P, 6) and float(cov.grad.abs().max()) > 0


@pytest.mark.parametrize("shape", [(300, 3), (300, 9), (299, 6), (300, 3, 2),
                                   (300, 1, 3, 3)])
def test_cov3d_precomp_of_another_shape_raises(scene, shape):
    _, cam_t = cameras()
    with pytest.raises(ValueError, match=r"\[300, 6\].*\[300, 3, 3\]"):
        rasterize(*(t(v) for v in scene), cam=cam_t, cfg=CFG, bg_color=t(BG),
                  cov3d_precomp=torch.zeros(shape))


def test_covariance3d_packed_matches_jax(scene):
    _, scales, rots, *_ = scene
    want = jax_cov_packed(scales, rots, 1.5)
    got = port_ops.covariance3d_packed(t(scales), t(rots), 1.5)
    # float32 products summed in another order: entries up to ~0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        quaternions.unpack_symmetric(got).numpy(),
        jax_quat.unpack_symmetric(got.numpy()))


def test_render_view_override_color_matches_jax(tmp_path):
    params, aux, active = jax_model()
    path = str(tmp_path / "chkpnt1.npz")
    jax_checkpoint.save_checkpoint(path, 1, params=params, aux=aux)
    _, model = checkpoint.load_checkpoint(path, device="cpu")
    cam_j, cam_t = cameras()
    rng = np.random.default_rng(4)
    colors = rng.uniform(size=(params.xyz.shape[0], 3)).astype(np.float32)
    want = jax.jit(lambda p, a, c: jax_render_view(
        p, a, cam_j, jax_config(3), jnp.asarray(BG), override_color=c))(
        params, aux.active, jnp.asarray(colors))
    got = port_render.render_view(model, cam_t, RasterConfig(SIZE, SIZE),
                                  t(BG), override_color=t(colors[active]))
    np.testing.assert_allclose(got["render"].detach().numpy(), want["render"],
                               atol=2e-5)
    plain = port_render.render_view(model, cam_t, RasterConfig(SIZE, SIZE),
                                    t(BG))
    assert not np.allclose(plain["render"].detach().numpy(), want["render"])


# the reference-API facade (tests/test_relighting_cli.py:150's scene)

def facade_inputs(n: int = 10):
    cam = make_camera_params(np.eye(3), np.array([0.0, 0.0, 4.0]), 32, 32,
                             fovx=0.8, fovy=0.8, device="cpu")
    cam_j = jax_make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 32, 32,
                            fovx=0.8, fovy=0.8)
    rng = np.random.default_rng(0)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    arrays = dict(means3D=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
                  opacities=np.full((n, 1), 0.8, np.float32),
                  shs=np.zeros((n, 1, 3), np.float32),
                  scales=np.full((n, 3), 0.1, np.float32), rotations=rots,
                  features=np.ones((n, 5), np.float32))
    return cam, cam_j, arrays


TPU_OVERRIDES = dict(buffer_multiple=16, chunk=32, max_tiles_per_gaussian=4,
                     max_chunks_per_tile=8)


def settings(cls, cam, bg):
    return cls(image_height=32, image_width=32, tanfovx=float(np.tan(0.4)),
               tanfovy=float(np.tan(0.4)), cx=16.0, cy=16.0, bg=bg,
               scale_modifier=1.0, viewmatrix=cam.world_view,
               projmatrix=cam.full_proj, sh_degree=0, campos=cam.campos)


def test_facade_returns_the_jax_10_tuple():
    cam, cam_j, arrays = facade_inputs()
    jax_facade = JaxRasterizer(settings(JaxSettings, cam_j, jnp.zeros(3)),
                               **TPU_OVERRIDES)
    want = jax.jit(lambda kw: jax_facade(**kw))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    got = GaussianRasterizer(settings(GaussianRasterizationSettings, cam,
                                      torch.zeros(3)),
                             **TPU_OVERRIDES)(**{k: t(v)
                                                 for k, v in arrays.items()})
    assert len(got) == len(want) == 10
    assert got[0] == int(want[0]) > 0                       # num_rendered
    np.testing.assert_array_equal(got[1].numpy(), want[1])  # num_contrib
    np.testing.assert_array_equal(got[9].numpy(), want[9])  # radii
    for i, atol in ((2, 2e-5), (3, 2e-5), (4, 1e-4), (5, 5e-5), (6, 1e-3),
                    (7, 1e-4)):
        np.testing.assert_allclose(got[i].numpy(), want[i], atol=atol,
                                   err_msg=str(i))
    np.testing.assert_allclose(got[8].numpy(), want[8], rtol=1e-3, atol=1e-6)
    assert float(got[3].max()) > 0.5


def test_facade_mark_visible_matches_jax():
    cam, cam_j, _ = facade_inputs()
    pos = np.random.default_rng(1).uniform(-6, 6, (200, 3)).astype(np.float32)
    want = np.asarray(jax_mark_visible(jnp.asarray(pos), cam_j.world_view,
                                       cam_j.full_proj))
    assert 0 < want.sum() < len(want)
    got = mark_visible(t(pos), cam.world_view, cam.full_proj)
    np.testing.assert_array_equal(got.numpy(), want)
    r = GaussianRasterizer(settings(GaussianRasterizationSettings, cam,
                                    torch.zeros(3)))
    np.testing.assert_array_equal(r.markVisible(t(pos)).numpy(), want)


@pytest.mark.parametrize("overrides", [{"feature_dim": 5}, {"bogus": 1},
                                       {"height": 64}])
def test_facade_refuses_unknown_overrides(overrides):
    cam, _, _ = facade_inputs()
    with pytest.raises(TypeError, match="overrides"):
        GaussianRasterizer(settings(GaussianRasterizationSettings, cam,
                                    torch.zeros(3)), **overrides)


def test_facade_takes_port_config_fields():
    cam, _, arrays = facade_inputs()
    r = GaussianRasterizer(settings(GaussianRasterizationSettings, cam,
                                    torch.zeros(3)), compute_weights=False,
                           use_pallas=True)
    assert r._config().compute_weights is False
    out = r(**{k: t(v) for k, v in arrays.items()})
    assert out[2].shape == (3, 32, 32)
