"""The port's `rasterize` and `render` against the JAX package's, on the CPU.

Tolerances follow tests/test_rasterizer_parity.py: colour and opacity 2e-5,
depth 1e-4, features 5e-5, pseudo-normal 1e-3, weights rtol 1e-3; radii,
`n_contrib` and `num_rendered` identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models import gaussians as jax_gaussians
from relightable3dgaussian_tpu.models.render import ViewInputs as JaxViewInputs
from relightable3dgaussian_tpu.models.render import render as jax_render
from relightable3dgaussian_tpu.ops.rasterize import rasterize as jax_rasterize
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu_torch.models import render as port_render
from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.rasterize import rasterize
from relightable3dgaussian_tpu_torch.train import checkpoint
from test_torch_ops import SIZE, cameras, jax_config, random_scene, t

BG = np.array([0.1, 0.2, 0.3], np.float32)


def well_conditioned(covered: np.ndarray) -> np.ndarray:
    """Pixels whose 3x3 neighbourhood is all covered. Elsewhere the Sobel
    cross product of the pseudo-normal can vanish (e.g. a background pixel
    with one covered corner neighbour gives two parallel gradients), and its
    direction is then set by float rounding alone."""
    p = np.pad(covered, 1)
    h, w = covered.shape
    return np.all([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)


@pytest.fixture(scope="module", params=[0, 3], ids=["sh0", "sh3"])
def raster_pair(request):
    deg = request.param
    scene = random_scene(0, deg=deg)
    cam_j, cam_t = cameras()
    want = jax.jit(lambda *a: jax_rasterize(
        *a, cam=cam_j, cfg=jax_config(deg), bg_color=jnp.asarray(BG)))(*scene)
    assert int(want.overflow_pairs) == 0 and int(want.overflow_chunks) == 0
    got = rasterize(*(t(x) for x in scene), cam=cam_t,
                    cfg=RasterConfig(SIZE, SIZE, sh_degree=deg),
                    bg_color=t(BG))
    return want, got


def test_rasterize_color_opacity(raster_pair):
    want, got = raster_pair
    np.testing.assert_allclose(got.color.numpy(), want.color, atol=2e-5)
    np.testing.assert_allclose(got.opacity.numpy(), want.opacity, atol=2e-5)
    np.testing.assert_allclose(got.final_T.numpy(), want.final_T, atol=2e-5)
    assert float(got.opacity.max()) > 0.5


def test_rasterize_depth_features(raster_pair):
    want, got = raster_pair
    np.testing.assert_allclose(got.depth.numpy(), want.depth, atol=1e-4)
    np.testing.assert_allclose(got.feature.numpy(), want.feature, atol=5e-5)


def test_rasterize_counts_exact(raster_pair):
    want, got = raster_pair
    np.testing.assert_array_equal(got.radii.numpy(), want.radii)
    np.testing.assert_array_equal(got.n_contrib.numpy(), want.n_contrib)
    assert got.num_rendered == int(want.num_rendered) > 0
    assert got.overflow_pairs == 0 and got.overflow_chunks == 0


def test_rasterize_weights(raster_pair):
    want, got = raster_pair
    np.testing.assert_allclose(got.weights.numpy(), want.weights,
                               rtol=1e-3, atol=1e-6)


def test_rasterize_surface_and_pseudo_normal(raster_pair):
    want, got = raster_pair
    np.testing.assert_allclose(got.surface_xyz.numpy(), want.surface_xyz,
                               atol=1e-4)
    ok = well_conditioned(np.asarray(want.n_contrib) > 0)
    assert ok.sum() > 1000
    np.testing.assert_allclose(got.pseudo_normal.numpy()[:, ok],
                               np.asarray(want.pseudo_normal)[:, ok], atol=1e-3)


def test_rasterize_non_square_partial_tiles():
    """H=56, W=72: partial edge tiles and width != height (mean2d uses each)."""
    from relightable3dgaussian_tpu.ops import RasterConfig as JaxRasterConfig
    from relightable3dgaussian_tpu.ops.camera import make_camera_params as jax_cam
    from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
    h, w = 56, 72
    scene = random_scene(2, deg=3)
    args = (np.eye(3), np.array([0.0, 0.0, 4.0]), w, h)
    cfg_j = JaxRasterConfig(height=h, width=w, feature_dim=5, sh_degree=3,
                            buffer_multiple=16, max_tiles_per_gaussian=20,
                            chunk=32, max_chunks_per_tile=32)
    want = jax.jit(lambda *a: jax_rasterize(
        *a, cam=jax_cam(*args, fovx=0.9, fovy=0.75), cfg=cfg_j,
        bg_color=jnp.asarray(BG)))(*scene)
    assert int(want.overflow_pairs) == 0 and int(want.overflow_chunks) == 0
    got = rasterize(*(t(x) for x in scene),
                    cam=make_camera_params(*args, fovx=0.9, fovy=0.75),
                    cfg=RasterConfig(h, w, sh_degree=3), bg_color=t(BG))
    assert got.color.shape == (3, h, w)
    np.testing.assert_allclose(got.color.numpy(), want.color, atol=2e-5)
    np.testing.assert_allclose(got.depth.numpy(), want.depth, atol=1e-4)
    np.testing.assert_array_equal(got.radii.numpy(), want.radii)
    np.testing.assert_array_equal(got.n_contrib.numpy(), want.n_contrib)
    assert got.num_rendered == int(want.num_rendered) > 0


def test_rasterize_gradients_match_jax():
    means, scales, rots, opacity, shs, features = random_scene(1, deg=3)
    cam_j, cam_t = cameras()
    target = np.random.default_rng(7).uniform(
        size=(3, SIZE, SIZE)).astype(np.float32)

    def loss_jax(m, s, o, sh_, ft):
        out = jax_rasterize(m, s, rots, o, sh_, ft, cam=cam_j,
                            cfg=jax_config(3), bg_color=jnp.asarray(BG))
        return ((out.color - target) ** 2).mean() + out.feature.var()

    want = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2, 3, 4)))(
        means, scales, opacity, shs, features)
    inputs = [t(x).requires_grad_() for x in
              (means, scales, opacity, shs, features)]
    m, s, o, sh_, ft = inputs
    out = rasterize(m, s, t(rots), o, sh_, ft, cam=cam_t,
                    cfg=RasterConfig(SIZE, SIZE, sh_degree=3), bg_color=t(BG))
    (((out.color - t(target)) ** 2).mean() + out.feature.var()).backward()
    for name, x, w in zip(["means", "scales", "opacity", "shs", "features"],
                          inputs, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-8
        assert np.isfinite(x.grad.numpy()).all()
        # relative to the largest entry, as test_rasterizer_parity does
        np.testing.assert_allclose(x.grad.numpy() / scale, w / scale,
                                   atol=2e-3, err_msg=name)


# ---------------------------------------------------------------------------
# render, with weights carried across as numpy arrays and through checkpoints
# ---------------------------------------------------------------------------

CAPACITY, N_ACTIVE = 340, 300


def jax_model():
    """Padded JAX GaussianParams (stage 1) with 40 inactive rows spread out."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    c = CAPACITY
    params = jax_gaussians.GaussianParams(
        xyz=jnp.asarray(rng.uniform(-1.2, 1.2, (c, 3)).astype(f32)),
        normal=jnp.asarray(rng.normal(size=(c, 3)).astype(f32)),
        shs_dc=jnp.asarray(rng.normal(size=(c, 1, 3)).astype(f32)),
        shs_rest=jnp.asarray((rng.normal(size=(c, 15, 3)) * 0.1).astype(f32)),
        scaling=jnp.asarray(np.log(rng.uniform(0.02, 0.15, (c, 3))).astype(f32)),
        rotation=jnp.asarray(rng.normal(size=(c, 4)).astype(f32)),
        opacity=jnp.asarray(rng.normal(0.0, 1.5, (c, 1)).astype(f32)),
        base_color=jnp.zeros((0, 3)), roughness=jnp.zeros((0, 1)),
        incidents_dc=jnp.zeros((0, 1, 3)), incidents_rest=jnp.zeros((0, 15, 3)),
        visibility_dc=jnp.zeros((0, 1, 1)), visibility_rest=jnp.zeros((0, 15, 1)))
    active = np.zeros(c, bool)
    active[rng.permutation(c)[:N_ACTIVE]] = True
    aux = jax_gaussians.init_aux(c, c).replace(active=jnp.asarray(active))
    return params, aux, active


def view_pair():
    cam_j, cam_t = cameras()
    zeros = np.zeros((3, SIZE, SIZE), np.float32)
    view_j = JaxViewInputs(cam=cam_j, image=zeros, image_mask=zeros[:1] + 1,
                           depth=zeros[:1], normal=zeros)
    view_t = port_render.ViewInputs(cam=cam_t, image=t(zeros),
                                    image_mask=t(zeros[:1] + 1),
                                    depth=t(zeros[:1]), normal=t(zeros))
    return view_j, view_t


@pytest.fixture(scope="module")
def render_pair(tmp_path_factory):
    params, aux, active = jax_model()
    path = str(tmp_path_factory.mktemp("ckpt") / "chkpnt7.npz")
    jax_checkpoint.save_checkpoint(path, 7, params=params, aux=aux)
    iteration, model = checkpoint.load_checkpoint(path)
    view_j, view_t = view_pair()
    cfg_j = jax_config(3)
    want = jax.jit(lambda p, a: jax_render(
        view_j, p, a, cfg_j, jnp.asarray(BG)))(params, aux.active)
    with torch.no_grad():
        got = port_render.render(view_t, model, RasterConfig(SIZE, SIZE),
                                 t(BG))
    return iteration, model, params, active, want, got


def test_checkpoint_from_jax_keeps_active_rows(render_pair):
    iteration, model, params, active, _, _ = render_pair
    assert iteration == 7
    assert model.num_points == N_ACTIVE
    for name in ("xyz", "normal", "shs_dc", "shs_rest", "scaling", "rotation",
                 "opacity"):
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(),
                                      np.asarray(getattr(params, name))[active])


def test_render_images_match_jax(render_pair):
    *_, want, got = render_pair
    assert int(want["overflow_pairs"]) == 0 and int(want["overflow_chunks"]) == 0
    np.testing.assert_allclose(got["render"].numpy(), want["render"], atol=2e-5)
    np.testing.assert_allclose(got["opacity"].numpy(), want["opacity"],
                               atol=2e-5)
    np.testing.assert_allclose(got["raw_depth"].numpy(), want["raw_depth"],
                               atol=1e-4)
    np.testing.assert_array_equal(got["num_contrib"].numpy(),
                                  want["num_contrib"])
    assert got["num_rendered"] == int(want["num_rendered"]) > 0


def test_render_normalized_maps_match_jax(render_pair):
    """depth, normal and depth_var are divided by opacity; compare where the
    opacity is at least 0.05 so the division does not magnify the 1e-4 /
    5e-5 tolerances of the raw channels past them."""
    *_, want, got = render_pair
    ok = np.asarray(want["opacity"])[0] >= 0.05
    assert ok.sum() > 1000
    np.testing.assert_allclose(got["depth"].numpy()[:, ok],
                               np.asarray(want["depth"])[:, ok], atol=1e-4)
    np.testing.assert_allclose(got["normal"].numpy()[:, ok],
                               np.asarray(want["normal"])[:, ok], atol=5e-5)
    np.testing.assert_allclose(got["depth_var"].numpy()[:, ok],
                               np.asarray(want["depth_var"])[:, ok], atol=1e-3)
    cov = well_conditioned(np.asarray(want["num_contrib"]) > 0)
    np.testing.assert_allclose(got["pseudo_normal"].numpy()[:, cov],
                               np.asarray(want["pseudo_normal"])[:, cov],
                               atol=1e-3)


def test_render_per_gaussian_outputs_match_jax(render_pair):
    _, _, _, active, want, got = render_pair
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(want["radii"])[active])
    np.testing.assert_array_equal(got["visibility_filter"].numpy(),
                                  np.asarray(want["visibility_filter"])[active])
    np.testing.assert_allclose(got["weights"].numpy(),
                               np.asarray(want["weights"])[active],
                               rtol=1e-3, atol=1e-6)
    for key in ("opacities", "normals", "directions"):
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(want[key])[active], atol=1e-6,
                                   err_msg=key)


def test_render_from_numpy_matches_checkpoint_path(render_pair):
    """GaussianModel.from_numpy on the JAX arrays gives the same render."""
    _, _, params, active, _, got = render_pair
    fields = {k: np.asarray(getattr(params, k)) for k in
              ("xyz", "normal", "shs_dc", "shs_rest", "scaling", "rotation",
               "opacity")}
    model = GaussianModel.from_numpy(fields, active)
    _, view_t = view_pair()
    with torch.no_grad():
        again = port_render.render(view_t, model, RasterConfig(SIZE, SIZE),
                                   t(BG))
    assert torch.equal(again["render"], got["render"])
    assert torch.equal(again["weights"], got["weights"])


def test_port_checkpoint_loads_in_jax(render_pair, tmp_path):
    """A file written by the port restores in the JAX package the way
    cli/eval_nvs.py loads one: a capacity-sized stage-1 template."""
    _, model, *_ = render_pair
    path = str(tmp_path / "chkpnt9.npz")
    checkpoint.save_checkpoint(path, 9, model)
    cap = model.num_points
    template, _ = jax_gaussians.create_from_pcd(
        jnp.zeros((1, 3)), jnp.full((1, 3), 0.5), jnp.asarray([[0.0, 0, 1.0]]),
        capacity=cap)
    it, restored = jax_checkpoint.load_checkpoint(
        path, params=template, aux=jax_gaussians.init_aux(cap, 0))
    assert it == 9
    assert bool(np.asarray(restored["aux"].active).all())
    for name, value in model.to_numpy().items():
        np.testing.assert_array_equal(
            np.asarray(getattr(restored["params"], name)), value, err_msg=name)
    # and back into the port unchanged
    it2, model2 = checkpoint.load_checkpoint(path)
    assert it2 == 9
    for name, value in model.to_numpy().items():
        np.testing.assert_array_equal(model2.to_numpy()[name], value)
