"""The port's losses, image metrics and stage-1 loss against the JAX package's, on the CPU.

Values agree to 1e-5 relative (float32 sums taken in another order by
F.conv2d and XLA); gradients to 1e-4 of the largest entry of each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from relightable3dgaussian_tpu import losses as jax_losses
from relightable3dgaussian_tpu.models.render import ViewInputs as JaxViewInputs
from relightable3dgaussian_tpu.models.render import calculate_loss as jax_loss
from relightable3dgaussian_tpu.models.render import render_view as jax_render_view
from relightable3dgaussian_tpu.train.config import OptimizationConfig as JaxOpt
from relightable3dgaussian_tpu.utils import image as jax_image
from relightable3dgaussian_tpu_torch import losses
from relightable3dgaussian_tpu_torch.models import render as port_render
from relightable3dgaussian_tpu_torch.models.gaussians import FIELDS, GaussianModel
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.train.config import OptimizationConfig
from relightable3dgaussian_tpu_torch.utils import image
from test_torch_ops import SIZE, cameras, jax_config, t
from test_torch_rasterize import BG, jax_model


def images(seed: int, c: int = 3, h: int = 40, w: int = 48):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (c, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(size=(1, h, w)) > 0.3).astype(np.float32)
    return a, b, mask


# name → (jax fn, port fn); each takes (data, image, mask) and returns a scalar
LOSSES = {
    "ssim": (lambda d, i, m: jax_losses.ssim(d, i),
             lambda d, i, m: losses.ssim(d, i)),
    "ssim_map": (lambda d, i, m: (jax_losses.ssim_map(d, i) ** 2).mean(),
                 lambda d, i, m: (losses.ssim_map(d, i) ** 2).mean()),
    "spatial_gradient_1": (
        lambda d, i, m: (jax_losses.spatial_gradient(d, 1) * i[:, None]).sum(),
        lambda d, i, m: (losses.spatial_gradient(d, 1) * i[:, None]).sum()),
    "spatial_gradient_2": (
        lambda d, i, m: (jax_losses.spatial_gradient(d, 2)
                         * i[:, None]).sum(),
        lambda d, i, m: (losses.spatial_gradient(d, 2) * i[:, None]).sum()),
    "first_order_edge_aware": (
        lambda d, i, m: jax_losses.first_order_edge_aware_loss(d, i),
        lambda d, i, m: losses.first_order_edge_aware_loss(d, i)),
    "second_order_edge_aware": (
        lambda d, i, m: jax_losses.second_order_edge_aware_loss(d, i),
        lambda d, i, m: losses.second_order_edge_aware_loss(d, i)),
    "first_order_edge_aware_norm": (
        lambda d, i, m: jax_losses.first_order_edge_aware_norm_loss(d, i),
        lambda d, i, m: losses.first_order_edge_aware_norm_loss(d, i)),
    "first_order": (lambda d, i, m: jax_losses.first_order_loss(d),
                    lambda d, i, m: losses.first_order_loss(d)),
    "bilateral_smooth": (jax_losses.bilateral_smooth_loss,
                         losses.bilateral_smooth_loss),
    "tv": (lambda d, i, m: jax_losses.tv_loss(d),
           lambda d, i, m: losses.tv_loss(d)),
    "l1": (lambda d, i, m: jax_losses.l1_loss(d, i),
           lambda d, i, m: losses.l1_loss(d, i)),
    "mse": (lambda d, i, m: jax_losses.mse_loss(d, i),
            lambda d, i, m: losses.mse_loss(d, i)),
    "mask_entropy": (lambda d, i, m: jax_losses.mask_entropy_loss(d[:1], m),
                     lambda d, i, m: losses.mask_entropy_loss(d[:1], m)),
    "psnr": (lambda d, i, m: jax_image.psnr(d[None], i[None]).mean(),
             lambda d, i, m: image.psnr(d[None], i[None]).mean()),
    "image_mse": (lambda d, i, m: jax_image.mse(d, i).sum(),
                  lambda d, i, m: image.mse(d, i).sum()),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_gradient_match_jax(name):
    jfn, tfn = LOSSES[name]
    a, b, mask = images(sum(map(ord, name)))
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(mask))
    x = t(a).requires_grad_()
    got = tfn(x, t(b), t(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-7)
    want_g = np.asarray(want_g)
    scale = np.abs(want_g).max()
    assert scale > 0
    np.testing.assert_allclose(x.grad.numpy() / scale, want_g / scale,
                               atol=1e-4)


def flat_cases():
    """The near-flat pairs of tests/test_losses_ssim.py, whose variances
    cancel to float noise (the clamps keep SSIM within [-1, 1])."""
    rng = np.random.default_rng(2)
    a = np.ones((3, 64, 64), np.float32)
    b = np.ones((3, 64, 64), np.float32)
    b[:, 30:34, :] = 0.996
    yield a, b
    for scale in (1e-7, 1e-6, 1e-5):
        yield ((1.0 + rng.normal(0, scale, (3, 64, 64))).astype(np.float32),
               (1.0 + rng.normal(0, scale, (3, 64, 64))).astype(np.float32))


@pytest.mark.parametrize("case", range(4))
def test_ssim_flat_regions_match_jax(case):
    a, b = list(flat_cases())[case]
    want = float(jax_losses.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(losses.ssim(t(a), t(b)))
    assert -1.0 - 1e-4 <= got <= 1.0 + 1e-4
    # E[x^2] - mu^2 cancels to float noise here, which the two frameworks
    # round differently; the clamped SSIM still agrees closely.
    assert got == pytest.approx(want, abs=1e-3)


def test_ssim_identity_is_one():
    a, _, _ = images(1)
    assert float(losses.ssim(t(a), t(a))) == pytest.approx(1.0, abs=1e-5)


# ---------------------------------------------------------------------------
# calculate_loss, every term
# ---------------------------------------------------------------------------

ALL_TERMS = dict(lambda_normal_render_depth=0.01, lambda_normal_smooth=0.01,
                 lambda_mask_entropy=0.1, lambda_depth_var=1e-2,
                 lambda_depth_smooth=0.02, lambda_point_entropy=0.03,
                 lambda_orientation=0.04, lambda_orientation_from_iter=2,
                 lambda_surface=0.05, lambda_scaling=0.06, iterations=100)


def test_calculate_loss_every_term_matches_jax():
    """Both packages' render results feed their own calculate_loss; the
    loss, every tb_dict term and the gradients of the loss agree."""
    params, aux, active = jax_model()
    cam_j, cam_t = cameras()
    rng = np.random.default_rng(3)
    gt = rng.uniform(size=(3, SIZE, SIZE)).astype(np.float32)
    mask = (rng.uniform(size=(1, SIZE, SIZE)) > 0.4).astype(np.float32)
    zeros = np.zeros((3, SIZE, SIZE), np.float32)
    iteration = 7

    view_j = JaxViewInputs(cam_j, jnp.asarray(gt), jnp.asarray(mask),
                           jnp.asarray(zeros[:1]), jnp.asarray(zeros))
    cfg_j = jax_config(3)

    def jax_fn(p):
        res = jax_render_view(p, aux.active, cam_j, cfg_j, jnp.asarray(BG))
        return jax_loss(view_j, p, aux.active, res, JaxOpt(**ALL_TERMS),
                        jnp.asarray(iteration))

    (want, want_tb), want_g = jax.jit(jax.value_and_grad(
        jax_fn, has_aux=True))(params)

    model = GaussianModel.from_numpy(
        {k: np.asarray(getattr(params, k)) for k in FIELDS}, active,
        device="cpu")
    view_t = port_render.ViewInputs(cam_t, t(gt), t(mask), t(zeros[:1]),
                                    t(zeros))
    res = port_render.render(view_t, model, RasterConfig(SIZE, SIZE), t(BG),
                             OptimizationConfig(**ALL_TERMS),
                             is_training=True, iteration=iteration)
    res["loss"].backward()
    assert set(res["tb_dict"]) == set(want_tb)
    for k, v in res["tb_dict"].items():
        np.testing.assert_allclose(float(v.detach()), float(want_tb[k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(res["loss"].detach()), float(want), rtol=2e-4)
    for k in FIELDS:
        w = np.asarray(getattr(want_g, k))[active]
        g = getattr(model, k).grad.numpy()
        scale = np.abs(w).max()
        assert scale > 0, k
        # relative to the largest entry, as test_torch_rasterize does
        np.testing.assert_allclose(g / scale, w / scale, atol=2e-3,
                                   err_msg=k)
