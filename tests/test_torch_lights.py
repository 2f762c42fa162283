"""The port's env lights and stage-2 graphics helpers against the JAX
package's, on the CPU, from the same seeded numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models import lights as jax_lights
from relightable3dgaussian_tpu.ops import camera as jax_camera
from relightable3dgaussian_tpu.utils import graphics as jax_graphics
from relightable3dgaussian_tpu.utils import sh as jax_sh
from relightable3dgaussian_tpu_torch.models import lights
from relightable3dgaussian_tpu_torch.ops import camera
from relightable3dgaussian_tpu_torch.utils import graphics, sh
from test_torch_ops import t


def unit_dirs(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # the poles and the seam of the map (theta = ±π), where the lookup wraps
    d[:4] = [[0, 0, 1], [0, 0, -1], [-1, 0, 0], [-1, 1e-7, 0]]
    return d


def raw_env(h: int, seed: int) -> np.ndarray:
    return (3.0 * np.random.default_rng(seed).uniform(size=(h, 2 * h, 3))
            ).astype(np.float32)


@pytest.mark.parametrize("h", [8, 16, 32])
def test_grid_sample_bilinear_matches_jax(h):
    """The same coordinates, inside and outside [-1, 1] (zero padding), to
    1e-6: the bilinear weights are rounded at other places."""
    rng = np.random.default_rng(h)
    gx, gy = rng.uniform(-1.1, 1.1, (2, 5000)).astype(np.float32)
    env = raw_env(h, h)
    want = jax_lights.grid_sample_bilinear(jnp.asarray(env), gx, gy)
    got = lights.grid_sample_bilinear(t(env), t(gx), t(gy))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("h", [8, 16, 32])
def test_equirect_query_and_env_gradient_match_jax(h):
    """The radiance to 1e-5: XLA's and torch's arccos and atan2 differ by
    one float32 ulp (2.4e-7 rad near π), which moves a sample by up to
    2.4e-6 texels at H = 32, and texels differ by up to 3. The gradient of a weighted sum with respect
    to the raw map to 1e-5 of its largest entry (the scatter of 2000
    samples into the texels adds in another order)."""
    dirs = unit_dirs(2000, h).reshape(40, 50, 3)
    env = raw_env(h, h + 1)
    w = np.random.default_rng(h + 2).normal(size=(40, 50, 3)).astype(np.float32)

    def f_jax(e):
        out = jax_lights.direct_light(jax_lights.DirectLightParams(env=e), dirs)
        return (out * w).sum(), out

    (_, want), g_want = jax.value_and_grad(f_jax, has_aux=True)(jnp.asarray(env))
    light = lights.DirectLightMap.from_raw(t(env))
    got = light.direct_light(t(dirs))
    (got * t(w)).sum().backward()
    assert got.shape == (40, 50, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(light.env.grad.numpy(), g_want, rtol=0,
                               atol=1e-5 * np.abs(g_want).max())


def test_equirect_query_with_transform_and_env_light():
    dirs = unit_dirs(500, 3)
    env = raw_env(16, 4)
    q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))
    q = q.astype(np.float32)
    want = jax_lights.EnvLight(jnp.asarray(env), jnp.asarray(q)).direct_light(dirs)
    got = lights.EnvLight(t(env), t(q)).direct_light(t(dirs))
    # as the query above: one ulp of the angles, texel steps up to 3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        lights.query_light(lights.EnvLight(t(env)), t(dirs)).numpy(),
        jax_lights.query_light(jax_lights.EnvLight(jnp.asarray(env)), dirs),
        atol=1e-5, rtol=0)
    assert torch.equal(lights.light_image(lights.EnvLight(t(env))), t(env))


def test_direct_light_map_activation_and_init():
    env = raw_env(8, 6) - 1.5
    light = lights.DirectLightMap.from_raw(t(env))
    np.testing.assert_allclose(
        light.get_env().detach().numpy(),
        jax_lights.get_env(jax_lights.DirectLightParams(env=jnp.asarray(env))),
        rtol=1e-6, atol=1e-7)
    assert torch.equal(lights.light_image(light), light.get_env())
    made = lights.DirectLightMap(16, 3.0, torch.Generator().manual_seed(1),
                                 device="cpu")
    again = lights.DirectLightMap(16, 3.0, torch.Generator().manual_seed(1),
                                  device="cpu")
    assert made.env.shape == (16, 32, 3) and made.env.requires_grad
    assert torch.equal(made.env, again.env)
    assert 0.0 <= float(made.env.detach().min())
    assert float(made.env.detach().max()) < 3.0
    with pytest.raises(TypeError, match="unknown light type"):
        lights.query_light(object(), t(unit_dirs(4, 0)))


@pytest.mark.parametrize("h", [8, 16])
def test_upsample_matches_jax(h):
    """To 2e-5: torch.linspace and jnp.linspace differ in the last bit
    (up to 1.8e-7), which moves a sample by up to 2.8e-6 texels of a
    32-wide map, and texels differ by up to 3."""
    env = raw_env(h, 7)
    want = jax_lights.upsample_direct_light(
        jax_lights.DirectLightParams(env=jnp.asarray(env))).env
    up = lights.upsample(lights.DirectLightMap.from_raw(t(env)))
    assert up.env.shape == (2 * h, 4 * h, 3) and up.env.requires_grad
    np.testing.assert_allclose(up.env.detach().numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lights.bilinear_resize_2x(t(env)).numpy(),
                               jax_lights._bilinear_resize_2x(jnp.asarray(env)),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("sample_num", [1, 8, 64])
def test_fibonacci_sphere_sampling_matches_jax(sample_num):
    n = unit_dirs(200, sample_num)
    dirs, areas = jax_graphics.fibonacci_sphere_sampling(n, sample_num, key=None)
    got_d, got_a = graphics.fibonacci_sphere_sampling(t(n), sample_num)
    assert got_d.shape == (200, sample_num, 3) and got_d.is_contiguous()
    np.testing.assert_allclose(got_d.numpy(), dirs, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(got_a.numpy(), areas)
    # the hemisphere around each normal (z >= sin 10° in the normal's frame)
    assert (np.einsum("nsk,nk->ns", got_d.numpy(), n) > 0.17).all()


def test_rotation_between_z_matches_jax():
    v = unit_dirs(300, 9)
    v[4] = [0, 0, -1 + 1e-8]
    got = sh.rotation_between_z(t(v)).numpy()
    np.testing.assert_allclose(got, jax_sh.rotation_between_z(v), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got[:, :, 2], v, atol=1e-5)


def test_srgb_transfer_matches_jax():
    x = np.random.default_rng(10).uniform(-0.2, 1.5, 4000).astype(np.float32)
    x[:3] = [0.0031308, 0.04045, 0.0]
    for clip in (True, False):
        np.testing.assert_allclose(graphics.rgb_to_srgb(t(x), clip).numpy(),
                                   jax_graphics.rgb_to_srgb(x, clip),
                                   rtol=1e-6, atol=1e-7)
    y = np.abs(x)
    np.testing.assert_allclose(graphics.srgb_to_rgb(t(y)).numpy(),
                               jax_graphics.srgb_to_rgb(y), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("intrinsics", [False, True])
def test_pixel_directions_match_jax(intrinsics):
    R, _ = np.linalg.qr(np.random.default_rng(11).normal(size=(3, 3)))
    T = np.array([0.2, -0.1, 3.5])
    kw = (dict(fx=70.0, fy=72.0, cx=30.0, cy=33.0) if intrinsics
          else dict(fovx=0.9, fovy=0.8))
    want = jax_camera.pixel_directions(
        jax_camera.make_camera_params(R, T, 64, 60, **kw), 60, 64)
    cam = camera.make_camera_params(R, T, 64, 60, **kw, device="cpu")
    np.testing.assert_array_equal(cam.c2w_rot.numpy(), np.asarray(
        jax_camera.make_camera_params(R, T, 64, 60, **kw).c2w_rot))
    got = camera.pixel_directions(cam, 60, 64)
    assert got.shape == (60, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
