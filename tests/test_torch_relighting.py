"""The port's relighting path against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function and the port's:
the quaternion helpers, scene composition (`set_transform`, `concatenate`,
`cli.relighting.scene_composition`), the env-map files (`write_exr_zip`,
`load_env_light`), the eval render with a base-colour scale under a rotated
environment, `finetune_visibility`, and the two relighting CLIs end to end.
Each comparison states its tolerance. The JAX CLIs run with --no_auto_plan.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.cli import eval_relighting_syn4 as jax_syn4
from relightable3dgaussian_tpu.cli import relighting as jax_relighting
from relightable3dgaussian_tpu.models import gaussians as jax_gaussians
from relightable3dgaussian_tpu.models import lights as jax_lights
from relightable3dgaussian_tpu.models import render_neilf as jax_neilf
from relightable3dgaussian_tpu.ops import ray_trace as jax_rt
from relightable3dgaussian_tpu.scene import exr as jax_exr
from relightable3dgaussian_tpu.scene import ply_io as jax_ply_io
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu.train import stage2 as jax_stage2
from relightable3dgaussian_tpu.utils import quaternions as jax_quat
from relightable3dgaussian_tpu_torch.cli import eval_relighting_syn4, relighting
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.models import lights, render_neilf
from relightable3dgaussian_tpu_torch.ops import ray_trace
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.scene import exr
from relightable3dgaussian_tpu_torch.scene.image_io import read_png, write_png
from relightable3dgaussian_tpu_torch.train import stage2
from relightable3dgaussian_tpu_torch.utils import quaternions, trace
from test_ray_trace import brute_force_visibility_vec
from test_scene_io import make_params
from test_torch_ops import t as tensor
from test_torch_ray_trace import shell_scene, surface_rays
from test_torch_stage2 import jax_cfg, jax_params, port_vis, views

F32 = np.float32


def to_numpy(params) -> dict:
    return {k: np.asarray(v) for k, v in vars(params).items()}


def rotation(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------

def test_rotmat_to_quaternion_matches_jax():
    """Seeded rotations and the angle-pi rotations about each axis (trace
    -1, where the diagonal pivots decide) and about diagonals; atol 1e-6."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(200, 4))
    mats = list(np.asarray(jax_quat.quaternion_to_rotmat(
        jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True)))))
    for axis in ([1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, -1, 1]):
        mats += [rotation(axis, np.pi), rotation(axis, np.pi - 1e-3),
                 rotation(axis, 0.5)]
    mats += [np.eye(3)]
    R = np.stack(mats).astype(F32)
    want = np.asarray(jax_quat.rotmat_to_quaternion(jnp.asarray(R)))
    got = quaternions.rotmat_to_quaternion(torch.from_numpy(R)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    back = quaternions.quaternion_to_rotmat(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, R, atol=1e-5)   # a rotation's own


def test_quaternion_multiply_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(50, 4)).astype(F32)
    b = rng.normal(size=(1, 4)).astype(F32)      # broadcast, as set_transform
    want = np.asarray(jax_quat.quaternion_multiply(jnp.asarray(b),
                                                   jnp.asarray(a)))
    got = quaternions.quaternion_multiply(torch.from_numpy(b),
                                          torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def transforms() -> dict[str, np.ndarray]:
    """A uniform and a non-uniform scale, each with a rotation and a
    translation."""
    out = {}
    for name, scale in (("uniform", [0.5, 0.5, 0.5]),
                        ("non-uniform", [0.5, 1.3, 2.0])):
        T = np.eye(4)
        T[:3, :3] = np.diag(scale) @ rotation([0.3, 1.0, -0.2], 1.1)
        T[:3, 3] = [0.6, -0.2, 0.4]
        out[name] = T.astype(F32)
    return out


@pytest.mark.parametrize("name", ["uniform", "non-uniform"])
def test_set_transform_matches_jax(name):
    """Every field at atol 1e-5 on a 40-point PBR model; the result is a
    new model with zero statistics."""
    T = transforms()[name]
    params = make_params(n=40, use_pbr=True, key=3)
    want = jax_gaussians.set_transform(params, jnp.asarray(T))
    model = G.GaussianModel.from_numpy(to_numpy(params), device="cpu")
    model.denom += 1.0
    got = G.set_transform(model, torch.from_numpy(T))
    assert got is not model and got.has_pbr
    for k in got.fields:
        np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5,
                                   rtol=0, err_msg=k)
    assert float(got.denom.abs().sum()) == 0.0


def test_concatenate_matches_jax_and_needs_pbr():
    parts = [make_params(n=n, use_pbr=True, key=k) for k, n in ((0, 20),
                                                                (1, 30))]
    want = jax_gaussians.concatenate(parts)
    got = G.concatenate([G.GaussianModel.from_numpy(to_numpy(p),
                                                    device="cpu")
                         for p in parts])
    assert got.num_points == 50
    for k in got.fields:
        np.testing.assert_array_equal(getattr(got, k).detach().numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    stage1 = G.GaussianModel.from_numpy(
        to_numpy(make_params(n=5, use_pbr=False)), device="cpu")
    with pytest.raises(ValueError, match="no PBR fields"):
        G.concatenate([got, stage1])


def write_plys(root, n: int = 20, count: int = 2):
    """`count` small opaque PBR models (make_params' fields, the JAX
    relighting test's adjustments) as PLYs by the JAX writer."""
    paths = []
    for i in range(count):
        params = make_params(n=n, use_pbr=True, key=i)
        params = params.replace(
            xyz=params.xyz * 0.3, scaling=jnp.full((n, 3), np.log(0.1)),
            rotation=jnp.zeros((n, 4)).at[:, 0].set(1.0),
            opacity=jnp.full((n, 1), 1.0))
        path = root / f"m{i}.ply"
        jax_ply_io.save_gaussian_ply(str(path), params)
        paths.append(path)
    return paths


def scene_dict(paths) -> dict:
    Ts = list(transforms().values())
    return {f"obj{i}": {"path": str(p), "transform": Ts[i].reshape(-1).tolist()}
            for i, p in enumerate(paths)}


def test_scene_composition_matches_jax(tmp_path):
    """Field by field at atol 1e-5: two transformed clouds, the visibility
    SH rest padded to 24 coefficients, zero incident-light SH."""
    d = scene_dict(write_plys(tmp_path, n=15))
    want, active = jax_relighting.scene_composition(d)
    got = relighting.scene_composition(d, device="cpu")
    assert got.num_points == int(active.sum()) == 30
    assert got.visibility_rest.shape == (30, 24, 1)
    assert float(got.get_incidents.detach().abs().max()) == 0.0
    assert float(got.visibility_rest.detach()[:, 15:].abs().max()) == 0.0
    for k in got.fields:
        np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5,
                                   rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# env-map files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 53, 3), (16, 8, 4), (1, 1, 3),
                                   (40, 9, 5)])
def test_write_exr_zip_is_the_jax_writer(tmp_path, shape):
    """The same bytes as the JAX writer (odd sizes, RGBA, a constant image,
    more than four channels); the port reads its own file back exactly."""
    img = (np.random.default_rng(sum(shape)).random(shape) * 20).astype(F32)
    if shape == (16, 8, 4):
        img[:] = 1.0
    jax_exr.write_exr_zip(str(tmp_path / "jax.exr"), img)
    exr.write_exr_zip(str(tmp_path / "port.exr"), img)
    assert ((tmp_path / "port.exr").read_bytes()
            == (tmp_path / "jax.exr").read_bytes())
    if shape[-1] <= 4:
        np.testing.assert_array_equal(
            exr.read_exr_rgb(str(tmp_path / "port.exr")), img)


def write_hdr(path, rgb: np.ndarray) -> None:
    """A Radiance .hdr of rgb [H, W, 3] with adaptive-RLE scanlines (each
    channel: a run of its first byte, then literals)."""
    H, W = rgb.shape[:2]
    m = np.maximum(rgb.max(-1), 1e-32)
    e = np.ceil(np.log2(m)).astype(np.int32)
    mant = np.clip(rgb / np.ldexp(1.0, e)[..., None] * 256, 0, 255)
    rgbe = np.concatenate([mant, (e + 128)[..., None]], -1).astype(np.uint8)
    rgbe[:, 0] = rgbe[:, 1]                  # a run of two at each row start
    out = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode()
    for y in range(H):
        out += bytes([2, 2, W >> 8, W & 255])
        for c in range(4):
            row = rgbe[y, :, c]
            out += bytes([128 + 2, row[0]]) + bytes([W - 2]) + row[2:].tobytes()
    path.write_bytes(out)


def env_files(root) -> dict:
    rng = np.random.default_rng(5)
    files = {"exr": root / "env.exr", "hdr": root / "env.hdr",
             "png": root / "env.png"}
    exr.write_exr_zip(str(files["exr"]), (rng.random((8, 16, 3)) * 30
                                          ).astype(F32))
    write_hdr(files["hdr"], (rng.random((8, 16, 3)) * 5).astype(F32))
    write_png(str(files["png"]), (rng.random((8, 16, 4)) * 255).astype(np.uint8))
    return files


@pytest.mark.parametrize("kind", ["exr", "hdr", "png"])
def test_load_env_light_matches_jax(tmp_path, kind):
    """The map at atol 1e-6 (a PNG is sRGB-decoded, its alpha dropped)."""
    path = str(env_files(tmp_path)[kind])
    want = jax_lights.load_env_light(path, scale=1.5)
    got = lights.load_env_light(path, scale=1.5, device="cpu")
    assert isinstance(got, lights.EnvLight) and got.transform is None
    assert got.envmap.device.type == "cpu" and got.envmap.shape == (8, 16, 3)
    np.testing.assert_allclose(got.envmap.numpy(), np.asarray(want.envmap),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the eval render with a base-colour scale under a rotated environment
# ---------------------------------------------------------------------------

def test_render_neilf_scaled_and_rotated_matches_jax():
    """render_neilf(is_training=False) with base_color_scale and a rotated
    EnvLight, under test_torch_stage2's eval tolerance: sRGB maps 1e-4
    where the opacity is at least 0.05, the environment background 1e-5,
    the SH render 2e-5. The scale and the rotation must each move the
    result."""
    params = jax_params()
    vis = jax_neilf.update_visibility(params, jnp.ones(300, bool), 8)
    envmap = (np.random.default_rng(7).random((8, 16, 3)) * 4).astype(F32)
    rot = rotation([0.2, 1.0, 0.4], 0.9).astype(F32)
    scale = np.array([1.6, 0.7, 1.2], F32)
    view_j, view_t = views()
    model = G.GaussianModel.from_numpy(to_numpy(params), device="cpu")

    def port(transform, bc):
        env = lights.EnvLight(torch.from_numpy(envmap),
                              None if transform is None
                              else torch.from_numpy(transform))
        with torch.no_grad():
            return render_neilf.render_neilf(
                view_t, model, RasterConfig(64, 64), torch.zeros(3), env,
                port_vis(vis), is_training=False,
                base_color_scale=None if bc is None else torch.from_numpy(bc))

    want = jax_neilf.render_neilf(
        view_j, params, jnp.ones(300, bool),
        jax_cfg(jax_neilf.EVAL_FEATURE_DIM), jnp.zeros(3),
        jax_lights.EnvLight(jnp.asarray(envmap), jnp.asarray(rot)), vis,
        is_training=False, base_color_scale=jnp.asarray(scale))
    got = port(rot, scale)
    ok = np.asarray(want["opacity"])[0] >= 0.05
    assert ok.sum() > 1000
    for k in ("pbr", "base_color", "diffuse", "specular", "lights",
              "local_lights", "global_lights", "roughness", "visibility",
              "normal", "pbr_env", "render_env"):
        np.testing.assert_allclose(got[k].numpy()[:, ok],
                                   np.asarray(want[k])[:, ok], atol=1e-4,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(got["env_only"].numpy(), want["env_only"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["render"].numpy(), want["render"],
                               atol=2e-5, rtol=0)
    for other in (port(None, scale), port(rot, None)):
        assert float((other["pbr_env"] - got["pbr_env"]).abs().max()) > 0.01


# ---------------------------------------------------------------------------
# finetune_visibility
# ---------------------------------------------------------------------------

def test_finetune_visibility_matches_jax():
    """5 iterations on the directions JAX's key draws
    (jax.random.split(key, 5), then jax.random.normal(k, xyz.shape)), the
    port's own tracer against the JAX package's: the visibility SH and the
    losses within rtol 1e-5 (elementwise, atol 1e-6 for entries near 0)."""
    rng = np.random.default_rng(3)
    n = 40
    d = {"xyz": rng.uniform(-1, 1, (n, 3)), "normal": rng.normal(size=(n, 3)),
         "shs_dc": rng.normal(size=(n, 1, 3)), "shs_rest": np.zeros((n, 15, 3)),
         "scaling": np.log(rng.uniform(0.05, 0.3, (n, 3))),
         "rotation": rng.normal(size=(n, 4)),
         "opacity": rng.normal(1, 1, (n, 1)),
         "base_color": np.zeros((n, 3)), "roughness": np.zeros((n, 1)),
         "incidents_dc": np.zeros((n, 1, 3)),
         "incidents_rest": np.zeros((n, 15, 3)),
         "visibility_dc": rng.normal(size=(n, 1, 1)) * 0.3,
         "visibility_rest": rng.normal(size=(n, 15, 1)) * 0.1}
    d = {k: v.astype(F32) for k, v in d.items()}
    key, iters = jax.random.PRNGKey(5), 5
    want, want_losses = jax_stage2.finetune_visibility(
        jax_gaussians.GaussianParams(**{k: jnp.asarray(v)
                                        for k, v in d.items()}),
        jnp.ones(n, bool), key, iterations=iters)
    dirs = np.stack([np.asarray(jax.random.normal(k, (n, 3)))
                     for k in jax.random.split(key, iters)])
    model = G.GaussianModel.from_numpy(d, device="cpu")
    before = trace.counter("k3.launches")
    got, losses = stage2.finetune_visibility(model, iters,
                                             directions=torch.from_numpy(dirs))
    assert got is model and trace.counter("k3.launches") == before
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=1e-5)
    for k in ("visibility_dc", "visibility_rest"):
        np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert not np.array_equal(getattr(got, k).detach().numpy(), d[k])


def test_finetune_visibility_draws_from_its_generator():
    """Without directions the draws come from the generator: the same seed
    gives the same fit, and the loss falls over 30 iterations."""
    rng = np.random.default_rng(4)
    params = to_numpy(make_params(n=30, use_pbr=True, key=4))
    params["xyz"] = rng.uniform(-1, 1, (30, 3)).astype(F32)
    fits = []
    for _ in range(2):
        model = G.GaussianModel.from_numpy(params, device="cpu")
        _, losses = stage2.finetune_visibility(
            model, 30, generator=torch.Generator().manual_seed(0))
        fits.append((model.visibility_rest.detach().clone(), losses))
    torch.testing.assert_close(fits[0][0], fits[1][0], rtol=0, atol=0)
    losses = fits[0][1].numpy()
    assert np.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean()


# ---------------------------------------------------------------------------
# the relighting CLI
# ---------------------------------------------------------------------------

def write_relight_config(root, paths, frames: int = 2, size: int = 32):
    """transform.json, trajectory.json (size x size, the Blender default
    field of view) and light_transform.json (a different rotation a
    frame), and an 8-bit env PNG."""
    with open(root / "transform.json", "w") as f:
        json.dump(scene_dict(paths), f)
    traj = {"camera": {"width": size, "height": size}, "trajectory": {}}
    rots = {"transform": {}}
    for i in range(frames):
        w2c = np.eye(4)
        w2c[:3, :3] = rotation([0, 1, 0], 0.4 * i)
        w2c[2, 3] = 4.0
        traj["trajectory"][str(i)] = w2c.reshape(-1).tolist()
        rots["transform"][str(i)] = rotation([1, 0.5, 0], 0.7 + i).reshape(
            -1).tolist()
    with open(root / "trajectory.json", "w") as f:
        json.dump(traj, f)
    with open(root / "light_transform.json", "w") as f:
        json.dump(rots, f)
    env = (np.random.default_rng(2).random((8, 16, 3)) * 255).astype(np.uint8)
    write_png(str(root / "env.png"), env)
    return root / "env.png"


CAPTURES = ["pbr_env", "pbr", "env_only", "base_color", "roughness",
            "visibility", "normal", "points"]


def test_relighting_main_matches_jax(tmp_path):
    """The port's and the JAX CLI's PNGs, 32x32, S = 4, 2 frames, a
    different light rotation a frame, --vis_one and --base_color_scale:
    within 1 u8 step at every pixel of every capture."""
    env = write_relight_config(tmp_path, write_plys(tmp_path))
    common = ["-co", str(tmp_path), "-e", str(env), "--sample_num", "4",
              "--capture_list", ",".join(CAPTURES), "--vis_one",
              "--base_color_scale", "1.5", "0.8", "1.1"]
    jax_relighting.main(common + ["--output", str(tmp_path / "jax"),
                                  "--no_auto_plan"])
    k1 = trace.counter("k1.launches")
    relighting.main(common + ["--output", str(tmp_path / "port"),
                              "--no_auto_plan", "--trace_max_clusters", "8"],
                    device="cpu")
    assert trace.counter("k1.launches") == k1
    for t in CAPTURES:
        for i in range(2):
            got = read_png(str(tmp_path / "port" / t / f"frame_{i}.png"))
            want = read_png(str(tmp_path / "jax" / t / f"frame_{i}.png"))
            assert got.shape == want.shape == (32, 32, 3), t
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1, (t, i, diff.max(), (diff > 1).sum())
    f0 = read_png(str(tmp_path / "port" / "env_only" / "frame_0.png"))
    f1 = read_png(str(tmp_path / "port" / "env_only" / "frame_1.png"))
    assert np.abs(f0.astype(int) - f1.astype(int)).max() > 10


def two_shells(seed: int, n: int):
    """Two of test_torch_ray_trace's occluding bowls of n flat gaussians,
    at half size side by side (A at x = -0.3, B at +0.3): [xyz, scaling,
    rotation, opacity, normal] of A and of the composite A + B."""
    clouds = []
    for k, shift in ((0, -0.3), (1, 0.3)):
        xyz, scaling, rot, op, nrm = shell_scene(seed + k, n)
        clouds.append([0.5 * xyz + F32([shift, 0, 0]), 0.5 * scaling, rot, op,
                       nrm])
    return clouds[0], [np.concatenate(x) for x in zip(*clouds)]


def pairs_tested(bvh, o, inv_d, n: int) -> torch.Tensor:
    """[R, n] whether the tracer's rule tests gaussian g < n (in input
    order) on each ray: its cluster's box is slab-hit."""
    hit = ray_trace.slab_hit(bvh.cluster_lo, bvh.cluster_hi, o, inv_d)
    pos = torch.empty_like(bvh.order)
    pos[bvh.order] = torch.arange(bvh.order.numel())
    return hit[:, pos[:n] // ray_trace.CLUSTER_SIZE]


def test_own_bvh_rise_comes_from_gaussians_outside_their_box():
    """Why chip_smoke.py's relight phase holds cloud A's rays in the
    composite against A with B's opacities below 1/255 under the same BVH,
    and not against A under a BVH of its own. The tracer's rule (K3's and
    the plain version's) tests every gaussian of each hit cluster, so a
    gaussian whose own 3-sigma box the ray misses counts only where its
    cluster is hit, and a BVH of A alone groups A into other clusters. On
    two shells: the plain tracer puts the composite above A's own-BVH
    visibility on some of A's rays (> 1e-6); the float64 brute force, which
    tests every gaussian, on none, and the JAX tracer, whose block rule
    tests a superset of the clusters, on fewer. On each such ray every
    gaussian of A that one trace tests and the other does not lies outside
    its own box, A's own trace has such extra factors below 1, and both
    traces taken over only the gaussians whose box the ray meets (the
    reference's rule) put the composite at or below A alone."""
    A, comp = two_shells(0, 2048)
    n_a = A[0].shape[0]
    rays_o, rays_d = surface_rays(A[0], A[4], 256, 8)
    o = tensor(rays_o) + ray_trace.RAY_OFFSET * tensor(rays_d)
    d, inv_d = tensor(rays_d), ray_trace.safe_inverse(tensor(rays_d))
    bvh_a, bvh_c = (ray_trace.build_bvh(*map(tensor, c)) for c in (A, comp))
    T_a, T_c = (ray_trace.trace_transmittance_plain(b, o, d)
                for b in (bvh_a, bvh_c))
    vis_a, vis_c = (torch.where(T >= ray_trace.T_MIN, T, 0.0).numpy()
                    for T in (T_a, T_c))
    jax_a, jax_c = (np.asarray(jax_rt.trace_visibility_adaptive(
        jax_rt.build_bvh(*c), rays_o, rays_d, max_supers=8, max_clusters=24,
        ray_chunk=128)["visibility"][:, 0]) for c in (A, comp))
    bf_a, bf_c = (brute_force_visibility_vec(*c, rays_o, rays_d)
                  for c in (A, comp))
    above = vis_c > vis_a + 1e-6
    share = {"plain": above.mean(), "jax": (jax_c > jax_a + 1e-6).mean(),
             "brute force": (bf_c > bf_a + 1e-6).mean()}
    assert share["plain"] > 0 and share["brute force"] == 0, share
    assert share["jax"] < share["plain"], share

    # the rays above A alone: which gaussians each trace tests
    idx = torch.from_numpy(np.nonzero(above)[0])
    o, d, inv_d = o[idx], d[idx], inv_d[idx]
    rec_c = bvh_c.records[torch.argsort(bvh_c.order)]       # input order
    f = ray_trace.pair_one_minus_alpha(rec_c, o, d).double()
    test_a = pairs_tested(bvh_a, o, inv_d, n_a)
    test_c = pairs_tested(bvh_c, o, inv_d, comp[0].shape[0])
    np.testing.assert_allclose(torch.where(test_a, f[:, :n_a], 1.0).prod(1),
                               T_a[idx].double(), rtol=1e-5)
    np.testing.assert_allclose(torch.where(test_c, f, 1.0).prod(1),
                               T_c[idx].double(), rtol=1e-5)
    R = quaternions.quaternion_to_rotmat(tensor(comp[2]))
    half = 3.0 * (R.abs() @ tensor(comp[1])[..., None])[..., 0]
    xyz = tensor(comp[0])
    box = ray_trace.slab_hit(xyz - half, xyz + half, o, inv_d)
    apart = test_a ^ test_c[:, :n_a]
    assert not (apart & box[:, :n_a]).any()
    extra = torch.where(test_a & ~test_c[:, :n_a], f[:, :n_a], 1.0).prod(1)
    assert (extra < 1).all(), extra
    T_box_a = torch.where(box[:, :n_a], f[:, :n_a], 1.0).prod(1)
    T_box_c = torch.where(box, f, 1.0).prod(1)
    vis_box_a, vis_box_c = (torch.where(T >= ray_trace.T_MIN, T, 0.0)
                            for T in (T_box_a, T_box_c))
    assert (vis_box_c <= vis_box_a + 1e-6).all()


def test_relighting_refuses_n_devices(tmp_path, monkeypatch):
    """On a machine with one card, --n_devices 2 is refused with the card
    count before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--n_devices 2 requested but only 1"):
        relighting.main(["-co", str(tmp_path), "--n_devices", "2"],
                        device="cuda")


def test_export_videos_keeps_the_pngs(tmp_path, capsys):
    relighting.export_videos(str(tmp_path), ["pbr_env"],
                             {"trajectory": {"0": [], "1": []}}, 32, 32)
    assert "frames of 32x32 saved as PNG" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the Synthetic4Relight eval
# ---------------------------------------------------------------------------

def write_syn4(root, size: int = 32, frames: int = 2):
    """A tiny Synthetic4Relight layout: transforms_test.json, RGBA relit
    ground truth for both maps (test_rli/envmap{6,12}_<stem>.png), constant
    albedo and roughness images under the same alpha, env_map/envmap
    {6,12}.exr (two different maps), and a JAX stage-2 checkpoint under a
    model path holding /hotdog/."""
    rng = np.random.default_rng(9)
    data, model_dir = root / "syn4" / "hotdog", root / "out" / "hotdog"
    for d in (data / "test_rli", data / "test", root / "env_map", model_dir):
        d.mkdir(parents=True, exist_ok=True)
    alpha = np.zeros((size, size), np.uint8)
    alpha[4:-4, 6:-6] = 255
    tf = []
    for i in range(frames):
        c2w = np.eye(4)
        c2w[:3, :3] = rotation([0, 1, 0], 0.5 * i)
        c2w[:3, 3] = c2w[:3, :3] @ np.array([0.0, 0.0, 4.0])
        tf.append({"file_path": f"test/r_{i}", "transform_matrix": c2w.tolist()})
        for env in ("envmap6", "envmap12"):
            rgb = (rng.random((size, size, 3)) * 255).astype(np.uint8)
            write_png(str(data / "test_rli" / f"{env}_r_{i}.png"),
                      np.dstack([rgb, alpha]))
        for name, value in (("albedo", (180, 120, 60)), ("rough", (90,) * 3)):
            img = np.zeros((size, size, 4), np.uint8)
            img[..., :3] = value
            img[..., 3] = alpha
            write_png(str(data / "test" / f"r_{i}_{name}.png"), img)
    with open(data / "transforms_test.json", "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": tf}, f)
    exr.write_exr_zip(str(root / "env_map" / "envmap6.exr"),
                      (rng.random((8, 16, 3)) * 3).astype(F32))
    exr.write_exr_zip(str(root / "env_map" / "envmap12.exr"),
                      (rng.random((8, 16, 3)) * 8).astype(F32))
    params = jax_params()
    jax_checkpoint.save_checkpoint(
        str(model_dir / "chkpnt7.npz"), 7, params=params,
        aux=jax_gaussians.init_aux(300, 300))
    return data, model_dir


def read_metrics(path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        k, v = line.split(": ")
        out[k] = v
    return out


def test_eval_relighting_syn4_matches_jax(tmp_path, monkeypatch, capsys):
    """metric.txt of both maps under LPIPS_WEIGHTS=random: the reference's
    seven fields (the log names the backbone); each value against the JAX
    CLI's on the same files, each package tracing its own visibility: PSNR
    within 1e-3 dB, SSIM within 1e-5, LPIPS and the roughness MSE within
    rtol 1e-4 (float32 sums in another order)."""
    from relightable3dgaussian_tpu.losses import lpips as jax_lpips
    from relightable3dgaussian_tpu_torch.losses import lpips as port_lpips
    monkeypatch.setenv("LPIPS_WEIGHTS", "random")
    jax_lpips._CACHE.clear()
    port_lpips._CACHE.clear()
    data, model_dir = write_syn4(tmp_path)
    args = ["-s", str(data), "-m", str(model_dir), "-c",
            str(model_dir / "chkpnt7.npz"), "-e", str(tmp_path),
            "--sample_num", "8"]
    try:
        jax_syn4.main(args + ["--no_auto_plan"])
        want = {t: read_metrics(model_dir / "test_rli" / t / "metric.txt")
                for t in ("env6", "env12")}
        k3 = trace.counter("k3.launches")
        capsys.readouterr()
        out = eval_relighting_syn4.main(args + ["--no_auto_plan"],
                                        device="cpu")
        log = capsys.readouterr().out
    finally:
        jax_lpips._CACHE.clear()
        port_lpips._CACHE.clear()
    assert trace.counter("k3.launches") == k3
    assert sorted(out) == ["env12", "env6"]
    for task in ("env6", "env12"):
        got = read_metrics(model_dir / "test_rli" / task / "metric.txt")
        assert list(got) == list(eval_relighting_syn4.METRICS)
        for k in eval_relighting_syn4.METRICS:
            g, w = float(got[k]), float(want[task][k])
            assert np.isfinite(g) and g == pytest.approx(out[task][k]), k
            tol = {"psnr": 1e-3, "ssim": 1e-5}.get(k.split("_")[0],
                                                   1e-4 * abs(w))
            assert abs(g - w) <= tol, (task, k, g, w)
        assert (model_dir / "test_rli" / task / "pbr_env" / "1.png").exists()
    assert out["env6"]["psnr_pbr"] != out["env12"]["psnr_pbr"]
    assert "LPIPS: lpips(random-vgg)" in log


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

@pytest.fixture
def lpips_modules(monkeypatch):
    from relightable3dgaussian_tpu.losses import lpips as jax_lpips
    from relightable3dgaussian_tpu_torch.losses import lpips as port_lpips
    jax_lpips._CACHE.clear()
    port_lpips._CACHE.clear()
    yield jax_lpips, port_lpips
    jax_lpips._CACHE.clear()
    port_lpips._CACHE.clear()


def image_pair(seed: int, shape=(3, 48, 64)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(F32)
    y = np.clip(x + rng.normal(0, 0.1, shape), 0, 1).astype(F32)
    return x, y


def test_lpips_random_backbone_matches_jax(lpips_modules, monkeypatch):
    """The seeded random backbone: the same weights as the JAX package's
    and LPIPS within rtol 1e-4, single images and a batch."""
    jax_lpips, port_lpips = lpips_modules
    monkeypatch.setenv("LPIPS_WEIGHTS", "random")
    assert port_lpips.available() and port_lpips.is_random_backbone()
    assert port_lpips.metric_name() == "lpips(random-vgg)"
    w_port, w_jax = port_lpips._load_weights(), jax_lpips._load_weights()
    assert sorted(w_port) == sorted(w_jax)
    for k in w_jax:
        np.testing.assert_array_equal(w_port[k], w_jax[k], err_msg=k)
    for shape in ((3, 48, 64), (2, 3, 32, 32)):
        x, y = image_pair(0, shape)
        want = float(jax_lpips.lpips(jnp.asarray(x), jnp.asarray(y)))
        got = float(port_lpips.lpips(torch.from_numpy(x), torch.from_numpy(y)))
        assert want > 0 and got == pytest.approx(want, rel=1e-4)


def lpips_state_dict(seed: int, renamed: bool) -> dict:
    """Random VGG16 and lin weights in the upstream file's tensor names."""
    from test_lpips import _random_state_dict
    return _random_state_dict(np.random.default_rng(seed),
                              "renamed" if renamed else "raw")


@pytest.mark.parametrize("suffix,renamed", [(".npz", False), (".npz", True),
                                            (".pth", False)])
def test_lpips_weight_file_matches_jax(lpips_modules, monkeypatch, tmp_path,
                                       suffix, renamed):
    """A weight file named by LPIPS_WEIGHTS (npz in both lin namings, a
    torch .pth read with weights_only=True): LPIPS within rtol 1e-4 of the
    JAX package's on the same file, named `lpips`."""
    jax_lpips, port_lpips = lpips_modules
    w = lpips_state_dict(1, renamed)
    path = tmp_path / f"weights{suffix}"
    if suffix == ".npz":
        np.savez(path, **w)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in w.items()}, path)
        monkeypatch.setitem(jax_lpips._CACHE, "w", w)   # JAX reads the npz
    monkeypatch.setenv("LPIPS_WEIGHTS", str(path))
    assert port_lpips.available() and port_lpips.metric_name() == "lpips"
    x, y = image_pair(2)
    want = float(jax_lpips.lpips(jnp.asarray(x), jnp.asarray(y)))
    got = float(port_lpips.lpips(torch.from_numpy(x), torch.from_numpy(y)))
    assert want > 0 and got == pytest.approx(want, rel=1e-4)
    assert float(port_lpips.lpips(torch.from_numpy(x),
                                  torch.from_numpy(x))) == pytest.approx(
        0.0, abs=1e-6)


def test_lpips_nan_without_weights(lpips_modules, monkeypatch, tmp_path):
    _, port_lpips = lpips_modules
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert not port_lpips.available() and not port_lpips.is_random_backbone()
    assert np.isnan(float(port_lpips.lpips(torch.zeros(3, 8, 8),
                                           torch.zeros(3, 8, 8))))


def test_lpips_reads_the_default_cache_file(lpips_modules, monkeypatch,
                                            tmp_path):
    _, port_lpips = lpips_modules
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    (tmp_path / ".cache").mkdir()
    np.savez(tmp_path / ".cache" / "lpips_vgg.npz", **lpips_state_dict(3, False))
    assert port_lpips.available()
    x, y = image_pair(4, (3, 32, 32))
    assert float(port_lpips.lpips(torch.from_numpy(x),
                                  torch.from_numpy(y))) > 0


def test_hdr_writer_round_trips(tmp_path):
    """The test's own HDR writer against the port's reader (RGBE keeps 8
    bits of mantissa against a pixel's largest channel), so the
    load_env_light case reads what it meant."""
    rgb = (np.random.default_rng(6).random((4, 16, 3)) * 5 + 0.01).astype(F32)
    write_hdr(tmp_path / "x.hdr", rgb)
    got = exr.read_hdr(str(tmp_path / "x.hdr"))
    step = rgb.max(-1, keepdims=True) / 128
    assert (np.abs(got - rgb)[:, 2:] <= step[:, 2:]).all()
    np.testing.assert_array_equal(got[:, 0], got[:, 1])
