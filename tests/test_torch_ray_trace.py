"""The port's ray tracer against the JAX package's, on the CPU: the BVH
(Morton order and AABBs), and the plain version of kernel K3 against the
JAX tracer (`trace_visibility_adaptive`, which recovers its exact result by
escalating its caps) and the numpy brute force of tests/test_ray_trace.py,
on occluding scenes and on the degenerate-scale needles, from the same
seeded numpy inputs."""
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.ops import ray_trace as jax_rt
from relightable3dgaussian_tpu.utils import graphics as jax_graphics
from relightable3dgaussian_tpu_torch.ops import ray_trace
from relightable3dgaussian_tpu_torch.utils import trace
from test_ray_trace import brute_force_visibility_vec
from test_torch_ops import t

F32 = np.float32


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(F32)


def shell_scene(seed: int, n: int):
    """The dense occluding bowl of test_ray_trace._shell_scene in numpy:
    points on the lower half of the unit sphere, normals inward, flat
    gaussians (0.06, 0.06, 0.012), opacities in [0.3, 0.95]."""
    rng = np.random.default_rng(seed)
    d = unit(rng, n)
    d[:, 2] = -np.abs(d[:, 2])
    xyz = (d * (1.0 + 0.03 * rng.normal(size=(n, 1)))).astype(F32)
    scaling = np.tile(np.array([0.06, 0.06, 0.012], F32), (n, 1))
    rot = rng.normal(size=(n, 4)).astype(F32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    op = rng.uniform(0.3, 0.95, n).astype(F32)
    return xyz, scaling, rot, op, -d


def random_cloud(seed: int, n: int):
    rng = np.random.default_rng(seed)
    rot = rng.normal(size=(n, 4)).astype(F32)
    return (rng.uniform(-1, 1, (n, 3)).astype(F32),
            rng.uniform(0.01, 0.05, (n, 3)).astype(F32),
            rot / np.linalg.norm(rot, axis=-1, keepdims=True),
            rng.uniform(0.1, 0.9, n).astype(F32), unit(rng, n))


def surface_rays(xyz, nrm, n_points: int, S: int):
    """S Fibonacci directions around each of the first n_points normals,
    from the points, as update_visibility casts them."""
    dirs, _ = jax_graphics.fibonacci_sphere_sampling(nrm[:n_points], S)
    rays_o = np.broadcast_to(xyz[:n_points, None], (n_points, S, 3))
    return rays_o.reshape(-1, 3).copy(), np.asarray(dirs).reshape(-1, 3)


@pytest.mark.parametrize("n", [1000, 1024, 3000])
def test_build_bvh_matches_jax(n):
    """The Morton order exactly (stable argsort of the same codes); cluster
    and super AABBs to 1e-6. The JAX BVH pads to whole quads of 4 clusters:
    its extra clusters are empty boxes."""
    xyz, scaling, rot, op, nrm = random_cloud(n, n)
    want = jax_rt.build_bvh(xyz, scaling, rot, op, nrm)
    got = ray_trace.build_bvh(t(xyz), t(scaling), t(rot), t(op), t(nrm))
    np.testing.assert_array_equal(got.order.numpy(),
                                  np.asarray(want.order)[:n])
    C = got.cluster_lo.shape[0]
    assert C == -(-n // ray_trace.CLUSTER_SIZE)
    for name in ("cluster_lo", "cluster_hi"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w[:C],
                                   atol=1e-6, rtol=0, err_msg=name)
    assert np.isinf(np.asarray(want.cluster_lo)[C:]).all()
    for name in ("super_lo", "super_hi"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    rec = got.records.numpy()
    order = got.order.numpy()
    np.testing.assert_array_equal(rec[:n, 0:3], xyz[order])
    np.testing.assert_array_equal(rec[:n, 12], op[order])
    np.testing.assert_array_equal(rec[n:], 0.0)
    # W = diag(1/s) Rᵀ whitens: Wᵀ W is the packed inverse covariance
    W = rec[:n, 3:12].reshape(-1, 3, 3)
    M = np.einsum("pki,pkj->pij", W, W)
    cov = np.asarray(jax_rt.inverse_covariance_packed(scaling, rot))[order]
    np.testing.assert_allclose(M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]],
                               cov, rtol=1e-5, atol=1e-2)


def test_inverse_covariance_matches_jax():
    _, scaling, rot, *_ = random_cloud(3, 200)
    np.testing.assert_allclose(
        ray_trace.inverse_covariance_packed(t(scaling), t(rot)).numpy(),
        jax_rt.inverse_covariance_packed(scaling, rot), rtol=1e-5, atol=1e-2)


def test_cpu_tracer_is_the_plain_version():
    xyz, scaling, rot, op, nrm = random_cloud(4, 300)
    bvh = ray_trace.build_bvh(t(xyz), t(scaling), t(rot), t(op), t(nrm))
    rays_o, rays_d = surface_rays(xyz, nrm, 40, 8)
    before = trace.counter("k3.launches")
    got = ray_trace.trace_visibility(bvh, t(rays_o), t(rays_d))
    assert trace.counter("k3.launches") == before
    assert torch.equal(got, ray_trace.trace_visibility_plain(
        bvh, t(rays_o), t(rays_d)))
    with pytest.raises(ValueError, match="expected all on CPU or all on CUDA"):
        ray_trace.trace_visibility(bvh, t(rays_o), t(rays_d).to("meta"))


@pytest.mark.parametrize("scene,seed", [("shell", 7), ("cloud", 0)])
def test_tracer_matches_jax_and_brute_force(scene, seed):
    """Visibility at atol 2e-3 (the JAX suite's), against the JAX tracer
    and the float64 brute force, on rays that leave surface points: the
    rule tests a subset of the JAX block rule's gaussians and a superset of
    the 3σ boxes', and a gaussian it skips has α < 0.0111·op."""
    if scene == "shell":
        xyz, scaling, rot, op, nrm = shell_scene(seed, 4096)
    else:
        xyz, scaling, rot, op, nrm = random_cloud(seed, 800)
    rays_o, rays_d = surface_rays(xyz, nrm, 256, 8)
    bvh = ray_trace.build_bvh(t(xyz), t(scaling), t(rot), t(op), t(nrm))
    got = ray_trace.trace_visibility(bvh, t(rays_o), t(rays_d))[:, 0].numpy()
    oracle = brute_force_visibility_vec(xyz, scaling, rot, op, nrm, rays_o,
                                        rays_d)
    want = jax_rt.trace_visibility_adaptive(
        jax_rt.build_bvh(xyz, scaling, rot, op, nrm), rays_o, rays_d,
        max_supers=8, max_clusters=24, ray_chunk=128)
    assert not np.asarray((want["visibility"][:, 0] > 0)
                          & (want["overflow"] > 0)).any()
    if scene == "shell":
        assert 0.02 < (oracle < 0.9).mean() < 0.98, "scene must occlude"
    np.testing.assert_allclose(got, oracle, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want["visibility"][:, 0]),
                               atol=2e-3, rtol=0)
    assert ((got == 0) | (got >= 0.9)).all()


def needle(pos, scale):
    return ray_trace.build_bvh(
        torch.tensor([pos]), torch.full((1, 3), scale),
        torch.tensor([[1.0, 0, 0, 0]]), torch.tensor([0.95]),
        torch.tensor([[0.0, 0.0, -1.0]]))


def trace_one(bvh, o, d) -> float:
    return float(ray_trace.trace_visibility(bvh, torch.tensor([o]),
                                            torch.tensor([d]))[0, 0])


def test_needles_far_from_the_origin():
    """tests/test_ray_trace.py::TestConditioning: a sigma=2e-6 needle missed
    by 0.1 (vis exactly 1), a 6σ miss of a sigma=1e-4 gaussian (> 0.999),
    and a dead-centre hit of it (0)."""
    assert trace_one(needle([2.0, 2.0, 2.5], 2e-6), [2.1, 2.0, 0.0],
                     [0.0, 0.0, 1.0]) == 1.0
    s = 1e-4
    bvh = needle([2.0, 2.0, 2.5], s)
    assert trace_one(bvh, [2.0 + 6 * s, 2.0, 0.0], [0.0, 0.0, 1.0]) > 0.999
    assert trace_one(bvh, [2.0, 2.0, 0.0], [0.0, 0.0, 1.0]) == 0.0


def test_single_gaussian_rules():
    """In front and facing the ray: blocked; behind the ray's start, or
    facing along the ray: visible (trace.cu:232-254)."""
    g = needle([0.0, 0.0, 1.0], 0.1)
    assert trace_one(g, [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]) == 0.0
    assert trace_one(g, [0.0, 0.0, 3.0], [0.0, 0.0, 1.0]) == 1.0
    back = ray_trace.build_bvh(
        torch.tensor([[0.0, 0.0, 1.0]]), torch.full((1, 3), 0.1),
        torch.tensor([[1.0, 0, 0, 0]]), torch.tensor([0.95]),
        torch.tensor([[0.0, 0.0, 1.0]]))
    assert trace_one(back, [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]) == 1.0


def coherent_rays(seed: int, n: int = 20_000):
    """A cloud and seeded rays: origins in its box, unit directions over the
    sphere (numpy float32)."""
    xyz, scaling, rot, op, nrm = random_cloud(seed, 600)
    rng = np.random.default_rng(seed + 100)
    return ((xyz, scaling, rot, op, nrm),
            rng.uniform(-1.1, 1.1, (n, 3)).astype(F32), unit(rng, n))


def test_coherent_key_matches_jax():
    """The direction bins and the 32-bit key (bin major, origin Morton code
    in the cloud's box minor) against the JAX package's _direction_bins and
    _coherent_order on the same rays. Both take the same float32 steps; at
    most 1e-3 of the rays may fall in another cell, where a quotient lies
    within rounding of a bin or cell edge (XLA may associate |x|+|y|+|z| or
    fold the box scaling differently). The JAX order sorts the port's key
    wherever the keys agree."""
    import jax.numpy as jnp
    from relightable3dgaussian_tpu.ops import knn as jax_knn

    cloud, o, d = coherent_rays(0)
    bvh_j = jax_rt.build_bvh(*cloud)
    bvh = ray_trace.build_bvh(*map(t, cloud))
    bins = ray_trace.direction_bins(t(d)).numpy()
    bins_j = np.asarray(jax_rt._direction_bins(jnp.asarray(d),
                                             res=ray_trace.DIR_RES))
    assert float((bins != bins_j).mean()) <= 1e-3
    key = ray_trace.coherent_key(bvh, t(o), t(d)).numpy()
    code_j = np.asarray(jax_knn.morton_codes(
        jnp.asarray(o), lo=bvh_j.cluster_lo.min(0),
        hi=bvh_j.cluster_hi.max(0))).astype(np.int64)
    key_j = (bins_j.astype(np.int64) << 24) | (code_j >> 6)
    differ = key != key_j
    assert float(differ.mean()) <= 1e-3
    assert key.min() >= 0 and key.max() < 1 << 32
    perm_j = np.asarray(jax_rt._coherent_order(bvh_j, jnp.asarray(o),
                                               jnp.asarray(d), 16))
    agree = ~differ[perm_j]
    assert (np.diff(key[perm_j][agree]) >= 0).all()


def test_coherent_order_sorts_its_key():
    """A permutation of the rays along which the key does not decrease."""
    cloud, o, d = coherent_rays(1)
    bvh = ray_trace.build_bvh(*map(t, cloud))
    perm = ray_trace.coherent_order(bvh, t(o), t(d))
    assert torch.equal(torch.sort(perm).values, torch.arange(o.shape[0]))
    key = ray_trace.coherent_key(bvh, t(o), t(d))[perm]
    assert bool((key[1:] >= key[:-1]).all())
    # rays of one direction bin lie together
    bins = ray_trace.direction_bins(t(d))[perm]
    assert int((bins[1:] != bins[:-1]).sum()) == len(torch.unique(bins)) - 1


def test_plain_tracer_in_coherent_order_is_the_same():
    """The plain tracer run on the rays in coherent order and scattered
    back gives the original order's T bit for bit: a ray's T is a function
    of that ray alone."""
    xyz, scaling, rot, op, nrm = shell_scene(7, 2048)
    rays_o, rays_d = surface_rays(xyz, nrm, 128, 8)
    bvh = ray_trace.build_bvh(t(xyz), t(scaling), t(rot), t(op), t(nrm))
    o = t(rays_o) + ray_trace.RAY_OFFSET * t(rays_d)
    d = t(rays_d)
    want = ray_trace.trace_transmittance_plain(bvh, o, d)
    perm = ray_trace.coherent_order(bvh, o, d)
    assert not torch.equal(perm, torch.arange(o.shape[0]))
    got = torch.empty_like(want)
    got[perm] = ray_trace.trace_transmittance_plain(bvh, o[perm], d[perm])
    assert torch.equal(got, want)
    assert 0.02 < float((want < ray_trace.T_MIN).float().mean()) < 0.98
