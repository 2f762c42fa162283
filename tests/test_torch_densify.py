"""The port's point-cloud creation, densification statistics, densify/prune
and opacity reset against the JAX package's, on the CPU.

The JAX package moves points between padded slots; the port resizes its
tensors and orders new rows after the survivors. So point sets are compared
as rows sorted by their values (parameters, then Adam moments), never row
by row. The split noise is JAX's own, re-drawn here from the same key splits
as `gaussians.py:401-402` and fed to the port's inner function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models import gaussians as jax_gaussians
from relightable3dgaussian_tpu.ops import knn as jax_knn
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu.train.optim import AdamState
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.ops import knn
from relightable3dgaussian_tpu_torch.train.checkpoint import load_train_state
from relightable3dgaussian_tpu_torch.train.config import OptimizationConfig
from test_torch_ops import t

CAPACITY, N_ACTIVE = 400, 150


@pytest.mark.parametrize("n", [50, 128, 3000])   # brute force, then window
def test_mean_sq_dist_to_3nn_matches_jax(n):
    pts = np.random.default_rng(n).uniform(-1, 1, (n, 3)).astype(np.float32)
    want = np.asarray(jax_knn.mean_sq_dist_to_3nn(jnp.asarray(pts)))
    got = knn.mean_sq_dist_to_3nn(t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(
        knn.morton_codes(t(pts)).numpy(),
        np.asarray(jax_knn.morton_codes(jnp.asarray(pts))).astype(np.int64))


def test_create_from_pcd_matches_jax():
    rng = np.random.default_rng(1)
    n = 200
    pts = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    cols = (rng.uniform(size=(n, 3)) / 255.0).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[:5] = 0.0                         # zero normals become +z
    params, aux = jax_gaussians.create_from_pcd(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(nrm), capacity=256)
    model = G.create_from_pcd(t(pts), t(cols), t(nrm))
    active = np.asarray(aux.active)
    assert model.num_points == int(active.sum()) == n
    for k, v in model.to_numpy().items():
        np.testing.assert_allclose(v, np.asarray(getattr(params, k))[active],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in G.STATS:
        assert float(getattr(model, k).abs().max()) == 0.0


def test_densification_stats_match_jax():
    rng = np.random.default_rng(2)
    P, W, H = 300, 64, 48
    m2d_g = rng.normal(size=(P, 2)).astype(np.float32) * 1e-3
    nrm_g = rng.normal(size=(P, 3)).astype(np.float32) * 1e-4
    weights = rng.uniform(size=(P,)).astype(np.float32)
    radii = rng.integers(0, 5, (P,)).astype(np.int32)
    aux = jax_gaussians.init_aux(P, P)
    model = G.create_from_pcd(t(rng.normal(size=(P, 3)).astype(np.float32)),
                              torch.full((P, 3), 0.5), torch.zeros((P, 3)))
    for _ in range(2):   # twice: sums accumulate, radii take the maximum
        aux = jax_gaussians.add_densification_stats(
            aux, m2d_g, nrm_g, weights, radii, (W, H))
        G.add_densification_stats(model, t(m2d_g), t(nrm_g), t(weights),
                                  t(radii), (W, H))
        radii = radii[::-1].copy()
    for k in G.STATS:
        np.testing.assert_allclose(getattr(model, k).numpy(),
                                   np.asarray(getattr(aux, k)), rtol=1e-6,
                                   err_msg=k)


def jax_train_state(seed: int):
    """A padded JAX state whose stats select clones, splits and prunes, with
    nonzero Adam moments; 250 of the 400 slots are free."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = CAPACITY
    active = np.zeros(c, bool)
    active[rng.permutation(c)[:N_ACTIVE]] = True
    op = rng.uniform(0.001, 0.9, (c, 1))
    # max scales log-uniform in [3e-4, 0.4]: below and above
    # percent_dense·extent (0.002) and 0.1·extent (0.2)
    scale = (np.exp(rng.uniform(np.log(3e-4), np.log(0.4), (c, 1)))
             * rng.uniform(0.6, 1.0, (c, 3)))
    params = jax_gaussians.GaussianParams(
        xyz=jnp.asarray(rng.uniform(-1, 1, (c, 3)).astype(f32)),
        normal=jnp.asarray(rng.normal(size=(c, 3)).astype(f32)),
        shs_dc=jnp.asarray(rng.normal(size=(c, 1, 3)).astype(f32)),
        shs_rest=jnp.asarray(rng.normal(size=(c, 15, 3)).astype(f32) * 0.1),
        scaling=jnp.asarray(np.log(scale).astype(f32)),
        rotation=jnp.asarray(rng.normal(size=(c, 4)).astype(f32)),
        opacity=jnp.asarray(np.log(op / (1 - op)).astype(f32)),
        base_color=jnp.zeros((0, 3)), roughness=jnp.zeros((0, 1)),
        incidents_dc=jnp.zeros((0, 1, 3)), incidents_rest=jnp.zeros((0, 15, 3)),
        visibility_dc=jnp.zeros((0, 1, 1)), visibility_rest=jnp.zeros((0, 15, 1)))
    denom = rng.integers(0, 4, c).astype(f32)
    aux = jax_gaussians.GaussianAux(
        active=jnp.asarray(active),
        max_radii2d=jnp.asarray(rng.uniform(0, 60, c).astype(f32)),
        xyz_grad_accum=jnp.asarray(
            (rng.uniform(0, 4e-4, c) * denom).astype(f32)),
        normal_grad_accum=jnp.asarray(
            (rng.uniform(0, 3e-9, c) * denom).astype(f32)),
        denom=jnp.asarray(denom),
        weights_accum=jnp.asarray(rng.uniform(-0.1, 1, c).clip(0).astype(f32)))

    def moments(scale):
        return jax.tree.map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(f32)) * scale,
            params)
    opt_state = AdamState(mu=moments(1e-3), nu=jax.tree.map(
        jnp.abs, moments(1e-6)), count=jnp.asarray(37, jnp.int32))
    return params, aux, opt_state, active


def port_state(tmp_path, params, aux, opt_state):
    """The same state carried into the port by the checkpoint format."""
    path = str(tmp_path / "state.npz")
    jax_checkpoint.save_checkpoint(path, 37, params=params, aux=aux,
                                   opt_state=opt_state)
    _, model, optimizer = load_train_state(path, OptimizationConfig(), 1.0,
                                           device="cpu")
    return model, optimizer


def sorted_rows(columns: list[np.ndarray]) -> np.ndarray:
    """Rows [N, D] of the flattened columns, sorted lexicographically."""
    rows = np.concatenate([c.reshape(c.shape[0], -1) for c in columns], 1)
    return rows[np.lexsort(rows.T[::-1])]


def port_rows(model, optimizer):
    by_name = {g["name"]: optimizer.state[g["params"][0]]
               for g in optimizer.param_groups}
    return sorted_rows(
        [getattr(model, k).detach().numpy() for k in G.FIELDS]
        + [by_name[k]["exp_avg"].numpy() for k in G.FIELDS]
        + [by_name[k]["exp_avg_sq"].numpy() for k in G.FIELDS])


def jax_rows(params, mu, nu, active):
    return sorted_rows(
        [np.asarray(getattr(tree, k))[active]
         for tree in (params, mu, nu) for k in G.FIELDS])


@pytest.mark.parametrize("max_screen_size", [float("inf"), 20.0])
def test_densify_and_prune_matches_jax(tmp_path, max_screen_size):
    """Clone, split (with JAX's noise) and prune. With a finite
    max_screen_size the world-size prune acts; the screen-size prune never
    does, although many points have max_radii2d > 20."""
    params, aux, opt_state, active = jax_train_state(3)
    key = jax.random.PRNGKey(4)
    kw = dict(grad_threshold=0.0002, grad_normal_threshold=2e-9,
              min_opacity=0.005, extent=2.0, max_screen_size=max_screen_size,
              percent_dense=0.001)
    new_params, new_aux, (mu, nu), want = jax_gaussians.densify_and_prune(
        params, aux, (opt_state.mu, opt_state.nu), key, **kw)
    assert int(want.n_dropped) == 0
    assert min(int(want.n_cloned), int(want.n_split), int(want.n_pruned)) > 5

    noise, sub_key = [], key
    for _ in range(2):
        sub_key, sub = jax.random.split(sub_key)
        noise.append(np.asarray(jax.random.normal(sub, (CAPACITY, 3)))[active])
    model, optimizer = port_state(tmp_path, params, aux, opt_state)
    got = G.densify_and_prune_with_noise(model, optimizer, t(np.stack(noise)),
                                         **kw)
    assert got == (int(want.n_cloned), int(want.n_split), int(want.n_pruned),
                   int(want.n_active))
    assert model.num_points == got.n_active
    new_active = np.asarray(new_aux.active)
    np.testing.assert_allclose(port_rows(model, optimizer),
                               jax_rows(new_params, mu, nu, new_active),
                               rtol=1e-5, atol=1e-6)
    for k in G.STATS:
        assert getattr(model, k).shape == (got.n_active,)
        assert float(getattr(model, k).abs().max()) == 0.0
    assert all(float(optimizer.state[g["params"][0]]["step"]) == 37
               for g in optimizer.param_groups)


def test_screen_size_prune_never_fires(tmp_path):
    """max_radii2d above any max_screen_size prunes nothing (the reference
    zeroes it just before reading it, gaussians.py:323-334)."""
    params, aux, opt_state, _ = jax_train_state(5)
    aux = aux.replace(max_radii2d=jnp.full((CAPACITY,), 1e6),
                      weights_accum=jnp.ones((CAPACITY,)),
                      denom=jnp.zeros((CAPACITY,)))
    params = params.replace(opacity=jnp.full((CAPACITY, 1), 2.0),
                            scaling=jnp.full((CAPACITY, 3), np.log(0.05)))
    model, optimizer = port_state(tmp_path, params, aux, opt_state)
    n = model.num_points
    got = G.densify_and_prune(model, optimizer, torch.Generator(),
                              grad_threshold=0.0002, grad_normal_threshold=2e-9,
                              min_opacity=0.005, extent=2.0,
                              max_screen_size=20.0, percent_dense=0.001)
    _, _, _, want = jax_gaussians.densify_and_prune(
        params, aux, (opt_state.mu, opt_state.nu), jax.random.PRNGKey(0),
        grad_threshold=0.0002, grad_normal_threshold=2e-9, min_opacity=0.005,
        extent=2.0, max_screen_size=20.0, percent_dense=0.001)
    assert got.n_pruned == int(want.n_pruned) == 0
    assert model.num_points == n


def test_optimizer_steps_the_new_tensors_after_densify(tmp_path):
    """After the surgery the optimizer holds the model's new parameters (a
    stale reference would train a ghost tensor): a step moves every field
    of the model, and the moments have the new row count."""
    params, aux, opt_state, _ = jax_train_state(6)
    model, optimizer = port_state(tmp_path, params, aux, opt_state)
    G.densify_and_prune(model, optimizer, torch.Generator().manual_seed(0),
                        grad_threshold=0.0002, grad_normal_threshold=2e-9,
                        min_opacity=0.005, extent=2.0,
                        max_screen_size=float("inf"), percent_dense=0.001)
    before = {k: getattr(model, k).detach().clone() for k in G.FIELDS}
    for g in optimizer.param_groups:
        assert g["params"][0] is getattr(model, g["name"])
        g["params"][0].grad = torch.ones_like(g["params"][0])
        g["lr"] = 0.01
    optimizer.step()
    for k in G.FIELDS:
        state = optimizer.state[getattr(model, k)]
        assert state["exp_avg"].shape == getattr(model, k).shape
        assert float((getattr(model, k).detach() - before[k]).abs().min()) > 0, k


def test_reset_opacity_matches_jax(tmp_path):
    params, aux, opt_state, active = jax_train_state(7)
    new_params, (mu, nu) = jax_gaussians.reset_opacity(
        params, (opt_state.mu, opt_state.nu))
    model, optimizer = port_state(tmp_path, params, aux, opt_state)
    G.reset_opacity(model, optimizer)
    np.testing.assert_allclose(model.opacity.detach().numpy(),
                               np.asarray(new_params.opacity)[active],
                               rtol=1e-5, atol=1e-5)
    assert float(model.get_opacity.detach().max()) <= 0.01 + 1e-6
    for g in optimizer.param_groups:
        state = optimizer.state[g["params"][0]]
        assert g["params"][0] is getattr(model, g["name"])
        assert float(state["step"]) == 37
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            np.testing.assert_array_equal(
                state[key].numpy(),
                np.asarray(getattr(tree, g["name"]))[active])
