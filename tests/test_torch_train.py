"""The port's stage-1 training against the JAX package's, on the CPU.

The training state crosses between the packages through the JAX named-npz
checkpoint format (train/checkpoint.py), so both start each comparison from
the same step. Tolerances are stated at each comparison.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models import gaussians as jax_gaussians
from relightable3dgaussian_tpu.models.render import ViewInputs as JaxViewInputs
from relightable3dgaussian_tpu.models.render import render as jax_render
from relightable3dgaussian_tpu.ops import composite as jax_composite
from relightable3dgaussian_tpu.ops import tiles as jax_tiles
from relightable3dgaussian_tpu.ops.composite_pallas import \
    composite_pallas_forward
from relightable3dgaussian_tpu.ops.composite_pallas_bwd import \
    composite_pallas_backward
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu.train import config as jax_config_mod
from relightable3dgaussian_tpu.train import optim as jax_optim
from relightable3dgaussian_tpu.train import stage1 as jax_stage1
from relightable3dgaussian_tpu.utils import lr_schedule as jax_lr
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.models import render as port_render
from relightable3dgaussian_tpu_torch.ops import composite, composite_cuda, tiles
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.train import checkpoint, optim, stage1
from relightable3dgaussian_tpu_torch.train.config import (STAGE1_NERF_SYNTHETIC,
                                                          OptimizationConfig)
from relightable3dgaussian_tpu_torch.utils import lr_schedule, trace
from relightable3dgaussian_tpu_torch.utils.sh import rgb_to_sh
import test_torch_cuda as card_tests
from test_torch_ops import (SIZE, cameras, composite_inputs, jax_config, t,
                            to_torch_prep)
from test_torch_rasterize import jax_model


def test_optimization_config_is_the_jax_one():
    ours = [(f.name, f.default) for f in
            dataclasses.fields(OptimizationConfig)]
    theirs = [(f.name, f.default) for f in
              dataclasses.fields(jax_config_mod.OptimizationConfig)]
    assert ours == theirs
    assert STAGE1_NERF_SYNTHETIC == jax_config_mod.STAGE1_NERF_SYNTHETIC


@pytest.mark.parametrize("step", [0, 1, 7, 500, 29_999, 30_000, 45_000])
@pytest.mark.parametrize("spatial_lr_scale", [1.0, 4.03])
def test_expon_lr_matches_jax(step, spatial_lr_scale):
    lr_init, lr_final = 1.6e-4 * spatial_lr_scale, 1.6e-6 * spatial_lr_scale
    # the JAX call as learning_rates makes it: a delay multiplier, no delay
    want = float(jax_lr.expon_lr(step, lr_init, lr_final, lr_delay_mult=0.01,
                                 max_steps=30_000))
    # float64 here; float32 there, whose exp of an argument near -9 is good
    # to ~1e-6 relative
    assert lr_schedule.expon_lr(step, lr_init, lr_final, 30_000) == (
        pytest.approx(want, rel=1e-5))
    assert lr_schedule.expon_lr(step, 0.0, 0.0, 30_000) == 0.0


# ---------------------------------------------------------------------------
# the plain backward compositor (the plain version of kernel K2)
# ---------------------------------------------------------------------------

def cotangents(cfg_j, P: int, A: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    g_img = rng.normal(size=(cfg_j.num_tiles, 256, A)).astype(np.float32)
    g_w = rng.normal(size=(P,)).astype(np.float32)
    return g_img, g_w


def assert_grads_close(got, want, tol):
    """Per field, max |got - want| <= tol · max |want| (sums over pixels
    taken in another order)."""
    for name, g, w in zip(("mean2d", "conic", "opacity", "attrs"), got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(np.asarray(g) / scale, w / scale,
                                   atol=tol, err_msg=name)


def test_composite_backward_matches_jax_vjp():
    prep, op, attrs, cfg_j, binning_j, binning_t = composite_inputs()
    g_img, g_w = cotangents(cfg_j, *attrs.shape)

    def f(mean2d, conic, opacity, at):
        out = jax_composite.composite(binning_j, mean2d, conic, opacity, at,
                                      cfg_j)
        return out.image, out.weights

    _, vjp = jax.vjp(f, prep.mean2d, prep.conic, jnp.asarray(op),
                     jnp.asarray(attrs))
    want = jax.jit(vjp)((jnp.asarray(g_img), jnp.asarray(g_w)))
    got = composite.composite_backward(
        binning_t, t(prep.mean2d), t(prep.conic), t(op), t(attrs), t(g_img),
        t(g_w), RasterConfig(SIZE, SIZE))
    assert_grads_close([g.numpy() for g in got], want, 1e-4)


def test_composite_backward_batches_and_weights_switch(monkeypatch):
    """Many small tile batches give the same sums; without compute_weights
    (or with g_weights None) the weights' cotangent is ignored."""
    prep, op, attrs, cfg_j, _, binning_t = composite_inputs()
    g_img, g_w = cotangents(cfg_j, *attrs.shape)
    args = (binning_t, t(prep.mean2d), t(prep.conic), t(op), t(attrs),
            t(g_img))
    cfg = RasterConfig(SIZE, SIZE)
    whole = composite.composite_backward(*args, t(g_w), cfg)
    no_w = composite.composite_backward(*args, None, cfg)
    monkeypatch.setattr(composite, "BATCH_ELEMENTS", 256 * 40)
    batched = composite.composite_backward(*args, t(g_w), cfg)
    assert_grads_close(batched, [w.numpy() for w in whole], 1e-5)
    ignored = composite.composite_backward(
        *args, t(g_w), RasterConfig(SIZE, SIZE, compute_weights=False))
    for a, b in zip(no_w, ignored):
        assert torch.equal(a, b)
    assert not torch.equal(no_w[1], whole[1])


def test_composite_backward_matches_the_pallas_backward():
    """Against the TPU kernels themselves in interpret mode: the forward's
    walk state drives the single-walk backward (_bwd_kernel_single), as
    tests/test_composite_pallas_bwd.py runs it."""
    prep, op, attrs, cfg_j, binning_j, binning_t = composite_inputs()
    g_img, g_w = cotangents(cfg_j, *attrs.shape, seed=9)
    *_, ft = composite_pallas_forward(binning_j, prep.mean2d, prep.conic,
                                      jnp.asarray(op), jnp.asarray(attrs),
                                      cfg_j, interpret=True)
    want = composite_pallas_backward(
        binning_j, prep.mean2d, prep.conic, jnp.asarray(op),
        jnp.asarray(attrs), jnp.asarray(g_img), jnp.asarray(g_w), cfg_j,
        interpret=True, walk_state=ft)
    got = composite.composite_backward(
        binning_t, t(prep.mean2d), t(prep.conic), t(op), t(attrs), t(g_img),
        t(g_w), RasterConfig(SIZE, SIZE))
    # the TPU kernel's chunked scans reorder its float32 sums: 2e-4, as
    # tests/test_composite_pallas_bwd.py holds it against jax.vjp
    assert_grads_close([g.numpy() for g in got], want, 2e-4)


@pytest.mark.parametrize("opaque", [False, True])
def test_composite_backward_matches_the_two_walk_pallas_backward(opaque):
    """The plain backward is the plain version of K5 as of K2: against K5's
    TPU kernel (_bwd_kernel, two front-to-back walks, suffix = total −
    prefix) in interpret mode, without walk state, as
    tests/test_composite_pallas_bwd.py runs it; on the scene of the tests
    above and on it with opacities in [0.5, 0.99], where the suffix cancels
    most. 2e-4 of each field's largest entry, as that suite holds the TPU
    kernel against jax.vjp: its chunked sums take another order."""
    prep, op, attrs, cfg_j, binning_j, binning_t = composite_inputs()
    if opaque:
        op = np.random.default_rng(11).uniform(0.5, 0.99, op.shape).astype(
            np.float32)
        binning_j = jax.jit(lambda: jax_tiles.bin_gaussians(prep, cfg_j,
                                                            op))()
        binning_t = tiles.bin_gaussians(to_torch_prep(prep),
                                        RasterConfig(SIZE, SIZE), t(op))
    g_img, g_w = cotangents(cfg_j, *attrs.shape, seed=13)
    want = composite_pallas_backward(
        binning_j, prep.mean2d, prep.conic, jnp.asarray(op),
        jnp.asarray(attrs), jnp.asarray(g_img), jnp.asarray(g_w), cfg_j,
        interpret=True, walk_state=None)
    got = composite.composite_backward(
        binning_t, t(prep.mean2d), t(prep.conic), t(op), t(attrs), t(g_img),
        t(g_w), RasterConfig(SIZE, SIZE))
    assert_grads_close([g.numpy() for g in got], want, 2e-4)


def test_two_walk_switch_takes_the_plain_backward_on_the_cpu(monkeypatch):
    """R3DG_BWD_TWO_WALK=1 picks K5 on CUDA tensors only: on CPU tensors the
    compositor's gradients are the plain backward's, bit for bit, and no
    kernel is launched."""
    prep, op, attrs, _, _, binning_t = composite_inputs()
    cfg = RasterConfig(SIZE, SIZE)
    grads = []
    for two_walk in ("0", "1"):
        monkeypatch.setenv("R3DG_BWD_TWO_WALK", two_walk)
        leaves = [t(x).requires_grad_() for x in
                  (prep.mean2d, prep.conic, op, attrs)]
        before = (trace.counter("k1.launches"), trace.counter("k2.launches"),
                  trace.counter("k5.launches"))
        out = composite_cuda.composite(binning_t, *leaves, cfg)
        (out.image.square().sum() + out.weights.sum()).backward()
        assert (trace.counter("k1.launches"), trace.counter("k2.launches"),
                trace.counter("k5.launches")) == before
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Adam, the checkpoint format, and one whole train step
# ---------------------------------------------------------------------------

OPT = dict(STAGE1_NERF_SYNTHETIC)
SPATIAL_LR_SCALE = 1.3


def jax_view():
    """The test_torch_rasterize model's view with a ground truth rendered
    from its points moved and recoloured (so the L1 residual is nowhere
    exactly 0, where sign() would flip on a last bit), and its mask."""
    params, aux, active = jax_model()
    cam_j, cam_t = cameras()
    z = np.zeros((3, SIZE, SIZE), np.float32)
    jitter = np.random.default_rng(9).normal(0, 0.03, params.xyz.shape)
    gt = jax_render(JaxViewInputs(cam_j, z, z[:1] + 1, z[:1], z),
                    params.replace(xyz=params.xyz + jitter.astype(np.float32),
                                   shs_dc=params.shs_dc[:, :, ::-1]),
                    aux.active, jax_config(3), jnp.zeros(3))
    image = np.asarray(gt["render"])
    mask = (np.asarray(gt["opacity"]) > 0.5).astype(np.float32)
    view_j = JaxViewInputs(cam_j, jnp.asarray(image), jnp.asarray(mask),
                           jnp.asarray(z[:1]), jnp.asarray(z))
    view_t = port_render.ViewInputs(cam_t, t(image), t(mask), t(z[:1]),
                                    t(z))
    return params, aux, active, view_j, view_t


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    """The JAX package's state after 3 train steps, saved as a checkpoint,
    and its 4th step (with the gradients of that step's loss)."""
    params, aux, active, view_j, view_t = jax_view()
    opt = jax_config_mod.OptimizationConfig(**OPT)
    kw = dict(cfg=jax_config(3), opt=opt, spatial_lr_scale=SPATIAL_LR_SCALE)
    opt_state = jax_optim.init_adam(params)
    for it in (1, 2, 3):
        params, aux, opt_state, _ = jax_stage1.train_step(
            params, aux, opt_state, view_j, jnp.asarray(it),
            jax.random.PRNGKey(it), **kw)
    path = str(tmp_path_factory.mktemp("state") / "chkpnt3.npz")
    jax_checkpoint.save_checkpoint(path, 3, params=params, aux=aux,
                                   opt_state=opt_state)

    def loss_fn(p, m2d):
        return jax_render(view_j, p, aux.active, kw["cfg"], jnp.zeros(3), opt,
                          is_training=True, iteration=jnp.asarray(4),
                          mean2d_offset=m2d)["loss"]

    grads, _ = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(
        params, jnp.zeros((params.capacity, 2)))
    step4 = jax_stage1.train_step(params, aux, opt_state, view_j,
                                  jnp.asarray(4), jax.random.PRNGKey(4), **kw)
    return path, active, view_t, (params, aux, opt_state), grads, step4


@pytest.fixture(scope="module")
def port_step(jax_state):
    """The port's 4th step from the JAX state the checkpoint carries."""
    path, _, view_t, *_ = jax_state
    it, model, optimizer = checkpoint.load_train_state(
        path, OptimizationConfig(**OPT), SPATIAL_LR_SCALE, device="cpu")
    assert it == 3
    metrics = stage1.train_step(
        model, optimizer, view_t, 4, cfg=RasterConfig(SIZE, SIZE),
        opt=OptimizationConfig(**OPT), spatial_lr_scale=SPATIAL_LR_SCALE)
    return model, optimizer, metrics


def test_train_step_loss_and_terms_match_jax(jax_state, port_step):
    *_, (_, _, _, want) = jax_state
    _, _, got = port_step
    # the port never drops a pair, so it has no overflow counters
    assert int(want["overflow_pairs"]) == int(want["overflow_chunks"]) == 0
    terms = set(want) - {"n_active", "overflow_pairs", "overflow_chunks"}
    assert terms <= set(got)
    for k in terms:
        # float32 sums of the loss terms in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    assert got["n_active"] == int(want["n_active"])


def test_train_step_gradients_match_jax(jax_state, port_step):
    _, active, _, _, grads, _ = jax_state
    model, _, _ = port_step
    for k in G.FIELDS:
        w = np.asarray(getattr(grads, k))[active]
        g = getattr(model, k).grad.numpy()
        scale = np.abs(w).max()
        assert scale > 0, k
        # relative to the largest entry, as test_torch_rasterize does
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-3,
                                   err_msg=k)


def test_train_step_adam_update_matches_jax(jax_state, port_step):
    """The updated parameters agree to 1% of each field's learning rate:
    Adam divides by sqrt(nu), so the gradients' relative noise shows up as
    a fraction of the step."""
    _, active, _, _, _, (new_params, _, new_opt, _) = jax_state
    model, optimizer, _ = port_step
    lrs = jax_optim.learning_rates(
        jax_config_mod.OptimizationConfig(**OPT), 4, SPATIAL_LR_SCALE)
    for g in optimizer.param_groups:
        k = g["name"]
        assert g["lr"] == pytest.approx(float(lrs[k]), rel=1e-6)
        got = getattr(model, k).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(new_params, k))[
            active], atol=0.01 * float(lrs[k]), rtol=0, err_msg=k)
        assert float(optimizer.state[g["params"][0]]["step"]) == int(
            new_opt.count) == 4


def test_train_step_densification_stats_match_jax(jax_state, port_step):
    _, active, _, _, _, (_, new_aux, _, _) = jax_state
    model, _, _ = port_step
    for k in G.STATS:
        w = np.asarray(getattr(new_aux, k))[active]
        g = getattr(model, k).numpy()
        if k in ("denom", "max_radii2d"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            # norms of gradients and sums of weights: 1e-4 of the largest
            np.testing.assert_allclose(g / np.abs(w).max(),
                                       w / np.abs(w).max(), atol=1e-4,
                                       err_msg=k)


def test_adam_step_matches_jax(jax_state):
    """torch.optim.Adam with the per-field groups against adam_step on the
    same state and the same gradients: the update agrees to 1e-4 of the
    learning rate (torch's lerp and sqrt(v)/sqrt(bc2) round differently
    from JAX's sqrt(v/bc2)), the moments to 1e-5 relative."""
    path, active, _, (params, _, opt_state), grads, _ = jax_state
    opt = OptimizationConfig(**OPT)
    _, model, optimizer = checkpoint.load_train_state(path, opt,
                                                      SPATIAL_LR_SCALE,
                                                      device="cpu")
    lrs = jax_optim.learning_rates(jax_config_mod.OptimizationConfig(**OPT),
                                   50, SPATIAL_LR_SCALE)
    want, want_state = jax_optim.adam_step(params, grads, opt_state, lrs)
    for k in G.FIELDS:
        getattr(model, k).grad = t(np.asarray(getattr(grads, k))[active])
    optim.set_learning_rates(optimizer, optim.learning_rates(
        opt, 50, SPATIAL_LR_SCALE))
    optimizer.step()
    for g in optimizer.param_groups:
        k = g["name"]
        state = optimizer.state[g["params"][0]]
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(getattr(want, k))[active],
                                   rtol=1e-6, atol=1e-4 * float(lrs[k]),
                                   err_msg=k)
        np.testing.assert_allclose(state["exp_avg"].numpy(), np.asarray(
            getattr(want_state.mu, k))[active], rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(
            getattr(want_state.nu, k))[active], rtol=1e-5, atol=1e-18)


def test_checkpoint_round_trip_jax_port_jax(jax_state, tmp_path):
    """A JAX train state (params, aux, opt_state, with inactive slots) loads
    in the port and the port's file restores in JAX's load_checkpoint."""
    path, active, _, (params, aux, opt_state), _, _ = jax_state
    it, model, optimizer = checkpoint.load_train_state(
        path, OptimizationConfig(**OPT), SPATIAL_LR_SCALE, device="cpu")
    out = str(tmp_path / "chkpnt3_port.npz")
    checkpoint.save_checkpoint(out, it, model, optimizer)
    n = model.num_points
    template, tmpl_aux = jax_gaussians.create_from_pcd(
        jnp.zeros((1, 3)), jnp.full((1, 3), 0.5), jnp.asarray([[0.0, 0, 1]]),
        capacity=n)
    it2, restored = jax_checkpoint.load_checkpoint(
        out, params=template, aux=tmpl_aux,
        opt_state=jax_optim.init_adam(template))
    assert it2 == 3
    assert bool(np.asarray(restored["aux"].active).all())
    for k in G.FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(restored["params"], k)),
            np.asarray(getattr(params, k))[active], err_msg=k)
        for tree, mine in ((opt_state.mu, restored["opt_state"].mu),
                           (opt_state.nu, restored["opt_state"].nu)):
            np.testing.assert_array_equal(
                np.asarray(getattr(mine, k)),
                np.asarray(getattr(tree, k))[active], err_msg=k)
    for k in G.STATS:
        np.testing.assert_array_equal(np.asarray(getattr(restored["aux"], k)),
                                      np.asarray(getattr(aux, k))[active])
    assert int(restored["opt_state"].count) == int(opt_state.count) == 3


# ---------------------------------------------------------------------------
# the schedule: a port of examples/train_toy.py
# ---------------------------------------------------------------------------

def toy_views(size: int):
    """8 orbit views at radius 4 of 80 coloured gaussians, as
    examples/train_toy.py renders its ground truth, and the points."""
    cams = []
    for i in range(8):
        ang = 2 * np.pi * i / 8
        fwd = -np.array([np.sin(ang), 0.0, np.cos(ang)])
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        cams.append(make_camera_params(R, -R.T @ (-fwd * 4.0), size, size,
                                       fovx=0.8, fovy=0.8, device="cpu"))
    rng = np.random.default_rng(0)
    n = 80
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    up = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    gt = G.GaussianModel(
        xyz=t(pts), normal=up, shs_dc=rgb_to_sh(t(cols))[:, None],
        shs_rest=torch.zeros((n, 15, 3)),
        scaling=torch.full((n, 3), float(np.log(0.1))),
        rotation=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
        opacity=torch.full((n, 1), 2.0))
    z = torch.zeros((3, size, size))
    views = []
    with torch.no_grad():
        for cam in cams:
            res = port_render.render(
                port_render.ViewInputs(cam, z, z[:1] + 1, z[:1], z), gt,
                RasterConfig(size, size, sh_degree=0), torch.zeros(3))
            views.append(port_render.ViewInputs(
                cam, res["render"], (res["opacity"] > 0.5).float(), z[:1], z))
    return views, pts, rng


def test_train_toy_psnr_rises():
    """examples/train_toy.py on the port at 64x64: from a noisy copy of the
    points, 200 steps with densification raise the PSNR by more than 2 dB."""
    iters, size = 200, 64
    views, pts, rng = toy_views(size)
    noisy = t(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.06)
    n = pts.shape[0]
    model = G.create_from_pcd(noisy, torch.full((n, 3), 0.5),
                              torch.tensor([[0.0, 0, 1]]).repeat(n, 1))
    opt = OptimizationConfig(
        iterations=iters, densify_from_iter=60, densify_until_iter=iters - 20,
        densification_interval=60, opacity_reset_interval=10 ** 9,
        position_lr_max_steps=iters, **STAGE1_NERF_SYNTHETIC)
    optimizer = optim.make_optimizer(model, opt, 1.0)
    psnr, densified = {}, []

    def callback(it, metrics):
        psnr[it] = float(metrics["psnr"])
        if "densify" in metrics:
            densified.append(metrics["densify"])

    stage1.run_training_schedule(
        model, optimizer, views, cfg=RasterConfig(size, size, sh_degree=0),
        opt=opt, spatial_lr_scale=1.0, extent=2.0,
        generator=torch.Generator().manual_seed(5), callback=callback)
    assert len(psnr) == iters and densified
    assert model.num_points == densified[-1].n_active > n
    first = np.mean([psnr[i] for i in range(1, 9)])      # one pass of views
    last = np.mean([psnr[i] for i in range(iters - 7, iters + 1)])
    assert last > first + 2.0, (first, last)


def test_train_step_gradients_under_a_last_bit_input_change(tmp_path):
    """The reading that sets test_torch_cuda.py's GRAD_TOL: on the CPU, a
    change of every parameter by 2e-7 of itself (a few float32 ulps, the
    size of the card's other rounding) moves the train step's gradients by
    a nonzero amount no larger than half of GRAD_TOL of their largest
    entry."""
    path, gt_view = card_tests.train_state(tmp_path)
    _, base = card_tests.step_from_state(path, gt_view, "cpu")
    spread = {}
    for rel_change in (2e-7, -2e-7):
        _, moved = card_tests.step_from_state(path, gt_view, "cpu", rel_change)
        for k in card_tests.GRAD_FIELDS:
            spread[k] = max(spread.get(k, 0.0), card_tests.max_rel_err(
                getattr(moved, k).grad, getattr(base, k).grad))
    print("CPU gradient spread under a 2e-7 relative change", spread)
    assert 0.0 < max(spread.values()) <= 0.5 * card_tests.GRAD_TOL, spread


def test_schedule_densifies_and_resets_like_jax(monkeypatch):
    """The same camera order from `seed`, densify and opacity-reset
    iterations as the JAX host loop."""
    opt = OptimizationConfig(iterations=40, densify_from_iter=5,
                             densify_until_iter=30, densification_interval=10,
                             opacity_reset_interval=15)
    calls, views_seen = [], []
    monkeypatch.setattr(stage1, "train_step",
                        lambda m, o, v, it, **kw: views_seen.append(v) or {})
    monkeypatch.setattr(stage1, "densify_step",
                        lambda *a, **kw: calls.append(("densify", a[3], a[4])))
    monkeypatch.setattr(stage1, "reset_opacity_step",
                        lambda *a: calls.append(("reset",)))
    stage1.run_training_schedule(
        None, None, list(range(6)), cfg=RasterConfig(8, 8), opt=opt,
        spatial_lr_scale=1.0, extent=1.0, generator=None, seed=3)
    rng, stack, order = np.random.default_rng(3), [], []
    for _ in range(40):
        if not stack:
            stack = list(rng.permutation(6))
        order.append(stack.pop())
    assert views_seen == order
    inf = float("inf")
    assert calls == [("densify", 2e-9, inf), ("reset",), ("densify", 2e-9, 20.0)]
