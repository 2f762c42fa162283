"""The port's shading against the JAX package's, on the CPU: the rendering
equation (the eval path and the plain version of kernel K4) against
`ops/shading.py::rendering_equation` and against the TPU kernels
themselves (`ops/shading_pallas.py::rendering_equation_train`, run in
Pallas interpret mode as tests/test_shading_fused.py runs it), outputs and
gradients, from the same seeded numpy inputs; and at the clips of K4's
float32 chain that chip_smoke.py's k4-branches phase forces."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.models import lights as jax_lights
from relightable3dgaussian_tpu.ops import shading as jax_shading
from relightable3dgaussian_tpu.ops import shading_pallas as jax_shading_pallas
from relightable3dgaussian_tpu.utils import graphics as jax_graphics
from relightable3dgaussian_tpu_torch.models import lights
from relightable3dgaussian_tpu_torch.ops import shading, shading_cuda
from relightable3dgaussian_tpu_torch.utils import trace
from test_torch_ops import t

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (k4_branch_case: the forced inputs)

NAMES = ("pbr", "diffuse", "specular")
GRAD_NAMES = ("base_color", "roughness", "viewdirs", "shs", "env")


def make_inputs(P: int, S: int, seed: int, rough=(0.05, 0.95)) -> dict:
    """Seeded numpy inputs on the pattern of test_shading_fused.make_inputs:
    unit normals and view directions, Fibonacci samples, visibility in
    [0, 1) (all zero on the first 5 points), roughness uniform in `rough`
    with the activation's extremes 0.09 and 0.99 on two points, local SH
    0.3·N(0, 1), an 8x16 raw env map, cotangents N(0, 1)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def unit(n):
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(f32)

    normals, viewdirs = unit(P), unit(P)
    dirs, areas = jax_graphics.fibonacci_sphere_sampling(normals, S)
    vis = rng.uniform(size=(P, S, 1)).astype(f32)
    vis[:5] = 0.0
    roughness = rng.uniform(*rough, (P, 1)).astype(f32)
    roughness[-2:, 0] = (0.09, 0.99)
    return {"base_color": rng.uniform(size=(P, 3)).astype(f32),
            "roughness": roughness, "normals": normals, "viewdirs": viewdirs,
            "shs": (0.3 * rng.normal(size=(P, 16, 3))).astype(f32),
            "env": (2.0 * rng.uniform(size=(8, 16, 3))).astype(f32),
            "vis": vis, "dirs": np.asarray(dirs), "areas": np.asarray(areas),
            "cot": rng.normal(size=(3, P, 3)).astype(f32)}


def jax_train_shading(x: dict, fn):
    """Outputs and gradients (bc, roughness, viewdirs, shs, raw env) of
    Σ cot · (pbr, diffuse, specular) through `fn` with the env query in
    front, normals stop-gradient, as the JAX train step shades."""
    def f(bc, rough, vdir, shs, env):
        gl = jax_lights.direct_light(jax_lights.DirectLightParams(env=env),
                                     x["dirs"])
        outs = fn(bc, rough, jax.lax.stop_gradient(x["normals"]), vdir, shs,
                  gl, x["vis"], x["dirs"], x["areas"])
        return sum((c * o).sum() for c, o in zip(x["cot"], outs)), outs

    args = [jnp.asarray(x[k]) for k in ("base_color", "roughness", "viewdirs",
                                         "shs", "env")]
    (_, outs), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(5)), has_aux=True))(*args)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def port_train_shading(x: dict):
    leaves = {k: t(x[k]).requires_grad_() for k in
              ("base_color", "roughness", "viewdirs", "shs")}
    env = lights.DirectLightMap.from_raw(t(x["env"]))
    gl = env.direct_light(t(x["dirs"]))
    outs = shading_cuda.rendering_equation_train(
        leaves["base_color"], leaves["roughness"], t(x["normals"]),
        leaves["viewdirs"], leaves["shs"], gl, t(x["vis"]), t(x["dirs"]),
        t(x["areas"]))
    sum((t(c) * o).sum() for c, o in zip(x["cot"], outs)).backward()
    grads = [leaves[k].grad.numpy() for k in
             ("base_color", "roughness", "viewdirs", "shs")] + [env.env.grad.numpy()]
    return [o.detach().numpy() for o in outs], grads


def assert_grads_close(got, want):
    """rtol 5e-5 and atol 5e-6 of each gradient's largest entry, the JAX
    suite's tolerance for the fused kernel (test_shading_fused.py)."""
    for name, g, w in zip(GRAD_NAMES, got, want):
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-6 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("P,S,seed", [(37, 8, 0), (260, 16, 1), (64, 4, 2)])
def test_rendering_equation_matches_jax(P, S, seed):
    """The eval shading, extras included: rtol 1e-4, atol 1e-5."""
    x = make_inputs(P, S, seed)
    env_j = jax_lights.DirectLightParams(env=jnp.asarray(x["env"]))
    env_t = lights.DirectLightMap.from_raw(t(x["env"]))
    args = ("base_color", "roughness", "normals", "viewdirs", "shs")
    want, want_ex = jax_shading.rendering_equation(
        *(x[k] for k in args), lambda d: jax_lights.direct_light(env_j, d),
        x["vis"], x["dirs"], x["areas"])
    with torch.no_grad():
        got, got_ex = shading.rendering_equation(
            *(t(x[k]) for k in args), env_t.direct_light, t(x["vis"]),
            t(x["dirs"]), t(x["areas"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    for k, v in got_ex.items():
        np.testing.assert_allclose(v.numpy(), want_ex[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert float(got.abs().max()) > 0.1


def assert_outputs_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("P,S,seed", [(37, 8, 0), (260, 16, 1), (64, 4, 2)])
def test_train_shading_matches_jax(P, S, seed):
    """The plain version of K4 (the CPU path of rendering_equation_train)
    against the JAX rendering equation with the same precomputed light:
    forward rtol 1e-4, atol 1e-5; gradients (env map included) rtol 5e-5,
    atol 5e-6 of their largest entry."""
    x = make_inputs(P, S, seed)
    before = (trace.counter("k4.launches"), trace.counter("k4.bwd_launches"))
    got, got_g = port_train_shading(x)
    assert (trace.counter("k4.launches"), trace.counter("k4.bwd_launches")) == before
    want, want_g = jax_train_shading(
        x, jax_shading_pallas.rendering_equation_train_reference)
    assert_outputs_close(got, want)
    assert_grads_close(got_g, want_g)


def test_train_shading_matches_the_pallas_kernels():
    """Against the TPU kernels K4-fwd and K4-bwd themselves, in interpret
    mode, with the same tolerances."""
    x = make_inputs(37, 8, 5)
    got, got_g = port_train_shading(x)
    want, want_g = jax_train_shading(
        x, jax_shading_pallas.rendering_equation_train)
    assert_outputs_close(got, want)
    assert_grads_close(got_g, want_g)


@pytest.mark.parametrize("rough", [0.09, 0.99])
def test_train_shading_rough_extremes_and_dark_points(rough):
    """Roughness at the activation's bounds on every point and visibility
    zero everywhere, as test_shading_fused.py's extreme case: forward rtol
    1e-4, atol 1e-5, and finite gradients."""
    x = make_inputs(29, 8, 7)
    x["roughness"][:] = rough
    x["vis"][:] = 0.0
    got, got_g = port_train_shading(x)
    want, _ = jax_train_shading(
        x, jax_shading_pallas.rendering_equation_train_reference)
    assert_outputs_close(got, want)
    for name, g in zip(GRAD_NAMES, got_g):
        assert np.isfinite(g).all(), name
    assert np.abs(got_g[-1]).max() == 0.0      # the env is never seen


def test_train_shading_from_zero_local_light():
    """The stage-2 start: the local-light SH are all zero, so max(SH, 0)
    sits at its tie on every sample. The jnp chain (the JAX package's
    default train shading) passes half the gradient there, and so does the
    port: the SH gradient is not zero, and the SH can train. Same
    tolerances as above."""
    x = make_inputs(37, 8, 6)
    x["shs"][:] = 0.0
    got, got_g = port_train_shading(x)
    want, want_g = jax_train_shading(
        x, jax_shading_pallas.rendering_equation_train_reference)
    assert_outputs_close(got, want)
    assert_grads_close(got_g, want_g)
    assert np.abs(got_g[3]).max() > 0.01


def test_train_wrapper_rejects_mixed_devices():
    x = make_inputs(8, 4, 4)
    args = [t(x[k]) for k in ("base_color", "roughness", "normals",
                              "viewdirs", "shs")]
    with pytest.raises(ValueError, match="expected all on CPU or all on CUDA"):
        shading_cuda.rendering_equation_train(
            *args, t(x["dirs"]).to("meta"), t(x["vis"]), t(x["dirs"]),
            t(x["areas"]))


def forced_inputs(case: str, P: int, S: int, seed: int,
                  dtype=np.float32) -> dict:
    """make_inputs with every point forced onto `case`'s clip as
    chip_smoke.k4_branch_case forces it (chip_smoke.k4_branch_geometry, in
    numpy): its normal, view direction and roughness, its samples made anew
    about the normal by the JAX package's Fibonacci sampling, its last
    sample (but for nov-clip) the forced one."""
    x = make_inputs(P, S, seed)
    g = cs.k4_branch_geometry(case, cs.k4_branch_deltas(P), seed)
    x.update(normals=g["normals"], viewdirs=g["viewdirs"],
             roughness=g["roughness"][:, None])
    dirs, _ = jax_graphics.fibonacci_sphere_sampling(g["normals"], S)
    x["dirs"] = np.array(dirs)
    if g.get("dirs") is not None:
        x["dirs"][:, -1] = g["dirs"]
    return {k: v.astype(dtype) for k, v in x.items()}


@pytest.mark.parametrize("case", cs.K4_BRANCH_CASES)
def test_forced_clip_inputs_put_the_operand_at_its_bound(case):
    """The k4-branches phase's inputs (its 2000 points, seeds and samples):
    the case's operand of a K4 clip in the plain version in float64
    (ops/shading.py::ggx_terms) lies at 1e-6 (1 + d') with d' on delta's
    side and within it (0.8 delta <= d' <= delta), both signs at every
    |delta| of the grid 1e-8 to 1e-5, and so on the [P, S] tensors
    k4_branch_case hands K4; no point is viewed at grazing; q-clip's
    roughness lies in [0.09, 0.2]; noh-clip and voh-clip view the point
    from behind its normal, and the forced sample lights it (n.d > 0)."""
    i = cs.K4_BRANCH_CASES.index(case)
    x, delta, reached = cs.k4_branch_case(case, cs.K4_BRANCH_P, 64,
                                          cs.SEED + 500 + i, "cpu")
    ratio = reached / delta
    assert ((ratio >= 0.8) & (ratio <= 1.0)).all(), (ratio.min(), ratio.max())
    for d in cs.K4_BRANCH_DELTAS:
        assert {1.0, -1.0} <= set(np.sign(delta[np.isclose(abs(delta), d)]))
    terms = shading.ggx_terms(*(x[k].double() for k in (2, 3, 7, 1)))
    op = cs.K4_BRANCHES[case]
    forced = terms[op][:, -1, 0] if op != "NoV" else terms[op][:, 0]
    port_ratio = (forced.numpy() / cs.K4_CLIP - 1) / delta
    assert ((port_ratio > 0.75) & (port_ratio <= 1.0)).all(), (
        port_ratio.min(), port_ratio.max())
    side32, side64 = shading_cuda.view_side(x[2], x[3])
    assert bool(((side32 == side64) & (side64 != 0)).all())
    n = x[2].double()
    if case == "q-clip":
        assert 0.09 <= float(x[1].min()) and float(x[1].max()) <= 0.2
    if case in ("noh-clip", "voh-clip"):
        assert bool(((n * x[3]).sum(-1) < 0).all())
        assert bool(((n * x[7][:, -1]).sum(-1) > 0).all())


@pytest.mark.parametrize("case", cs.K4_BRANCH_CASES)
def test_train_shading_matches_jax_at_the_forced_clips(case):
    """On the forced inputs (128 points, 16 samples) the plain version
    against the JAX jnp chain (the JAX package's rendering equation with the
    same precomputed light), outputs and gradients, env map included, at
    this file's tolerances. Both in float64, where the operand's place on
    either side of 1e-6 is what the case sets: in float32 each rounds it
    its own way and decides the clip by its own rounding (the jump is then
    ~0.7 of the roughness gradient's largest entry at q-clip)."""
    x = forced_inputs(case, 128, 16, 3, np.float64)
    got, got_g = port_train_shading(x)
    with jax.enable_x64(True):
        want, want_g = jax_train_shading(
            x, jax_shading_pallas.rendering_equation_train_reference)
    assert got_g[1].dtype == want_g[1].dtype == np.float64
    assert_outputs_close(got, want)
    assert_grads_close(got_g, want_g)


def test_upper_clip_tie_passes_no_gradient_that_matters():
    """V = N = (0, 0, 1): Fibonacci sample 0 is N exactly, so NoV, NoL, NoH
    and VoH sit at the clip's upper bound 1 exactly. jnp.clip passes half
    the gradient at that tie, torch.clamp all of it (and K4, which masks
    only the lower bound, all): the port's float32 gradients stay within
    1e-5 of the largest entry of JAX's, because at the top of a dot product
    of unit vectors the gradient projected onto the sphere is 0."""
    x = make_inputs(37, 8, 9)
    x["normals"][:] = x["viewdirs"][:] = (0.0, 0.0, 1.0)
    dirs, _ = jax_graphics.fibonacci_sphere_sampling(x["normals"], 8)
    x["dirs"] = np.array(dirs)
    terms = shading.ggx_terms(t(x["normals"]), t(x["viewdirs"]),
                              t(x["dirs"]), t(x["roughness"]))
    for name in ("NoV", "NoH", "VoH"):
        assert bool((terms[name].reshape(37, -1)[:, 0] == 1.0).all()), name
    got, got_g = port_train_shading(x)
    want, want_g = jax_train_shading(
        x, jax_shading_pallas.rendering_equation_train_reference)
    assert_outputs_close(got, want)
    for name, g, w in zip(GRAD_NAMES, got_g, want_g):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name


def grazing_inputs(P: int, S: int, n_grazing: int, eps: float, seed: int):
    """chip_smoke.shading_case's inputs with the view direction of the
    first `n_grazing` points set at V·N = +-eps (alternating signs), as
    examples/k4_grazing.py sets them."""
    x = list(cs.shading_case(P, S, 100 + seed, "cpu"))
    n, v = x[2][:n_grazing], x[3].clone()
    g = torch.Generator().manual_seed(seed)
    tang = torch.linalg.cross(n, torch.randn((n_grazing, 3), generator=g))
    tang = tang / tang.norm(dim=-1, keepdim=True)
    sign = 1.0 - 2.0 * (torch.arange(n_grazing) % 2)
    w = tang + (sign * eps)[:, None] * n
    v[:n_grazing] = w / w.norm(dim=-1, keepdim=True)
    x[3] = v.contiguous()
    return tuple(x)


@pytest.mark.parametrize("eps", [0.0, 1e-9])
def test_k4_takes_sign_and_nov_from_float64_at_grazing_views(eps):
    """Views within eps of grazing on 200 of 2000 points: float32 alone
    turns some normals the other way or zeroes them (view_side's first
    sign), K4's sign (its second) is numpy's float64 sign at every point,
    and K4's float32 NoV (k4_branch_operands, N turned by that sign) lies
    within 1e-6 of the float64 NoV = |V·N| everywhere, so K4's NoV clip
    decision (k4_clip_passes) is float64's."""
    x = grazing_inputs(2000, 16, 200, eps, 0)
    side32, k4_sign = shading_cuda.view_side(x[2], x[3])
    n, v = x[2].numpy().astype(np.float64), x[3].numpy().astype(np.float64)
    dot = ((v / np.linalg.norm(v, axis=-1, keepdims=True))
           * (n / np.linalg.norm(n, axis=-1, keepdims=True))).sum(-1)
    np.testing.assert_array_equal(k4_sign.numpy(), np.sign(dot))
    flipped = ((side32 == 0) | (side32 != k4_sign)).numpy()
    assert flipped.any() and not flipped[200:].any()
    ops = shading_cuda.k4_branch_operands(x[2], x[3], x[1], x[7])
    np.testing.assert_allclose(ops["NoV"].numpy(), np.abs(dot), rtol=0,
                               atol=1e-6)
    passes = shading_cuda.k4_clip_passes(x[2], x[3], x[1], x[7])
    np.testing.assert_array_equal(passes["NoV"].numpy(), np.abs(dot) >= 1e-6)


@pytest.mark.parametrize("case", cs.K4_BRANCH_CASES)
def test_k4_rule_decides_the_forced_clips_as_float64(case):
    """The k4-branches phase's inputs (2000 points, every |delta| of the
    grid in both signs): K4's decisions by its rule (k4_clip_passes: the
    sign and NoV's clip from float64, q's from float64 and VoH's past it
    inside their bands) equal check_k4's reference's (the plain version in
    float64, ops/shading.py::ggx_terms, VoH's clip exact where K4 takes it
    past float64) for the sign, NoV, q and VoH at every delta, where K4's
    float32 chain alone (k4_branch_operands) decides the forced clip
    otherwise on some points. At q-clip the forced samples lie inside the
    band at every delta up to 5e-4 and beyond it at 2e-3."""
    i = cs.K4_BRANCH_CASES.index(case)
    x, delta, _ = cs.k4_branch_case(case, cs.K4_BRANCH_P, 64,
                                    cs.SEED + 500 + i, "cpu")
    apart = cs.clip_decisions_apart(x)
    assert {k: apart["k4"][k] for k in ("sign", "NoV", "q", "VoH")} == {
        "sign": 0, "NoV": 0, "q": 0, "VoH": 0}, apart
    op = cs.K4_BRANCHES[case]
    assert apart["k4_float32"][op] > 0, apart
    if case == "q-clip":
        double = shading_cuda.k4_clip_passes(
            x[2], x[3], x[1], x[7])["double"][:, -1].numpy()
        beyond = np.isclose(abs(delta), 2e-3)
        assert beyond.any() and not double[beyond].any()
        assert double[abs(delta) <= 5e-4].all()


@pytest.mark.parametrize("delta", cs.K4_BRANCH_DELTAS)
def test_k4_voh_decision_is_the_exact_one(delta):
    """voh-clip's forced samples of the k4-branches phase (the last of each
    of its 2000 points, VoH at 1e-6 (1 + delta') in float64): K4's VoH
    decision by its rule (k4_clip_passes, the fix-up's double-double,
    voh_passes_dd) is the exact one on the float32 inputs (60-digit
    decimals, chip_smoke.exact_voh) at both signs of this |delta|, and
    every forced sample goes to K4's fix-up. Below |delta| 1e-5 float64's
    own decision is not the exact one on some of them: there the
    cancellation 1 + V.d ~ 3e-10 leaves float64 ~8e-6 of VoH."""
    from decimal import Decimal
    i = cs.K4_BRANCH_CASES.index("voh-clip")
    x, deltas, _ = cs.k4_branch_case("voh-clip", cs.K4_BRANCH_P, 64,
                                     cs.SEED + 500 + i, "cpu")
    rows = np.isclose(np.abs(deltas), delta)
    assert {1.0, -1.0} <= set(np.sign(deltas[rows]))
    passes = shading_cuda.k4_clip_passes(x[2], x[3], x[1], x[7])
    assert passes["double"][:, -1].numpy()[rows].all()
    v, d = x[3].numpy(), x[7][:, -1].numpy()
    exact = np.array([cs.exact_voh(v[p], d[p]) >= Decimal(1e-6)
                      for p in np.flatnonzero(rows)])
    np.testing.assert_array_equal(passes["VoH"][:, -1].numpy()[rows], exact)
    voh64 = shading.ggx_terms(*(x[k].double() for k in (2, 3, 7, 1)))["VoH"]
    float64_apart = int(((voh64[:, -1, 0].numpy()[rows] >= 1e-6)
                         != exact).sum())
    if delta <= 1e-6:
        assert float64_apart > 0


def test_given_voh_decision_moves_only_the_view_gradient():
    """ops/shading.py::ggx_terms' voh_pass: on voh-clip's forced inputs in
    float64, the decision flipped at the forced samples leaves the outputs
    and every gradient but the view direction's as they were, and moves
    the view direction's only at those points."""
    i = cs.K4_BRANCH_CASES.index("voh-clip")
    x, _, _ = cs.k4_branch_case("voh-clip", 64, 16, cs.SEED + 500 + i, "cpu")
    x64 = [a.double() for a in x]
    gen = torch.Generator().manual_seed(0)
    cot = [torch.randn((64, 3), generator=gen, dtype=torch.float64)
           for _ in range(3)]
    voh = shading.ggx_terms(x64[2], x64[3], x64[7], x64[1])["VoH"] >= 1e-6
    flipped = voh.clone()
    flipped[::2, -1] = ~flipped[::2, -1]
    runs = []
    for decision in (None, flipped):
        with torch.enable_grad():
            leaves, loss = cs.plain_shading_graph(x64, cot, decision)
            runs.append((float(loss.detach()),
                         torch.autograd.grad(loss, leaves)))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-12)
    for k, (a, b) in enumerate(zip(runs[0][1], runs[1][1])):
        moved = (a - b).abs().reshape(64, -1).amax(1) > 0
        if k == 2:
            assert moved[::2].all() and not moved[1::2].any()
        else:
            assert not moved.any(), k
