"""The stage-2 eval shading (`ops/shading_eval_cuda.py::
rendering_equation_eval`): its plain CPU version against the chunk loop it
replaced, the callers that go through it, the wrapper's checks; and on the
card kernel K6 against the plain version in float64 and against the JAX
package's outputs kept in `tests/data/eval_shading_jax.npz` (written and
held to JAX by `test_torch_shading_eval_jax.py`).

The card tests (marker `cuda`) skip without an NVIDIA GPU; they import no
jax, so on a machine without it run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_shading_eval.py`.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu_torch.models import render_neilf
from relightable3dgaussian_tpu_torch.models.lights import (DirectLightMap,
                                                           EnvLight,
                                                           query_light,
                                                           upsample)
from relightable3dgaussian_tpu_torch.ops import shading_eval_cuda as K6
from relightable3dgaussian_tpu_torch.ops.shading import rendering_equation
from relightable3dgaussian_tpu_torch.parallel import data_parallel as dp
from relightable3dgaussian_tpu_torch.parallel.point_sharded import \
    make_sharded_shading
from relightable3dgaussian_tpu_torch.utils import trace
from relightable3dgaussian_tpu_torch.utils.graphics import \
    fibonacci_sphere_sampling

# K6 (float32) against the plain version in float64, per output: its largest
# error within TOL of the field's scale (1 + its largest entry), or within
# SLACK times the plain float32 version's own error on the same inputs.
# A mean of S <= 384 terms of a ~300-operation float32 chain a term: the
# plain float32 version reads up to ~6e-7 of the scale on these inputs
# (its GGX peak aside, which K6 takes in a better-conditioned form). Where
# the map has sharp texels (a 512 x 1024 map of random texels) the float32
# rounding of the lookup's coordinates, which the plain float32 version
# shares (grid_sample's), moves each sample by up to ~1e-4 texel of the
# map's differences: that error is the plain version's too.
TOL = 4e-6
SLACK = 2.0
# The cases of the JAX file: points, samples, light ("map": a softplus'd
# raw DirectLightMap; "env": an EnvLight turned about z), seed.
JAX_FILE = Path(__file__).resolve().parent / "data" / "eval_shading_jax.npz"
JAX_CASES = {"map_s64": (97, 64, "map", 21), "env_s64": (97, 64, "env", 22),
             "map_s37": (97, 37, "map", 23), "env_s37": (97, 37, "env", 24)}
# The file's inputs, in rendering_equation_eval's order without the light,
# which the file holds as "env" (a DirectLightMap's raw map or an
# EnvLight's image) and "transform" (an EnvLight's).
JAX_INPUTS = ("base_color", "roughness", "normals", "viewdirs",
              "incidents_shs", "visibility", "incident_dirs", "incident_areas")


def old_shade_points(base_color, roughness, normal, viewdirs, incidents, env,
                     vis, chunk_samples):
    """The eval shading as `render_neilf._shade_points` and `render_view`
    computed it before K6 (its unsharded chunk loop and the visibility
    channel's mean)."""
    P, S = vis.visibility.shape[:2]
    chunk = max(1, chunk_samples // S)
    parts = []
    for i in range(0, P, chunk):
        sl = slice(i, i + chunk)
        pbr, ex = rendering_equation(
            base_color[sl], roughness[sl], normal[sl], viewdirs[sl],
            incidents[sl], lambda d: query_light(env, d), vis.visibility[sl],
            vis.incident_dirs[sl], vis.incident_areas[sl])
        parts.append((pbr, {k: (v if v.dim() == 2 else v.mean(-2))
                            for k, v in ex.items()}))
    extras = {k: torch.cat([ex[k] for _, ex in parts]) for k in parts[0][1]}
    extras["visibility"] = vis.visibility.mean(-2)
    return torch.cat([p for p, _ in parts]), extras


def rotation_z(a: float) -> torch.Tensor:
    return torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                         [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])


def shading_inputs(P: int, S: int, seed: int, light: str = "env",
                   H: int = 16, special: bool = True, device="cpu"):
    """rendering_equation_eval's inputs, seeded: unit normals, view
    directions of any length, Fibonacci samples, visibility in [0, 1),
    roughness in [0.09, 0.99], local-light SH 0.3 N(0, 1); the light an
    `EnvLight` of texels in [0, 3) turned by a rotation about z ("env"),
    without one ("env_fixed"), or a `DirectLightMap` (a softplus'd raw map,
    "map"; "map_up": one upsampled from H / 2, as training upsamples it,
    whose raw map is a strided view). With `special`, point 0's first samples lie at the poles (+z,
    where the lookup's row index falls below 0 and the zero padding shows,
    and -z) and at theta = +-pi on either side of the map's seam, and the
    last points are viewed within 1e-6 of grazing."""
    g = torch.Generator().manual_seed(seed)
    n = torch.randn(P, 3, generator=g)
    n = n / n.norm(dim=-1, keepdim=True)
    v = torch.randn(P, 3, generator=g) * 3
    dirs, areas = fibonacci_sphere_sampling(n, S)
    if special:
        sp = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
                           [-1.0, 1e-3, 0.0], [-1.0, -1e-3, 0.0],
                           [-1.0, 0.0, 0.0]])[:S]
        dirs[0, :len(sp)] = sp / sp.norm(dim=-1, keepdim=True)
        k = min(4, P - 1)
        side = torch.linalg.cross(n[-k:], torch.randn(k, 3, generator=g))
        side = side / side.norm(dim=-1, keepdim=True)
        v[-k:] = side + 1e-6 * torch.tensor([1.0, -1.0, 1.0, -1.0])[:k, None] \
            * n[-k:]
    vis = torch.rand(P, S, 1, generator=g)
    bc = torch.rand(P, 3, generator=g)
    rough = torch.rand(P, 1, generator=g) * 0.9 + 0.09
    shs = 0.3 * torch.randn(P, 16, 3, generator=g)
    if light == "map":
        env = DirectLightMap.from_raw(torch.randn(H, 2 * H, 3, generator=g))
    elif light == "map_up":
        env = upsample(DirectLightMap.from_raw(
            torch.randn(H // 2, H, 3, generator=g)))
    else:
        img = 3 * torch.rand(H, 2 * H, 3, generator=g)
        env = EnvLight(img, rotation_z(0.7) if light == "env" else None)
    x = (bc, rough, n, v, shs, env, vis, dirs, areas)
    return tuple(_to(a, device, torch.float32) for a in x)


def _to(a, device, dtype):
    if isinstance(a, EnvLight):
        return EnvLight(a.envmap.to(device, dtype), None if a.transform is None
                        else a.transform.to(device, dtype))
    if isinstance(a, DirectLightMap):
        return DirectLightMap.from_raw(a.env.detach().to(device, dtype))
    return a.to(device, dtype).contiguous()


def jax_case(case: str) -> tuple[dict, dict, dict]:
    """The JAX file's inputs for the case (float32 arrays by name) and
    JAX's outputs for them in float32 and in float64 ("pbr" and
    `K6.EXTRA_KEYS`, in that order)."""
    with np.load(JAX_FILE) as f:
        x = {k.split("/")[-1]: f[k] for k in f.files
             if k.startswith(f"{case}/in/")}
        out = [{k: f[f"{case}/{key}/{k}"] for k in ("pbr", *K6.EXTRA_KEYS)}
               for key in ("jax", "jax64")]
    return x, *out


def jax_torch_inputs(x: dict, dtype=torch.float32, device="cpu") -> tuple:
    """rendering_equation_eval's arguments from the JAX file's inputs."""
    t = {k: torch.from_numpy(v).to(device, dtype) for k, v in x.items()}
    env = (EnvLight(t["env"], t["transform"]) if "transform" in t
           else DirectLightMap.from_raw(t["env"]))
    return (*(t[n] for n in JAX_INPUTS[:5]), env,
            *(t[n] for n in JAX_INPUTS[5:]))


@torch.no_grad()
@pytest.mark.parametrize("chunk_samples", [1000, 4_000_000])
@pytest.mark.parametrize("light", ["env", "map"])
def test_cpu_version_equals_the_old_chunk_loop(chunk_samples, light):
    """On the CPU, `rendering_equation_eval` computes bit for bit what the
    eval shading computed before K6, at a chunk of 15 points (1000 // 64)
    and at one chunk."""
    x = shading_inputs(67, 64, 3, light)
    cache = render_neilf.VisibilityCache(*x[6:])
    want_pbr, want = old_shade_points(*x[:6], cache, chunk_samples)
    pbr, got = K6.rendering_equation_eval(*x, chunk_samples=chunk_samples)
    assert torch.equal(pbr, want_pbr)
    assert list(got) == list(want) == list(K6.EXTRA_KEYS)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["visibility"].shape == (67, 1)


@torch.no_grad()
def test_shade_points_and_the_sharded_shading_go_through_it(monkeypatch):
    """`_shade_points` calls `rendering_equation_eval` once with the CPU
    chunk bound, and each rank of `make_sharded_shading` once on its share
    (one chunk); both return its results, the visibility's mean among
    them."""
    calls = []
    real = K6.rendering_equation_eval

    def spy(*args, **kwargs):
        calls.append((args[0].shape[0], kwargs.get("chunk_samples")))
        return real(*args, **kwargs)

    monkeypatch.setattr(render_neilf, "rendering_equation_eval", spy)
    from relightable3dgaussian_tpu_torch.parallel import point_sharded
    monkeypatch.setattr(point_sharded, "rendering_equation_eval", spy)
    x = shading_inputs(21, 16, 5)
    cache = render_neilf.VisibilityCache(*x[6:])
    pbr, extras = render_neilf._shade_points(*x[:6], cache)
    assert calls == [(21, render_neilf.SHADE_CHUNK_SAMPLES)]
    want_pbr, want = real(*x)
    assert torch.equal(pbr, want_pbr)
    group = dp.Group((torch.device("cpu"),), 0, None)
    s_pbr, s_extras = render_neilf._shade_points(
        *x[:6], cache, sharded_shading=make_sharded_shading(group,
                                                            full_extras=True))
    assert calls[1:] == [(21, None)]
    assert torch.equal(s_pbr, want_pbr)
    assert list(s_extras) == list(K6.EXTRA_KEYS)
    for k in want:
        assert torch.equal(s_extras[k], want[k]), k
        assert torch.equal(extras[k], want[k]), k


def _bad_inputs(case: str) -> list:
    """rendering_equation_eval's inputs with one of them spoiled."""
    x = list(shading_inputs(10, 8, 7))
    if case == "float64_dirs":
        x[7] = x[7].double()
    elif case == "float64_viewdirs":
        x[3] = x[3].double()
    elif case == "short_area":
        x[8] = x[8][:, :7].contiguous()
    elif case == "areas_shared":
        x[8] = x[8][:, :1]
    elif case == "strided_dirs":
        x[7] = torch.zeros(10, 8, 6)[..., ::2]
    elif case == "sh_degree_2":
        x[4] = x[4][:, :9].contiguous()
    elif case == "vis_flat":
        x[6] = x[6][..., 0]
    elif case == "flat_env":
        x[5] = EnvLight(x[5].envmap.reshape(-1, 3), x[5].transform)
    elif case == "env_rgba":
        x[5] = EnvLight(torch.zeros(16, 32, 4), x[5].transform)
    elif case == "transform_4x4":
        x[5] = EnvLight(x[5].envmap, torch.eye(4))
    elif case == "float64_map":
        x[5] = DirectLightMap.from_raw(torch.zeros(16, 32, 3,
                                                  dtype=torch.float64))
    return x


BAD_CASES = ["float64_dirs", "float64_viewdirs", "short_area", "areas_shared",
             "strided_dirs", "sh_degree_2", "vis_flat", "flat_env", "env_rgba",
             "transform_4x4", "float64_map"]


@pytest.mark.parametrize("case", BAD_CASES)
def test_kernel_inputs_reject_bad_inputs(case):
    """`kernel_inputs`, the card path's one check before K6's launch,
    raises ValueError on what K6 cannot read as given: another dtype, a
    shape not K6's (SH of another degree, areas not [P, S, 1], a visibility
    without its last axis, a map not [H, W, 3], a transform not 3 x 3) or
    a strided per-sample input."""
    with pytest.raises(ValueError, match="K6"):
        K6.kernel_inputs(*_bad_inputs(case))


def test_kernel_inputs_make_the_light_contiguous():
    """The map and the transform reach K6 contiguous whatever their
    layout: a map upsampled in training (a strided raw map) and a
    transposed transform; the per-sample inputs stay views."""
    x = list(shading_inputs(10, 8, 7, "map_up"))
    assert not x[5].env.is_contiguous()
    ki = K6.kernel_inputs(*x)
    assert ki[8].is_contiguous() and ki[8].shape == (16, 32, 3)
    assert ki[0].data_ptr() == x[7].data_ptr()
    x = list(shading_inputs(10, 8, 7, "env"))
    x[5] = EnvLight(x[5].envmap, x[5].transform.T.contiguous().T)
    assert not x[5].transform.is_contiguous()
    ki = K6.kernel_inputs(*x)
    assert ki[9].is_contiguous() and torch.equal(ki[9], x[5].transform)


def test_mixed_devices_raise():
    """Inputs on two kinds of device (here the CPU and `meta`) raise, on
    the per-point fields and on the light alike."""
    x = list(shading_inputs(6, 4, 9))
    x[0] = x[0].to("meta")
    with pytest.raises(ValueError, match="expected all on CPU or all on CUDA"):
        K6.rendering_equation_eval(*x)
    x = list(shading_inputs(6, 4, 9))
    x[5] = EnvLight(x[5].envmap.to("meta"), x[5].transform)
    with pytest.raises(ValueError, match="expected all on CPU or all on CUDA"):
        K6.rendering_equation_eval(*x)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _errors(got, want64, plain32) -> dict:
    """{output: (K6's largest error from float64, the plain float32
    version's, the field's scale)}."""
    out = {}
    for name, g, e, p in [("pbr", got[0], want64[0], plain32[0])] + [
            (k, got[1][k], want64[1][k], plain32[1][k]) for k in K6.EXTRA_KEYS]:
        assert g.shape == e.shape, name
        assert bool(torch.isfinite(g).all()), name
        out[name] = (float((g.double() - e).abs().max()),
                     float((p.double() - e).abs().max()),
                     1.0 + float(e.abs().max()))
    return out


def _assert_within(errs: dict) -> None:
    bad = {k: v for k, (e, p, s) in errs.items() for v in [(e, p, s)]
           if e > max(TOL * s, SLACK * p)}
    assert not bad, f"K6 against float64 (err, plain32 err, scale): {bad}"


@torch.no_grad()
@pytest.mark.cuda
@pytest.mark.parametrize("P,S,light,H", [
    (300_000, 64, "env", 512),        # s2-relight's shapes
    (1001, 37, "map", 16),            # odd P and S, a DirectLightMap
    (333, 384, "env", 16),            # the Synthetic4Relight eval's S
    (97, 64, "env_fixed", 16),        # no transform
    (129, 64, "map_up", 16),          # a map upsampled in training
])
def test_k6_matches_float64(cuda, P, S, light, H):
    x = shading_inputs(P, S, P + S, light, H)
    x_card = tuple(_to(a, cuda, torch.float32) for a in x)
    before = trace.counter("k6.launches")
    got = K6.rendering_equation_eval(*x_card)
    torch.cuda.synchronize()
    assert trace.counter("k6.launches") == before + 1
    got = (got[0].cpu(), {k: v.cpu() for k, v in got[1].items()})
    x64 = tuple(_to(a, cuda, torch.float64) for a in x)
    want = K6.rendering_equation_eval_reference(*x64, chunk_samples=4_000_000)
    want = (want[0].cpu(), {k: v.cpu() for k, v in want[1].items()})
    plain = K6.rendering_equation_eval_reference(*x_card,
                                                 chunk_samples=4_000_000)
    plain = (plain[0].cpu(), {k: v.cpu() for k, v in plain[1].items()})
    _assert_within(_errors(got, want, plain))


@torch.no_grad()
@pytest.mark.cuda
def test_k6_special_directions(cuda):
    """Samples at both poles (+z: the row index below 0, the zero padding)
    and on both sides of the seam at theta = +-pi, in every point's first
    samples, and views within 1e-6 of grazing, against float64 at K6's
    tolerance."""
    x = list(shading_inputs(64, 64, 11, "env_fixed", 16))
    sp = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [-1.0, 1e-3, 0.0],
                       [-1.0, -1e-3, 0.0], [-1.0, 0.0, 0.0],
                       [-1.0, 0.0, 1e-3]])
    x[7][:, :6] = sp / sp.norm(dim=-1, keepdim=True)
    x_card = tuple(_to(a, cuda, torch.float32) for a in x)
    got = K6.rendering_equation_eval(*x_card)
    want = K6.rendering_equation_eval_reference(
        *(_to(a, cuda, torch.float64) for a in x))
    plain = K6.rendering_equation_eval_reference(*x_card)
    cpu = lambda r: (r[0].cpu(), {k: v.cpu() for k, v in r[1].items()})  # noqa: E731
    _assert_within(_errors(cpu(got), cpu(want), cpu(plain)))


@torch.no_grad()
@pytest.mark.cuda
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_k6_matches_jax(cuda, case):
    """K6 against the JAX package's eval shading (`_shade_chunk_reduced`)
    on the JAX file's inputs (a softplus'd DirectLightMap or a turned
    EnvLight, S = 64 and 37, with the poles, the seam and grazing views),
    every output the visibility's mean included: within TOL of the
    field's scale of JAX in float64, or within SLACK times JAX's own
    float32 error, K6's rule against the plain version."""
    x, want32, want64 = jax_case(case)
    pair = lambda w: (torch.from_numpy(w["pbr"]),  # noqa: E731
                      {k: torch.from_numpy(w[k]) for k in K6.EXTRA_KEYS})
    before = trace.counter("k6.launches")
    got = K6.rendering_equation_eval(*jax_torch_inputs(x, device=cuda))
    torch.cuda.synchronize()
    assert trace.counter("k6.launches") == before + 1
    got = (got[0].cpu(), {k: v.cpu() for k, v in got[1].items()})
    _assert_within(_errors(got, pair(want64), pair(want32)))


@torch.no_grad()
@pytest.mark.cuda
def test_render_neilf_eval_launches_k6_once_a_frame(cuda):
    from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel
    from relightable3dgaussian_tpu_torch.models.render import ViewInputs
    from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
    from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
    rng = np.random.default_rng(4)
    n = 2000
    f32 = np.float32
    op = rng.uniform(0.1, 0.99, (n, 1))
    fields = {"xyz": rng.uniform(-1, 1, (n, 3)).astype(f32),
              "normal": rng.normal(size=(n, 3)).astype(f32),
              "shs_dc": rng.normal(size=(n, 1, 3)).astype(f32),
              "shs_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(f32),
              "scaling": np.log(rng.uniform(0.01, 0.08, (n, 3))).astype(f32),
              "rotation": rng.normal(size=(n, 4)).astype(f32),
              "opacity": np.log(op / (1 - op)).astype(f32),
              "base_color": rng.normal(size=(n, 3)).astype(f32),
              "roughness": rng.normal(size=(n, 1)).astype(f32),
              "incidents_dc": (0.1 * rng.uniform(size=(n, 1, 3))).astype(f32),
              "incidents_rest": (0.02 * rng.normal(size=(n, 15, 3))
                                 ).astype(f32),
              "visibility_dc": (0.5 * rng.normal(size=(n, 1, 1))).astype(f32),
              "visibility_rest": (0.05 * rng.normal(size=(n, 15, 1))
                                  ).astype(f32)}
    model = GaussianModel.from_numpy(fields, device=cuda)
    vis = render_neilf.update_visibility(model, 16)
    env = EnvLight(3 * torch.rand(16, 32, 3, device=cuda))
    cfg = RasterConfig(64, 64)
    bg = torch.zeros(3, device=cuda)
    before = trace.counter("k6.launches")
    for i in range(3):
        cam = make_camera_params(np.eye(3), np.array([0.0, 0.0, 3.0 + i]), 64,
                                 64, fovx=0.9, fovy=0.9, device=cuda)
        view = ViewInputs(cam=cam, image=None, image_mask=None, depth=None,
                          normal=None)
        res = render_neilf.render_neilf(view, model, cfg, bg, env, vis)
        assert trace.counter("k6.launches") == before + i + 1
        assert bool(torch.isfinite(res["pbr_env"]).all())
    assert bool((res["visibility"] >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64_dirs", "sh_degree_2", "flat_env",
                                  "transform_4x4"])
def test_k6_rejects_bad_inputs_before_any_launch(cuda, case):
    """A spoiled input raises on the card as on the CPU, and K6 is not
    launched."""
    x = _bad_inputs(case)
    x = [EnvLight(a.envmap.to(cuda), a.transform.to(cuda))
         if isinstance(a, EnvLight) else a.to(cuda) for a in x]
    before = trace.counter("k6.launches")
    with pytest.raises(ValueError, match="K6"):
        K6.rendering_equation_eval(*x)
    assert trace.counter("k6.launches") == before


@pytest.mark.cuda
def test_k6_mixed_devices_raise(cuda):
    x = list(shading_inputs(6, 4, 9))
    x_card = [_to(a, cuda, torch.float32) for a in x]
    for i in (0, 6):
        y = list(x_card)
        y[i] = x[i]
        with pytest.raises(ValueError, match="expected all on CPU or all on "
                                             "CUDA"):
            K6.rendering_equation_eval(*y)
    y = list(x_card)
    y[5] = x[5]                          # the light on the CPU
    with pytest.raises(ValueError, match="expected all on CPU or all on CUDA"):
        K6.rendering_equation_eval(*y)
