"""The projection's plain version and K7's specification, on the CPU.

`projection_backward_plain`, K7's backward formulas written out in plain
PyTorch, against autograd of `preprocess_plain` in float64 over every branch
the kernel takes; `preprocess` on CPU tensors against the benchmark's frozen
copy of the plain version (what the port computed before K7, bit for bit);
the input check K7's wrapper makes before a launch; `chip_smoke.py`'s
`k7_check`, the card's check of K7, against wrong kernels. The kernel itself
runs only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from benchmark.reference import projection as frozen
from relightable3dgaussian_tpu_torch.ops import projection, projection_cuda
from relightable3dgaussian_tpu_torch.ops.camera import (CameraParams,
                                                        make_camera_params)
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.utils import trace
from relightable3dgaussian_tpu_torch.utils.sh import C0, eval_sh

from test_torch_ops import share_cpu_threads  # noqa: F401  (torch threads)

N = 240
FOCAL = 64.0          # and the camera at z = -4 looking down +z: t_z = 4
DET_POINTS = 3        # the covariance cases' points with det(cov2d) == 0
# case: (SH degree, covariance source, colours given, offset given,
# opacity given)
CASES = {"deg0": (0, None, False, True, True),
         "deg1": (1, None, False, True, True),
         "deg2": (2, None, False, True, True),
         "deg3": (3, None, False, True, True),
         "packed": (3, "packed", False, True, True),
         "full": (2, "full", False, False, True),
         "colors": (3, None, True, True, False),
         "bare": (1, None, False, False, False)}


def camera(dtype) -> CameraParams:
    """64 x 48 pixels, focal 64 (tan(fov/2) = 0.5: the Jacobian clamps at
    |t_xy / t_z| = 0.65), at the world's z = -4 looking down +z."""
    cam = make_camera_params(np.eye(3), np.array([0.0, 0.0, 4.0]), 64, 48,
                             fx=FOCAL, fy=FOCAL, cx=32.0, cy=24.0,
                             device="cpu")
    return CameraParams(*(t.to(dtype) for t in cam))


def case_inputs(case: str, dtype=torch.float64, seed: int = 0) -> dict:
    """preprocess's keyword inputs (leaves requiring grad) for CASES[case]:
    points before the camera, a sixth of them far to the side (past the
    Jacobian's clamp), a tenth behind it or at the near plane (culled by
    depth), a quarter with a DC colour term that clamps the colour at 0, SH
    rows of 16 coefficients whatever the degree, raw quaternions, opacities
    from 0 (an empty rect) to 1. The covariance cases' first DET_POINTS
    points sit on the view's y axis with a covariance whose cov2d + 0.3 I
    is exactly singular (culled by det)."""
    deg, source, colors, offset, opacity = CASES[case]
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.0, 1.0, N),
                    rng.uniform(-1.0, 1.0, N)], -1)
    side = rng.random(N) < 1 / 6
    xyz[side, 0] = rng.choice([-1.0, 1.0], int(side.sum())) * rng.uniform(
        3.0, 5.0, int(side.sum()))
    behind = rng.random(N) < 0.1
    xyz[behind, 2] = rng.uniform(-7.0, -3.85, int(behind.sum()))
    shs = rng.normal(size=(N, 16, 3)) * 0.3
    shs[rng.random(N) < 0.25, 0] = -3.0

    def leaf(a):
        return torch.tensor(a, dtype=dtype, requires_grad=True)

    x = {"means3d": None, "scales": leaf(rng.uniform(0.02, 0.3, (N, 3))),
         "rotations": leaf(rng.normal(size=(N, 4))), "shs": leaf(shs),
         "mean2d_offset": leaf(rng.normal(size=(N, 2))) if offset else None,
         "opacity": (torch.tensor(rng.uniform(0.0, 1.0, N), dtype=dtype)
                     if opacity else None),
         "colors": leaf(rng.uniform(size=(N, 3))) if colors else None,
         "cov3d_precomp": None}
    if colors:
        x["shs"] = None
    if source is not None:
        full = rng.normal(size=(N, 3, 3)) * 0.01
        if source == "packed":
            full = full + full.transpose(0, 2, 1)
        # t = (0, y, 4): J's first row is (16, 0, 0), so cov2d's xx is
        # 256 cov[0, 0] and its xy 0; cov[0, 0] = -0.3 / 256 makes
        # cov2d + 0.3 I singular, exactly in any precision
        xyz[:DET_POINTS] = np.stack([np.zeros(DET_POINTS),
                                     rng.uniform(-0.5, 0.5, DET_POINTS),
                                     np.zeros(DET_POINTS)], -1)
        full[:DET_POINTS, 0, :] = 0.0
        full[:DET_POINTS, :, 0] = 0.0
        full[:DET_POINTS, 0, 0] = -0.3 / 256
        x["cov3d_precomp"] = leaf(full if source == "full" else
                                  np.ascontiguousarray(full[
                                      :, [0, 0, 0, 1, 1, 2],
                                      [0, 1, 2, 1, 2, 2]]))
        x["scales"] = x["scales"].detach()
        x["rotations"] = x["rotations"].detach()
    x["means3d"] = leaf(xyz)
    return x


def config(case: str) -> RasterConfig:
    return RasterConfig(48, 64, sh_degree=CASES[case][0], scale_modifier=0.8)


def upstream(dtype=torch.float64, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=s), dtype=dtype)
            for s in ((N, 2), (N,), (N, 3), (N, 3))]


@pytest.mark.parametrize("case", list(CASES))
def test_backward_spec_matches_autograd(case):
    """projection_backward_plain against autograd of preprocess_plain in
    float64, every gradient within 1e-10 of its field's largest entry,
    each case holding the branches it names: the colour's clamp, the
    Jacobian's clamp, culling by depth and (covariance cases) by det."""
    x, cam, cfg, g = case_inputs(case), camera(torch.float64), config(case), \
        upstream()
    prep = projection.preprocess_plain(cam=cam, cfg=cfg, **x)
    leaves = {k: v for k, v in x.items()
              if isinstance(v, torch.Tensor) and v.requires_grad}
    want = dict(zip(leaves, torch.autograd.grad(
        (prep.mean2d, prep.depth, prep.conic, prep.rgb),
        list(leaves.values()), g, allow_unused=True)))
    d = {k: None if v is None else v.detach() for k, v in x.items()}
    got = projection.projection_backward_plain(
        d["means3d"], d["scales"], d["rotations"], d["shs"], cam, cfg, *g,
        colors=d["colors"], cov3d_precomp=d["cov3d_precomp"])
    got = dict(zip(("means3d", "scales", "rotations", "shs",
                    "cov3d_precomp"), got))
    got["mean2d_offset"], got["colors"] = g[0], g[3]   # passed through
    for name, w in want.items():
        assert w is not None and got[name] is not None, name
        scale = float(w.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(got[name], w, rtol=0, atol=1e-10 * scale,
                                   msg=name)
    # the branches the case is for
    xyz1 = torch.cat([x["means3d"], torch.ones((N, 1), dtype=torch.float64)],
                     -1).detach()
    t = xyz1 @ cam.world_view
    assert int((t[:, 2] <= 0.2).sum()) > 5
    assert int(((t[:, 0] / t[:, 2]).abs() > 0.65).sum()) > 5
    assert int((prep.radius == 0).sum()) > int((t[:, 2] <= 0.2).sum())
    if x["colors"] is None:
        raw = prep.rgb.detach()
        assert 0 < int((raw == 0).sum()) < raw.numel()
    if x["cov3d_precomp"] is not None:
        assert bool((prep.conic[:DET_POINTS] == 0).all())
        assert bool((prep.radius[:DET_POINTS] == 0).all())
        assert bool((prep.conic[DET_POINTS:] != 0).any(-1).all())
    if x["shs"] is not None and x["colors"] is None and cfg.sh_degree < 3:
        n = (cfg.sh_degree + 1) ** 2
        assert float(got["shs"][:, n:].abs().max()) == 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_preprocess_on_cpu_is_the_plain_version_bitwise(case):
    """preprocess on CPU tensors returns, bit for bit, what the port's
    projection returned before K7: the benchmark's frozen copy of it
    (benchmark/reference/projection.py), float32, in the span
    render.projection and with its one sync counted."""
    x = case_inputs(case, torch.float32)
    cam, cfg = camera(torch.float32), config(case)
    syncs = trace.counter("host.syncs")
    got = projection.preprocess(cam=cam, cfg=cfg, **x)
    assert trace.counter("host.syncs") == syncs + 1
    want = frozen.preprocess(cam=cam, cfg=cfg, **x)
    for name in projection.Preprocessed._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def camera_tensors(cam: CameraParams) -> tuple:
    """The camera tensors K7 reads, in its order."""
    return tuple(t.contiguous() for t in (cam.world_view, cam.full_proj,
                                          cam.campos, cam.focal, cam.tan_fov))


def check(x: dict, cam, cfg):
    """projection_cuda.check_inputs on preprocess's inputs, as `project`
    passes them (the scales and rotations dropped for a covariance, the SH
    rows for colours)."""
    x = {k: None if v is None else v.contiguous() for k, v in x.items()}
    cov = x["cov3d_precomp"]
    return projection_cuda.check_inputs(
        x["means3d"], None if cov is not None else x["scales"],
        None if cov is not None else x["rotations"],
        None if x["colors"] is not None else x["shs"], cov,
        x["mean2d_offset"], x["opacity"], x["colors"], camera_tensors(cam),
        cfg)


def refused(case: str):
    """(preprocess's inputs, camera, cfg) changed to something K7 does not
    take, and the ValueError's message."""
    x, cam, cfg = case_inputs("deg3", torch.float32), camera(torch.float32), \
        config("deg3")
    if case in ("half", "double"):
        dtype = torch.float16 if case == "half" else torch.float64
        return dict(x, means3d=x["means3d"].to(dtype)), cam, cfg, \
            f"means3d: got {dtype} .* expected float32"
    if case == "degree4":
        return x, cam, RasterConfig(48, 64, sh_degree=4), "SH degree 4"
    if case == "few_coefficients":
        return dict(x, shs=x["shs"][:, :9]), cam, cfg, "expected .* >= 16"
    if case == "camera_grad":
        return x, cam._replace(
            world_view=cam.world_view.clone().requires_grad_()), cfg, \
            "requires grad"
    if case == "cov_shape":
        return dict(x, cov3d_precomp=torch.zeros((N, 9))), cam, cfg, \
            r"expected float32 \(240, 6\)"
    if case == "no_colour":
        return dict(x, shs=None), cam, cfg, "neither shs nor colors"
    return dict(x, opacity=x["opacity"].double()), cam, cfg, \
        "opacity: got torch.float64"


@pytest.mark.parametrize("case", ["half", "double", "degree4",
                                  "few_coefficients", "camera_grad",
                                  "cov_shape", "no_colour", "opacity_dtype"])
def test_k7_input_check_refuses(case):
    """K7's wrapper refuses before any launch what the kernel does not take
    (checked on CPU tensors, which reach no launch)."""
    x, cam, cfg, match = refused(case)
    with pytest.raises(ValueError, match=match):
        check(x, cam, cfg)


def test_k7_input_check_takes_every_case():
    """The same check passes every case of CASES and reads its layout."""
    for case, (deg, source, colors, _, _) in CASES.items():
        layout = check(case_inputs(case, torch.float32),
                       camera(torch.float32), config(case))
        assert layout.deg == (-1 if colors else deg), case
        assert layout.cov_kind == {None: 0, "packed": 6, "full": 9}[source]
        assert (layout.P, layout.K) == (N, 0 if colors else 16)
        assert layout.scale_modifier == pytest.approx(0.8)


def test_preprocess_refuses_a_device_neither_cpu_nor_cuda():
    x = {k: None if v is None else v.detach().to("meta")
         for k, v in case_inputs("deg0", torch.float32).items()}
    cam = CameraParams(*(t.to("meta") for t in camera(torch.float32)))
    with pytest.raises(ValueError, match="expected the CPU or a CUDA"):
        projection.preprocess(cam=cam, cfg=config("deg0"), **x)


# ---------------------------------------------------------------------------
# chip_smoke.py's k7_check, the card's check of K7, run here on wrong kernels
# ---------------------------------------------------------------------------

def wrong_kernel(kind: str):
    """preprocess_plain with one fault a kernel could have: the conic off
    by 1e-3 of itself; one radius off by one (at a point no rounding
    explains); no gradient from the colour's view direction to the means;
    the colour's gradient passing its clamp at 0."""
    import chip_smoke as cs

    def kernel(cam, cfg, **x):
        prep = projection.preprocess_plain(cam=cam, cfg=cfg, **x)
        if kind == "conic":
            return prep._replace(conic=prep.conic * (1.0 + 1e-3))
        if kind == "radius":
            pts = cs.k7_points(x, cam, cfg)
            j = int(torch.nonzero((prep.radius > 0) & ~pts.integer)[0, 0])
            radius = prep.radius.clone()
            radius[j] += 1
            return prep._replace(radius=radius)
        if kind == "sh_direction":
            return prep._replace(rgb=projection.preprocess_plain(
                cam=cam, cfg=cfg, **dict(x, means3d=x["means3d"].detach())
            ).rgb)
        dirs = torch.nn.functional.normalize(x["means3d"] - cam.campos, dim=-1)
        raw = eval_sh(cfg.sh_degree, x["shs"].transpose(-1, -2), dirs) + 0.5
        return prep._replace(rgb=raw + (prep.rgb - raw).detach())
    return kernel


def k7_check_case(case: str):
    return (case_inputs(case, torch.float32), camera(torch.float32),
            config(case), upstream(torch.float32))


@pytest.mark.parametrize("case", ["deg3", "packed", "colors"])
def test_k7_check_passes_the_plain_path(case):
    """The plain float32 path passes the check it is the yardstick of, over
    both groups of points, the covariance cases' det = 0 points left out as
    at a branch."""
    import chip_smoke as cs
    errs = cs.k7_check(projection.preprocess_plain, *k7_check_case(case),
                       case, rare=0.05)
    assert {"conic.front", "conic.culled", "d_means3d.front"} <= set(errs)
    assert errs["culled"] > 5 and errs["int_apart"] == 0
    assert errs["at_branch"] == (DET_POINTS if case == "packed" else 0)


@pytest.mark.parametrize("kind,field", [
    ("conic", "conic.front"), ("radius", "none near an integer"),
    ("sh_direction", "d_means3d.front"), ("clamp", "d_shs.front")])
def test_k7_check_fails_a_wrong_kernel(kind, field):
    """Each fault of wrong_kernel fails k7_check, named by its field."""
    import chip_smoke as cs
    with pytest.raises(AssertionError, match=field):
        cs.k7_check(wrong_kernel(kind), *k7_check_case("deg3"), kind,
                    rare=0.05)


def test_k7_points_flag_the_branches():
    """A colour at its clamp (SH + 0.5 = 0), a point on the Jacobian's
    clamp (t_x / t_z = 1.3 tan(fov/2) = 0.65) and the det = 0 points are at
    a branch; the points culled by depth are those behind the near plane."""
    import chip_smoke as cs
    x, cam, cfg, _ = k7_check_case("packed")
    with torch.no_grad():
        x["shs"][DET_POINTS] = 0.0
        x["shs"][DET_POINTS, 0] = -0.5 / C0              # the colour's clamp
        x["means3d"][DET_POINTS + 1] = torch.tensor([2.6, 0.0, 0.0])
    pts = cs.k7_points(x, cam, cfg)
    assert pts.branch[:DET_POINTS + 2].all()
    assert int(pts.branch.sum()) == DET_POINTS + 2
    depth = x["means3d"][:, 2].detach().double() + 4.0
    assert torch.equal(pts.culled, depth <= 0.2)
