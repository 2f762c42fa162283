"""The Synthetic4Relight evaluation's per-view body,
`cli/eval_relighting_syn4.py::relight_view`, on the CPU: against the
benchmark's plain reference (`benchmark/reference/relight_eval.py`, which
imports nothing of the port) at a small size in float64, the reference's
LPIPS against the port's on the same seeded weights, and the CLI writing
through it the metric.txt its per-view formulas give."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.reference import lpips as ref_lpips
from benchmark.reference import neilf as ref_neilf
from benchmark.reference import relight_eval as ref_eval
from benchmark.reference.camera import make_camera_params as ref_camera
from benchmark.reference.config import RasterConfig as RefRasterConfig
from relightable3dgaussian_tpu_torch import losses
from relightable3dgaussian_tpu_torch.cli import eval_relighting_syn4 as syn4
from relightable3dgaussian_tpu_torch.losses import lpips
from relightable3dgaussian_tpu_torch.models import gaussians as G
from relightable3dgaussian_tpu_torch.models.lights import EnvLight
from relightable3dgaussian_tpu_torch.models.render import ViewInputs
from relightable3dgaussian_tpu_torch.models.render_neilf import (
    update_visibility)
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.utils import trace
from relightable3dgaussian_tpu_torch.utils.image import psnr

SIZE, P, FOVX, RADIUS = 32, 200, 0.6911, 4.0
SCALE = (2.6734, 2.0917, 1.2587)          # hotdog's albedo scale
F64 = torch.float64


@pytest.fixture
def random_lpips(monkeypatch):
    """LPIPS on its seeded backbone (LPIPS_WEIGHTS=random) for the test."""
    monkeypatch.setenv("LPIPS_WEIGHTS", "random")
    lpips.reset()
    yield {k: torch.as_tensor(v, dtype=F64)
           for k, v in lpips.weights().items()}
    lpips.reset()


def small_case(S: int, seed: int = 5):
    """A seeded stage-2 model on the benchmark's spheres, its traced
    visibility at S samples, a seeded HDR map, a camera on the orbit and
    the view's ground truth with a roughness map (float32, the port's)."""
    gen = torch.Generator().manual_seed(seed)
    fields = scene.make_points(P, gen, "cpu")
    fields.update(scene.make_pbr(P, fields, gen, "cpu"))
    model = G.GaussianModel(**{k: v.clone() for k, v in fields.items()})
    vis = update_visibility(model, S)
    envmap = scene.env_map(16, gen, "cpu")
    R, T = scene.orbit_cameras(8, RADIUS, 30.0)[3]
    image, mask = scene.ground_truth((R, T), SIZE, SIZE, FOVX, "cpu")
    albedo = torch.rand((3, SIZE, SIZE), generator=gen)
    rough = torch.rand((1, SIZE, SIZE), generator=gen).expand(3, -1, -1)
    truth = syn4.GroundTruth(image, mask, albedo, rough)
    return fields, model, vis, envmap, (R, T), truth


@pytest.mark.parametrize("S", [24, 384])
def test_relight_view_matches_the_reference(random_lpips, S):
    """The port's view (images, the render's pbr_env and the seven scores)
    in float32 against the plain reference in float64, on the same inputs
    and the port's traced visibility. Tolerances: float32 rounding through
    the projection, the shading's S-sample means and the compositor,
    ~1e-7 relative a step over a few hundred steps: images 5e-6 (1.3e-6
    read at S = 384); the scores read those images (PSNR 1e-5 dB, SSIM
    2e-6, the roughness MSE 1e-8: its float32 mean of ~3e-2) and LPIPS's
    13 float32 convolutions (1e-5 relative)."""
    fields, model, vis, envmap, (R, T), truth = small_case(S)
    cfg = RasterConfig(height=SIZE, width=SIZE, sh_degree=3)
    cam = make_camera_params(R, T, SIZE, SIZE, fovx=FOVX, fovy=FOVX,
                             device="cpu")
    view = ViewInputs(cam=cam, image=None, image_mask=None, depth=None,
                      normal=None)
    rv = syn4.relight_view(view, model, cfg, EnvLight(envmap), vis, truth,
                           base_color_scale=torch.tensor(SCALE))
    assert list(rv.scores) == list(syn4.METRICS)

    p64 = {k: v.to(F64) for k, v in fields.items()}
    rcam = ref_camera(R, T, SIZE, SIZE, fovx=FOVX, fovy=FOVX, device="cpu")
    rcam = type(rcam)(*(x.to(F64) for x in rcam))
    dirs, areas = ref_neilf.samples(p64, S)
    res = ref_eval.render(p64, rcam, RefRasterConfig(SIZE, SIZE), 1.0,
                          envmap.to(F64), vis.visibility.to(F64), dirs, areas,
                          torch.tensor(SCALE, dtype=F64))
    img = ref_eval.images(res, {k: v.to(F64) for k, v in
                                truth._asdict().items()}, 1.0)
    gaps = {name: float((rv.images[name].to(F64) - img[name]).abs().max())
            for name in img}
    gaps["render_pbr_env"] = float((rv.results["pbr_env"].to(F64)
                                    - res["pbr_env"]).abs().max())
    assert max(gaps.values()) < 5e-6, gaps
    want = ref_eval.scores(img, random_lpips)
    tol = {"psnr_pbr": 1e-5, "psnr_albedo": 1e-5, "ssim_pbr": 2e-6,
           "ssim_albedo": 2e-6, "mse_roughness": 1e-8}
    for k in syn4.METRICS:
        if k.startswith("lpips"):
            assert math.isclose(rv.scores[k], want[k], rel_tol=1e-5), k
        else:
            assert abs(rv.scores[k] - want[k]) < tol[k], (k, rv.scores[k],
                                                          want[k])


def test_reference_lpips_is_the_ports(random_lpips):
    """The reference's LPIPS against the port's on the same seeded weights,
    pairs of 48 x 48 images (the 3x3 convolutions at every stage), float64
    on both sides through the port's float32 cast: 1e-5 relative, float32
    rounding through 13 convolutions."""
    gen = torch.Generator().manual_seed(3)
    a, b = torch.rand((2, 3, 48, 48), generator=gen), torch.rand(
        (2, 3, 48, 48), generator=gen)
    got = lpips.lpips_each(a, b)
    want = ref_lpips.lpips(a.to(F64), b.to(F64), random_lpips)
    assert got.shape == (2,) and torch.all(want > 0)
    assert torch.allclose(got.to(F64), want, rtol=1e-5, atol=0)
    assert math.isclose(float(lpips.lpips(a[0], b[0])), float(want[0]),
                        rel_tol=1e-5)


def test_lpips_counts_its_forwards(random_lpips):
    before = trace.counter("lpips.forwards")
    lpips.lpips_each(torch.rand((2, 3, 32, 32)), torch.rand((2, 3, 32, 32)))
    assert trace.counter("lpips.forwards") - before == 4


def test_the_cli_writes_its_metrics_through_relight_view(tmp_path,
                                                         monkeypatch,
                                                         random_lpips):
    """cli.eval_relighting_syn4 on a tiny Synthetic4Relight layout: every
    view goes through `relight_view`, and metric.txt holds, per map, the
    mean over the views of the per-view formulas the CLI used before it
    called `relight_view` (PSNR, SSIM and LPIPS each alone, the roughness
    MSE) on the images it returned: 1e-6 relative, float32 rounding of
    SSIM's stacked pass and LPIPS's batched one."""
    from test_torch_relighting import read_metrics, write_syn4
    data, model_dir = write_syn4(tmp_path)
    seen = []
    real = syn4.relight_view

    def recording(*args, **kwargs):
        rv = real(*args, **kwargs)
        seen.append(rv)
        return rv

    monkeypatch.setattr(syn4, "relight_view", recording)
    syn4.main(["-s", str(data), "-m", str(model_dir), "-c",
               str(model_dir / "chkpnt7.npz"), "-e", str(tmp_path),
               "--sample_num", "8"], device="cpu")
    assert len(seen) == 4                 # two views under two maps
    for task, views in (("env6", seen[:2]), ("env12", seen[2:])):
        got = read_metrics(model_dir / "test_rli" / task / "metric.txt")
        assert list(got) == list(syn4.METRICS)
        old = {k: [] for k in syn4.METRICS}
        for rv in views:
            im = rv.images
            old["psnr_pbr"].append(float(psnr(im["pbr"][None],
                                              im["gt"][None]).mean()))
            old["ssim_pbr"].append(float(losses.ssim(im["pbr"], im["gt"])))
            old["lpips_pbr"].append(float(lpips.lpips(im["pbr"], im["gt"])))
            old["psnr_albedo"].append(float(psnr(
                im["base_color"][None], im["gt_albedo"][None]).mean()))
            old["ssim_albedo"].append(float(losses.ssim(im["base_color"],
                                                        im["gt_albedo"])))
            old["lpips_albedo"].append(float(lpips.lpips(
                im["base_color"], im["gt_albedo"])))
            old["mse_roughness"].append(float(
                ((im["roughness"].expand(3, -1, -1) - im["gt_roughness"])
                 ** 2).mean()))
        for k in syn4.METRICS:
            assert math.isclose(float(got[k]), float(np.mean(old[k])),
                                rel_tol=1e-6), (task, k)


def test_a_rank_past_rank_0_only_renders(monkeypatch):
    """Without a ground truth (a rank past rank 0 of a sharded run)
    `relight_view` renders and returns None; without LPIPS weights both
    LPIPS scores are NaN and no image goes through its backbone."""
    monkeypatch.setenv("LPIPS_WEIGHTS", "")
    monkeypatch.setenv("HOME", "/nonexistent")
    lpips.reset()
    fields, model, vis, envmap, (R, T), truth = small_case(8)
    cam = make_camera_params(R, T, SIZE, SIZE, fovx=FOVX, fovy=FOVX,
                             device="cpu")
    view = ViewInputs(cam=cam, image=None, image_mask=None, depth=None,
                      normal=None)
    args = (view, model, RasterConfig(height=SIZE, width=SIZE),
            EnvLight(envmap), vis)
    ones = torch.ones(3)
    assert syn4.relight_view(*args, None, base_color_scale=ones) is None
    before = trace.counter("lpips.forwards")
    rv = syn4.relight_view(*args, truth, base_color_scale=ones)
    lpips.reset()
    assert math.isnan(rv.scores["lpips_pbr"]) and math.isnan(
        rv.scores["lpips_albedo"])
    assert math.isfinite(rv.scores["psnr_pbr"])
    assert trace.counter("lpips.forwards") == before
