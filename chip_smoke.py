"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Drives the port's main paths, the stage-1 render of a checkpoint and stage-1
training, through the entry points a user calls, and checks every kernel on
those paths against its plain PyTorch version. Phases (each prints one line,
the train phase a few; any failure raises, so the exit code is non-zero and
no result line is printed):

  1. device   needs torch.cuda; prints the card's name and power limit;
  2. build    compiles kernels K1 (csrc/composite_fwd.cu) and K2
              (csrc/composite_bwd.cu) with nvcc, both at once;
  3. k1-mid   K1 against the plain compositor on a seeded 20k-gaussian
              400x400 scene (opacities in [0.1, 0.99]), with and without
              per-gaussian weights;
  4. k2-mid   K2 against the plain backward (ops/composite.py::
              composite_backward) on the same scene, with a seeded image
              cotangent (zero on pixels where K1's and the plain n_contrib
              differ), with and without a weights cotangent;
  5. slice    builds a seeded 100k-gaussian scene, saves it as a JAX-format
              checkpoint, loads it with train.checkpoint.load_checkpoint and
              renders 8 orbit views at 800x800 through models.render.render;
              K1 must launch once per view;
  6. k1-main  K1 against the plain compositor on the first view's inputs
              (the render's shapes), timed beside it;
  7. train    stage-1 training at 800x800: ground truth rendered by the port
              from the 100k-gaussian scene of phase 5 over 8 orbit views, a
              model made by train.create_from_pcd from 100k random points
              as scene/dataset_readers.py makes them, and
              train.stage1.run_training_schedule with STAGE1_NERF_SYNTHETIC,
              compressed to hold densify calls and an opacity reset; K1 and
              K2 must launch once per step, the loss stay finite and the
              PSNR rise;
  8. k2-main  K2 against the plain backward at the train step's shapes (the
              trained model after its last densify, 800x800), timed beside it;
  9. profile  three windows of further train steps of the trained model:
              without a profiler (ms per step), under torch.profiler with
              device activity only (kernel ms against the window's stream
              ms: the device's busy share), and with host activity too
              (aten ops and kernel launches per step, the largest kernels).

The card's render and train step against the CPU path, which
tests/test_torch_*.py tie to the JAX package, are checked by
tests/test_torch_cuda.py.

The line before the last holds the kernels' numbers; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from relightable3dgaussian_tpu_torch.models.gaussians import (GaussianModel,
                                                              create_from_pcd)
from relightable3dgaussian_tpu_torch.models.render import (ViewInputs, render,
                                                           view_features)
from relightable3dgaussian_tpu_torch.ops import _build, composite_cuda
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.composite import composite as composite_plain
from relightable3dgaussian_tpu_torch.ops.composite import composite_backward
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.rasterize import prepare
from relightable3dgaussian_tpu_torch.train.checkpoint import (load_checkpoint,
                                                              save_checkpoint)
from relightable3dgaussian_tpu_torch.train.config import (STAGE1_NERF_SYNTHETIC,
                                                          OptimizationConfig)
from relightable3dgaussian_tpu_torch.train.optim import make_optimizer
from relightable3dgaussian_tpu_torch.train.stage1 import (StepTimer,
                                                          run_training_schedule,
                                                          train_step)
from relightable3dgaussian_tpu_torch.utils.sh import C0, rgb_to_sh

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 0
N_MAIN, SIZE_MAIN, VIEWS = 100_000, 800, 8
N_MID, SIZE_MID = 20_000, 400
CAM_RADIUS, FOV = 3.0, 0.9
K1_SOURCE = "relightable3dgaussian_tpu_torch/csrc/composite_fwd.cu"
K1_REPLACES = "relightable3dgaussian_tpu/ops/composite_pallas.py:45"
K2_SOURCE = "relightable3dgaussian_tpu_torch/csrc/composite_bwd.cu"
K2_REPLACES = "relightable3dgaussian_tpu/ops/composite_pallas_bwd.py:283"
# The train phase: the 30k-step NeRF-synthetic schedule compressed in its
# densify/reset timing so 300 steps hold two densify calls (steps 100 and
# 200; the recipe's normal-gradient threshold of 2e-9 selects nearly every
# visible point, so each call can double the cloud) and an opacity reset
# (step 150, which turns the world-size prune on).
TRAIN_OPT = OptimizationConfig(
    iterations=300, position_lr_max_steps=300, densify_from_iter=50,
    densification_interval=100, densify_until_iter=280,
    opacity_reset_interval=150, **STAGE1_NERF_SYNTHETIC)
N_INIT, PCD_LO, PCD_HI = 100_000, -1.3, 1.3   # dataset_readers.py:230
# K1 against the plain version. Image: float32 sums in the same order, but
# the card's FMA contraction rounds differently. n_contrib: alpha = 1/255 and
# T = 1e-4 are threshold crossings a last-bit change can move, so equal on
# >= 99.99% of pixels, and the image is compared where it is equal. Weights:
# the atomics add in another order.
IMG_ATOL = IMG_RTOL = 1e-5
COUNT_AGREE = 0.9999
W_RTOL, W_ATOL = 1e-4, 1e-6
# K2 against the plain backward, per gradient field: max |diff| <= K2_TOL ·
# max |plain|. Both sum over pixels in another order (K2 with atomics). K2
# decides "blended" by K1's stop index where the plain version tests
# T >= 1e-4, so where a last-bit change moves that crossing (a pixel whose
# K1 and plain n_contrib differ, held to COUNT_AGREE as for K1) one pixel
# moves a gradient by ~1e-4 of its max on a trained, near-opaque model:
# the image cotangent is zeroed on those pixels for both.
K2_TOL = 1e-4
PROFILE_STEPS = 10   # train steps in each window of the profile phase


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def make_scene(n: int, seed: int, opacity: float | None = 0.1) -> dict:
    """Seeded scene on the pattern of bench.py: points uniform in the unit
    ball, log-scales from the mean squared 3-NN distance (create_from_pcd),
    random unit quaternions and normals, SH degree 3 with small rest bands.
    `opacity` None draws opacities uniform in [0.1, 0.99]."""
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(seed)
    r = rng.uniform(size=(n, 1)) ** (1 / 3)
    d = rng.normal(size=(n, 3))
    pts = r * d / np.linalg.norm(d, axis=-1, keepdims=True)
    dist, _ = cKDTree(pts).query(pts, k=4)
    dist2 = np.maximum((dist[:, 1:] ** 2).mean(-1), 1e-7)
    q = rng.normal(size=(n, 4))
    nrm = rng.normal(size=(n, 3))
    op = (np.full((n, 1), opacity) if opacity is not None
          else rng.uniform(0.1, 0.99, (n, 1)))
    colors = rng.uniform(size=(n, 3))
    f32 = np.float32
    return {
        "xyz": pts.astype(f32),
        "normal": (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(f32),
        "shs_dc": rgb_to_sh(torch.from_numpy(colors)).numpy()[:, None].astype(f32),
        "shs_rest": (rng.normal(size=(n, 15, 3)) * 0.05).astype(f32),
        "scaling": np.repeat(np.log(np.sqrt(dist2))[:, None], 3, 1).astype(f32),
        "rotation": (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(f32),
        "opacity": np.log(op / (1 - op)).astype(f32),
    }


def orbit_view(i: int, n_views: int, size: int, device) -> ViewInputs:
    """Camera i of n on a circle of radius 3 around the y axis, looking at
    the origin (view 0 is bench.py's camera)."""
    a = 2 * math.pi * i / n_views
    R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                  [-math.sin(a), 0, math.cos(a)]])
    cam = make_camera_params(R, np.array([0.0, 0.0, CAM_RADIUS]), size, size,
                             fovx=FOV, fovy=FOV, device=device)
    zeros = torch.zeros((3, size, size), device=device)
    return ViewInputs(cam=cam, image=zeros, image_mask=zeros[:1] + 1,
                      depth=zeros[:1], normal=zeros)


def compositor_args(model: GaussianModel, view: ViewInputs, cfg: RasterConfig):
    """The compositor's inputs for one view, as models.render passes them."""
    prep, binning, attrs = prepare(
        model.xyz, model.get_scaling, model.get_rotation, model.get_opacity,
        model.get_shs, view_features(model, view.cam), view.cam, cfg)
    return (binning, prep.mean2d, prep.conic, model.get_opacity[:, 0].contiguous(),
            attrs, cfg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs after one warm-up: CUDA
    events around each run, synchronized after each."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def check_k1(args, label: str, k1_reps: int = 10, plain_reps: int = 3) -> dict:
    """K1 against the plain compositor on the same card inputs; raises on
    disagreement. Returns the numbers for the kernels line."""
    got, _ = composite_cuda.composite_k1(*args)
    torch.cuda.synchronize()
    want = composite_plain(*args)
    torch.cuda.synchronize()
    agree = got.n_contrib == want.n_contrib
    agree_frac = float(agree.float().mean())
    if agree_frac < COUNT_AGREE:
        raise AssertionError(f"{label}: n_contrib equal on {agree_frac:.6f} "
                             f"of pixels < {COUNT_AGREE}")
    torch.testing.assert_close(got.image[agree], want.image[agree],
                               atol=IMG_ATOL, rtol=IMG_RTOL)
    torch.testing.assert_close(got.weights, want.weights, rtol=W_RTOL,
                               atol=W_ATOL)
    img_err = float((got.image[agree] - want.image[agree]).abs().max())
    w_err = float((got.weights - want.weights).abs().max())

    k1_ms = cuda_ms(lambda: composite_cuda.composite_k1(*args), k1_reps)
    plain_ms = cuda_ms(lambda: composite_plain(*args), plain_reps)
    binning = args[0]
    say(label, pairs=binning.num_rendered, tiles=args[-1].num_tiles,
        attrs=args[4].shape[1], weights=args[-1].compute_weights,
        n_contrib_equal=f"{agree_frac:.6f}", image_max_abs_err=img_err,
        weights_max_abs_err=w_err, k1_ms=f"{k1_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}")
    return {"max_abs_err": img_err, "ms": k1_ms, "plain_ms": plain_ms}


def check_k2(args, label: str, with_g_weights: bool, seed: int,
             k2_reps: int = 10, plain_reps: int = 3) -> dict:
    """K2 (from K1's walk state) against the plain backward on the same card
    inputs and a seeded cotangent; raises on disagreement."""
    binning, mean2d, conic, opacity, attrs, cfg = args
    out, walk = composite_cuda.composite_k1(*args)
    agree = out.n_contrib == composite_plain(*args).n_contrib
    agree_frac = float(agree.float().mean())
    if agree_frac < COUNT_AGREE:
        raise AssertionError(f"{label}: n_contrib equal on {agree_frac:.6f} "
                             f"of pixels < {COUNT_AGREE}")
    gen = torch.Generator(device=attrs.device).manual_seed(seed)
    g_image = torch.randn(out.image.shape, generator=gen,
                          device=attrs.device) * agree[..., None]
    g_weights = (torch.randn((attrs.shape[0],), generator=gen,
                             device=attrs.device) if with_g_weights else None)
    k2_args = (binning, mean2d, conic, opacity, attrs, walk, g_image,
               g_weights, cfg)
    got = composite_cuda.composite_k2(*k2_args)
    torch.cuda.synchronize()
    plain_args = (binning, mean2d, conic, opacity, attrs, g_image, g_weights,
                  cfg)
    want = composite_backward(*plain_args)
    torch.cuda.synchronize()
    rel, abs_err = {}, 0.0
    for name, g, w in zip(("mean2d", "conic", "opacity", "attrs"), got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: K2 d{name} not finite")
        diff = float((g - w).abs().max())
        rel[name] = diff / max(float(w.abs().max()), 1e-30)
        abs_err = max(abs_err, diff)
    if max(rel.values()) > K2_TOL:
        raise AssertionError(f"{label}: K2 against the plain backward, max "
                             f"relative error {rel} > {K2_TOL}")
    k2_ms = cuda_ms(lambda: composite_cuda.composite_k2(*k2_args), k2_reps)
    plain_ms = cuda_ms(lambda: composite_backward(*plain_args), plain_reps)
    say(label, pairs=binning.num_rendered, gaussians=attrs.shape[0],
        attrs=attrs.shape[1], g_weights=with_g_weights,
        n_contrib_equal=f"{agree_frac:.6f}",
        pixels_masked=int((~agree).sum()),
        max_rel_err={k: f"{v:.3e}" for k, v in rel.items()},
        max_abs_err=f"{abs_err:.3e}", k2_ms=f"{k2_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}")
    return {"max_abs_err": abs_err, "ms": k2_ms, "plain_ms": plain_ms}


def random_pcd(n: int, seed: int, device):
    """The random initial cloud of scene/dataset_readers.py:85-95: points
    uniform in [-1.3, 1.3]^3, SH-DC values uniform in [0, 1/255] written as
    8-bit colours (so about 0.498 grey), random unit normals."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((n, 3)) * (PCD_HI - PCD_LO) + PCD_LO
    shs = rng.random((n, 3)) / 255.0
    colors = ((shs * C0 + 0.5) * 255).astype(np.uint8) / 255.0
    normals = rng.standard_normal((n, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return [torch.as_tensor(x, dtype=torch.float32, device=device)
            for x in (xyz, colors, normals)]


def train_phase(gt_model: GaussianModel, size: int, n_views: int, n_init: int,
                opt: OptimizationConfig, device) -> dict:
    """Stage-1 training through run_training_schedule; returns the trained
    model, its optimizer, views, raster config and extent, and K1's and K2's
    launches during the schedule."""
    cfg = RasterConfig(size, size, compute_weights=True)
    views = []
    with torch.no_grad():             # ground truth: the port's render (K1)
        for i in range(n_views):
            v = orbit_view(i, n_views, size, device)
            res = render(v, gt_model, cfg, torch.zeros(3, device=device))
            views.append(v._replace(image=res["render"],
                                    image_mask=(res["opacity"] > 0.5).float()))
    model = create_from_pcd(*random_pcd(n_init, SEED + 2, device))
    # getNerfppNorm: 1.1 x the largest camera distance from their centre
    extent = 1.1 * CAM_RADIUS
    optimizer = make_optimizer(model, opt, extent)
    timer = StepTimer()
    steps, densified = [], []

    def callback(it, metrics):
        steps.append((it, metrics["loss"], metrics["psnr"],
                      metrics["num_rendered"]))
        if "densify" in metrics:
            densified.append((it, metrics["densify"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_cuda.LAUNCHES = composite_cuda.BWD_LAUNCHES = 0
    generator = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    run_training_schedule(model, optimizer, views, cfg=cfg, opt=opt,
                          spatial_lr_scale=extent, extent=extent,
                          generator=generator, callback=callback, seed=SEED,
                          timer=timer)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {"K1": composite_cuda.LAUNCHES, "K2": composite_cuda.BWD_LAUNCHES}

    n_steps = opt.iterations
    loss = np.array([float(m[1]) for m in steps])
    psnr = np.array([float(m[2]) for m in steps])
    pairs = np.array([m[3] for m in steps])
    if len(steps) != n_steps or not np.isfinite(loss).all():
        raise AssertionError(f"train: {len(steps)} steps, non-finite loss at "
                             f"{np.flatnonzero(~np.isfinite(loss))[:5]}")
    if launches["K1"] != n_steps or launches["K2"] != n_steps:
        raise AssertionError(f"train: {n_steps} steps launched K1 "
                             f"{launches['K1']} and K2 {launches['K2']} times")
    first, last = psnr[:n_views].mean(), psnr[-n_views:].mean()
    if not last > first:
        raise AssertionError(f"train: PSNR did not rise ({first} -> {last})")
    if len(densified) < 2:
        raise AssertionError(f"train: {len(densified)} densify calls")
    split = timer.split_ms()[1:]       # step 1 is the warm-up
    med = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    say("train", size=f"{size}x{size}", views=n_views, init_points=n_init,
        steps=n_steps, k1_launches=launches["K1"],
        k2_launches=launches["K2"], final_points=model.num_points,
        extent=extent, host_s=f"{host_s:.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    say("train-time", ms_per_step_median=f"{med['total']:.3f}",
        forward_ms=f"{med['forward']:.3f}", backward_ms=f"{med['backward']:.3f}",
        optimizer_and_stats_ms=f"{med['optimizer']:.3f}",
        host_ms_per_step=f"{host_s * 1e3 / n_steps:.3f}",
        pairs_first=int(pairs[0]), pairs_median=int(np.median(pairs)),
        pairs_last=int(pairs[-1]), pairs_max=int(pairs.max()))
    say("train-quality", loss_first=f"{loss[0]:.5f}", loss_last=f"{loss[-1]:.5f}",
        psnr_first=f"{psnr[0]:.3f}", psnr_last=f"{psnr[-1]:.3f}",
        psnr_first_views_mean=f"{first:.3f}", psnr_last_views_mean=f"{last:.3f}")
    say("train-densify", points_after=[(it, d.n_active) for it, d in densified],
        cloned=[d.n_cloned for _, d in densified],
        split=[d.n_split for _, d in densified],
        pruned=[d.n_pruned for _, d in densified],
        opacity_reset_at=[i for i in range(1, n_steps + 1)
                          if i < opt.densify_until_iter
                          and i % opt.opacity_reset_interval == 0])
    return {"model": model, "optimizer": optimizer, "views": views, "cfg": cfg,
            "extent": extent, "launches": launches}


def profile_phase(trained: dict, opt: OptimizationConfig) -> None:
    """Three windows of PROFILE_STEPS train steps each, continuing the trained
    model past the schedule's end (no densify): no profiler; torch.profiler
    with device activity only, whose kernel time and the window's stream
    time (CUDA events from the first step's start to the last step's end)
    give the busy share; host and device activity, for aten ops and kernel
    launches per step and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    model, views = trained["model"], trained["views"]
    it = opt.iterations

    def window(prof=None):
        nonlocal it
        timer = StepTimer()
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            it += 1
            train_step(model, trained["optimizer"], views[it % len(views)], it,
                       cfg=trained["cfg"], opt=opt,
                       spatial_lr_scale=trained["extent"], timer=timer)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
        if prof is not None:
            prof.stop()
        stream_ms = timer.steps[0]["start"].elapsed_time(
            timer.steps[-1]["end"]) / PROFILE_STEPS
        return stream_ms, host_ms

    def device_events(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    plain_ms, plain_host_ms = window()
    dev_prof = profile(activities=[ProfilerActivity.CUDA])
    dev_ms, dev_host_ms = window(dev_prof)
    kernels = device_events(dev_prof)
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILE_STEPS
    if kernel_ms <= 0:
        raise AssertionError("profile: the profiler recorded no device time")
    full_prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    full_ms, full_host_ms = window(full_prof)
    events = full_prof.key_averages()
    aten_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    launches = sum(e.count for e in device_events(full_prof))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    say("profile", points=model.num_points, steps_per_window=PROFILE_STEPS,
        ms_per_step_no_profiler=f"{plain_ms:.3f}",
        host_ms_per_step_no_profiler=f"{plain_host_ms:.3f}",
        ms_per_step_device_profiler=f"{dev_ms:.3f}",
        host_ms_per_step_device_profiler=f"{dev_host_ms:.3f}",
        kernel_ms_per_step=f"{kernel_ms:.3f}",
        busy_share=f"{kernel_ms / dev_ms:.3f}",
        ms_per_step_full_profiler=f"{full_ms:.3f}",
        host_ms_per_step_full_profiler=f"{full_host_ms:.3f}",
        aten_ops_per_step=aten_ops / PROFILE_STEPS,
        device_ops_per_step=launches / PROFILE_STEPS)
    say("profile-kernels", ms_per_step=[
        (e.key[:60], round(e.self_device_time_total / 1e3 / PROFILE_STEPS, 4),
         e.count // PROFILE_STEPS) for e in top])


def main(device: str = "cuda:0") -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke needs an NVIDIA GPU")
    device = torch.device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=f"'{card}'")

    # 2. build K1 and K2 from the checkout's sources, one nvcc each, together
    t0 = time.perf_counter()
    kernels = (composite_cuda.KERNEL, composite_cuda.BWD_KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_build.load_library, kernels))
    say("build", kernels=list(kernels),
        build_s=f"{time.perf_counter() - t0:.2f}")

    with torch.no_grad():
        # 3. K1 against the plain version, mid-size scene
        mid = GaussianModel.from_numpy(make_scene(N_MID, SEED + 1, None),
                                       device=device)
        view = orbit_view(1, VIEWS, SIZE_MID, device)
        for weights in (True, False):
            cfg = RasterConfig(SIZE_MID, SIZE_MID, compute_weights=weights)
            check_k1(compositor_args(mid, view, cfg), "k1-mid")

        # 4. K2 against the plain backward, mid-size scene
        mid_args = compositor_args(mid, view, RasterConfig(SIZE_MID, SIZE_MID))
        for seed, with_g_weights in enumerate((True, False)):
            check_k2(mid_args, "k2-mid", with_g_weights, seed)

        # 5. the render slice: checkpoint → load_checkpoint → render, 8 views
        t0 = time.perf_counter()
        scene = make_scene(N_MAIN, SEED)
        WORK.mkdir(parents=True, exist_ok=True)
        ckpt = WORK / f"scene_{N_MAIN}.npz"
        save_checkpoint(str(ckpt), 0, GaussianModel.from_numpy(scene))
        _, model = load_checkpoint(str(ckpt), device=device)
        setup_s = time.perf_counter() - t0
        cfg = RasterConfig(SIZE_MAIN, SIZE_MAIN, compute_pseudo_normal=True)
        bg = torch.zeros(3, device=device)
        views = [orbit_view(i, VIEWS, SIZE_MAIN, device) for i in range(VIEWS)]
        torch.cuda.synchronize()

        composite_cuda.LAUNCHES = composite_cuda.BWD_LAUNCHES = 0
        results, events = [], []
        t0 = time.perf_counter()
        for v in views:                 # view 0 is the warm-up
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
            results.append(render(v, model, cfg, bg))
            events[-1][1].record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        render_launches = (composite_cuda.LAUNCHES, composite_cuda.BWD_LAUNCHES)
        view_ms = [a.elapsed_time(b) for a, b in events]
        steady_ms = float(np.median(view_ms[1:]))

        if render_launches != (VIEWS, 0):
            raise AssertionError(f"K1, K2 launched {render_launches} times for "
                                 f"{VIEWS} views")
        rendered = []
        for i, res in enumerate(results):
            for key in ("render", "opacity", "depth", "normal", "pseudo_normal"):
                x = res[key]
                if x.shape[-2:] != (SIZE_MAIN, SIZE_MAIN) or not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"view {i}: {key} {tuple(x.shape)} not finite")
            covered = float((res["num_contrib"] > 0).float().mean())
            if res["num_rendered"] <= 0 or covered < 0.05 or float(res["opacity"].max()) < 0.5:
                raise AssertionError(f"view {i}: empty render (covered {covered})")
            if res["weights"].shape != (N_MAIN, 1) or float(res["weights"].sum()) <= 0:
                raise AssertionError(f"view {i}: no per-gaussian weights")
            rendered.append(res["num_rendered"])
        say("slice", gaussians=model.num_points, size=f"{SIZE_MAIN}x{SIZE_MAIN}",
            views=VIEWS, setup_s=f"{setup_s:.2f}", k1_launches=render_launches[0],
            num_rendered=rendered, steady_ms_per_view=f"{steady_ms:.3f}",
            fps=f"{1e3 / steady_ms:.2f}",
            view_ms=[round(ms, 3) for ms in view_ms],
            host_ms_all_views=f"{host_ms:.1f}",
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

        # 6. K1 against the plain version at the render's shapes
        main_k1 = check_k1(compositor_args(model, views[0], cfg), "k1-main")

    # 7. the training slice
    trained = train_phase(model, SIZE_MAIN, VIEWS, N_INIT, TRAIN_OPT, device)
    launches = trained["launches"]
    # 8. K2 against the plain backward at the train step's shapes
    with torch.no_grad():
        main_k2 = check_k2(compositor_args(
            trained["model"], orbit_view(0, VIEWS, SIZE_MAIN, device),
            RasterConfig(SIZE_MAIN, SIZE_MAIN)), "k2-main", False, 7)
    # 9. where a train step's time goes
    profile_phase(trained, TRAIN_OPT)

    print(json.dumps({"kernels": [
        {"name": "K1 composite_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["K1"], **main_k1},
        {"name": "K2 composite_bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"], **main_k2}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
