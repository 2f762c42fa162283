"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Drives the port's main path, the stage-1 render of a checkpoint, through the
entry points a user calls, and checks every kernel on that path against its
plain PyTorch version. Phases (each prints one line; any failure raises, so
the exit code is non-zero and no result line is printed):

  1. device   needs torch.cuda; prints the card's name and power limit;
  2. build    compiles kernel K1 (csrc/composite_fwd.cu) with nvcc;
  3. k1-mid   K1 against the plain compositor on a seeded 20k-gaussian
              400x400 scene, with and without per-gaussian weights;
  4. slice    builds a seeded 100k-gaussian scene, saves it as a JAX-format
              checkpoint, loads it with train.checkpoint.load_checkpoint and
              renders 8 orbit views at 800x800 through models.render.render;
              K1 must launch once per view;
  5. k1-main  K1 against the plain compositor on the first view's inputs
              (the main path's shapes), timed beside it.

The card's render against the CPU path, which tests/test_torch_*.py tie to
the JAX package, is checked by tests/test_torch_cuda.py.

The line before the last holds the kernels' numbers; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel
from relightable3dgaussian_tpu_torch.models.render import (ViewInputs, render,
                                                           view_features)
from relightable3dgaussian_tpu_torch.ops import _build, composite_cuda
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.composite import composite as composite_plain
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.rasterize import prepare
from relightable3dgaussian_tpu_torch.train.checkpoint import (load_checkpoint,
                                                              save_checkpoint)
from relightable3dgaussian_tpu_torch.utils.sh import rgb_to_sh

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 0
N_MAIN, SIZE_MAIN, VIEWS = 100_000, 800, 8
N_MID, SIZE_MID = 20_000, 400
CAM_RADIUS, FOV = 3.0, 0.9
K1_SOURCE = "relightable3dgaussian_tpu_torch/csrc/composite_fwd.cu"
K1_REPLACES = "relightable3dgaussian_tpu/ops/composite_pallas.py:45"
# K1 against the plain version. Image: float32 sums in the same order, but
# the card's FMA contraction rounds differently. n_contrib: alpha = 1/255 and
# T = 1e-4 are threshold crossings a last-bit change can move, so equal on
# >= 99.99% of pixels, and the image is compared where it is equal. Weights:
# the atomics add in another order.
IMG_ATOL = IMG_RTOL = 1e-5
COUNT_AGREE = 0.9999
W_RTOL, W_ATOL = 1e-4, 1e-6


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
    got = composite_cuda.composite_k1(*args)
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

    # 2. build K1 from the checkout's sources
    t0 = time.perf_counter()
    _build.load_library(composite_cuda.KERNEL)
    say("build", kernel=composite_cuda.KERNEL,
        build_s=f"{time.perf_counter() - t0:.2f}")

    with torch.no_grad():
        # 3. K1 against the plain version, mid-size scene
        mid = GaussianModel.from_numpy(make_scene(N_MID, SEED + 1, None),
                                       device=device)
        view = orbit_view(1, VIEWS, SIZE_MID, device)
        for weights in (True, False):
            cfg = RasterConfig(SIZE_MID, SIZE_MID, compute_weights=weights)
            check_k1(compositor_args(mid, view, cfg), "k1-mid")

        # 4. the slice: checkpoint → load_checkpoint → render, 8 views
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

        composite_cuda.LAUNCHES = 0
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
        launches = composite_cuda.LAUNCHES
        view_ms = [a.elapsed_time(b) for a, b in events]
        steady_ms = float(np.median(view_ms[1:]))

        if launches != VIEWS:
            raise AssertionError(f"K1 launched {launches} times for {VIEWS} views")
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
            views=VIEWS, setup_s=f"{setup_s:.2f}", k1_launches=launches,
            num_rendered=rendered, steady_ms_per_view=f"{steady_ms:.3f}",
            fps=f"{1e3 / steady_ms:.2f}",
            view_ms=[round(ms, 3) for ms in view_ms],
            host_ms_all_views=f"{host_ms:.1f}",
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

        # 5. K1 against the plain version at the main path's shapes
        main_k1 = check_k1(compositor_args(model, views[0], cfg), "k1-main")

    print(json.dumps({"kernels": [{
        "name": "K1 composite_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches, **main_k1}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
