"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py
[--ptxas-also OTHER_KERNEL_CU ...]

Drives the port's main paths, the stage-1 render of a checkpoint, stage-1
training and stage-2 (PBR) training with its eval render, through the entry
points a user calls, and checks every kernel on those paths against its
plain PyTorch version. Phases, in the order they run (each prints one line,
the train phases a few; any failure raises, so the exit code is non-zero and
no result line is printed):

  1. device   needs torch.cuda; prints the card's name and power limit;
  2. build    compiles kernels K1 (csrc/composite_fwd.cu), K2
              (csrc/composite_bwd.cu), K3 (csrc/ray_trace.cu), K4
              (csrc/shading.cu) and K5 (csrc/composite_bwd_two_walk.cu)
              with nvcc, all at once, and prints ptxas's registers, spills
              and shared memory for csrc/ray_trace.cu and
              csrc/composite_bwd_two_walk.cu and for each source given with
              --ptxas-also (another version of one, to compare);
  3. k1-mid   K1 against the plain compositor on a seeded 20k-gaussian
              400x400 scene (opacities in [0.1, 0.99]), with and without
              per-gaussian weights; the weights of the tiles that hold a
              split pixel (K1 and the plain walk end apart: count, stop or
              final T, ops/composite.py::split_pixels) are held to the
              count-split rule, every other weight to W_RTOL, W_ATOL;
  4. k2-mid   K2 against the plain backward (ops/composite.py::
              composite_backward) on the same scene, with a seeded image
              cotangent (zero on pixels where K1 and the plain compositor
              blend other pairs: their n_contrib or their images differ),
              with and without a weights cotangent;
     k5-mid   K5, the two-walk backward, against the plain backward under
              K2's gate on the same inputs, timed beside K2 and the plain
              backward; its count of blended pairs against K1's n_contrib;
  5. k3-mid   K3 against the plain tracer (ops/ray_trace.py::
              trace_transmittance_plain) on every ray of the same scene, 16
              rays per point as update_visibility lays them out, timed
              beside it;
  6. k4-mid   K4 forward and backward against the plain shading (ops/
              shading_cuda.py::rendering_equation_train_reference, and it in
              float64) at 20k points, 16 samples, on seeded inputs: mixed
              roughness, all-zero visibility at the roughness bounds 0.09
              and 0.99, and all-zero local-light SH (whose gradient must
              reach the SH);
  7. slice    builds a seeded 100k-gaussian scene, saves it as a JAX-format
              checkpoint, loads it with train.checkpoint.load_checkpoint and
              renders 8 orbit views at 800x800 through models.render.render;
              K1 must launch once per view;
  8. k1-main  K1 against the plain compositor on the first view's inputs
              (the render's shapes), timed beside it;
  9. train    stage-1 training at 800x800: ground truth rendered by the port
              from the 100k-gaussian scene of phase 7 over 8 orbit views, a
              model made by train.create_from_pcd from 100k random points
              as scene/dataset_readers.py makes them, and
              train.stage1.run_training_schedule with STAGE1_NERF_SYNTHETIC,
              compressed to hold densify calls and an opacity reset; K1 and
              K2 must launch once per step, the loss stay finite and the
              PSNR rise;
 10. k2-main  K2 against the plain backward at the train step's shapes (the
              trained model after its last densify, 800x800), timed beside it;
     k2-views K2 as in k2-main on the trained model's 7 other views, under
              k2-main's gate;
     k5-main  K5 as in k5-mid, on k2-main's inputs;
 11. profile  three windows of further train steps of the trained model:
              without a profiler (ms per step), under torch.profiler with
              device activity only (kernel ms against the window's stream
              ms: the device's busy share), and with host activity too
              (aten ops and kernel launches per step, the largest kernels);
 12. stage2   the trained model through save_checkpoint, load_checkpoint
              and train.stage2.setup_stage2 (PBR fields, K3 over P x 64
              rays, a 16x32 env map), then train.stage2.
              run_training_schedule for 200 steps from the stage-1 count
              with STAGE2_NERF_SYNTHETIC and no densify, on the train
              phase's views; K1, K2, K4-fwd and K4-bwd must launch once per
              step, K3 at least once, the loss stay finite and the PBR
              PSNR rise;
     k12-stage2  K1 and K2 at the stage-2 train width (A = 8) and K1 at the
              eval width (A = 32), each against its plain version and timed
              beside it, on the inputs render_neilf hands the compositor for
              the stage's trained model and first view;
 13. k3-main  K3 against the plain tracer on a seeded subset of the stage's
              rays, both timed, and K3 timed on all of them: in coherent
              order with the sort (the main path), the sort alone, in the
              order visibility_rays gives, and sample-major; its bound
              counted on all of them;
 14. k4-main  K4 against the plain shading at the train step's shapes;
 15. stage2-eval  models.render_neilf.render_neilf(is_training=False) of
              the 8 views at 800x800 (32 splatted channels);
 16. stage2-profile  two windows of further stage-2 steps: without a
              profiler, and under the device-only profiler (kernel ms per
              step, the largest kernels, and K4-fwd's and K4-bwd's device
              ms a step whatever their rank);
 17. cli      the README's commands through the CLIs' main functions: a
              NeRF-synthetic-layout scene (24 train and 8 test views at
              800x800, RGBA PNGs written by the port's own PNG writer from
              its render of phase 7's scene), cli.train stage 1 from the 100k
              random init for 300 steps on the train phase's schedule with
              R3DG_BWD_TWO_WALK=1 (K5 once per step, K2 never), cli.train
              -t neilf from its checkpoint for 200 steps (a visibility
              refresh, an env-map upsample), and cli.eval_nvs -t neilf on
              the test views; every artifact, the launch counts and rising
              test PSNRs are checked.
 18. relight  cli.relighting.main: the cli phase's stage-2 PLY and the
              stage2 phase's model (written by save_gaussian_ply) composed
              side by side at half scale, one turned a quarter (~193k
              points), visibility traced at 64 samples (K3 once), 8 frames
              at 800x800 under a procedural 256x512 sky-and-sun map written
              by write_exr_zip, the light rotated each frame (K1 once a
              frame); every PNG; K3's T on 65,536 of the traced rays (the
              last 1024 included) against the plain tracer under k3-main's
              gate, K1 on the first frame's inputs under k1-main's
              (relight-k3, relight-k1); on cloud A's rays the composite's
              visibility nowhere above A's alone and lower on some; a
              --vis_one run no darker at any pbr_env pixel; env_only moved
              by the light rotation alone;
 19. relight-eval  cli.eval_relighting_syn4.main with LPIPS_WEIGHTS=random
              on a Synthetic4Relight layout of the cli phase's 8 test views
              (its RGBA images as the relit ground truth, constant albedo
              and roughness), the cli phase's stage-2 checkpoint under a
              model path holding /hotdog/, two procedural maps, 384 samples
              (~35M rays in one K3 launch, K1 16 times): K3 and K1 held as
              in relight (relight-eval-k3, relight-eval-k1), both metric.txt
              whole and finite, the two maps' renders apart;
 20. finetune-vis  train.stage2.finetune_visibility, 50 iterations on the
              stage2 phase's model: K3 once an iteration, losses finite.

Every kernel's entry in the kernels line carries its bound: the larger of
the bytes it must move (each input read once, each output written once) over
the H100's 3.35 TB/s and the FP32 operations it does on this run's inputs
over 67 TFLOP/s (the H100 SXM's published peak rates).

The card's render and train steps against the CPU path, which
tests/test_torch_*.py tie to the JAX package, are checked by
tests/test_torch_cuda.py.

The line before the last holds the kernels' numbers; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from relightable3dgaussian_tpu_torch.cli import (eval_nvs,
                                                 eval_relighting_syn4,
                                                 relighting)
from relightable3dgaussian_tpu_torch.cli import train as train_cli
from relightable3dgaussian_tpu_torch.models.gaussians import (GaussianModel,
                                                              create_from_pcd)
from relightable3dgaussian_tpu_torch.losses import lpips
from relightable3dgaussian_tpu_torch.models import render_neilf as neilf
from relightable3dgaussian_tpu_torch.models.lights import (load_env_light,
                                                           query_light)
from relightable3dgaussian_tpu_torch.models.render import (ViewInputs, render,
                                                           view_features)
from relightable3dgaussian_tpu_torch.models.render_neilf import (
    EVAL_FEATURE_DIM, render_neilf, update_visibility, visibility_rays)
from relightable3dgaussian_tpu_torch.ops import (_build, composite_cuda,
                                                 ray_trace, ray_trace_cuda,
                                                 shading_cuda)
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.composite import composite as composite_plain
from relightable3dgaussian_tpu_torch.ops.composite import (composite_backward,
                                                          split_pixels,
                                                          walk_state)
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.rasterize import prepare
from relightable3dgaussian_tpu_torch.scene.cameras import Camera
from relightable3dgaussian_tpu_torch.scene.dataset_readers import _blender_pose
from relightable3dgaussian_tpu_torch.scene.exr import write_exr_zip
from relightable3dgaussian_tpu_torch.scene.image_io import read_png, write_png
from relightable3dgaussian_tpu_torch.scene.ply_io import save_gaussian_ply
from relightable3dgaussian_tpu_torch.train.checkpoint import (load_checkpoint,
                                                              save_checkpoint)
from relightable3dgaussian_tpu_torch.train import stage2
from relightable3dgaussian_tpu_torch.train.config import (
    STAGE1_NERF_SYNTHETIC, STAGE2_NERF_SYNTHETIC, ModelConfig,
    OptimizationConfig, PipelineConfig)
from relightable3dgaussian_tpu_torch.train.optim import (make_env_optimizer,
                                                         make_optimizer,
                                                         start_state)
from relightable3dgaussian_tpu_torch.train.stage1 import (StepTimer,
                                                          run_training_schedule,
                                                          train_step)
from relightable3dgaussian_tpu_torch.utils.graphics import \
    fibonacci_sphere_sampling
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
# the atomics add in another order. A pixel whose count differs moved one
# crossing by one pair: at T = 1e-4 that pair's w = alpha T < 1e-4; at
# alpha = 1/255 its w = T / 255 and the 1/255 it takes from the T of every
# later pair, at most 2/255 in all. Such a pair blended on one side only can
# leave the counts equal, where the T = 1e-4 end moves one pair the other
# way: so the split pixels are those where the two walks' counts, stops or
# final T differ (ops/composite.py::split_pixels). Only gaussians with a
# pair in a split pixel's tile can move: every other weight is held to
# W_RTOL, W_ATOL, and those of the tiles that differ by more may differ by
# at most 2/255 in sum for each split pixel.
IMG_ATOL = IMG_RTOL = 1e-5
COUNT_AGREE = 0.9999
W_RTOL, W_ATOL = 1e-4, 1e-6
# K2 against the plain backward, per gradient field: max |diff| <= K2_TOL ·
# max |plain|. Both sum over pixels in another order (K2 with atomics). K2
# decides "blended" by K1's stop index where the plain version tests
# T >= 1e-4, so where a last-bit change moves that crossing (a pixel whose
# K1 and plain n_contrib differ, held to COUNT_AGREE as for K1) one pixel
# moves a gradient by ~1e-4 of its max on a trained, near-opaque model:
# the image cotangent is zeroed on those pixels for both. So it is where the
# counts are equal but the blended pairs are not: a pair at alpha ~ 1/255
# blended by one side only moves T by 1/255, and with it the T = 1e-4
# crossing by one pair the other way, so both blend as many pairs but not
# the same ones (one view in ~100 of a trained model, 3.5e-4 of mean2d's
# max with the count mask alone). Those pixels are K1's split pixels, and,
# as before, the pixels whose images differ past IMG_ATOL, IMG_RTOL.
K2_TOL = 1e-4
PROFILE_STEPS = 10   # train steps in each window of the profile phases
K3_SOURCE = "relightable3dgaussian_tpu_torch/csrc/ray_trace.cu"
K3_REPLACES = "relightable3dgaussian_tpu/ops/ray_trace.py:488"
K4_SOURCE = "relightable3dgaussian_tpu_torch/csrc/shading.cu"
K4F_REPLACES = "relightable3dgaussian_tpu/ops/shading_pallas.py:252"
K4B_REPLACES = "relightable3dgaussian_tpu/ops/shading_pallas.py:261"
K5_SOURCE = "relightable3dgaussian_tpu_torch/csrc/composite_bwd_two_walk.cu"
K5_REPLACES = "relightable3dgaussian_tpu/ops/composite_pallas_bwd.py:45"
# A kernel's bound: the larger of the bytes it must move over the HBM rate and
# its FP32 operations over the rate outside the tensor cores (the H100 SXM's
# published peak rates, both at the 700 W power limit).
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12
# FP32 operations per (pixel, pair), counted from the compositor sources.
# Walking a pair is the alpha step (dx, dy, the power, expf, alpha, the two
# tests): 15. A blended pair adds, in K1, w, the T update and A FMAs (3 + 2A);
# in K2 the T division, w, d (2A), g_alpha, the suffix, the chain into the 6
# geometry gradients and g_attr (27 + 3A). K5 computes K2's function and is
# bound by K2's count (its second walk is its design's cost, not the
# function's). The pairs walked per pixel are K1's stop indices.
WALK_OPS = 15
# FP32 operations per tested (ray, gaussian) pair of K3 (g - o, the two
# 3x3 products, t, the residual, the power, expf, alpha, the tests, the
# product): 72, counted from csrc/ray_trace.cu. Counted only on the rays that
# end visible (K3's T on this run's rays): every implementation must test
# all their pairs, where an occluded ray may stop early.
K3_PAIR_OPS = 72
# FP32 operations per (point, sample) of K4, counted from the plain shading's
# formula (SH incident light 126, the env mix, half vector and dots 38, GGX
# and Fresnel 40, Lambert and the sums 16): 220 forward; the backward
# recomputes the forward and chains through it, about 3x.
K4_FWD_OPS, K4_BWD_OPS = 220, 660
S_MID = 16                                   # samples per point, mid phases
SAMPLE_NUM = PipelineConfig().sample_num     # 64
ENV_RES = ModelConfig().env_resolution       # 16: a 16x32 env map
# Stage 2 continues stage 1's count for STAGE2_STEPS steps; densify ends where
# it starts, so stage 2 never densifies (the reference protocol: stage 2
# starts at 30k, past densify_until_iter).
STAGE2_STEPS = 200
STAGE2_OPT = OptimizationConfig(**{
    **STAGE2_NERF_SYNTHETIC, "iterations": TRAIN_OPT.iterations + STAGE2_STEPS,
    "densify_until_iter": TRAIN_OPT.iterations})
K3_SUBSET = 65_536   # rays of the stage's trace held against the plain tracer
K3_TAIL = 1024       # of them, a CLI trace's last rays (check_cli_kernels)
# K3 against the plain tracer. Both take the product of the same factors in
# another order: |dvis| <= VIS_ATOL where both T lie on the same side of 0.9;
# a last-bit change can move a T across 0.9, so at most SPLIT_SHARE of the
# rays may lie on different sides, each with its plain T within SPLIT_BAND of
# 0.9.
VIS_ATOL, SPLIT_SHARE, SPLIT_BAND = 1e-5, 1e-4, 1e-4
# K4 against the plain shading. At the GGX peak of a smooth surface
# nom0 = 1 - NoH^2 (1 - alpha^2) cancels as NoH -> 1, so a last bit of NoH
# moves the specular term by ~1e-3 of itself and no two float32
# implementations agree there to the JAX suite's rtol 1e-4 / atol 1e-5
# (tests/test_shading_fused.py). So K4 and the plain float32 version are both
# held against the plain version in float64: K4 within that tolerance (the
# backward: per field within K4_BWD_TOL of the largest entry, sums over
# samples in another order), or within K4_SLACK times the plain float32
# version's own error, whichever is larger.
K4_RTOL, K4_ATOL, K4_BWD_TOL, K4_SLACK = 1e-4, 1e-5, 1e-4, 2.0


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, ops: float) -> dict:
    """The least time the H100 could take for work moving `n_bytes` and
    doing `ops` FP32 operations, and which of the two bounds it."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def compositor_inputs_bytes(args) -> int:
    binning, mean2d, conic, opacity, attrs, _ = args
    return nbytes(binning.sorted_ids, binning.tile_start, binning.tile_end,
                  mean2d, conic, opacity, attrs)


def pairs_walked(out, walk) -> tuple[int, int]:
    """(pixel-pair evaluations up to each pixel's stop, blended pairs)."""
    return int(walk.stop.sum()), int(out.n_contrib.sum())


def k1_split(args, got, walk) -> tuple:
    """The plain compositor on K1's inputs, and the pixels where K1 and it
    blended other pairs (split_pixels against the plain walk state)."""
    want = composite_plain(*args)
    want_walk = walk_state(*args[:4], args[-1])
    torch.cuda.synchronize()
    return want, split_pixels(got.n_contrib, walk, want.n_contrib, want_walk)


def check_k1(args, label: str, k1_reps: int = 10, plain_reps: int = 3) -> dict:
    """K1 against the plain compositor on the same card inputs; raises on
    disagreement. Returns the numbers for the kernels line."""
    got, walk = composite_cuda.composite_k1(*args)
    torch.cuda.synchronize()
    want, split = k1_split(args, got, walk)
    agree = got.n_contrib == want.n_contrib
    agree_frac = float(agree.float().mean())
    if agree_frac < COUNT_AGREE:
        raise AssertionError(f"{label}: n_contrib equal on {agree_frac:.6f} "
                             f"of pixels < {COUNT_AGREE}")
    torch.testing.assert_close(got.image[agree], want.image[agree],
                               atol=IMG_ATOL, rtol=IMG_RTOL)
    img_err = float((got.image[agree] - want.image[agree]).abs().max())
    # the gaussians with a pair in the range of a tile that holds a split
    # pixel; every other weight is held to W_RTOL, W_ATOL
    binning = args[0]
    starts, ends = binning.tile_start.tolist(), binning.tile_end.tolist()
    near = torch.zeros_like(got.weights, dtype=torch.bool)
    split_tiles = torch.nonzero(split.any(1)).flatten().tolist()
    for t in split_tiles:
        near[binning.sorted_ids[starts[t]:ends[t]].long()] = True
    torch.testing.assert_close(got.weights[~near], want.weights[~near],
                               rtol=W_RTOL, atol=W_ATOL)
    w_diff = (got.weights - want.weights).abs()
    moved = near & (w_diff > W_ATOL + W_RTOL * want.weights.abs())
    n_split = int(split.sum())
    w_err = float(w_diff[~moved].max())
    moved_sum = float(w_diff[moved].sum())
    if moved_sum > 2 / 255 * n_split:
        raise AssertionError(
            f"{label}: {int(moved.sum())} weights of the split pixels' tiles "
            f"off by {moved_sum} in sum (beyond {W_RTOL} rel, {W_ATOL} abs) "
            f"with {n_split} split pixels")

    k1_ms = cuda_ms(lambda: composite_cuda.composite_k1(*args), k1_reps)
    plain_ms = cuda_ms(lambda: composite_plain(*args), plain_reps)
    A = args[4].shape[1]
    walked, blended = pairs_walked(got, walk)
    bnd = bound(compositor_inputs_bytes(args) + nbytes(
        got.image, got.n_contrib, got.weights if args[-1].compute_weights
        else None, *walk), walked * WALK_OPS + blended * (3 + 2 * A))
    say(label, pairs=binning.num_rendered, tiles=args[-1].num_tiles,
        attrs=A, weights=args[-1].compute_weights,
        n_contrib_equal=f"{agree_frac:.6f}", image_max_abs_err=img_err,
        weights_max_abs_err=w_err, split_pixels=n_split,
        count_equal_splits=int((split & agree).sum()),
        split_tiles=len(split_tiles), weights_moved_by_splits=int(moved.sum()),
        weights_moved_sum=f"{moved_sum:.3e}", k1_ms=f"{k1_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", pixel_pairs_walked=walked,
        pixel_pairs_blended=blended, bound_ms=f"{bnd['bound_ms']:.4f}",
        bound_by=bnd["bound_by"])
    return {"max_abs_err": img_err, "ms": k1_ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None}


def backward_case(args, label: str, with_g_weights: bool, seed: int):
    """K1's forward and walk state on `args`, and a seeded cotangent whose
    image part is zero on the pixels where K1 and the plain compositor
    blended other pairs: split_pixels (their n_contrib, stops or final T
    differ), or their images differ past IMG_ATOL, IMG_RTOL (K2_TOL's
    note). The others, `agree`, are held to COUNT_AGREE. Returns (out,
    walk, agree, g_image, g_weights)."""
    attrs = args[4]
    out, walk = composite_cuda.composite_k1(*args)
    plain, split = k1_split(args, out, walk)
    agree = ~split & (
        (out.image - plain.image).abs()
        <= IMG_ATOL + IMG_RTOL * plain.image.abs()).all(-1)
    agree_frac = float(agree.float().mean())
    if agree_frac < COUNT_AGREE:
        raise AssertionError(f"{label}: K1 and the plain compositor agree "
                             f"on {agree_frac:.6f} of pixels < {COUNT_AGREE}")
    gen = torch.Generator(device=attrs.device).manual_seed(seed)
    g_image = torch.randn(out.image.shape, generator=gen,
                          device=attrs.device) * agree[..., None]
    g_weights = (torch.randn((attrs.shape[0],), generator=gen,
                             device=attrs.device) if with_g_weights else None)
    return out, walk, agree, g_image, g_weights


def grad_errors(label: str, kernel: str, got, want) -> tuple[dict, float]:
    """Per gradient field max |got - want| / max |want|, and the largest
    absolute difference; raises where a field is not finite."""
    rel, abs_err = {}, 0.0
    for name, g, w in zip(("mean2d", "conic", "opacity", "attrs"), got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: {kernel} d{name} not finite")
        diff = float((g - w).abs().max())
        rel[name] = diff / max(float(w.abs().max()), 1e-30)
        abs_err = max(abs_err, diff)
    return rel, abs_err


def check_k2(args, label: str, with_g_weights: bool, seed: int,
             k2_reps: int = 10, plain_reps: int = 3) -> dict:
    """K2 (from K1's walk state) against the plain backward on the same card
    inputs and a seeded cotangent; raises on disagreement."""
    binning, mean2d, conic, opacity, attrs, cfg = args
    out, walk, agree, g_image, g_weights = backward_case(
        args, label, with_g_weights, seed)
    k2_args = (binning, mean2d, conic, opacity, attrs, walk, g_image,
               g_weights, cfg)
    got = composite_cuda.composite_k2(*k2_args)
    torch.cuda.synchronize()
    plain_args = (binning, mean2d, conic, opacity, attrs, g_image, g_weights,
                  cfg)
    want = composite_backward(*plain_args)
    torch.cuda.synchronize()
    rel, abs_err = grad_errors(label, "K2", got, want)
    if max(rel.values()) > K2_TOL:
        raise AssertionError(f"{label}: K2 against the plain backward, max "
                             f"relative error {rel} > {K2_TOL}")
    k2_ms = cuda_ms(lambda: composite_cuda.composite_k2(*k2_args), k2_reps)
    plain_ms = cuda_ms(lambda: composite_backward(*plain_args), plain_reps)
    A = attrs.shape[1]
    walked, blended = pairs_walked(out, walk)
    bnd = bound(compositor_inputs_bytes(args) + nbytes(*walk, g_image,
                                                       g_weights, *got),
                walked * WALK_OPS + blended * (27 + 3 * A))
    say(label, pairs=binning.num_rendered, gaussians=attrs.shape[0],
        attrs=A, g_weights=with_g_weights,
        pixels_agree=f"{float(agree.float().mean()):.6f}",
        pixels_masked=int((~agree).sum()),
        max_rel_err={k: f"{v:.3e}" for k, v in rel.items()},
        max_abs_err=f"{abs_err:.3e}", k2_ms=f"{k2_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bnd['bound_ms']:.4f}",
        bound_by=bnd["bound_by"])
    return {"max_abs_err": abs_err, "ms": k2_ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None}


def check_k2_views(model: GaussianModel, device) -> None:
    """K2 against the plain backward on the trained model's other views
    (seeded image cotangents, no weights cotangent) under k2-main's gate:
    one line with each view's largest relative error over the gradient
    fields, and its masked pixels; raises where one exceeds K2_TOL."""
    worst, masked = [], []
    for v in range(1, VIEWS):
        args = compositor_args(model, orbit_view(v, VIEWS, SIZE_MAIN, device),
                               RasterConfig(SIZE_MAIN, SIZE_MAIN))
        _, walk, agree, g_image, _ = backward_case(args, f"k2-views {v}",
                                                   False, 7 + v)
        got = composite_cuda.composite_k2(*args[:5], walk, g_image, None,
                                          args[5])
        want = composite_backward(*args[:5], g_image, None, args[5])
        rel, _ = grad_errors(f"k2-views {v}", "K2", got, want)
        worst.append(max(rel.values()))
        masked.append(int((~agree).sum()))
    say("k2-views", views=list(range(1, VIEWS)),
        max_rel_err=[f"{e:.3e}" for e in worst], pixels_masked=masked)
    if max(worst) > K2_TOL:
        raise AssertionError(f"k2-views: K2 against the plain backward, max "
                             f"relative error {max(worst)} > {K2_TOL}")


def check_k5(args, label: str, with_g_weights: bool, seed: int,
             reps: int = 10, plain_reps: int = 3) -> dict:
    """K5, the two-walk backward, against the plain backward on the same
    card inputs and cotangent as check_k2 (K2's gate), with K2's error
    beside it; its count of blended pairs against K1's n_contrib (held to
    COUNT_AGREE, the share printed); K5, K2 and the plain backward timed in
    turns. Raises on disagreement."""
    binning, mean2d, conic, opacity, attrs, cfg = args
    out, walk, agree, g_image, g_weights = backward_case(
        args, label, with_g_weights, seed)
    count = torch.full_like(out.n_contrib, -1)
    k5_args = (binning, mean2d, conic, opacity, attrs, g_image, g_weights,
               cfg)
    got = composite_cuda.composite_k5(*k5_args, n_blended=count)
    k2_args = (binning, mean2d, conic, opacity, attrs, walk, g_image,
               g_weights, cfg)
    k2 = composite_cuda.composite_k2(*k2_args)
    torch.cuda.synchronize()
    want = composite_backward(*k5_args)
    torch.cuda.synchronize()
    count_equal = float((count == out.n_contrib).float().mean())
    if count_equal < COUNT_AGREE:
        raise AssertionError(f"{label}: K5's blended count equals K1's "
                             f"n_contrib on {count_equal:.6f} of pixels < "
                             f"{COUNT_AGREE}")
    rel, abs_err = grad_errors(label, "K5", got, want)
    rel_k2, _ = grad_errors(label, "K2", k2, want)
    if max(rel.values()) > K2_TOL:
        raise AssertionError(f"{label}: K5 against the plain backward, max "
                             f"relative error {rel} > {K2_TOL}")
    k5_ms = cuda_ms(lambda: composite_cuda.composite_k5(*k5_args), reps)
    k2_ms = cuda_ms(lambda: composite_cuda.composite_k2(*k2_args), reps)
    plain_ms = cuda_ms(lambda: composite_backward(*k5_args), plain_reps)
    k5_ms_again = cuda_ms(lambda: composite_cuda.composite_k5(*k5_args), reps)
    A = attrs.shape[1]
    walked, blended = pairs_walked(out, walk)
    # The work the VJP needs, K2's count: K5's second walk and its phase-A
    # sums are its design's, not the function's.
    bnd = bound(compositor_inputs_bytes(args) + nbytes(g_image, g_weights,
                                                       *got),
                walked * WALK_OPS + blended * (27 + 3 * A))
    say(label, pairs=binning.num_rendered, gaussians=attrs.shape[0],
        attrs=A, g_weights=with_g_weights,
        blended_count_equal_to_k1=f"{count_equal:.6f}",
        pixels_masked=int((~agree).sum()),
        k5_max_rel_err={k: f"{v:.3e}" for k, v in rel.items()},
        k2_max_rel_err={k: f"{v:.3e}" for k, v in rel_k2.items()},
        max_abs_err=f"{abs_err:.3e}", k5_ms=f"{k5_ms:.4f}",
        k5_ms_again=f"{k5_ms_again:.4f}", k2_ms=f"{k2_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bnd['bound_ms']:.4f}",
        bound_by=bnd["bound_by"])
    return {"max_abs_err": abs_err, "ms": k5_ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None}


def captured_compositor_args(fn) -> tuple:
    """The inputs fn() hands K1 at its first launch, as the entry point
    builds them (detached)."""
    captured, launch = [], composite_cuda.composite_k1

    def record(*args):
        captured.append(args)
        return launch(*args)

    composite_cuda.composite_k1 = record
    try:
        fn()
    finally:
        composite_cuda.composite_k1 = launch
    binning, *tensors, cfg = captured[0]
    return (binning, *(t.detach() for t in tensors), cfg)


@torch.no_grad()
def k12_stage2_phase(s2: dict) -> None:
    """K1 and K2 at the stage-2 train width and K1 at the eval width, each
    against its plain version under the k1-/k2-main gates, on what
    render_neilf gives the compositor for the stage's model and first view;
    raises on disagreement or on another width than 8 and 32."""
    view, model, env, vis = s2["views"][0], s2["model"], s2["env"], s2["vis"]
    bg = torch.zeros(3, device=view.image.device)
    train_args = captured_compositor_args(lambda: render_neilf(
        view, model, s2["cfg"], bg, env, vis, STAGE2_OPT, is_training=True))
    eval_args = captured_compositor_args(lambda: render_neilf(
        view, model, RasterConfig(SIZE_MAIN, SIZE_MAIN), bg, env, vis))
    widths = (train_args[4].shape[1], eval_args[4].shape[1])
    if widths != (8, 32):
        raise AssertionError(f"k12-stage2: widths {widths}, expected (8, 32)")
    check_k1(train_args, "k12-stage2")
    check_k2(train_args, "k12-stage2", False, 11)
    check_k1(eval_args, "k12-stage2")


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
    reset_launches()
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


def profile_phase(label: str, step, points: int, full: bool,
                  named: dict[str, str] | None = None) -> None:
    """Windows of PROFILE_STEPS calls of step(timer), each one train step
    continuing a trained model (no densify): no profiler; torch.profiler with
    device activity only, whose kernel time and the window's stream time
    (CUDA events from the first step's start to the last step's end) give
    the busy share; with `full`, host and device activity, for aten ops and
    kernel launches per step. Prints the readings, the largest kernels and
    the device ms and launches a step of each `named` kernel ({label: a
    substring of its name}), which must have run."""
    from torch.profiler import ProfilerActivity, profile

    def window(prof=None):
        timer = StepTimer()
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step(timer)
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
        raise AssertionError(f"{label}: the profiler recorded no device time")
    readings = dict(
        points=points, steps_per_window=PROFILE_STEPS,
        ms_per_step_no_profiler=f"{plain_ms:.3f}",
        host_ms_per_step_no_profiler=f"{plain_host_ms:.3f}",
        ms_per_step_device_profiler=f"{dev_ms:.3f}",
        host_ms_per_step_device_profiler=f"{dev_host_ms:.3f}",
        kernel_ms_per_step=f"{kernel_ms:.3f}",
        busy_share=f"{kernel_ms / dev_ms:.3f}")
    if full:
        full_prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        full_ms, full_host_ms = window(full_prof)
        events = full_prof.key_averages()
        readings.update(
            ms_per_step_full_profiler=f"{full_ms:.3f}",
            host_ms_per_step_full_profiler=f"{full_host_ms:.3f}",
            aten_ops_per_step=sum(e.count for e in events
                                  if e.key.startswith("aten::")) / PROFILE_STEPS,
            device_ops_per_step=sum(e.count for e in device_events(full_prof))
            / PROFILE_STEPS)
    say(label, **readings)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    say(f"{label}-kernels", ms_per_step=[
        (e.key[:60], round(e.self_device_time_total / 1e3 / PROFILE_STEPS, 4),
         e.count // PROFILE_STEPS) for e in top])
    if named:
        found = {}
        for name, part in named.items():
            hits = [e for e in kernels if part in e.key]
            if not hits:
                raise AssertionError(f"{label}: no device time for {name}")
            found[name] = (round(sum(e.self_device_time_total for e in hits)
                                 / 1e3 / PROFILE_STEPS, 4),
                           sum(e.count for e in hits) / PROFILE_STEPS)
        say(f"{label}-named", ms_and_launches_per_step=found)


def timed_ms(fn):
    """(fn(), its milliseconds): CUDA events around one run."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def visible_ray_pairs(bvh, o, d, T, chunk: int = 16384) -> int:
    """The (ray, gaussian) pairs the rays that end visible (T >= 0.9) test:
    every gaussian of each cluster they slab-hit (ops/ray_trace.py's rule)."""
    inv_d, pairs = ray_trace.safe_inverse(d), 0
    for i in range(0, o.shape[0], chunk):
        hit = ray_trace.slab_hit(bvh.cluster_lo, bvh.cluster_hi,
                                 o[i:i + chunk], inv_d[i:i + chunk])
        pairs += int(hit[T[i:i + chunk] >= ray_trace.T_MIN].sum())
    return pairs * ray_trace.CLUSTER_SIZE


def k3_bound(bvh, o, d, T) -> tuple[dict, int]:
    """K3's bound on rays o, d whose transmittance is T, and the visible
    rays' pairs it counts."""
    pairs = visible_ray_pairs(bvh, o, d, T)
    return bound(nbytes(o, d, T, bvh.records, bvh.cluster_lo, bvh.cluster_hi,
                        bvh.super_lo, bvh.super_hi), pairs * K3_PAIR_OPS), pairs


def k3_gate(T, T_plain, label: str) -> tuple[float, int, torch.Tensor]:
    """K3's transmittance T against the plain tracer's T_plain on the same
    rays: raises unless |dvis| <= VIS_ATOL where both lie on one side of
    0.9, and at most SPLIT_SHARE of the rays, each within SPLIT_BAND of 0.9,
    lie on different sides. Returns (max |dvis|, split rays, plain vis)."""
    side, side_plain = T >= ray_trace.T_MIN, T_plain >= ray_trace.T_MIN
    same = side == side_plain
    vis = torch.where(side, T, 0.0)
    vis_plain = torch.where(side_plain, T_plain, 0.0)
    err = float((vis - vis_plain)[same].abs().max()) if bool(same.any()) else 0.0
    split = ~same
    n_split = int(split.sum())
    far = int(((T_plain[split] - ray_trace.T_MIN).abs() >= SPLIT_BAND).sum())
    if err > VIS_ATOL or n_split > SPLIT_SHARE * T.numel() or far:
        raise AssertionError(f"{label}: K3 against the plain tracer: max "
                             f"|dvis| {err} (limit {VIS_ATOL}), {n_split} rays "
                             f"on different sides of 0.9, {far} of them with "
                             f"|T_plain - 0.9| >= {SPLIT_BAND}")
    return err, n_split, vis_plain


def check_k3(bvh, rays_o, rays_d, label: str, subset: int | None = None,
             seed: int = 0, reps: int = 5, samples: int = SAMPLE_NUM) -> dict:
    """K3 against the plain tracer on rays [R, 3] from their points (a seeded
    subset of `subset` rays, kept in their order, when given); raises on
    disagreement. K3 is timed on the checked rays and, with a subset, on all
    of them: in coherent order (the sort included, and the sort alone), in
    the order given, and sample-major (ray (s, p) of `samples` a point at
    s P + p, a layout that needs no sort); the bound counted on all rays."""
    o = rays_o + ray_trace.RAY_OFFSET * rays_d     # as trace_visibility does
    o_all, d_all = o, rays_d
    if subset is not None and subset < o.shape[0]:
        gen = torch.Generator().manual_seed(seed)
        idx = torch.randperm(o.shape[0], generator=gen)[:subset].sort().values
        o, rays_d = o[idx.to(o.device)], rays_d[idx.to(o.device)]
    T = ray_trace_cuda.trace_k3(bvh, o, rays_d)
    T_plain, plain_ms = timed_ms(
        lambda: ray_trace.trace_transmittance_plain(bvh, o, rays_d))
    err, n_split, vis_plain = k3_gate(T, T_plain, label)
    k3_ms = cuda_ms(lambda: ray_trace_cuda.trace_k3(bvh, o, rays_d), reps)
    k3_unsorted_ms = cuda_ms(
        lambda: ray_trace_cuda.trace_k3(bvh, o, rays_d, sort=False), reps)
    bnd, pairs = k3_bound(bvh, o, rays_d, T)
    extra, line = {}, {}
    if o_all.shape[0] != o.shape[0]:
        T_all = ray_trace_cuda.trace_k3(bvh, o_all, d_all)
        all_ms = cuda_ms(lambda: ray_trace_cuda.trace_k3(bvh, o_all, d_all),
                         reps)
        sort_ms = cuda_ms(lambda: ray_trace.coherent_order(bvh, o_all, d_all),
                          reps)
        given_ms = cuda_ms(lambda: ray_trace_cuda.trace_k3(
            bvh, o_all, d_all, sort=False), reps)
        o_sm, d_sm = (x.view(-1, samples, 3).transpose(0, 1).reshape(-1, 3)
                      for x in (o_all, d_all))
        sample_major_ms = cuda_ms(lambda: ray_trace_cuda.trace_k3(
            bvh, o_sm, d_sm, sort=False), reps)
        all_bnd, all_pairs = k3_bound(bvh, o_all, d_all, T_all)
        extra = {"rays_all": o_all.shape[0], "k3_ms_all_rays": f"{all_ms:.4f}",
                 "sort_ms_all_rays": f"{sort_ms:.4f}",
                 "k3_ms_all_rays_given_order": f"{given_ms:.4f}",
                 "k3_ms_all_rays_sample_major": f"{sample_major_ms:.4f}",
                 "visible_ray_pairs_all_rays": all_pairs,
                 "bound_ms_all_rays": f"{all_bnd['bound_ms']:.4f}",
                 "bound_by_all_rays": all_bnd["bound_by"]}
        line = {"rays_all": o_all.shape[0], "ms_all_rays": all_ms,
                "sort_ms_all_rays": sort_ms,
                "bound_ms_all_rays": all_bnd["bound_ms"]}
    say(label, gaussians=bvh.order.shape[0], rays=T.numel(),
        mean_vis=f"{float(vis_plain.mean()):.4f}",
        vis_zero_share=f"{float((vis_plain == 0).float().mean()):.4f}",
        max_abs_err=f"{err:.3e}", rays_split=n_split, k3_ms=f"{k3_ms:.4f}",
        k3_ms_given_order=f"{k3_unsorted_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", visible_ray_pairs=pairs,
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"], **extra)
    return {"max_abs_err": err, "ms": k3_ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None, **line}


def shading_case(P: int, S: int, seed: int, device, rough: float | None = None,
                 dark: bool = False, zero_shs: bool = False):
    """rendering_equation_train's inputs, seeded: unit normals and view
    directions, Fibonacci samples, roughness uniform in [0.05, 0.95] with the
    activation's bounds 0.09 and 0.99 on two points (or `rough` everywhere),
    visibility in [0, 1) (zero everywhere when `dark`), local-light SH
    0.3 N(0, 1) (zero, as at the stage-2 start, with `zero_shs`), global
    light in [0, 2)."""
    rng = np.random.default_rng(seed)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    normals = f(unit(P))
    dirs, areas = fibonacci_sphere_sampling(normals, S)
    roughness = rng.uniform(0.05, 0.95, (P, 1))
    roughness[-2:, 0] = (0.09, 0.99)
    if rough is not None:
        roughness[:] = rough
    vis = rng.uniform(size=(P, S, 1)) * (not dark)
    return (f(rng.uniform(size=(P, 3))), f(roughness), normals, f(unit(P)),
            f(0.3 * rng.normal(size=(P, 16, 3)) * (not zero_shs)),
            f(2.0 * rng.uniform(size=(P, S, 3))), f(vis), dirs, areas)


def train_shading_case(model: GaussianModel, env, vis, view: ViewInputs):
    """The inputs the stage-2 train step gives rendering_equation_train."""
    viewdirs = view.cam.campos[None, :] - model.xyz
    viewdirs = viewdirs / torch.clamp(
        torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
    return tuple(t.detach().contiguous() for t in (
        model.get_base_color, model.get_roughness, model.get_normal, viewdirs,
        model.get_incidents, query_light(env, vis.incident_dirs),
        vis.visibility, vis.incident_dirs, vis.incident_areas))


def k4_worst_points(x, got, plain, exact, n: int = 4) -> list[dict]:
    """For a K4 failure report: the n points where `got` is farthest from
    `exact` ([P, ...]), with the view-normal cosine in float32 and float64,
    the roughness, and the kernel's, the plain and the float64 values
    there."""
    far = (got.double() - exact).abs().reshape(got.shape[0], -1).amax(1)
    out = []
    for i in far.topk(min(n, far.numel())).indices.tolist():
        nrm, vd = x[2][i], x[3][i]
        cos32 = float((nrm / nrm.norm()) @ (vd / vd.norm()))
        n64, v64 = nrm.double(), vd.double()
        cos64 = float((n64 / n64.norm()) @ (v64 / v64.norm()))
        out.append({"point": i, "cos_nv32": f"{cos32:.3e}",
                    "cos_nv64": f"{cos64:.3e}",
                    "roughness": f"{float(x[1][i]):.4f}",
                    "got": got[i].flatten()[:3].tolist(),
                    "plain": plain[i].flatten()[:3].tolist(),
                    "exact": exact[i].flatten()[:3].tolist()})
    return out


def plain_shading_graph(x, cot):
    """The plain shading's forward under autograd: (leaves base_color,
    roughness, viewdirs, shs, global_light; Σ cot · outputs)."""
    leaves = [x[i].detach().clone().requires_grad_() for i in (0, 1, 3, 4, 5)]
    bc, rough, vdir, shs, gl = leaves
    outs = shading_cuda.rendering_equation_train_reference(
        bc, rough, x[2], vdir, shs, gl, *x[6:])
    return leaves, sum((c * o).sum() for c, o in zip(cot, outs))


def check_k4(x, label: str, seed: int, reps: int = 10, plain_reps: int = 3,
             min_dshs: float | None = None) -> tuple[dict, dict]:
    """K4-fwd and K4-bwd against the plain shading on the same inputs and a
    seeded cotangent, each held against the plain shading in float64 beside
    the plain float32 version's own error (K4_SLACK), and with `min_dshs`
    the SH gradient's largest entry above it; raises on disagreement.
    Returns the numbers for the kernels line, fwd and bwd."""
    P = x[0].shape[0]
    gen = torch.Generator().manual_seed(seed)
    cot = [torch.randn((P, 3), generator=gen).to(x[0].device) for _ in range(3)]
    x64, cot64 = [t.double() for t in x], [c.double() for c in cot]
    kin = shading_cuda.kernel_inputs(*x)
    got = shading_cuda.shade_fwd(*kin)
    dbc, drough, dvdir, dshs, dgl = shading_cuda.shade_bwd(*kin, *cot)
    got_g = (dbc, drough[:, None], dvdir, dshs.view(P, -1, 3), dgl)
    plain = shading_cuda.rendering_equation_train_reference(*x)
    exact = shading_cuda.rendering_equation_train_reference(*x64)
    with torch.enable_grad():
        leaves, loss = plain_shading_graph(x, cot)
        plain_g = torch.autograd.grad(loss, leaves)
        leaves64, loss64 = plain_shading_graph(x64, cot64)
        exact_g = torch.autograd.grad(loss64, leaves64)

    def fwd_err(a, e):
        return float(((a.double() - e).abs() / (K4_ATOL + K4_RTOL * e.abs())).max())

    def bwd_err(a, e):
        return float((a.double() - e).abs().max() / e.abs().max().clamp(min=1e-30))

    errs, abs_err = {}, {"fwd": 0.0, "bwd": 0.0}
    for kind, names, outs, plains, exacts, err, tol in (
            ("fwd", ("pbr", "diffuse", "specular"), got, plain, exact,
             fwd_err, 1.0),
            ("bwd", ("base_color", "roughness", "viewdirs", "shs", "gl"),
             got_g, plain_g, exact_g, bwd_err, K4_BWD_TOL)):
        for name, g, p, e in zip(names, outs, plains, exacts):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{label}: K4-{kind} {name} not finite")
            e_kernel, e_plain = err(g, e), err(p, e)
            errs[f"{kind}.{name}"] = (f"{e_kernel:.3e}", f"{e_plain:.3e}")
            if e_kernel > max(tol, K4_SLACK * e_plain):
                raise AssertionError(
                    f"{label}: K4-{kind} {name} is {e_kernel} from float64, "
                    f"the plain float32 version {e_plain} (limit "
                    f"max({tol}, {K4_SLACK} x that)); worst points "
                    f"{k4_worst_points(x, g, p, e)}")
            abs_err[kind] = max(abs_err[kind], float((g - p).abs().max()))
    if min_dshs is not None and not float(dshs.abs().max()) > min_dshs:
        raise AssertionError(f"{label}: K4-bwd's SH gradient "
                             f"{float(dshs.abs().max())} is not above {min_dshs}")
    fwd_ms = cuda_ms(lambda: shading_cuda.shade_fwd(*kin), reps)
    bwd_ms = cuda_ms(lambda: shading_cuda.shade_bwd(*kin, *cot), reps)
    plain_fwd_ms = cuda_ms(
        lambda: shading_cuda.rendering_equation_train_reference(*x), plain_reps)
    with torch.enable_grad():
        leaves, loss = plain_shading_graph(x, cot)
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            loss, leaves, retain_graph=True), plain_reps)
    S = x[6].shape[1]
    fwd_bound = bound(nbytes(*kin, *got), P * S * K4_FWD_OPS)
    bwd_bound = bound(nbytes(*kin, *cot, dbc, drough, dvdir, dshs, dgl),
                      P * S * K4_BWD_OPS)
    say(label, points=P, samples=S,
        visibility_mean=f"{float(x[6].mean()):.4f}",
        err_kernel_plain_vs_float64=errs,
        fwd_max_abs_err=f"{abs_err['fwd']:.3e}",
        bwd_max_abs_err=f"{abs_err['bwd']:.3e}",
        fwd_ms=f"{fwd_ms:.4f}", plain_fwd_ms=f"{plain_fwd_ms:.4f}",
        bwd_ms=f"{bwd_ms:.4f}", plain_bwd_ms=f"{plain_bwd_ms:.4f}",
        fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}",
        fwd_bound_by=fwd_bound["bound_by"],
        bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}",
        bwd_bound_by=bwd_bound["bound_by"])
    return ({"max_abs_err": abs_err["fwd"], "ms": fwd_ms,
             "plain_ms": plain_fwd_ms, **fwd_bound, "library_ms": None},
            {"max_abs_err": abs_err["bwd"], "ms": bwd_ms,
             "plain_ms": plain_bwd_ms, **bwd_bound, "library_ms": None})


def k4_mid_phase(device) -> None:
    """K4 against the plain shading at N_MID points, S_MID samples: mixed
    roughness, all-zero visibility at the roughness bounds 0.09 and 0.99,
    and all-zero local-light SH (the stage-2 start, where max(SH, 0) passes
    half the gradient: it must reach the SH)."""
    for seed, (rough, dark, zero_shs) in enumerate((
            (None, False, False), (0.09, True, False), (0.99, True, False),
            (None, False, True))):
        check_k4(shading_case(N_MID, S_MID, SEED + 4 + seed, device, rough,
                              dark, zero_shs), "k4-mid", seed,
                 min_dshs=0.01 if zero_shs else None)


def reset_launches() -> None:
    composite_cuda.LAUNCHES = composite_cuda.BWD_LAUNCHES = 0
    composite_cuda.TWO_WALK_LAUNCHES = 0
    ray_trace_cuda.LAUNCHES = 0
    shading_cuda.LAUNCHES = shading_cuda.BWD_LAUNCHES = 0


def read_launches() -> dict:
    return {"K1": composite_cuda.LAUNCHES, "K2": composite_cuda.BWD_LAUNCHES,
            "K3": ray_trace_cuda.LAUNCHES, "K4-fwd": shading_cuda.LAUNCHES,
            "K4-bwd": shading_cuda.BWD_LAUNCHES,
            "K5": composite_cuda.TWO_WALK_LAUNCHES}


def stage2_phase(trained: dict, device) -> dict:
    """Stage 2 from the trained stage-1 model: checkpoint, load, set-up
    (PBR fields, K3's trace, env map) and STAGE2_STEPS steps through
    run_training_schedule; returns the stage-2 state and the launches."""
    first_iter = TRAIN_OPT.iterations
    views, cfg, extent = trained["views"], trained["cfg"], trained["extent"]
    WORK.mkdir(parents=True, exist_ok=True)
    ckpt = WORK / f"chkpnt{first_iter}.npz"
    save_checkpoint(str(ckpt), first_iter, trained["model"], trained["optimizer"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    it, model = load_checkpoint(str(ckpt), device=device)
    (vis, env), setup_ms = timed_ms(lambda: stage2.setup_stage2(
        model, SAMPLE_NUM, ENV_RES, STAGE2_OPT.light_init,
        torch.Generator(device=device).manual_seed(SEED + 3)))
    # cli/train.py: Adam restarts with zero moments, the step count carried
    optimizer = make_optimizer(model, STAGE2_OPT, extent)
    start_state(optimizer, it)
    env_optimizer = make_env_optimizer(env, STAGE2_OPT)
    vis0 = vis.visibility
    timer, steps = StepTimer(), []

    def callback(i, m):
        steps.append((float(m["loss"]), float(m["psnr"]), float(m["psnr_pbr"]),
                      float(m["light_mean"]), m["num_rendered"]))

    t1 = time.perf_counter()
    vis = stage2.run_training_schedule(
        model, optimizer, env, env_optimizer, vis, views, cfg=cfg,
        opt=STAGE2_OPT, spatial_lr_scale=extent, extent=extent,
        generator=torch.Generator(device=device).manual_seed(SEED),
        first_iter=it, callback=callback, seed=SEED, timer=timer)
    torch.cuda.synchronize()
    train_s, host_s = time.perf_counter() - t1, time.perf_counter() - t0
    launches = read_launches()

    loss, psnr, psnr_pbr, light, pairs = (np.array(c) for c in zip(*steps))
    if len(steps) != STAGE2_STEPS or not np.isfinite(loss).all():
        raise AssertionError(f"stage2: {len(steps)} steps, non-finite loss at "
                             f"{np.flatnonzero(~np.isfinite(loss))[:5]}")
    per_step = {k: launches[k] for k in ("K1", "K2", "K4-fwd", "K4-bwd")}
    if set(per_step.values()) != {STAGE2_STEPS} or launches["K3"] < 1:
        raise AssertionError(f"stage2: {STAGE2_STEPS} steps launched "
                             f"{launches}")
    first, last = psnr_pbr[:8].mean(), psnr_pbr[-8:].mean()
    if not last > first:
        raise AssertionError(f"stage2: PBR PSNR did not rise ({first} -> {last})")
    split = timer.split_ms()[1:]       # step 1 is the warm-up
    med = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    P, S = vis0.shape[:2]
    say("stage2", size=f"{SIZE_MAIN}x{SIZE_MAIN}", views=len(views),
        points=P, first_iter=it, steps=STAGE2_STEPS, launches=launches,
        rays=P * S, setup_ms=f"{setup_ms:.3f}",
        mean_vis=f"{float(vis0.mean()):.4f}",
        vis_zero_share=f"{float((vis0 == 0).float().mean()):.4f}",
        env=tuple(env.env.shape), train_s=f"{train_s:.2f}",
        host_s=f"{host_s:.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    say("stage2-time", ms_per_step_median=f"{med['total']:.3f}",
        forward_ms=f"{med['forward']:.3f}", backward_ms=f"{med['backward']:.3f}",
        optimizer_and_stats_ms=f"{med['optimizer']:.3f}",
        host_ms_per_step=f"{train_s * 1e3 / STAGE2_STEPS:.3f}",
        pairs_median=int(np.median(pairs)))
    say("stage2-quality", loss_first=f"{loss[0]:.5f}", loss_last=f"{loss[-1]:.5f}",
        psnr_first=f"{psnr[0]:.3f}", psnr_last=f"{psnr[-1]:.3f}",
        psnr_pbr_first8_mean=f"{first:.3f}", psnr_pbr_last8_mean=f"{last:.3f}",
        light_mean_first=f"{light[0]:.4f}", light_mean_last=f"{light[-1]:.4f}")
    return {"model": model, "optimizer": optimizer, "env": env,
            "env_optimizer": env_optimizer, "vis": vis, "views": views,
            "cfg": cfg, "extent": extent, "launches": launches}


@torch.no_grad()
def stage2_eval_phase(s2: dict, device) -> None:
    """render_neilf(is_training=False) of every view at 800x800: 3 + 27 + 2
    splatted channels, K1 once per view, every output finite."""
    views = s2["views"]
    cfg = RasterConfig(SIZE_MAIN, SIZE_MAIN)
    bg = torch.zeros(3, device=device)
    channels = 3 + EVAL_FEATURE_DIM + 2
    if channels != composite_cuda.MAX_ATTRS:
        raise AssertionError(f"stage2-eval: {channels} channels")
    torch.cuda.synchronize()
    reset_launches()
    results, view_ms = [], []
    for v in views:
        res, ms = timed_ms(lambda: render_neilf(
            v, s2["model"], cfg, bg, s2["env"], s2["vis"], is_training=False))
        results.append(res)
        view_ms.append(ms)
    launches = read_launches()
    if launches["K1"] != len(views) or launches["K2"] or launches["K4-fwd"]:
        raise AssertionError(f"stage2-eval: {len(views)} views launched "
                             f"{launches}")
    keys = ("render", "pbr", "pbr_env", "render_env", "env_only", "base_color",
            "roughness", "normal", "visibility", "diffuse", "specular",
            "lights", "local_lights", "global_lights", "depth", "opacity")
    for i, res in enumerate(results):
        for key in keys:
            x = res[key]
            if x.shape[-2:] != (SIZE_MAIN, SIZE_MAIN) or not bool(
                    torch.isfinite(x).all()):
                raise AssertionError(f"stage2-eval view {i}: {key} "
                                     f"{tuple(x.shape)} not finite")
    say("stage2-eval", views=len(views), size=f"{SIZE_MAIN}x{SIZE_MAIN}",
        channels=channels, k1_launches=launches["K1"],
        ms_per_view_median=f"{float(np.median(view_ms[1:])):.3f}",
        view_ms=[round(ms, 3) for ms in view_ms],
        pbr_mean=f"{float(torch.stack([r['pbr'].mean() for r in results]).mean()):.4f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")


# The cli phase: a NeRF-synthetic-layout scene of the render cell's views;
# stage 1 on TRAIN_OPT, stage 2 for CLI_STAGE2_STEPS more steps with a
# visibility re-trace every CLI_VIS_REFRESH steps (once, at step 401) and the
# env map upsampled CLI_ENV_UPSAMPLE steps in; test PSNRs every
# CLI_TEST_INTERVAL steps.
CLI_TRAIN_VIEWS, CLI_TEST_VIEWS = 24, 8
CLI_STAGE2_STEPS, CLI_VIS_REFRESH, CLI_ENV_UPSAMPLE = 200, 100, 150
CLI_TEST_INTERVAL = 50


def opt_flags(opt: OptimizationConfig) -> list[str]:
    """The command-line flags that give `opt` (its fields that differ from
    the defaults)."""
    flags = []
    for f in dataclasses.fields(OptimizationConfig):
        value = getattr(opt, f.name)
        if value != f.default:
            flags += [f"--{f.name}"] if value is True else [
                f"--{f.name}", str(value)]
    return flags


def write_nerf_synthetic(root: Path, gt_model: GaussianModel, device) -> None:
    """transforms_{train,test}.json (camera_angle_x = FOV) and RGBA PNGs of
    the port's render of `gt_model` on the orbit of radius CAM_RADIUS, the
    test views between the train views; straight alpha (rgb = render /
    opacity, alpha = opacity), as Blender writes them, by the port's PNG
    writer."""
    cfg = RasterConfig(SIZE_MAIN, SIZE_MAIN, compute_weights=False)
    for split, n, offset in (("train", CLI_TRAIN_VIEWS, 0.0),
                             ("test", CLI_TEST_VIEWS, 0.5)):
        frames = []
        for i in range(n):
            a = 2 * math.pi * (i + offset) / n
            R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                          [-math.sin(a), 0, math.cos(a)]])
            T = np.array([0.0, 0.0, CAM_RADIUS])
            w2c = np.eye(4)
            w2c[:3, :3], w2c[:3, 3] = R.T, T
            c2w = np.linalg.inv(w2c)
            c2w[:3, 1:3] *= -1                 # COLMAP → OpenGL axes
            cam = make_camera_params(R, T, SIZE_MAIN, SIZE_MAIN, fovx=FOV,
                                     fovy=FOV, device=device)
            zeros = torch.zeros((3, SIZE_MAIN, SIZE_MAIN), device=device)
            with torch.no_grad():
                res = render(ViewInputs(cam, zeros, zeros[:1] + 1, zeros[:1],
                                        zeros), gt_model, cfg,
                             torch.zeros(3, device=device))
            alpha = res["opacity"]
            rgb = res["render"] / torch.clamp(alpha, min=1e-6)
            rgba = torch.cat([rgb, alpha]).clamp(0, 1).permute(1, 2, 0)
            write_png(str(root / split / f"r_{i}.png"),
                      (rgba * 255 + 0.5).to(torch.uint8).cpu().numpy())
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": FOV, "frames": frames}, f)


def test_psnrs(model_path: Path) -> list[tuple[int, float]]:
    """The periodic test PSNRs cli.train logged to metrics.jsonl."""
    with open(model_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["test_psnr"]) for r in recs if "test_psnr" in r]


def run_cli(fn) -> tuple[dict, float, float]:
    """fn() with every launch count set to 0 just before and read just
    after: (launches, wall seconds, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return read_launches(), wall, torch.cuda.max_memory_allocated() / 2**30


def cli_phase(gt_model: GaussianModel, device) -> dict:
    """The README's three commands through cli.train.main and
    cli.eval_nvs.main on a scene of the render cell; raises on a missing
    artifact, a wrong launch count or test PSNRs that do not rise. Returns
    the launches of stage 1, the dataset's and the stage-2 run's
    directories and the stage-2 run's last iteration."""
    root = WORK / "cli"
    data, out1, out2 = root / "nerf_synthetic", root / "stage1", root / "stage2"
    for d in (data, out1, out2):
        if d.exists():
            shutil.rmtree(d)
    t0 = time.perf_counter()
    write_nerf_synthetic(data, gt_model, device)
    write_s = time.perf_counter() - t0
    common = ["-s", str(data), "--eval", "--test_interval",
              str(CLI_TEST_INTERVAL), "--log_interval", "100"]
    n1 = TRAIN_OPT.iterations
    n2 = n1 + CLI_STAGE2_STEPS

    # 1. stage 1, its backward on K5
    os.environ["R3DG_BWD_TWO_WALK"] = "1"
    try:
        l1, wall1, peak1 = run_cli(lambda: train_cli.main(
            common + ["-m", str(out1), "--save_interval", str(n1),
                      "--checkpoint_interval", str(n1)]
            + opt_flags(TRAIN_OPT), device=device))
    finally:
        del os.environ["R3DG_BWD_TWO_WALK"]
    # 2. stage 2 from its checkpoint
    stage2_opt = OptimizationConfig(**{**STAGE2_NERF_SYNTHETIC,
                                       "iterations": n2})
    l2, wall2, peak2 = run_cli(lambda: train_cli.main(
        common + ["-m", str(out2), "-t", "neilf",
                  "-c", str(out1 / f"chkpnt{n1}.npz"),
                  "--sample_num", str(SAMPLE_NUM),
                  "--vis_refresh_interval", str(CLI_VIS_REFRESH),
                  "--env_upsample_iters", str(n1 + CLI_ENV_UPSAMPLE),
                  "--save_interval", str(n2),
                  "--checkpoint_interval", str(n2)]
        + opt_flags(stage2_opt), device=device))
    with open(out2 / "metric_test.txt") as f:
        stage2_metrics = f.read()
    # 3. eval_nvs on the test views
    evaluated = {}
    l3, wall3, peak3 = run_cli(lambda: evaluated.update(eval_nvs.main(
        ["-s", str(data), "-m", str(out2), "-t", "neilf",
         "-c", str(out2 / f"chkpnt{n2}.npz"), "--skip_train",
         "--sample_num", str(SAMPLE_NUM)], device=device)))

    missing = [str(p) for p in (
        out1 / f"chkpnt{n1}.npz", out1 / "point_cloud" / f"iteration_{n1}"
        / "point_cloud.ply", out1 / "cfg_args.json", out1 / "metric_test.txt",
        out1 / "best_chkpnt.npz", out1 / "best.json", out1 / "input.ply",
        out1 / "cameras.json", out2 / f"chkpnt{n2}.npz",
        out2 / f"env_light_chkpnt{n2}.npz", out2 / "point_cloud"
        / f"iteration_{n2}" / "point_cloud.ply", out2 / "cfg_args.json",
        out2 / "env_light_best_chkpnt.npz", out2 / "metric_test.txt",
        out2 / "test" / "renders" / "00000.png") if not p.exists()]
    if missing:
        raise AssertionError(f"cli: missing artifacts {missing}")
    with np.load(out2 / f"env_light_chkpnt{n2}.npz") as env_file:
        env_shape = env_file["env.env"].shape
        if env_shape != (2 * ENV_RES, 4 * ENV_RES, 3) or (
                env_file["env_state.mu"].shape != env_shape):
            raise AssertionError(f"cli: env map {env_shape} after the "
                                 "upsample")
    want = {"stage 1": (l1, {"K5": n1, "K2": 0}),
            "stage 2": (l2, {"K2": CLI_STAGE2_STEPS, "K5": 0,
                             "K4-fwd": CLI_STAGE2_STEPS,
                             "K4-bwd": CLI_STAGE2_STEPS, "K3": 2}),
            "eval": (l3, {"K3": 1, "K2": 0, "K5": 0, "K4-fwd": 0})}
    for label, (got, expect) in want.items():
        if any(got[k] != v for k, v in expect.items()):
            raise AssertionError(f"cli {label}: launches {got}, expected "
                                 f"{expect}")
    psnr1, psnr2 = test_psnrs(out1), test_psnrs(out2)
    for label, series in (("stage 1 test PSNR", psnr1),
                          ("stage 2 test PBR PSNR", psnr2)):
        values = np.array([v for _, v in series])
        if len(values) < 2 or not np.isfinite(values).all() or not (
                values[-1] > values[0]):
            raise AssertionError(f"cli: {label} {series} not finite and "
                                 "rising")
    test = evaluated["test"]
    if not (np.isfinite(test["psnr"]) and np.isfinite(test["ssim"])):
        raise AssertionError(f"cli eval: {test}")

    def step_medians(model_path):
        """Medians over the steps cli.train logged to metrics.jsonl (the
        first one, the warm-up, left out) of its step times and pairs."""
        with open(model_path / "metrics.jsonl") as f:
            recs = sorted((r for r in map(json.loads, f) if "step_ms" in r),
                          key=lambda r: r["step"])[1:]
        return {k: float(np.median([r[k] for r in recs])) for k in (
            "step_ms", "forward_ms", "backward_ms", "optimizer_ms",
            "num_rendered")}

    med1, med2 = step_medians(out1), step_medians(out2)
    say("cli", size=f"{SIZE_MAIN}x{SIZE_MAIN}",
        views=f"{CLI_TRAIN_VIEWS}+{CLI_TEST_VIEWS}",
        dataset_write_s=f"{write_s:.2f}", stage1_wall_s=f"{wall1:.2f}",
        stage2_wall_s=f"{wall2:.2f}", eval_wall_s=f"{wall3:.2f}",
        **{f"stage{i}_{k}": (int(v) if k == "num_rendered" else f"{v:.3f}")
           for i, med in ((1, med1), (2, med2)) for k, v in med.items()},
        eval_ms_per_view_median=f"{float(np.median(test['view_ms'][1:])):.3f}",
        peak_mem_gib=f"{peak1:.2f}/{peak2:.2f}/{peak3:.2f}")
    say("cli-launches", stage1=l1, stage2=l2, eval=l3)
    say("cli-quality", stage1_test_psnr=[(i, round(v, 3)) for i, v in psnr1],
        stage2_test_pbr_psnr=[(i, round(v, 3)) for i, v in psnr2],
        stage2_metric_test=stage2_metrics.strip().replace("\n", "; "),
        eval_nvs_test={k: round(v, 4) for k, v in test.items()
                       if k != "view_ms"})
    return {"launches": l1, "data": data, "stage2": out2, "n2": n2}


# The relighting phases: the composition's two clouds side by side at half
# scale (RELIGHT_SHIFT along x, the second turned a quarter about the
# vertical), RELIGHT_FRAMES frames at 800x800 (the first two from one pose
# under two light rotations) at the CLI's default 64 samples; the syn4 eval
# at the README's 384 samples; FINETUNE_ITERS iterations of
# finetune_visibility. The mutual-occlusion check allows OCCLUSION_SHARE of
# the rays to be above the cloud-alone trace (float order at the 0.9
# threshold) and wants at least SHADOWED_SHARE of them lower.
RELIGHT_SCALE, RELIGHT_SHIFT, RELIGHT_FRAMES = 0.5, 0.6, 8
RELIGHT_CAPTURES = ("pbr_env", "base_color", "roughness", "visibility",
                    "normal", "points", "env_only")
SYN4_SAMPLES = 384
FINETUNE_ITERS = 50
OCCLUSION_SHARE, SHADOWED_SHARE = 1e-5, 1e-3
ENV_H, ENV_W = 256, 512


def rotation(axis, angle: float) -> np.ndarray:
    """Rodrigues' rotation about `axis` by `angle`."""
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


def sky_envmap(sun_dir, sun_rgb, sky_rgb) -> np.ndarray:
    """A procedural equirect HDR map [ENV_H, ENV_W, 3] in the layout
    models/lights.py::equirect_query reads (row r at polar angle
    pi r / (H - 1) from +z, column c at azimuth -pi (2c / (W - 1) - 1)): a
    sky gradient over the +z hemisphere, a dim ground, and a sun lobe of
    peak radiance sun_rgb (~0.06 rad wide) about sun_dir."""
    phi = np.linspace(0, math.pi, ENV_H)[:, None]
    theta = -math.pi * (np.linspace(-1, 1, ENV_W)[None, :])
    d = np.stack(np.broadcast_arrays(np.sin(phi) * np.cos(theta),
                                     np.sin(phi) * np.sin(theta),
                                     np.cos(phi)), -1)
    up = np.clip(d[..., 2:], 0, 1)
    sky = np.asarray(sky_rgb) * (0.4 + 0.6 * up) * (d[..., 2:] > 0) + 0.05
    s = np.asarray(sun_dir, np.float64) / np.linalg.norm(sun_dir)
    sun = np.exp(((d @ s) - 1) / 0.002)[..., None] * np.asarray(sun_rgb)
    return (sky + sun).astype(np.float32)


class CallTimer:
    """While active, replaces `module.name` (looked up at each call by its
    callers) by a wrapper that times each call with CUDA events around it,
    synchronized after (timed_ms), or with `timed=False` calls it as it is;
    `ms` lists the calls' times, `sizes` size(*args) of each and `kept`
    keep(args, result) of the first call, taken outside its timing.
    Counters stay the wrapped function's own."""

    def __init__(self, module, name: str, size=lambda *args: None,
                 keep=None, timed: bool = True):
        self.module, self.name, self.size, self.keep = module, name, size, keep
        self.timed = timed
        self.ms: list[float] = []
        self.sizes: list = []
        self.kept = None

    def __enter__(self):
        fn = self._fn = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            if self.timed:
                out, ms = timed_ms(lambda: fn(*args, **kwargs))
            else:
                out, ms = fn(*args, **kwargs), None
            self.ms.append(ms)
            self.sizes.append(self.size(*args))
            if self.keep is not None and len(self.ms) == 1:
                self.kept = self.keep(args, out)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)


def write_relight_config(root: Path, plys: list[Path]) -> Path:
    """transform.json (the two clouds side by side), trajectory.json
    (RELIGHT_FRAMES frames on the orbit of radius CAM_RADIUS, fov FOV; frames
    0 and 1 from the same pose), light_transform.json (a rotation of its own
    for each frame, frame 0 the identity) and env_map/envmap12.exr; returns
    the map's path."""
    entries = {}
    for i, (ply, sign, turn) in enumerate(((plys[0], -1, 0.0),
                                           (plys[1], 1, math.pi / 2))):
        T = np.eye(4)
        T[:3, :3] = RELIGHT_SCALE * rotation([0, 1, 0], turn)
        T[0, 3] = sign * RELIGHT_SHIFT
        entries[f"obj{i}"] = {"path": str(ply),
                              "transform": T.reshape(-1).tolist()}
    traj = {"camera": {"width": SIZE_MAIN, "height": SIZE_MAIN,
                       "camera_angle_x": FOV}, "trajectory": {}}
    lights = {"transform": {}}
    for i in range(RELIGHT_FRAMES):
        a = 2 * math.pi * max(i - 1, 0) / (RELIGHT_FRAMES - 1)
        w2c = np.eye(4)
        w2c[:3, :3] = rotation([0, 1, 0], a).T
        w2c[2, 3] = CAM_RADIUS
        traj["trajectory"][str(i)] = w2c.reshape(-1).tolist()
        lights["transform"][str(i)] = rotation(
            [math.sin(i), 1.0, math.cos(i)], 0.7 * i).reshape(-1).tolist()
    for name, obj in (("transform.json", entries),
                      ("trajectory.json", traj),
                      ("light_transform.json", lights)):
        with open(root / name, "w") as f:
            json.dump(obj, f)
    env = root / "env_map" / "envmap12.exr"
    env.parent.mkdir(parents=True, exist_ok=True)
    write_exr_zip(str(env), sky_envmap([0.5, 0.3, 0.8], [20.0, 19.0, 17.0],
                                       [0.3, 0.45, 0.8]))
    return env


def k3_check_rays(args, T) -> tuple:
    """Of K3's inputs (bvh, o, d) and output T: a seeded K3_SUBSET of the
    rays, spread over the whole index range and the last K3_TAIL of them
    included, as (bvh, all rays, indices, o, d, T at them)."""
    bvh, o, d = args[:3]
    R = o.shape[0]
    gen = torch.Generator().manual_seed(SEED + 9)
    head = torch.randperm(R - K3_TAIL, generator=gen)[:K3_SUBSET - K3_TAIL]
    idx = torch.cat([head.sort().values,
                     torch.arange(R - K3_TAIL, R)]).to(o.device)
    return bvh, R, idx, o[idx], d[idx], T[idx]


def k1_inputs(args, _) -> tuple:
    binning, *tensors, cfg = args
    return (binning, *(t.detach() for t in tensors), cfg)


def run_cli_timed(fn, cli_module):
    """run_cli with K3's launches (the ray order included; rays) and the
    CLI module's render_neilf calls timed, and kept from the first K3 and
    K1 launch what check_cli_kernels checks: (fn's result, launches, wall
    s, peak GiB, the K3 timer, the K1 recorder, the render timer)."""
    result = []
    with CallTimer(ray_trace_cuda, "trace_k3", keep=k3_check_rays,
                   size=lambda bvh, o, d, *rest: o.shape[0]) as k3, \
            CallTimer(composite_cuda, "composite_k1", keep=k1_inputs,
                      timed=False) as k1, \
            CallTimer(cli_module, "render_neilf") as renders:
        launches, wall, peak = run_cli(lambda: result.append(fn()))
    return result[0], launches, wall, peak, k3, k1, renders


@torch.no_grad()
def check_cli_kernels(k3: CallTimer, k1: CallTimer, label: str) -> dict:
    """K3 and K1 as a CLI run launched them, against their plain versions:
    the T K3 gave on the rays k3_check_rays kept against the plain tracer
    under k3-main's gate, and K1 on its first launch's inputs under
    k1-main's (check_k1). Returns K3's readings."""
    bvh, R, idx, o, d, T = k3.kept
    T_plain, plain_ms = timed_ms(
        lambda: ray_trace.trace_transmittance_plain(bvh, o, d))
    err, n_split, vis_plain = k3_gate(T, T_plain, f"{label}-k3")
    say(f"{label}-k3", gaussians=bvh.order.shape[0], rays=R,
        rays_checked=idx.numel(), last_ray_checked=int(idx[-1]),
        mean_vis=f"{float(vis_plain.mean()):.4f}", max_abs_err=f"{err:.3e}",
        rays_split=n_split, plain_ms=f"{plain_ms:.4f}")
    check_k1(k1.kept, f"{label}-k1", k1_reps=3, plain_reps=1)
    return {"k3_max_abs_err": err, "k3_rays_split": n_split}


def relight_phase(s2: dict, cli: dict, device) -> dict:
    """cli.relighting.main on the card: the cli phase's stage-2 PLY and the
    stage2 phase's model composed; every PNG, K3 once and K1 once a frame
    (each held against its plain version as the CLI launched it); the
    mutual occlusion on cloud A's rays; a --vis_one run no darker at
    any pbr_env pixel and brighter on average; env_only moved by the light
    rotation alone. Returns its launches and K3's readings."""
    root = WORK / "relight"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    t0 = phase_t0 = time.perf_counter()
    plys = [cli["stage2"] / "point_cloud" / f"iteration_{cli['n2']}"
            / "point_cloud.ply", root / "stage2_model.ply"]
    save_gaussian_ply(str(plys[1]), s2["model"].to_numpy())
    env = write_relight_config(root, plys)
    setup_s = time.perf_counter() - t0

    def relight(out: str, *flags):
        return relighting.main(
            ["-co", str(root), "-e", str(env), "--output", str(root / out),
             "--sample_num", str(SAMPLE_NUM), *flags], device=device)

    _, launches, wall, peak, k3, k1, renders = run_cli_timed(lambda: relight(
        "capture", "--capture_list", ",".join(RELIGHT_CAPTURES)), relighting)
    missing = [f"{t}/frame_{i}.png" for t in RELIGHT_CAPTURES
               for i in range(RELIGHT_FRAMES)
               if not (root / "capture" / t / f"frame_{i}.png").exists()]
    expect = {"K1": RELIGHT_FRAMES, "K3": 1, "K2": 0, "K4-fwd": 0, "K5": 0}
    if missing or any(launches[k] != v for k, v in expect.items()):
        raise AssertionError(f"relight: launches {launches} (expected "
                             f"{expect}), missing {missing[:5]}")
    traced_k3 = check_cli_kernels(k3, k1, "relight")
    _, launches1, wall1, *_ = run_cli_timed(lambda: relight(
        "capture_vis_one", "--capture_list", "pbr_env", "--vis_one"),
        relighting)
    if launches1["K1"] != RELIGHT_FRAMES or launches1["K3"] != 1:
        raise AssertionError(f"relight --vis_one: launches {launches1}")

    # the ablation: visibility 1 can only brighten a pixel
    traced, ones = ([read_png(str(root / d / "pbr_env" / f"frame_{i}.png"))
                     .astype(np.int64) for i in range(RELIGHT_FRAMES)]
                    for d in ("capture", "capture_vis_one"))
    darker = sum(int((b < a - 1).sum()) for a, b in zip(traced, ones))
    mean_traced = float(np.mean([a.mean() for a in traced]))
    mean_ones = float(np.mean([b.mean() for b in ones]))
    if darker or not mean_ones > mean_traced:
        raise AssertionError(f"relight --vis_one: {darker} pixel values "
                             f"darker, mean {mean_ones} against traced "
                             f"{mean_traced}")
    # the light rotation alone moves the environment (frames 0 and 1 share
    # a pose)
    env0, env1 = (read_png(str(root / "capture" / "env_only"
                               / f"frame_{i}.png")).astype(np.int64)
                  for i in (0, 1))
    env_moved = float(np.abs(env0 - env1).mean())
    if not env_moved > 1.0:
        raise AssertionError(f"relight: env_only of frames 0 and 1 differ by "
                             f"{env_moved} u8 on average")

    # mutual occlusion: cloud A's rays in the composite against A alone
    # (the composite with B's opacities below the tested 1/255, so both
    # traces test the same clusters), and against A under its own BVH
    # (other clusters: a gaussian outside its 3-sigma box counts in one
    # trace only)
    with open(root / "transform.json") as f:
        entries = json.load(f)
    with torch.no_grad():
        comp = relighting.scene_composition(entries, device)
        own = relighting.scene_composition({"obj0": entries["obj0"]}, device)
        n_a = own.num_points
        values = {k: getattr(comp, k).detach().clone() for k in comp.fields}
        values["opacity"][n_a:] = -30.0
        alone = GaussianModel(**values)
        vis_c = update_visibility(comp, SAMPLE_NUM).visibility[:n_a]
        vis_a = update_visibility(alone, SAMPLE_NUM).visibility[:n_a]
        vis_own = update_visibility(own, SAMPLE_NUM).visibility
    above = float((vis_c > vis_a + 1e-6).float().mean())
    lower = float((vis_c < vis_a - 1e-6).float().mean())
    own_above = float((vis_c > vis_own + 1e-6).float().mean())
    own_lower = float((vis_c < vis_own - 1e-6).float().mean())
    if above > OCCLUSION_SHARE or lower < SHADOWED_SHARE:
        raise AssertionError(f"relight: on cloud A's rays the composite's "
                             f"visibility is above A's alone on {above} of "
                             f"them (limit {OCCLUSION_SHARE}), lower on "
                             f"{lower} (at least {SHADOWED_SHARE})")
    (k3_rays,), (k3_ms,) = k3.sizes, k3.ms
    render_ms = renders.ms
    say("relight", points=comp.num_points, points_a=n_a, rays=k3_rays,
        k3_ms=f"{k3_ms:.4f}",
        render_ms_per_frame_median=f"{float(np.median(render_ms[1:])):.3f}",
        render_ms=[round(ms, 3) for ms in render_ms],
        size=f"{SIZE_MAIN}x{SIZE_MAIN}", frames=RELIGHT_FRAMES,
        captures=len(RELIGHT_CAPTURES), setup_s=f"{setup_s:.2f}",
        wall_s=f"{wall:.2f}", vis_one_wall_s=f"{wall1:.2f}",
        phase_s=f"{time.perf_counter() - phase_t0:.2f}",
        peak_mem_gib=f"{peak:.2f}", launches=launches,
        vis_one_launches=launches1)
    say("relight-checks", vis_one_darker_values=darker,
        pbr_env_mean_traced=f"{mean_traced:.3f}",
        pbr_env_mean_vis_one=f"{mean_ones:.3f}",
        env_only_frame0_vs_1_mean_u8=f"{env_moved:.3f}",
        a_rays=int(vis_c.numel()), above_alone_share=above,
        lower_than_alone_share=f"{lower:.5f}",
        mean_vis_a_composite=f"{float(vis_c.mean()):.4f}",
        mean_vis_a_alone=f"{float(vis_a.mean()):.4f}",
        own_bvh_above_share=f"{own_above:.6f}",
        own_bvh_lower_share=f"{own_lower:.5f}")
    return {"launches": launches, "k3_ms": k3_ms, "k3_rays": k3_rays,
            **traced_k3}


def write_syn4(root: Path, cli: dict) -> tuple[Path, Path]:
    """A Synthetic4Relight layout of the cli phase's test views:
    transforms_test.json (its poses), test_rli/envmap{6,12}_<stem>.png (its
    RGBA test images), test/<stem>_{albedo,rough}.png (constant under the
    same alpha); env_map/envmap{6,12}.exr (two procedural maps) in a
    directory of their own. Returns (the scene, the maps' directory, the
    number of views)."""
    data, envs = root / "syn4" / "hotdog", root / "envs"
    for d in (data / "test_rli", data / "test", envs / "env_map"):
        d.mkdir(parents=True)
    with open(cli["data"] / "transforms_test.json") as f:
        meta = json.load(f)
    for frame in meta["frames"]:
        stem = frame["file_path"].split("/")[-1]
        src = cli["data"] / f"{frame['file_path']}.png"
        for env in ("envmap6", "envmap12"):
            shutil.copy(src, data / "test_rli" / f"{env}_{stem}.png")
        rgba = read_png(str(src))
        for name, value in (("albedo", (180, 120, 60)), ("rough", (90,) * 3)):
            img = np.zeros_like(rgba)
            img[..., :3], img[..., 3] = value, rgba[..., 3]
            write_png(str(data / "test" / f"{stem}_{name}.png"), img)
    with open(data / "transforms_test.json", "w") as f:
        json.dump(meta, f)
    write_exr_zip(str(envs / "env_map" / "envmap6.exr"),
                  sky_envmap([-0.6, 0.2, 0.7], [8.0, 6.0, 4.0],
                             [0.5, 0.35, 0.2]))
    write_exr_zip(str(envs / "env_map" / "envmap12.exr"),
                  sky_envmap([0.5, 0.3, 0.8], [20.0, 19.0, 17.0],
                             [0.3, 0.45, 0.8]))
    return data, envs, len(meta["frames"])


@torch.no_grad()
def syn4_view_breakdown(ckpt: Path, data: Path, envs: Path, frame: dict,
                        device, views: int = 3) -> dict:
    """Where a syn4 view's time goes, on the relight-eval phase's model and
    first view under envmap12 at SYN4_SAMPLES samples (traced once more,
    outside the phase's counted run): `views` renders under the device-only
    profiler (kernel ms a view against the stream's, K1's and the env
    query's share, the largest kernels), and the plain eval shading alone
    (models/render_neilf.py::_shade_points, CUDA events)."""
    from torch.profiler import ProfilerActivity, profile
    _, model = load_checkpoint(str(ckpt), device=device)
    vis = update_visibility(model, SYN4_SAMPLES)
    env = load_env_light(str(envs / "env_map" / "envmap12.exr"),
                         device=device)
    scale = torch.tensor(eval_relighting_syn4.BASE_COLOR_SCALE["hotdog"],
                         device=device)
    with open(data / "transforms_test.json") as f:
        fovx = json.load(f)["camera_angle_x"]
    R, T = _blender_pose(frame)
    view = Camera(uid=0, R=R, T=T, fovx=fovx, fovy=fovx, width=SIZE_MAIN,
                  height=SIZE_MAIN).view_inputs(device)
    cfg, bg = RasterConfig(SIZE_MAIN, SIZE_MAIN), torch.ones(3, device=device)

    def render_one():
        return render_neilf(view, model, cfg, bg, env, vis,
                            base_color_scale=scale)

    render_one()
    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    prof.start()
    start.record()
    for _ in range(views):
        render_one()
    end.record()
    torch.cuda.synchronize()
    prof.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(part: str = "") -> float:
        return sum(e.self_device_time_total for e in kernels
                   if part in e.key) / 1e3 / views

    stream_ms = start.elapsed_time(end) / views
    if ms() <= 0:
        raise AssertionError("relight-eval: the profiler recorded no device "
                             "time")
    viewdirs = F.normalize(view.cam.campos[None] - model.xyz, dim=-1)
    shade_ms = cuda_ms(lambda: neilf._shade_points(
        model.get_base_color * scale, model.get_roughness, model.get_normal,
        viewdirs, model.get_incidents, env, vis), 3)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"ms_per_view_device_profiler": f"{stream_ms:.3f}",
            "kernel_ms_per_view": f"{ms():.3f}",
            "busy_share": f"{ms() / stream_ms:.3f}",
            "k1_ms_per_view": f"{ms('composite_fwd_kernel'):.4f}",
            "grid_sample_ms_per_view": f"{ms('grid_sampler'):.3f}",
            "shading_ms_per_view": f"{shade_ms:.3f}",
            "largest_kernels_ms_per_view": [
                (e.key[:50], round(e.self_device_time_total / 1e3 / views, 3))
                for e in top]}


def relight_eval_phase(cli: dict, device) -> dict:
    """cli.eval_relighting_syn4.main on the card, LPIPS_WEIGHTS=random, at
    SYN4_SAMPLES samples, on the cli phase's stage-2 checkpoint under a
    model path holding /hotdog/: both metric.txt files with the seven
    fields, finite, the LPIPS the CLI loaded the random backbone, K3 once
    over every ray and K1 once a view of each map (each held against its
    plain version as the CLI launched it), the two maps' renders apart.
    Returns its launches and K3's readings."""
    root = WORK / "relight_eval"
    if root.exists():
        shutil.rmtree(root)
    t0 = time.perf_counter()
    data, envs, n_frames = write_syn4(root, cli)
    setup_s = time.perf_counter() - t0
    model_dir = root / "out" / "hotdog"
    saved = os.environ.get("LPIPS_WEIGHTS")
    os.environ["LPIPS_WEIGHTS"] = "random"
    lpips._CACHE.clear()
    try:
        res, launches, wall, peak, k3, k1, renders = run_cli_timed(
            lambda: eval_relighting_syn4.main(
                ["-s", str(data), "-m", str(model_dir), "-c",
                 str(cli["stage2"] / f"chkpnt{cli['n2']}.npz"), "-e",
                 str(envs), "--sample_num", str(SYN4_SAMPLES)],
                device=device), eval_relighting_syn4)
        backbone = lpips.metric_name()
    finally:
        lpips._CACHE.clear()
        if saved is None:
            del os.environ["LPIPS_WEIGHTS"]
        else:
            os.environ["LPIPS_WEIGHTS"] = saved
    n_views = len(renders.ms)
    metrics = {}
    for task in ("env6", "env12"):
        with open(model_dir / "test_rli" / task / "metric.txt") as f:
            metrics[task] = dict(line.split(": ") for line in
                                 f.read().splitlines())
    fields = list(eval_relighting_syn4.METRICS)
    bad = {t: m for t, m in metrics.items() if list(m) != fields
           or not all(np.isfinite(float(m[k])) for k in fields)}
    if backbone != "lpips(random-vgg)":
        bad["backbone"] = backbone
    expect = {"K1": 2 * n_frames, "K3": 1, "K2": 0, "K4-fwd": 0, "K5": 0}
    (k3_rays,), (k3_ms,) = k3.sizes, k3.ms
    if bad or sorted(res) != ["env12", "env6"] or any(
            launches[k] != v for k, v in expect.items()) or (
            k3_rays % SYN4_SAMPLES or n_views != 2 * n_frames):
        raise AssertionError(f"relight-eval: metric files {bad}, tasks "
                             f"{sorted(res)}, launches {launches} (expected "
                             f"{expect}), K3 over {k3_rays} rays, {n_views} "
                             "views")
    traced_k3 = check_cli_kernels(k3, k1, "relight-eval")
    # the relit object under the two maps: its mean u8 value inside the
    # mask, and the mean difference of the two renders there
    pbr, inside = {}, []
    with open(data / "transforms_test.json") as f:
        frames = json.load(f)["frames"]
    for i, frame in enumerate(frames):
        stem = frame["file_path"].split("/")[-1]
        inside.append(read_png(str(data / "test_rli" / f"envmap6_{stem}.png"))
                      [..., 3] > 0)
        for t in ("env6", "env12"):
            pbr.setdefault(t, []).append(read_png(str(
                model_dir / "test_rli" / t / "pbr" / f"{i}.png")).astype(
                    np.int64))
    pbr_mean = {t: float(np.mean([x[m].mean() for x, m in zip(v, inside)]))
                for t, v in pbr.items()}
    pbr_apart = float(np.mean([np.abs(a - b)[m].mean() for a, b, m in zip(
        pbr["env6"], pbr["env12"], inside)]))
    if not pbr_apart > 1.0:
        raise AssertionError(f"relight-eval: the renders under the two maps "
                             f"differ by {pbr_apart} u8 inside the mask "
                             f"(means {pbr_mean})")
    view_ms = renders.ms
    breakdown = syn4_view_breakdown(
        cli["stage2"] / f"chkpnt{cli['n2']}.npz", data, envs, frames[0],
        device)
    say("relight-eval", rays=k3_rays, samples=SYN4_SAMPLES,
        points=k3_rays // SYN4_SAMPLES, k3_ms=f"{k3_ms:.4f}",
        views=len(view_ms),
        ms_per_view_median=f"{float(np.median(view_ms[1:])):.3f}",
        view_ms=[round(ms, 3) for ms in view_ms], setup_s=f"{setup_s:.2f}",
        wall_s=f"{wall:.2f}", phase_s=f"{time.perf_counter() - t0:.2f}",
        peak_mem_gib=f"{peak:.2f}",
        launches=launches, pbr_mean_u8_in_mask={t: round(v, 3) for t, v in
                                                pbr_mean.items()},
        pbr_env6_vs_env12_u8_in_mask=f"{pbr_apart:.3f}")
    say("relight-eval-breakdown", **breakdown)
    say("relight-eval-metrics", **{t: "; ".join(f"{k} {v}" for k, v in
                                                m.items())
                                   for t, m in metrics.items()})
    return {"launches": launches, "k3_ms": k3_ms, "k3_rays": k3_rays,
            **traced_k3}


def finetune_vis_phase(s2: dict, device) -> dict:
    """train.stage2.finetune_visibility for FINETUNE_ITERS iterations on a
    copy of the stage2 phase's model: K3 once an iteration (P rays), the
    losses finite. Returns its launches."""
    t0 = time.perf_counter()
    src = s2["model"]
    model = GaussianModel(**{k: getattr(src, k).detach().clone()
                             for k in src.fields})
    torch.cuda.synchronize()
    reset_launches()
    (_, losses), ms = timed_ms(lambda: stage2.finetune_visibility(
        model, FINETUNE_ITERS,
        generator=torch.Generator(device=device).manual_seed(SEED + 8)))
    launches = read_launches()
    losses = losses.cpu().numpy()
    expect = {"K3": FINETUNE_ITERS, "K1": 0, "K2": 0, "K4-fwd": 0, "K5": 0}
    if any(launches[k] != v for k, v in expect.items()) or not (
            np.isfinite(losses).all() and losses.shape == (FINETUNE_ITERS,)):
        raise AssertionError(f"finetune-vis: launches {launches} (expected "
                             f"{expect}), losses {losses}")
    say("finetune-vis", points=model.num_points, iterations=FINETUNE_ITERS,
        ms_per_iteration=f"{ms / FINETUNE_ITERS:.3f}",
        phase_s=f"{time.perf_counter() - t0:.2f}", launches=launches,
        loss_first=f"{losses[0]:.5f}",
        loss_last5_mean=f"{losses[-5:].mean():.5f}")
    return {"launches": launches}


def build_phase(ptxas_also: tuple[str, ...] = ()) -> None:
    """Builds K1 to K5 from the checkout's sources, one nvcc each, all at
    once, and prints ptxas's report of csrc/shading.cu and of each source in
    `ptxas_also`, compiled beside them."""
    t0 = time.perf_counter()
    kernels = (composite_cuda.KERNEL, composite_cuda.BWD_KERNEL,
               ray_trace_cuda.KERNEL, shading_cuda.KERNEL,
               composite_cuda.TWO_WALK_KERNEL)
    ptxas_sources = (*(str(_build.CSRC / f"{k}.cu") for k in (
        ray_trace_cuda.KERNEL, composite_cuda.TWO_WALK_KERNEL)), *ptxas_also)
    with ThreadPoolExecutor(len(kernels) + len(ptxas_sources)) as pool:
        reports = pool.map(_build.ptxas_report, ptxas_sources)
        list(pool.map(_build.load_library, kernels))
        reports = list(reports)
    say("build", kernels=list(kernels),
        build_s=f"{time.perf_counter() - t0:.2f}")
    for src, report in zip(ptxas_sources, reports):
        say("ptxas", source=src, kernels=report)


def main(device: str = "cuda:0", ptxas_also: tuple[str, ...] = ()) -> None:
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

    # The phases before cli check K2 on the default backward.
    os.environ.pop("R3DG_BWD_TWO_WALK", None)

    # 2. build K1 to K5 from the checkout's sources
    build_phase(ptxas_also)

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
        # K5 against the plain backward and K2, mid-size scene
        for seed, with_g_weights in enumerate((True, False)):
            check_k5(mid_args, "k5-mid", with_g_weights, seed)

        # 5. K3 against the plain tracer, every ray of the mid-size scene
        mid_dirs, _ = fibonacci_sphere_sampling(mid.get_normal, S_MID)
        check_k3(*visibility_rays(mid, mid_dirs), "k3-mid", samples=S_MID)

        # 6. K4 against the plain shading, mid size
        k4_mid_phase(device)

        # 7. the render slice: checkpoint → load_checkpoint → render, 8 views
        t0 = time.perf_counter()
        scene = make_scene(N_MAIN, SEED)
        WORK.mkdir(parents=True, exist_ok=True)
        ckpt = WORK / f"scene_{N_MAIN}.npz"
        save_checkpoint(str(ckpt), 0, GaussianModel.from_numpy(scene,
                                                            device="cpu"))
        _, model = load_checkpoint(str(ckpt), device=device)
        setup_s = time.perf_counter() - t0
        cfg = RasterConfig(SIZE_MAIN, SIZE_MAIN, compute_pseudo_normal=True)
        bg = torch.zeros(3, device=device)
        views = [orbit_view(i, VIEWS, SIZE_MAIN, device) for i in range(VIEWS)]
        torch.cuda.synchronize()

        reset_launches()
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

        # 8. K1 against the plain version at the render's shapes
        main_k1 = check_k1(compositor_args(model, views[0], cfg), "k1-main")

    # 9. the training slice
    scene_model = model
    trained = train_phase(model, SIZE_MAIN, VIEWS, N_INIT, TRAIN_OPT, device)
    launches = trained["launches"]
    # 10. K2 against the plain backward at the train step's shapes
    with torch.no_grad():
        main_args = compositor_args(
            trained["model"], orbit_view(0, VIEWS, SIZE_MAIN, device),
            RasterConfig(SIZE_MAIN, SIZE_MAIN))
        main_k2 = check_k2(main_args, "k2-main", False, 7)
        check_k2_views(trained["model"], device)
        # K5 on the same inputs
        main_k5 = check_k5(main_args, "k5-main", False, 7)
    # 11. where a train step's time goes
    it = TRAIN_OPT.iterations

    def stage1_step(timer):
        nonlocal it
        it += 1
        train_step(trained["model"], trained["optimizer"],
                   trained["views"][it % VIEWS], it, cfg=trained["cfg"],
                   opt=TRAIN_OPT, spatial_lr_scale=trained["extent"],
                   timer=timer)

    profile_phase("profile", stage1_step, trained["model"].num_points, True)

    # 12. the stage-2 slice, from the trained stage-1 model
    s2 = stage2_phase(trained, device)
    # K1 and K2 at stage 2's widths
    k12_stage2_phase(s2)
    with torch.no_grad():
        # 13. K3 against the plain tracer on the stage's rays
        model = s2["model"]
        dirs = s2["vis"].incident_dirs
        main_k3 = check_k3(*visibility_rays(model, dirs), "k3-main",
                           subset=K3_SUBSET, seed=SEED + 5,
                           samples=dirs.shape[1])
        # 14. K4 at the train step's shapes
        main_k4f, main_k4b = check_k4(train_shading_case(
            model, s2["env"], s2["vis"], s2["views"][0]), "k4-main", SEED + 6)
    # 15. the stage-2 eval render
    stage2_eval_phase(s2, device)
    # 16. where a stage-2 step's time goes
    it2 = STAGE2_OPT.iterations

    def stage2_step(timer):
        nonlocal it2
        it2 += 1
        stage2.train_step(model, s2["optimizer"], s2["env"],
                          s2["env_optimizer"], s2["vis"], s2["views"][it2 % VIEWS],
                          it2, cfg=s2["cfg"], opt=STAGE2_OPT,
                          spatial_lr_scale=s2["extent"], timer=timer)

    profile_phase("stage2-profile", stage2_step, model.num_points, False,
                  named={"K4-fwd": "shade_fwd_kernel",
                         "K4-bwd": "shade_bwd_kernel"})

    # 17. the README's commands through the CLIs
    cli = cli_phase(scene_model, device)
    cli_launches = cli["launches"]
    # 18. composition and relighting through cli.relighting
    relight = relight_phase(s2, cli, device)
    # 19. the Synthetic4Relight eval through cli.eval_relighting_syn4
    relight_eval = relight_eval_phase(cli, device)
    # 20. the visibility SH fit
    finetune = finetune_vis_phase(s2, device)

    s2_launches = s2["launches"]
    print(json.dumps({"kernels": [
        {"name": "K1 composite_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["K1"], **main_k1,
         "relight_launches": relight["launches"]["K1"],
         "relight_eval_launches": relight_eval["launches"]["K1"]},
        {"name": "K2 composite_bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"], **main_k2},
        {"name": "K3 ray_trace", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": s2_launches["K3"], **main_k3,
         "relight_launches": relight["launches"]["K3"],
         "relight_rays": relight["k3_rays"], "relight_ms": relight["k3_ms"],
         "relight_max_abs_err": relight["k3_max_abs_err"],
         "relight_eval_launches": relight_eval["launches"]["K3"],
         "relight_eval_rays": relight_eval["k3_rays"],
         "relight_eval_ms": relight_eval["k3_ms"],
         "relight_eval_max_abs_err": relight_eval["k3_max_abs_err"],
         "finetune_vis_launches": finetune["launches"]["K3"]},
        {"name": "K4 shade_fwd", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4F_REPLACES, "launches": s2_launches["K4-fwd"],
         **main_k4f},
        {"name": "K4 shade_bwd", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4B_REPLACES, "launches": s2_launches["K4-bwd"],
         **main_k4b},
        {"name": "K5 composite_bwd_two_walk", "route": "cuda",
         "source": K5_SOURCE, "replaces": K5_REPLACES,
         "launches": cli_launches["K5"], **main_k5}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ptxas-also", nargs="*", default=[],
                        help="other kernel sources to print ptxas's report of")
    sys.exit(main(ptxas_also=tuple(parser.parse_args().ptxas_also)))
