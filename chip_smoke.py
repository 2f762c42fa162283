"""Smoke run of the PyTorch port on NVIDIA GPUs (one or more): python3
chip_smoke.py [--ptxas-also OTHER_KERNEL_CU ...]

Drives the port's main paths, the stage-1 render of a checkpoint, stage-1
training and stage-2 (PBR) training with its eval render, through the entry
points a user calls, and checks every kernel on those paths against its
plain PyTorch version. Phases, in the order they run (each prints one line,
the train phases a few; any failure raises, so the exit code is non-zero and
no result line is printed):

  1. device   needs torch.cuda; prints how the cards are joined (nvidia-smi
              topo -m, NVLink status, peer access) and the card's name
              and power limit;
  2. build    compiles kernels K1 (csrc/composite_fwd.cu), K2
              (csrc/composite_bwd.cu), K3 (csrc/ray_trace.cu), K4
              (csrc/shading.cu), K5 (csrc/composite_bwd_two_walk.cu) and K6
              (csrc/shading_eval.cu),
              and the check kernel csrc/composite_decisions.cu (K1's blend
              decisions at given pixels, for k2-split), with nvcc, all at
              once, and prints ptxas's registers, spills
              and shared memory for csrc/ray_trace.cu, csrc/shading.cu,
              csrc/composite_bwd_two_walk.cu and csrc/shading_eval.cu and
              for each source given with --ptxas-also (another version of
              one, to compare);
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
     k2-split K2 at the pixels the K2 gates leave out, where K1 and the
              plain compositor blend other pairs (split_pixels): against a
              float64 replay of K1's own blend decisions there (ops/
              composite.py::replay_backward; the decisions read by the check
              kernel, whose walk must equal K1's final T, stop and count
              bitwise), for a seeded cotangent on those pixels alone, under
              K2_TOL, on k2-main's and k12-stage2's inputs and on a built
              input where split pixels are certain (at least one required);
              the split pixels of each are printed;
 13. k3-main  K3 against the plain tracer on a seeded subset of the stage's
              rays, both timed, and K3 timed on all of them: in coherent
              order with the sort (the main path), the sort alone, in the
              order visibility_rays gives, and sample-major; its bound
              counted on all of them;
 14. k4-main  K4 against the plain shading at the train step's shapes
              (at every point, as every K4 gate);
     k6-eval  K6, the eval shading, against the plain version (ops/
              shading_eval_cuda.py::rendering_equation_eval_reference) in
              float64 at s2-relight's shapes (300,000 points, 64 samples,
              a 512 x 1024 sky with a sun, turned), every output within
              K6_TOL of its scale or K6_SLACK times the plain float32
              version's error; K6 timed beside the plain version in float32
              and its bound (bytes and operations);
 15. stage2-eval  models.render_neilf.render_neilf(is_training=False) of
              the 8 views at 800x800 (32 splatted channels), K1 and K6 once
              a view;
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
     syn4-view  cli.eval_relighting_syn4.relight_view at the benchmark
              cell s2-eval.syn4's shapes: 300,000 points, 384 samples (K3
              over 115.2M rays), 800x800 under a 512 x 1024 map,
              LPIPS_WEIGHTS=random; K6 once a view, its launch timed
              against its bound at S = 384, the LPIPS forward of the
              view's four images timed, the scores finite;
 20. finetune-vis  train.stage2.finetune_visibility, 50 iterations on the
              stage2 phase's model: K3 once an iteration, losses finite.
 21. mvs-plane  cli.mvs.run_pipeline at the CLI's defaults (5 sources,
              planes 48, 32, 16) on tests/test_mvs.py's analytic textured
              plane at 800x800, seven views with sources on both sides: the
              median relative depth error of the kept pixels under 1% and
              their share above MVS_MIN_KEPT on every view; ms a view of
              each cascade stage, the filter and the packaging; peak memory;
 22. mvs      the cli phase's 8 test views through a COLMAP model written by
              the port's writers (the gaussian centres each view weighs as
              its observations), cli.mvs.main --layout blender, its extra/
              in a copy of the scene, cli.eval_nvs there: every artifact,
              the test cameras carry finite depth and normals; the median
              relative error against the port's rendered depth, not gated;
 23. gui      cli.gui.main --headless, 24 frames at 800x800: -t render on
              the slice phase's checkpoint, -t neilf on the cli phase's
              stage-2 checkpoint; every PNG, K1 once a frame, K3 once for
              neilf, K1 on the first frame's inputs under k1-main's gate
              (gui-k1); ms a frame and FPS against the 30 FPS bar;
 24. train-gui  cli.train --gui for 20 stage-1 steps on the cli phase's
              scene with a stub dearpygui: a viewer frame a step on K1;
 25. k4-seeds  k4-main's gate on 20 fresh sets of sample directions (each
              point's samples turned about its normal by a seeded angle;
              --k4-seeds N for more) and the 8 views: K4 held against
              float64 at every point; each seed's view-direction error,
              K4's and the plain version's, and the points whose sign(V.N)
              float32 alone would have turned the other way.
     k4-branches  K4's float32 clips forced (k4_branch_case): at 2000
              points x 64 samples each, the GGX denominator q (roughness
              0.09-0.15), NoV, NoH or VoH put at 1e-6 (1 + delta) in
              float64, delta from 1e-8 to 2e-3 in both signs; per case the
              decisions that differ from float64's (K4's by its rule,
              shading_cuda.k4_clip_passes, which must find none for the
              sign, NoV, q and VoH; K4's float32 chain's alone; the plain
              float32 version's) and K4's and the plain version's error
              from float64 per field; each case under check_k4's gate,
              q-clip, nov-clip and voh-clip on K4's tolerance alone.
 26. dense    ops.rasterize (K1 forward, K2 backward) against the dense
              oracle ops.rasterize_dense on the card in float32, on
              tests/test_rasterizer_parity.py's scene (300 gaussians, 64x64)
              and a larger one (2000, 128x128), under that test's bounds
              (colour and opacity 2e-5, depth 1e-4, features 5e-5, weights
              1e-3, n_contrib on 99.9% of pixels, radii equal, gradients 2e-3
              of each field's largest entry); K1's and the float32 oracle's
              error from the float64 oracle printed;
 27. facade   raster.GaussianRasterizer on the slice phase's scene and view
              0 against ops.rasterize on the same inputs: the 10-tuple
              bitwise but the weights (K1's atomics, k1-main's weights
              bounds); again with the SH colour and the packed covariance
              given precomputed (the covariance under k1-main's gate: its
              packing may move a last bit); mark_visible against view z >
              0.2; the covariance also given full [P, 3, 3] (the packed one
              unpacked): the same render bitwise but the weights, and K2's
              gradient into each layout, the full one's symmetrized within
              K2_TOL of the packed one's;
 28. dp-stage1  at each rank layout (dp_layouts: with two or more cards
              one rank a card over NCCL at 1, 2 and min(count, 4) ranks;
              with one card two ranks on it over gloo, and a line saying
              the NCCL layouts need two cards), one parallel.spawn a
              layout, every line naming its layout: DP1_STEPS
              data-parallel stage-1 steps (parallel.make_dp_train_step)
              from the train phase's model and views, a camera a rank a
              step, a densify and an opacity reset inside; every replica
              bitwise equal after every step (sha256 of the model,
              statistics and Adam state, parallel.replica_digest), K1 and
              K2 once per rank per step, the first step against a hand
              combination in this process (each view's gradients and
              statistics alone, gradients averaged, statistics summed,
              radii maxed, one Adam step) under tests/test_torch_train.py's
              tolerances; ms per data-parallel step (utils.timing) and
              views per second, ms of parallel.replicate, and the ms
              (CUDA events) and bytes of the step's gradient all_reduce;
 29. dp-stage2  the same for DP2_STEPS steps of make_dp_train_step_stage2
              from the stage2 phase's state, its visibility traced anew
              through the ray-sharded trace; K4-fwd and K4-bwd once per rank
              per step, the env maps bitwise equal;
 30. sharded  make_sharded_trace over the layout's ranks on the stage-2
              model's rays (~6.5M): each ray's visibility bitwise equal to
              one K3 launch on all rays; make_sharded_shading(full_extras=
              True) through render_neilf._shade_points against the
              unsharded shading within 1e-6 (and whether bitwise); a
              render_neilf(is_training=False) view with both hooks against
              the unsharded view under k1-main's gate. Phases 28 to 30
              share one spawn a layout; then parallel-scaling: each
              layout's stage-1 and stage-2 ms a step and views per second
              (and over one rank's), all_reduce and replicate ms, the
              sharded trace's ms a rank against one launch, beside the
              card's name and power limit;
 31. cli-ranks  (two or more cards) the cli phase's scene through the
              CLIs' mains at --n_devices min(count, 4), one rank a card
              over NCCL, each rank counting its launches and holding each
              ray-sharded trace bitwise against one K3 launch on its rays
              (cli_rank): cli.train stage 1 (20 steps, a densify at 10),
              -t neilf (10 steps), cli.eval_nvs -t neilf against its own
              one-rank run (images bitwise, or within one u8 level and
              1e-4 dB), cli.relighting against the relight phase's
              frames; the replicas bitwise equal at the end of each
              training (parallel.check_replicas), the losses finite and
              falling, K1, K2 (and K4) once a step on every rank; the
              eval's ms a view at n ranks and at one;
 32. prune-only  stage-1 steps of a copy of the train phase's model (its
              statistics and Adam state, through save_checkpoint and
              load_train_state) on its views (K1, K2): 10 steps, models.
              gaussians.prune_only with max_screen_size inf, 10 steps, again
              with 20 (statistics live), each held bitwise to the rows, Adam
              state and statistics selected on the host from the same
              tensors, then 20 more steps with a finite loss; the count
              pruned, the points left and the ms of each prune.

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

import contextlib
import dataclasses
import decimal
import functools
import hashlib
import itertools
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
from relightable3dgaussian_tpu_torch.cli.arguments import rank_devices
from relightable3dgaussian_tpu_torch.models.gaussians import STATS as G_STATS
from relightable3dgaussian_tpu_torch.models.gaussians import (
    WEIGHTS_PRUNE, GaussianModel, StatContribs, apply_stat_contribs,
    create_from_pcd, densification_contribs, prune_only)
from relightable3dgaussian_tpu_torch.losses import lpips
from relightable3dgaussian_tpu_torch.models import render_neilf as neilf
from relightable3dgaussian_tpu_torch.models.lights import (EnvLight,
                                                           load_env_light,
                                                           query_light)
from relightable3dgaussian_tpu_torch.models.render import (ViewInputs, render,
                                                           view_features)
from relightable3dgaussian_tpu_torch.models.render_neilf import (
    EVAL_FEATURE_DIM, render_neilf, update_visibility, visibility_rays)
from relightable3dgaussian_tpu_torch.ops import (_build, composite_cuda,
                                                 ray_trace, ray_trace_cuda,
                                                 shading_cuda,
                                                 shading_eval_cuda)
from relightable3dgaussian_tpu_torch.ops.camera import (CameraParams,
                                                        make_camera_params)
from relightable3dgaussian_tpu_torch.ops.composite import composite as composite_plain
from relightable3dgaussian_tpu_torch.ops.composite import (
    BLEND_AT_CAP, composite_backward, replay_backward, split_pixels,
    walk_state)
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.projection import (Preprocessed,
                                                           preprocess)
from relightable3dgaussian_tpu_torch.ops.rasterize import prepare, rasterize
from relightable3dgaussian_tpu_torch.ops.rasterize_dense import (
    _alpha_at, rasterize_dense)
from relightable3dgaussian_tpu_torch.ops.shading import ggx_terms
from relightable3dgaussian_tpu_torch.ops.tiles import Binning
from relightable3dgaussian_tpu_torch.parallel import (make_dp_train_step,
                                                      make_dp_train_step_stage2,
                                                      replicate, spawn)
from relightable3dgaussian_tpu_torch.parallel import data_parallel
from relightable3dgaussian_tpu_torch.parallel.data_parallel import (
    all_reduce_, choose_backend, replica_digest)
from relightable3dgaussian_tpu_torch.parallel.point_sharded import (
    make_sharded_shading, make_sharded_trace)
from relightable3dgaussian_tpu_torch.raster import (
    GaussianRasterizationSettings, GaussianRasterizer, mark_visible)
from relightable3dgaussian_tpu_torch.scene.cameras import Camera
from relightable3dgaussian_tpu_torch.scene.dataset_readers import _blender_pose
from relightable3dgaussian_tpu_torch.scene.exr import write_exr_zip
from relightable3dgaussian_tpu_torch.scene.image_io import read_png, write_png
from relightable3dgaussian_tpu_torch.scene.ply_io import save_gaussian_ply
from relightable3dgaussian_tpu_torch.train.checkpoint import (
    load_checkpoint, load_env_checkpoint, load_train_state, save_checkpoint,
    save_env_checkpoint)
from relightable3dgaussian_tpu_torch.train import stage2
from relightable3dgaussian_tpu_torch.train.config import (
    STAGE1_NERF_SYNTHETIC, STAGE2_NERF_SYNTHETIC, ModelConfig,
    OptimizationConfig, PipelineConfig)
from relightable3dgaussian_tpu_torch.train.optim import (
    learning_rates, make_env_optimizer, make_optimizer, set_learning_rates,
    start_state)
from relightable3dgaussian_tpu_torch.train.stage1 import (
    StepTimer, backward_or_zero_grads, densify_step, reset_opacity_step,
    run_training_schedule, train_step)
from relightable3dgaussian_tpu_torch.utils import trace
from relightable3dgaussian_tpu_torch.utils.graphics import \
    fibonacci_sphere_sampling
from relightable3dgaussian_tpu_torch.utils.quaternions import (
    strip_symmetric, unpack_symmetric)
from relightable3dgaussian_tpu_torch.utils.sh import C0, rgb_to_sh
from relightable3dgaussian_tpu_torch.utils.timing import Timing

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 0
CARD = ""    # nvidia-smi's name and power limit of the card, set by main
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
# k2-split: K2 against a float64 replay of K1's own blend decisions (read by
# the check kernel csrc/composite_decisions.cu) at the split pixels, which
# the gate above leaves out, under K2_TOL. Split pixels are rare on a
# trained model, so the phase also builds SPLIT_P gaussians, all in every
# tile of a SPLIT_SIZE^2 image, each with its opacity set so that its alpha
# at one pixel 1-2 sigma from its centre is 1/255 to float32 rounding: K1
# fuses two products of the power that the plain version rounds apart, and
# in a float32 emulation of both 8% of those pairs land on either side of
# 1/255.
SPLIT_P, SPLIT_SIZE, SPLIT_A = 3000, 128, 9
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
# FP32 operations per (point, sample) of K6: K4-fwd's 220 (the env mix
# included), the env lookup's transform 15, angles and grid coordinates 12
# (acosf and atan2f one each), corner weights 8 and blend 24, and the sums
# of the incident, local and global lights and the visibility 10: 289.
K6_OPS = 289
# K6 at s2-relight's shapes: points, samples, the env map's height (a
# 512 x 1024 map), and the light's turn about +z.
K6_P, K6_S, K6_ENV_H, K6_TURN = 300_000, 64, 512, 0.3
# K6 (float32) against the plain version in float64, per output: within
# K6_TOL of the field's scale (1 + its largest entry) or within K6_SLACK
# times the plain float32 version's own error (tests/test_torch_shading_eval.py
# TOL, SLACK: the lookup's float32 coordinates are grid_sample's too).
K6_TOL, K6_SLACK = 4e-6, 2.0
K6_SOURCE = "relightable3dgaussian_tpu_torch/csrc/shading_eval.cu"
K6_REPLACES = ("none: the JAX package leaves the eval shading to XLA "
               "(models/render_neilf.py::_shade_chunk_reduced)")
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
# version's own error, whichever is larger. Every point counts: K4 takes
# sign(V.N), by which it turns the normal to the viewer, from float64, so at
# a grazing view it shades the reference's function (examples/
# k4_grazing.py; where float32's sign was 0 or the other one, K4 shaded
# another: a viewdirs gradient of 10.81 against 0.0013).
K4_RTOL, K4_ATOL, K4_BWD_TOL, K4_SLACK = 1e-4, 1e-5, 1e-4, 2.0
# k4-branches: each case puts one operand of a float32 clip of K4
# (csrc/shading.cu: the GGX denominator q, NoV, NoH or VoH against 1e-6) at
# K4_CLIP (1 + delta) in float64, point i's delta the (i // 2)-th of
# K4_BRANCH_DELTAS in turn, + on even i and - on odd: the grid passes
# through float32's own rounding of the operand, so float32 alone decides
# the clip either way on some points; 1e-4, 5e-4 and 2e-3 lie inside, at
# and beyond the edge of K4's band about 1e-6 for q (shading_cuda.Q_BAND:
# inside it K4 decides q's clip from float64, beyond it from float32). K4
# decides the clips of K4_SLACK_FREE's operands from float64 where float32
# could err, so there it is held to its tolerance alone, without K4_SLACK.
K4_CLIP = 1e-6
K4_BRANCHES = {"q-clip": "q", "nov-clip": "NoV", "noh-clip": "NoH",
               "voh-clip": "VoH"}          # case: the operand it forces
K4_BRANCH_CASES = tuple(K4_BRANCHES)
K4_BRANCH_DELTAS = (1e-8, 3e-8, 1e-7, 3e-7, 1e-6, 3e-6, 1e-5, 1e-4, 5e-4,
                    2e-3)
K4_SLACK_FREE = ("q-clip", "nov-clip", "voh-clip")
K4_BRANCH_P = 2000


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
    try:
        torch.testing.assert_close(got.image[agree], want.image[agree],
                                   atol=IMG_ATOL, rtol=IMG_RTOL)
    except AssertionError as e:
        far = agree & ((got.image - want.image).abs()
                       > IMG_ATOL + IMG_RTOL * want.image.abs()).any(-1)
        raise AssertionError(
            f"{label}: K1's image apart from the plain compositor's at "
            f"{int(far.sum())} pixels of equal counts, {int((far & split).sum())}"
            f" of them split pixels (their stops or final T apart: "
            f"ops/composite.py::split_pixels); {e}") from None
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


def forced_split_args(device, seed: int = SEED + 12, n: int = SPLIT_P,
                      size: int = SPLIT_SIZE, A: int = SPLIT_A) -> tuple:
    """Compositor inputs on which K1 and the plain compositor are certain
    to blend other pairs somewhere (SPLIT_P's note): every tile's range
    holds all n gaussians, widths 1-3 pixels at random angles, each with
    its alpha at one pixel set to 1/255 in float64, and seeded attributes."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mean = rng.uniform(0, size, (n, 2))
    sig = rng.uniform(1.0, 3.0, (n, 2))
    th = rng.uniform(0.0, np.pi, n)
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], -2)
    inv = np.linalg.inv(rot @ (np.eye(2) * (sig ** 2)[:, None, :])
                        @ rot.transpose(0, 2, 1))
    conic = inv[:, [0, 0, 1], [0, 1, 1]].astype(f32)
    mean = mean.astype(f32)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    reach = rng.uniform(1.0, 2.0, n) * sig.mean(1)
    target = np.clip(np.round(mean + np.stack([np.cos(ang), np.sin(ang)], -1)
                              * reach[:, None]), 0, size - 1)
    dx, dy = (mean.astype(np.float64) - target).T
    a, b, c = conic.astype(np.float64).T
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    opacity = np.minimum(np.exp(-power) / 255.0, 0.99).astype(f32)
    cfg = RasterConfig(size, size)
    tiles = cfg.num_tiles

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    binning = Binning(t(np.tile(np.arange(n), tiles), torch.int32),
                      t(np.arange(tiles) * n, torch.int32),
                      t((np.arange(tiles) + 1) * n, torch.int32), tiles * n)
    attrs = rng.uniform(0.0, 1.0, (n, A))
    return (binning, t(mean), t(conic), t(opacity), t(attrs), cfg)


def check_k2_split(args, label: str, seed: int) -> dict:
    """K2 (from K1's walk state) against the float64 replay of K1's own
    blend decisions at the pixels where K1 and the plain compositor blend
    other pairs, for a seeded image cotangent on those pixels alone; the
    decisions' walk must be K1's, bitwise (final T, stop, count). Raises
    past K2_TOL. Returns the count of split pixels and the largest relative
    error over the gradient fields."""
    binning, mean2d, conic, opacity, attrs, cfg = args
    out, walk = composite_cuda.composite_k1(*args)
    plain, split = k1_split(args, out, walk)
    pixels = torch.nonzero(split.flatten()).flatten()
    dec = composite_cuda.blend_decisions(binning, mean2d, conic, opacity,
                                         pixels, cfg)
    apart = [name for name, a, b in (
        ("final_T", dec.final_T, walk.final_T.flatten()[pixels]),
        ("stop", dec.stop, walk.stop.flatten()[pixels]),
        ("n_contrib", dec.n_contrib, out.n_contrib.flatten()[pixels]))
        if not torch.equal(a, b)]
    if apart:
        raise AssertionError(f"{label}: the decisions' walk is not K1's: "
                             f"{apart} apart")
    A = attrs.shape[1]
    gen = torch.Generator(device=attrs.device).manual_seed(seed)
    g_pixels = torch.randn((pixels.numel(), A), generator=gen,
                           device=attrs.device)
    g_image = torch.zeros_like(out.image)
    g_image.view(-1, A)[pixels] = g_pixels
    got = composite_cuda.composite_k2(binning, mean2d, conic, opacity, attrs,
                                      walk, g_image, None, cfg)
    want = replay_backward(binning, mean2d, conic, opacity, attrs, pixels,
                           dec.codes, g_pixels, cfg)
    torch.cuda.synchronize()
    rel, abs_err = grad_errors(label, "K2", got, want)
    worst = max(rel.values())
    say(label, pairs=binning.num_rendered, attrs=A,
        split_pixels=pixels.numel(),
        count_equal_splits=int((dec.n_contrib == plain.n_contrib.flatten()
                                [pixels]).sum()),
        pairs_blended=int(dec.n_contrib.sum()),
        pairs_at_cap=int((dec.codes == BLEND_AT_CAP).sum()),
        max_rel_err={k: f"{v:.3e}" for k, v in rel.items()},
        max_abs_err=f"{abs_err:.3e}")
    if worst > K2_TOL:
        raise AssertionError(f"{label}: K2 against the float64 replay of K1's "
                             f"decisions, max relative error {rel} > {K2_TOL}")
    return {"pixels": pixels.numel(), "max_rel_err": worst}


@torch.no_grad()
def k2_split_phase(main_args, s2: dict) -> dict:
    """check_k2_split on k2-main's inputs, on k12-stage2's train-width
    inputs and on forced_split_args; raises where the forced input has no
    split pixel. Returns the kernels line's fields."""
    view, model = s2["views"][0], s2["model"]
    bg = torch.zeros(3, device=view.image.device)
    s2_args = captured_compositor_args(lambda: render_neilf(
        view, model, s2["cfg"], bg, s2["env"], s2["vis"], STAGE2_OPT,
        is_training=True))
    cases = {"k2-main": main_args, "k12-stage2": s2_args,
             "forced": forced_split_args(view.image.device)}
    res = {name: check_k2_split(args, f"k2-split {name}", 21 + i)
           for i, (name, args) in enumerate(cases.items())}
    if res["forced"]["pixels"] == 0:
        raise AssertionError("k2-split: no split pixel on the forced input")
    worst = max(r["max_rel_err"] for r in res.values())
    say("k2-split", split_pixels={k: r["pixels"] for k, r in res.items()},
        max_rel_err=f"{worst:.3e}")
    return {"k2_split_pixels": {k: r["pixels"] for k, r in res.items()},
            "k2_split_max_rel_err": worst}


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
    launches = {"K1": trace.counter("k1.launches"), "K2": trace.counter("k2.launches")}

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


def k4_worst_points(x, got, plain, exact, rows, n: int = 4) -> list[dict]:
    """For a K4 failure report: of the points `rows` ([P] bool), the n
    where `got` is farthest from `exact` ([P, ...]), with the view-normal
    cosine in float32 and float64, its sign as float32 alone takes it and
    as K4 takes it, from float64 (shading_cuda.view_side), the roughness,
    and the kernel's, the plain and the float64 values there."""
    far = (got.double() - exact).abs().reshape(got.shape[0], -1).amax(1)
    far = torch.where(rows, far, -1.0)
    side32, side64 = shading_cuda.view_side(x[2], x[3])
    out = []
    for i in far.topk(min(n, int(rows.sum()))).indices.tolist():
        nrm, vd = x[2][i], x[3][i]
        cos32 = float((nrm / nrm.norm()) @ (vd / vd.norm()))
        n64, v64 = nrm.double(), vd.double()
        cos64 = float((n64 / n64.norm()) @ (v64 / v64.norm()))
        out.append({"point": i, "cos_nv32": f"{cos32:.3e}",
                    "cos_nv64": f"{cos64:.3e}",
                    "sign32": int(side32[i]), "k4_sign": int(side64[i]),
                    "roughness": f"{float(x[1][i]):.4f}",
                    "got": got[i].flatten()[:3].tolist(),
                    "plain": plain[i].flatten()[:3].tolist(),
                    "exact": exact[i].flatten()[:3].tolist()})
    return out


def plain_shading_graph(x, cot, voh_pass=None):
    """The plain shading's forward under autograd: (leaves base_color,
    roughness, viewdirs, shs, global_light; Σ cot · outputs); `voh_pass`
    [P, S, 1], where given, decides VoH's lower clip (reference_voh_pass)."""
    leaves = [x[i].detach().clone().requires_grad_() for i in (0, 1, 3, 4, 5)]
    bc, rough, vdir, shs, gl = leaves
    outs = shading_cuda.rendering_equation_train_reference(
        bc, rough, x[2], vdir, shs, gl, *x[6:], voh_pass=voh_pass)
    return leaves, sum((c * o).sum() for c, o in zip(cot, outs))


def exact_voh(v, d) -> decimal.Decimal:
    """V.H with V = v / |v| and H = (d + V) / |d + V|, in 60 digits, from
    the float32 view direction v [3] and sample d [3]."""
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        v = [decimal.Decimal(float(a)) for a in v]
        d = [decimal.Decimal(float(a)) for a in d]
        m = sum(a * a for a in v).sqrt()
        V = [a / m for a in v]
        s = [a + b for a, b in zip(d, V)]
        return sum(a * b for a, b in zip(V, s)) / sum(a * a for a in s).sqrt()


def reference_voh_pass(x) -> tuple[torch.Tensor, dict]:
    """VoH's lower-clip decision [P, S, 1] for check_k4's float64
    reference, on rendering_equation_train's inputs x: at the samples K4
    takes to its fix-up (shading_cuda.k4_clip_passes' "double"), the exact
    one (exact_voh in 60 digits: there 1 + V.d cancels to ~3e-10, and
    float64's own decision can go either way within ~8e-6 of 1e-6 of the
    clip); elsewhere float64's. Returns it and a count of those samples and
    of the ones where float64 decides otherwise."""
    vdir, dirs = x[3], x[7]
    voh64 = ggx_terms(x[2].double(), vdir.double(), dirs.double(),
                      x[1].double())["VoH"]
    want = voh64 >= K4_CLIP
    marked = shading_cuda.k4_clip_passes(x[2], vdir, x[1], dirs)["double"]
    rows = marked.nonzero().cpu().numpy()
    if len(rows):
        v, d = vdir.cpu().numpy(), dirs.cpu().numpy()
        clip = decimal.Decimal(K4_CLIP)
        exact = torch.tensor([exact_voh(v[p], d[p, j]) >= clip
                              for p, j in rows], device=want.device)
        idx = torch.as_tensor(rows.T, device=want.device)
        apart = int((want[idx[0], idx[1], 0] != exact).sum())
        want = want.clone()
        want[idx[0], idx[1], 0] = exact
    else:
        apart = 0
    return want, {"voh_exact_samples": len(rows),
                  "float64_voh_apart_from_exact": apart}


def check_k4(x, label: str, seed: int, reps: int = 10, plain_reps: int = 3,
             min_dshs: float | None = None, timed: bool = True,
             slack: bool = True):
    """K4-fwd and K4-bwd against the plain shading on the same inputs and a
    seeded cotangent, at every point, each held against the plain shading
    in float64 (VoH's clip decided exactly where K4 takes it past float64:
    reference_voh_pass) beside the plain float32 version's own error (K4_SLACK;
    without `slack`, to K4's tolerance alone), and with `min_dshs` the SH
    gradient's largest entry above it; raises on disagreement. Returns the
    numbers for the kernels line, fwd and bwd (without `timed`, no times),
    and a report: each field's error, K4's and the plain version's, whether
    K4 is within its tolerance alone, and how many points float32 alone
    would have turned the other way at sign(V·N) (shading_cuda.view_side;
    K4 takes that sign from float64), and reference_voh_pass' counts."""
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
    voh_pass, voh_info = reference_voh_pass(x)
    with torch.enable_grad():
        leaves, loss = plain_shading_graph(x, cot)
        plain_g = torch.autograd.grad(loss, leaves)
        leaves64, loss64 = plain_shading_graph(x64, cot64, voh_pass)
        exact_g = torch.autograd.grad(loss64, leaves64)
    side32, side64 = shading_cuda.view_side(x[2], x[3])
    every = torch.ones_like(side64, dtype=torch.bool)

    def fwd_err(a, e):
        return float(((a.double() - e).abs()
                      / (K4_ATOL + K4_RTOL * e.abs())).max())

    def bwd_err(a, e):
        return float((a.double() - e).abs().max()
                     / e.abs().max().clamp(min=1e-30))

    errs, within_tol, failures = {}, {}, []
    abs_err = {"fwd": 0.0, "bwd": 0.0}
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
            within_tol[f"{kind}.{name}"] = e_kernel <= tol
            limit = max(tol, K4_SLACK * e_plain) if slack else tol
            if e_kernel > limit:
                failures.append(
                    f"K4-{kind} {name} is {e_kernel} from float64, the plain "
                    f"float32 version {e_plain} (limit {limit}: "
                    + (f"max({tol}, {K4_SLACK} x that)" if slack
                       else "its tolerance alone")
                    + f"); worst points {k4_worst_points(x, g, p, e, every)}")
            abs_err[kind] = max(abs_err[kind], float((g - p).abs().max()))
    if failures:
        raise AssertionError(f"{label}: " + "; ".join(failures)
                             + f" (every field, K4's and the plain version's "
                             f"error: {errs})")
    if min_dshs is not None and not float(dshs.abs().max()) > min_dshs:
        raise AssertionError(f"{label}: K4-bwd's SH gradient "
                             f"{float(dshs.abs().max())} is not above {min_dshs}")
    info = {"float32_sign_flips": int(((side32 == 0)
                                       | (side32 != side64)).sum()),
            "errs": errs, "within_tol": within_tol, **voh_info}
    if not timed:
        return None, None, info
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
        float32_sign_flips=info["float32_sign_flips"],
        voh_exact_samples=info["voh_exact_samples"],
        float64_voh_apart_from_exact=info["float64_voh_apart_from_exact"],
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
             "plain_ms": plain_bwd_ms, **bwd_bound, "library_ms": None}, info)


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


def k6_case(P: int, S: int, seed: int, device, env_h: int = K6_ENV_H):
    """rendering_equation_eval's inputs at s2-relight's shapes, seeded:
    unit normals, view directions of length 1-4, Fibonacci samples,
    visibility in [0, 1), roughness in [0.09, 0.99], base colour in [0, 1),
    local-light SH about 0.1, and an `EnvLight` [env_h, 2 env_h] (a smooth
    random sky, 0.5-1.5, with a sun of radiance 50 in a 2-degree disc at
    40 degrees' elevation) turned K6_TURN about +z."""
    g = torch.Generator().manual_seed(seed)

    def unit(n):
        v = torch.randn((n, 3), generator=g)
        return v / v.norm(dim=-1, keepdim=True)

    normals = unit(P)
    viewdirs = unit(P) * (1 + 3 * torch.rand((P, 1), generator=g))
    dirs, areas = fibonacci_sphere_sampling(normals, S)
    sky = 0.5 + torch.rand((1, 3, 16, 32), generator=g)
    sky = F.interpolate(sky, size=(env_h, 2 * env_h), mode="bilinear",
                        align_corners=True)[0].permute(1, 2, 0)
    phi = torch.linspace(0, math.pi, env_h)[:, None]
    theta = -math.pi * torch.linspace(-1, 1, 2 * env_h)[None, :]
    d = torch.stack(torch.broadcast_tensors(
        torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta),
        torch.cos(phi)), -1)
    el = math.radians(40.0)
    sun = torch.tensor([math.cos(el), 0.0, math.sin(el)])
    img = sky + 50.0 * ((d @ sun) > math.cos(math.radians(2.0)))[..., None]
    turn = torch.tensor(rotation((0, 0, 1), K6_TURN), dtype=torch.float32)
    x = (torch.rand((P, 3), generator=g),
         0.09 + 0.9 * torch.rand((P, 1), generator=g), normals, viewdirs,
         0.1 * torch.randn((P, 16, 3), generator=g),
         EnvLight(img.contiguous(), turn), torch.rand((P, S, 1), generator=g),
         dirs, areas)
    return k6_to(x, device, torch.float32)


def k6_to(x, device, dtype) -> tuple:
    """rendering_equation_eval's inputs on `device` in `dtype`."""
    return tuple(
        EnvLight(a.envmap.to(device, dtype), a.transform.to(device, dtype))
        if isinstance(a, EnvLight) else a.to(device, dtype).contiguous()
        for a in x)


def k6_eval_phase(device, reps: int = 20, plain_reps: int = 3) -> dict:
    """K6 against the plain eval shading at s2-relight's shapes (K6_P
    points, K6_S samples, a 2:1 map K6_ENV_H high, turned), each output held
    against the plain version in float64 (K6_TOL, or K6_SLACK times the
    plain float32 version's own error); K6 timed beside the plain version
    in float32 (its chunks of render_neilf.SHADE_CHUNK_SAMPLES samples) and
    against its bound."""
    x = k6_case(K6_P, K6_S, SEED + 16, device)
    reset_launches()
    got = shading_eval_cuda.rendering_equation_eval(*x)
    torch.cuda.synchronize()
    if read_launches()["K6"] != 1:
        raise AssertionError(f"k6-eval: K6 launched {read_launches()['K6']} "
                             "times for one call")
    chunk = neilf.SHADE_CHUNK_SAMPLES
    plain = shading_eval_cuda.rendering_equation_eval_reference(
        *x, chunk_samples=chunk)
    exact = shading_eval_cuda.rendering_equation_eval_reference(
        *k6_to(x, device, torch.float64), chunk_samples=chunk)
    names = ("pbr",) + shading_eval_cuda.EXTRA_KEYS
    flat = lambda r: (r[0],) + tuple(r[1][k] for k in names[1:])  # noqa: E731
    errs, failures, max_abs = {}, [], 0.0
    for name, g, p, e in zip(names, flat(got), flat(plain), flat(exact)):
        if g.shape != e.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"k6-eval: {name} {tuple(g.shape)} not finite "
                                 f"or not {tuple(e.shape)}")
        e_k = float((g.double() - e).abs().max())
        e_p = float((p.double() - e).abs().max())
        scale = 1.0 + float(e.abs().max())
        errs[name] = (f"{e_k:.3e}", f"{e_p:.3e}", f"{scale:.3f}")
        max_abs = max(max_abs, float((g - p).abs().max()))
        if e_k > max(K6_TOL * scale, K6_SLACK * e_p):
            failures.append(f"{name}: {e_k} from float64, plain float32 "
                            f"{e_p}, scale {scale}")
    if failures:
        raise AssertionError("k6-eval: " + "; ".join(failures)
                             + f" (every output: K6's, the plain version's "
                             f"error, the scale: {errs})")
    del plain, exact
    ms = cuda_ms(lambda: shading_eval_cuda.rendering_equation_eval(*x), reps)
    plain_ms = cuda_ms(
        lambda: shading_eval_cuda.rendering_equation_eval_reference(
            *x, chunk_samples=chunk), plain_reps)
    ki = shading_eval_cuda.kernel_inputs(*x)
    b = bound(nbytes(*ki) + nbytes(*flat(got)), K6_P * K6_S * K6_OPS)
    say("k6-eval", points=K6_P, samples=K6_S,
        env=f"{K6_ENV_H}x{2 * K6_ENV_H}", card=f"'{CARD}'",
        err_kernel_plain_vs_float64_scale=errs, max_abs_err=f"{max_abs:.3e}",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
        bytes=nbytes(*ki) + nbytes(*flat(got)), ops=K6_P * K6_S * K6_OPS,
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def k4_branch_deltas(n: int, deltas=K4_BRANCH_DELTAS) -> np.ndarray:
    """Point i's delta: the (i // 2)-th of `deltas` in turn, + on even i and
    - on odd."""
    i = np.arange(n)
    return (np.asarray(deltas, np.float64)[(i // 2) % len(deltas)]
            * np.where(i % 2 == 0, 1.0, -1.0))


def _unit64(a) -> np.ndarray:
    a = np.asarray(a, np.float64)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _perp(rng, a: np.ndarray) -> np.ndarray:
    """Seeded unit vectors perpendicular to the unit vectors a [n, 3]."""
    u = rng.normal(size=a.shape)
    return _unit64(u - (u * a).sum(-1, keepdims=True) * a)


def k4_clip_operands(g: dict) -> dict:
    """The clip operands of the plain version in float64 (ops/shading.py::
    ggx_terms) from the float32 inputs `g` (numpy): normals, viewdirs
    [n, 3], roughness [n] and one sample's direction `dirs` [n, 3] (none
    for nov-clip). {"NoV", "NoH", "VoH", "q"}, each [n], the last three at
    that sample."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    dirs = g["dirs"] if g.get("dirs") is not None else g["normals"]
    terms = ggx_terms(t(g["normals"]), t(g["viewdirs"]), t(dirs)[:, None],
                      t(g["roughness"])[:, None])
    return {k: v.reshape(-1).numpy() for k, v in terms.items() if k != "f_s"}


def _knob_operand(g: dict, op: str, knob: tuple, value: np.ndarray):
    key, c = knob
    moved = g[key].astype(np.float64)
    moved[:, c] = value
    return k4_clip_operands({**g, key: moved})[op]


def _newton(g: dict, op: str, knob: tuple, target: np.ndarray, h: float,
            iters: int = 4) -> np.ndarray:
    """Newton steps on the float32 component `knob` (key, index) of g
    towards operand `op` == target, each rounded to float32; returns the
    last slope d op / d knob."""
    key, c = knob
    for _ in range(iters):
        x0 = g[key][:, c].astype(np.float64)
        slope = (_knob_operand(g, op, knob, x0 + h)
                 - _knob_operand(g, op, knob, x0 - h)) / (2 * h)
        g[key][:, c] = x0 - (k4_clip_operands(g)[op] - target) / slope
    return slope


def _lattice(g: dict, op: str, key: str, target: np.ndarray,
             comps: tuple = (0, 1, 2), reach: int = 3) -> None:
    """Moves components `comps` of each vector g[key] by up to `reach`
    steps each, a step the ulp of the vector's largest component, to the
    float32 vector whose operand `op` lies nearest `target`."""
    base = g[key].copy()
    ulp = np.spacing(np.abs(base).max(-1, keepdims=True))
    best, pick = np.full(len(base), np.inf), base.copy()
    for step in itertools.product(range(-reach, reach + 1), repeat=len(comps)):
        move = np.zeros(3, np.float32)
        move[list(comps)] = step
        g[key] = (base + move * ulp).astype(np.float32)
        err = np.abs(k4_clip_operands(g)[op] - target)
        better = err < best
        best[better], pick[better] = err[better], g[key][better]
    g[key] = pick


def _settle(g: dict, op: str, knob: tuple, delta: np.ndarray,
            slope: np.ndarray, reach: int = 32) -> None:
    """Sets the knob, within `reach` steps of 2% of delta's operand (or of
    one ulp, where that is coarser), to the float32 value whose operand
    lies at K4_CLIP (1 + delta') nearest 0.9 delta with 0.8 <= delta' /
    delta <= 1."""
    key, c = knob
    x0 = g[key][:, c].astype(np.float64)
    step = np.maximum(np.spacing(g[key][:, c]).astype(np.float64),
                      0.02 * np.abs(delta) * K4_CLIP / np.abs(slope))
    best, pick = np.full(len(x0), np.inf), g[key][:, c].copy()
    for j in range(-reach, reach + 1):
        g[key][:, c] = x0 + j * step
        ratio = (k4_clip_operands(g)[op] / K4_CLIP - 1) / delta
        score = np.where((ratio >= 0.8) & (ratio <= 1.0),
                         np.abs(ratio - 0.9), np.inf)
        better = score < best
        best[better], pick[better] = score[better], g[key][better, c]
    g[key][:, c] = pick


def k4_branch_geometry(case: str, delta: np.ndarray, seed: int) -> dict:
    """Seeded float32 normals, viewdirs [n, 3], roughness [n] and (but for
    nov-clip) one sample's direction `dirs` [n, 3] whose float64 operand of
    the case's clip (k4_clip_operands) lies at K4_CLIP (1 + delta') with
    0.8 <= delta' / delta[i] <= 1 at each point i:
      * q-clip: the sample near the specular peak of a surface of roughness
        0.09-0.15 (0.2 would keep q above 1e-6), NoL 0.2-0.9;
      * nov-clip: the view 1e-6 above the tangent plane;
      * noh-clip: the half vector 1e-6 above the tangent plane, the view
        behind the normal (so n.d > 0 and the sample lights the point);
      * voh-clip: the sample a few 1e-4 off the opposite of the view,
        behind the normal. VoH = (1 + V.d) / |d + V| reaches 1e-6 only
        where |d| > 1, so the sample is float32's unit vector made one ulp
        longer where it is not.
    The sample (nov-clip: the normal) lies in the xy-plane: its z
    component, tiny, is a knob whose float32 ulps move the operand by less
    than 1e-15. Rounding the other vectors to float32 moves the operand by
    up to ~1e-7 (q: ~1e-5 of itself); a search over their last bits
    (_lattice; voh-clip: Newton on V's z) brings it near, then Newton and
    _settle on the knob put it in place."""
    op = K4_BRANCHES[case]
    rng = np.random.default_rng(seed)
    n = len(delta)
    target = K4_CLIP * (1 + 0.9 * delta)
    ez = np.array([0.0, 0.0, 1.0])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    ang = rng.uniform(0, 2 * np.pi, n)
    flat = np.stack([np.cos(ang), np.sin(ang), 0 * ang], -1)   # xy-plane
    side = np.stack([-np.sin(ang), np.cos(ang), 0 * ang], -1)
    r = rng.uniform(0.05, 0.95, n)

    def bisect(f, lo, hi, iters=100):       # f increasing on [lo, hi]
        for _ in range(iters):
            mid = (lo + hi) / 2
            below = f(mid) < target
            lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
        return lo

    if op == "NoV":
        tilt = rng.uniform(0.3, 1.2, n)[:, None]
        w = np.cos(tilt) * side + np.sin(tilt) * ez
        g = {"normals": f32(flat), "viewdirs": f32(K4_CLIP * flat + w),
             "roughness": f32(r)}
        _lattice(g, op, "viewdirs", target)
        _lattice(g, op, "normals", target, (0, 1))
        knob = ("normals", 2)
    elif op == "q":
        d = flat
        r = rng.uniform(0.09, 0.15, n)
        k = (r * r + 2 * r + 1) / 8
        # NoL at most where q at the peak, 4 pi alpha^4 nom2^2, is 1e-6 / 2
        top = np.clip((np.sqrt(0.5e-6 / (4 * np.pi * r ** 8)) - k) / (1 - k),
                      0.2, 0.9)
        nol = 0.2 + (top - 0.2) * rng.uniform(size=n)
        tilt = rng.uniform(0.2, 1.0, n)[:, None]
        nrm = nol[:, None] * d + np.sqrt(1 - nol ** 2)[:, None] * (
            np.cos(tilt) * side + np.sin(tilt) * ez)
        # h tilts off the normal along t, which rises out of the xy-plane:
        # d z moves nom0 by ~ sin(theta) t_z, so the knob keeps its grip
        up = _unit64(ez - nrm[:, 2:] * nrm)
        turn = rng.uniform(-0.7, 0.7, n)[:, None]
        t = np.cos(turn) * up + np.sin(turn) * np.cross(nrm, up)

        def view(th):                       # d mirrored about h(th)
            h = np.cos(th)[:, None] * nrm + np.sin(th)[:, None] * t
            return 2 * (h * d).sum(-1, keepdims=True) * h - d

        th = bisect(lambda th: k4_clip_operands(
            {"normals": nrm, "viewdirs": view(th), "dirs": d,
             "roughness": r})["q"], np.zeros(n), np.full(n, 0.3))
        g = {"normals": f32(nrm), "viewdirs": f32(view(th)), "dirs": f32(d),
             "roughness": f32(r)}
        _lattice(g, op, "viewdirs", target)
        knob = ("dirs", 2)
    elif op == "NoH":
        d = flat
        nov = rng.uniform(0.2, 0.8, n)
        tilt = rng.uniform(0.5, 1.2, n)[:, None]
        ns = (-nov[:, None] * d + np.sqrt(1 - nov ** 2)[:, None]
              * (np.cos(tilt) * side + np.sin(tilt) * ez))    # ns.d = -NoV
        p = _perp(rng, ns)
        p = np.where((p * d).sum(-1, keepdims=True) < 0, -p, p)  # V off -d

        def view(c):                        # V.ns = c
            return c[:, None] * ns + np.sqrt(1 - c ** 2)[:, None] * p

        c = bisect(lambda c: (ns * _unit64(d + view(c))).sum(-1),
                   nov - 0.01, nov + 0.01)
        g = {"normals": f32(-ns), "viewdirs": f32(view(c)), "dirs": f32(d),
             "roughness": f32(r)}
        _lattice(g, op, "viewdirs", target)
        knob = ("dirs", 2)
    else:
        d = f32(flat)
        big = np.abs(d).argmax(-1)
        rows = np.arange(n)
        while True:                         # |d| > 1
            short = (d.astype(np.float64) ** 2).sum(-1) <= 1
            if not short.any():
                break
            i, j = rows[short], big[short]
            d[i, j] = np.nextafter(d[i, j],
                                   np.sign(d[i, j]) * np.float32(np.inf))
        u = _unit64(d)

        def view(b):                        # b off the opposite of d
            return -(np.cos(b)[:, None] * u + np.sin(b)[:, None] * ez)

        b = bisect(lambda b: (view(b) * _unit64(d + view(b))).sum(-1),
                   np.zeros(n), np.full(n, 0.05))
        nol = rng.uniform(0.2, 0.9, n)[:, None]
        g = {"normals": f32(nol * u + np.sqrt(1 - nol ** 2) * _perp(rng, u)),
             "viewdirs": f32(view(b)), "dirs": d, "roughness": f32(r)}
        _newton(g, op, ("viewdirs", 2), target, 1e-7)
        knob = ("dirs", 2)
    slope = _newton(g, op, knob, target, 1e-9)
    _settle(g, op, knob, delta, slope)
    return g


def k4_branch_case(case: str, P: int, S: int, seed: int, device,
                   deltas=K4_BRANCH_DELTAS) -> tuple:
    """shading_case(P, S, seed) with every point forced onto `case`'s clip
    (k4_branch_geometry, point i at k4_branch_deltas' delta): its normal,
    view direction and roughness replaced, its samples made anew about the
    normal and (but for nov-clip) its last sample the forced one. Returns
    (the inputs, delta [P], delta' [P]: where the float64 operand lies)."""
    delta = k4_branch_deltas(P, deltas)
    g = k4_branch_geometry(case, delta, seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    x = list(shading_case(P, S, seed, device))
    x[1] = f(g["roughness"][:, None])
    x[2], x[3] = f(g["normals"]), f(g["viewdirs"])
    x[7], x[8] = fibonacci_sphere_sampling(x[2], S)
    if g.get("dirs") is not None:
        x[7][:, -1] = f(g["dirs"])
    reached = k4_clip_operands(g)[K4_BRANCHES[case]] / K4_CLIP - 1
    return tuple(x), delta, reached


def clip_decisions_apart(x) -> dict:
    """How many decisions (sign(V·N) and NoV's clip a point; NoH's, VoH's
    and q's a sample) are taken otherwise than by check_k4's reference (the
    plain version in float64, VoH's clip exact where K4 takes it past
    float64: reference_voh_pass), on rendering_equation_train's inputs x: by K4
    (shading_cuda.k4_clip_passes emulates its rule, view_side its sign),
    by K4's float32 chain alone (shading_cuda.k4_branch_operands, the sign
    from view_side), and by the plain float32 version; and how many samples
    K4 sends to its double branch, and at how many of them float64's own
    VoH decision is not the exact one. NoV, NoH and VoH pass their gradient
    at or above 1e-6, q within [1e-6, 4 pi]."""
    rough, nrm, vdir, dirs = x[1], x[2], x[3], x[7]
    P = nrm.shape[0]

    def passes(ops, lo, hi):
        out = {k: ops[k].reshape(P, -1) >= lo for k in ("NoV", "NoH", "VoH")}
        q = ops["q"].reshape(P, -1)
        out["q"] = (q >= lo) & (q <= hi)
        return out

    exact = ggx_terms(nrm.double(), vdir.double(), dirs.double(),
                      rough.double())
    voh_pass, voh_info = reference_voh_pass(x)
    side32, side64 = shading_cuda.view_side(nrm, vdir)
    plain_sign = torch.sign((torch.nn.functional.normalize(vdir, dim=-1)
                             * torch.nn.functional.normalize(nrm, dim=-1)
                             ).sum(-1))
    k4 = shading_cuda.k4_clip_passes(nrm, vdir, rough, dirs)
    double = int(k4.pop("double").sum())
    want = {"sign": side64, **passes(exact, K4_CLIP, 4 * math.pi),
            "VoH": voh_pass.reshape(P, -1)}
    sides = {
        "k4": {"sign": side64, **k4},
        "k4_float32": {"sign": side32, **passes(
            shading_cuda.k4_branch_operands(nrm, vdir, rough, dirs),
            shading_cuda.FLOAT32_CLIP, shading_cuda.K4_PI4)},
        "plain": {"sign": plain_sign, **passes(
            ggx_terms(nrm, vdir, dirs, rough), K4_CLIP, 4 * math.pi)}}
    out = {who: {k: int((v.reshape(want[k].shape) != want[k]).sum())
                 for k, v in side.items()} for who, side in sides.items()}
    out["k4_double_branch_samples"] = double
    out["float64_voh_apart_from_exact"] = voh_info[
        "float64_voh_apart_from_exact"]
    return out


def k4_branches_phase(device) -> None:
    """K4 on the four forced clip cases (k4_branch_case), K4_BRANCH_P
    points x SAMPLE_NUM samples each, under check_k4's gate, and the cases
    of K4_SLACK_FREE on K4's tolerance alone: one line a case (where the
    float64 operands lie, the decisions that differ from float64's, K4's
    and the plain version's error per field and whether K4's is within its
    tolerance); raises after the last case if any failed or if K4's rule
    (shading_cuda.k4_clip_passes) decides a sign or a clip of NoV, q or VoH
    otherwise than float64."""
    t0 = time.perf_counter()
    failed = []
    for i, case in enumerate(K4_BRANCH_CASES):
        x, delta, reached = k4_branch_case(case, K4_BRANCH_P, SAMPLE_NUM,
                                           SEED + 500 + i, device)
        ratio = reached / delta
        apart = clip_decisions_apart(x)
        line = {"points": K4_BRANCH_P, "samples": SAMPLE_NUM,
                "abs_delta": f"{min(K4_BRANCH_DELTAS):g}-"
                             f"{max(K4_BRANCH_DELTAS):g}",
                "reached_over_delta": f"{ratio.min():.3f}-{ratio.max():.3f}",
                "decisions_apart_from_float64": apart,
                "slack": case not in K4_SLACK_FREE}
        k4_apart = {k: v for k, v in apart["k4"].items()
                    if k != "NoH" and v}
        try:
            if k4_apart:
                raise AssertionError(f"K4's rule decides {k4_apart} "
                                     f"otherwise than float64")
            _, _, info = check_k4(x, f"k4-branches-{case}", SEED + 510 + i,
                                  timed=False,
                                  slack=case not in K4_SLACK_FREE)
        except AssertionError as e:
            failed.append(case)
            say(f"k4-branches-{case}", **line, FAILED=str(e))
            continue
        say(f"k4-branches-{case}", **line,
            err_kernel_plain_vs_float64=info["errs"],
            k4_within_tolerance_alone=info["within_tol"])
    say("k4-branches", cases=len(K4_BRANCH_CASES), failed=failed,
        wall_s=f"{time.perf_counter() - t0:.2f}")
    if failed:
        raise AssertionError(f"k4-branches: K4 failed the gate on {failed}")


LAUNCH_COUNTERS = {"K1": "k1.launches", "K2": "k2.launches",
                   "K3": "k3.launches", "K4-fwd": "k4.launches",
                   "K4-bwd": "k4.bwd_launches", "K5": "k5.launches",
                   "K6": "k6.launches"}


def reset_launches() -> None:
    for name in LAUNCH_COUNTERS.values():
        trace.set_counter(name, 0)


def read_launches() -> dict:
    return {k: trace.counter(name) for k, name in LAUNCH_COUNTERS.items()}


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
def stage2_eval_phase(s2: dict, device) -> dict:
    """render_neilf(is_training=False) of every view at 800x800: 3 + 27 + 2
    splatted channels, K1 and K6 once per view, every output finite.
    Returns the kernels' launch counts."""
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
    if (launches["K1"] != len(views) or launches["K6"] != len(views)
            or launches["K2"] or launches["K4-fwd"]):
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
        k6_launches=launches["K6"], ms_per_view_median=f"{float(np.median(view_ms[1:])):.3f}",
        view_ms=[round(ms, 3) for ms in view_ms],
        pbr_mean=f"{float(torch.stack([r['pbr'].mean() for r in results]).mean()):.4f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return launches


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
    included, as (bvh, o, d, T, indices)."""
    bvh, o, d = args[:3]
    R = o.shape[0]
    gen = torch.Generator().manual_seed(SEED + 9)
    head = torch.randperm(R - K3_TAIL, generator=gen)[:K3_SUBSET - K3_TAIL]
    idx = torch.cat([head.sort().values,
                     torch.arange(R - K3_TAIL, R)]).to(o.device)
    return bvh, o, d, T, idx


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
    k1-main's (check_k1). Returns K3's readings and its bound counted on
    all the rays (k3_bound)."""
    bvh, o_all, d_all, T_all, idx = k3.kept
    R = o_all.shape[0]
    o, d, T = o_all[idx], d_all[idx], T_all[idx]
    bnd, pairs = k3_bound(bvh, o_all, d_all, T_all)
    T_plain, plain_ms = timed_ms(
        lambda: ray_trace.trace_transmittance_plain(bvh, o, d))
    err, n_split, vis_plain = k3_gate(T, T_plain, f"{label}-k3")
    say(f"{label}-k3", gaussians=bvh.order.shape[0], rays=R,
        rays_checked=idx.numel(), last_ray_checked=int(idx[-1]),
        mean_vis=f"{float(vis_plain.mean()):.4f}", max_abs_err=f"{err:.3e}",
        rays_split=n_split, plain_ms=f"{plain_ms:.4f}",
        visible_ray_pairs_all_rays=pairs,
        bound_ms_all_rays=f"{bnd['bound_ms']:.4f}",
        bound_by_all_rays=bnd["bound_by"])
    check_k1(k1.kept, f"{label}-k1", k1_reps=3, plain_reps=1)
    return {"k3_max_abs_err": err, "k3_rays_split": n_split,
            "k3_bound_ms": bnd["bound_ms"], "k3_bound_by": bnd["bound_by"]}


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
    expect = {"K1": RELIGHT_FRAMES, "K3": 1, "K2": 0, "K4-fwd": 0, "K5": 0,
              "K6": RELIGHT_FRAMES}
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
            "root": root, "env": env, **traced_k3}


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
    lpips.reset()
    try:
        res, launches, wall, peak, k3, k1, renders = run_cli_timed(
            lambda: eval_relighting_syn4.main(
                ["-s", str(data), "-m", str(model_dir), "-c",
                 str(cli["stage2"] / f"chkpnt{cli['n2']}.npz"), "-e",
                 str(envs), "--sample_num", str(SYN4_SAMPLES)],
                device=device), eval_relighting_syn4)
        backbone = lpips.metric_name()
    finally:
        lpips.reset()
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
    expect = {"K1": 2 * n_frames, "K3": 1, "K2": 0, "K4-fwd": 0, "K5": 0,
              "K6": 2 * n_frames}
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


# The syn4-view phase: one scored view of the Synthetic4Relight evaluation
# (cli/eval_relighting_syn4.py::relight_view) at the benchmark cell
# s2-eval.syn4's shapes: points, and views timed after one warm-up.
SYN4_P, SYN4_VIEWS = 300_000, 4


def syn4_view_phase(device) -> dict:
    """relight_view at SYN4_P points and SYN4_SAMPLES samples a point (a
    seeded stage-2 model of the slice's pattern, base colour and
    roughness from the seed, the visibility traced by K3 over every
    ray), 800x800, under a 512 x 1024 map with hotdog's albedo scale and
    LPIPS_WEIGHTS=random: K6 launched once a view, its launch timed
    (CUDA events) against its bound at S = SYN4_SAMPLES (bytes and
    operations as k6_eval_phase counts them), the LPIPS forward of the
    view's four images timed, and the seven scores finite."""
    from relightable3dgaussian_tpu_torch.models.gaussians import add_pbr_params
    model = GaussianModel.from_numpy(make_scene(SYN4_P, SEED + 21, None),
                                     device=device)
    add_pbr_params(model)
    g = torch.Generator(device=device).manual_seed(SEED + 22)
    with torch.no_grad():
        model.base_color.copy_(torch.randn(model.base_color.shape,
                                           generator=g, device=device))
        model.roughness.copy_(torch.randn(model.roughness.shape,
                                          generator=g, device=device))
    t0 = time.perf_counter()
    vis = update_visibility(model, SYN4_SAMPLES)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    env = EnvLight(torch.as_tensor(np.ascontiguousarray(np.repeat(np.repeat(
        sky_envmap([0.5, 0.3, 0.8], [20.0, 19.0, 17.0], [0.3, 0.45, 0.8]),
        2, 0), 2, 1)), device=device))
    cfg = RasterConfig(SIZE_MAIN, SIZE_MAIN, sh_degree=3)
    truth = eval_relighting_syn4.GroundTruth(
        torch.rand((3, SIZE_MAIN, SIZE_MAIN), generator=g, device=device),
        (torch.rand((1, SIZE_MAIN, SIZE_MAIN), generator=g,
                    device=device) > 0.3).float(),
        torch.rand((3, SIZE_MAIN, SIZE_MAIN), generator=g, device=device),
        torch.rand((3, SIZE_MAIN, SIZE_MAIN), generator=g, device=device))
    scale = torch.tensor(eval_relighting_syn4.BASE_COLOR_SCALE["hotdog"],
                         device=device)
    saved = os.environ.get("LPIPS_WEIGHTS")
    os.environ["LPIPS_WEIGHTS"] = "random"
    lpips.reset()
    scores, view_ms = [], []
    try:
        with CallTimer(shading_eval_cuda, "_launch",
                       keep=lambda args, out: nbytes(*args) + nbytes(*out)
                       ) as k6, CallTimer(lpips, "lpips_each") as lp:
            for i in range(SYN4_VIEWS + 1):
                view = orbit_view(i, VIEWS, SIZE_MAIN, device)
                reset_launches()
                rv, ms = timed_ms(lambda: eval_relighting_syn4.relight_view(
                    view, model, cfg, env, vis, truth, base_color_scale=scale))
                if read_launches()["K6"] != 1:
                    raise AssertionError(f"syn4-view: K6 launched "
                                         f"{read_launches()['K6']} times")
                scores.append(rv.scores)
                view_ms.append(ms)
        backbone = lpips.metric_name()
    finally:
        lpips.reset()
        if saved is None:
            del os.environ["LPIPS_WEIGHTS"]
        else:
            os.environ["LPIPS_WEIGHTS"] = saved
    bad = [s for s in scores if not all(np.isfinite(v) for v in s.values())]
    if bad or backbone != "lpips(random-vgg)":
        raise AssertionError(f"syn4-view: scores {bad}, backbone {backbone}")
    b = bound(k6.kept, SYN4_P * SYN4_SAMPLES * K6_OPS)
    k6_ms = float(np.median(k6.ms[1:]))
    say("syn4-view", points=SYN4_P, samples=SYN4_SAMPLES, views=SYN4_VIEWS,
        card=f"'{CARD}'", trace_s=f"{trace_s:.3f}",
        k6_ms=f"{k6_ms:.4f}", k6_bound_ms=f"{b['bound_ms']:.4f}",
        k6_bound_by=b["bound_by"], k6_bytes=k6.kept,
        lpips_ms=f"{float(np.median(lp.ms[1:])):.3f}",
        view_ms=[round(ms, 3) for ms in view_ms[1:]],
        scores={k: round(v, 5) for k, v in scores[-1].items()},
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return {"ms": k6_ms, **b, "lpips_ms": float(np.median(lp.ms[1:]))}


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
    expect = {"K3": FINETUNE_ITERS, "K1": 0, "K2": 0, "K4-fwd": 0, "K5": 0,
              "K6": 0}
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


# The MVS phases: mvs-plane, tests/test_mvs.py's analytic scene (a textured
# plane z = A + B x + C y seen by cameras that look along +z) at 800x800
# (its focal scaled with the size, the texture's frequencies too, so its
# features span as many pixels as at 96x96), seven views (the centre and a
# hexagon of radius MVS_BASELINE), each matched against its five nearest
# (every view has sources on both sides), through cli.mvs.run_pipeline at
# the CLI's defaults but the probability threshold: this weight-free
# cascade's winning softmax mass is ~0.05-0.15 (the JAX package's the same),
# so the default .6 (the reference network's) keeps no pixel; MVS_PTHRESH
# is tests/test_mvs_pipeline.py's. Gated by the median relative depth error
# of the kept pixels (that test's 1%) and their share. mvs: the cli phase's
# test views through a COLMAP model the port writes, cli.mvs.main and
# cli.eval_nvs.
MVS_SIZE, MVS_FOCAL = 800, 110.0 * 800 / 96
MVS_PLANE = (2.5, 0.3, 0.2)
MVS_BASELINE, MVS_RING = 0.25, 6
MVS_DEPTH = (1.8, 3.6)
MVS_PTHRESH = ".05,.05,.05"
MVS_MAX_REL_ERR, MVS_MIN_KEPT = 0.01, 0.7
# The viewer: 24 frames at 800x800 (headless), the 30 FPS bar of bench.py:4;
# cli.train --gui for TRAIN_GUI_STEPS stage-1 steps.
GUI_FRAMES, FPS_BAR, TRAIN_GUI_STEPS = 24, 30.0, 20
# K4's gate over K4_SEEDS fresh sample directions on the stage-2 model.
K4_SEEDS = 20


def plane_view(tx: float, ty: float) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """The analytic plane from a camera at (tx, ty, 0) looking along +z:
    (world-to-camera extrinsic, grey image [H, W] in [0, 1], depth)."""
    A, B, C = MVS_PLANE
    n = MVS_SIZE
    ys, xs = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5,
                         indexing="ij")
    dx, dy = (xs - n / 2) / MVS_FOCAL, (ys - n / 2) / MVS_FOCAL
    t = (A + B * tx + C * ty) / (1 - B * dx - C * dy)   # depth: unit-z rays
    px, py = tx + t * dx, ty + t * dy
    k = MVS_SIZE / 96
    tex = (0.55 + 0.2 * np.sin(9.0 * k * px + 3.0) * np.sin(7.5 * k * py)
           + 0.2 * np.sin(4.0 * k * px) * np.cos(5.5 * k * py))
    E = np.eye(4)
    E[:2, 3] = (-tx, -ty)
    return E, np.clip(tex, 0, 1), t


def write_plane_scene(root: Path) -> dict:
    """images/, cams/ and pair.txt of the MVS_RING + 1 views (each view's
    sources: the others by distance, the nearest first); returns the
    ground-truth depths by name."""
    from relightable3dgaussian_tpu_torch.mvs.formats import (MVSCamera,
                                                            write_cam_txt,
                                                            write_pair_txt)
    (root / "images").mkdir(parents=True)
    (root / "cams").mkdir()
    K = np.array([[MVS_FOCAL, 0, MVS_SIZE / 2], [0, MVS_FOCAL, MVS_SIZE / 2],
                  [0, 0, 1]])
    centres = [(0.0, 0.0)] + [
        (MVS_BASELINE * math.cos(2 * math.pi * i / MVS_RING),
         MVS_BASELINE * math.sin(2 * math.pi * i / MVS_RING))
        for i in range(MVS_RING)]
    gt = {}
    for i, (tx, ty) in enumerate(centres):
        E, img, depth = plane_view(tx, ty)
        name = f"v_{i}"
        gt[name] = depth
        write_png(str(root / "images" / f"{name}.png"),
                  np.repeat((img * 255 + 0.5).astype(np.uint8)[..., None],
                            3, -1))
        lo, hi = MVS_DEPTH
        write_cam_txt(str(root / "cams" / f"{name}_cam.txt"),
                      MVSCamera(E, K, lo, (hi - lo) / 255, 256.0, hi))
    sel = []
    for i, c in enumerate(centres):
        dist = [math.dist(c, o) for o in centres]
        order = sorted((j for j in range(len(centres)) if j != i),
                       key=lambda j: (dist[j], j))
        sel.append([(j, 1.0 / dist[j]) for j in order])
    write_pair_txt(str(root / "pair.txt"), sel)
    (root / "names.txt").write_text(
        "\n".join(f"v_{i}" for i in range(len(centres))) + "\n")
    return gt


def mvs_plane_phase(device) -> dict:
    """cli.mvs.run_pipeline at the CLI's defaults on the analytic plane at
    800x800: the median relative depth error of the kept pixels under
    MVS_MAX_REL_ERR on every view and their share above MVS_MIN_KEPT; ms a
    view of each cascade stage (CUDA events around each sweep), of the
    geometric filter and of the packaging; peak memory."""
    from relightable3dgaussian_tpu_torch.cli import mvs as mvs_cli
    from relightable3dgaussian_tpu_torch.mvs import plane_sweep
    root = WORK / "mvs_plane"
    if root.exists():
        shutil.rmtree(root)
    t0 = time.perf_counter()
    gt = write_plane_scene(root)
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with CallTimer(plane_sweep, "_sweep") as s1, \
            CallTimer(plane_sweep, "_sweep_local") as s23, \
            CallTimer(mvs_cli, "geometric_filter") as filt, \
            CallTimer(mvs_cli, "prepare_blender_extra") as prep:
        t0 = time.perf_counter()
        out = mvs_cli.run_pipeline(
            str(root), pthresh=tuple(float(v) for v in MVS_PTHRESH.split(",")),
            device=device)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(out["names"])
    errs, kept = {}, {}
    for name in out["names"]:
        m = out["masks"][name]
        d = out["depths"][name]
        kept[name] = float(m.mean())
        errs[name] = (float(np.median(np.abs(d[m] - gt[name][m])
                                      / gt[name][m])) if m.any() else 1.0)
        for f in (f"extra/depths/{name}.tiff", f"extra/normals/{name}.pfm",
                  f"extra/masks/{name}.png", f"vis_mvsnet/{name}_flow3.pfm"):
            if not (root / f).exists():
                raise AssertionError(f"mvs-plane: missing {f}")
        if not np.isfinite(d).all():
            raise AssertionError(f"mvs-plane: {name}: depth not finite")
    if (len(s1.ms), len(s23.ms), len(filt.ms)) != (n, 2 * n, n):
        raise AssertionError(f"mvs-plane: {len(s1.ms)} stage-1 sweeps, "
                             f"{len(s23.ms)} band sweeps, {len(filt.ms)} "
                             f"filters for {n} views")
    worst = max(errs.values())
    if worst >= MVS_MAX_REL_ERR or min(kept.values()) <= MVS_MIN_KEPT:
        raise AssertionError(f"mvs-plane: median relative depth error "
                             f"{errs} (limit {MVS_MAX_REL_ERR}), kept "
                             f"{kept} (at least {MVS_MIN_KEPT})")
    say("mvs-plane", size=f"{MVS_SIZE}x{MVS_SIZE}", views=n,
        planes=(48, 32, 16), sources=5, pthresh=MVS_PTHRESH,
        stage1_ms_per_view=f"{float(np.mean(s1.ms)):.3f}",
        stage2_ms_per_view=f"{float(np.mean(s23.ms[0::2])):.3f}",
        stage3_ms_per_view=f"{float(np.mean(s23.ms[1::2])):.3f}",
        filter_ms_per_view=f"{float(np.mean(filt.ms)):.3f}",
        prepare_ms_per_view=f"{prep.ms[0] / n:.3f}",
        wall_s=f"{wall:.2f}", write_s=f"{write_s:.2f}",
        peak_mem_gib=f"{peak:.3f}",
        median_rel_err={k: f"{v:.5f}" for k, v in errs.items()},
        kept_share={k: f"{v:.4f}" for k, v in kept.items()})
    return {"wall_s": wall}


def write_colmap_model(dense: Path, data: Path, model: GaussianModel,
                       device) -> int:
    """sparse/0 of the cli phase's 8 test views (r_0 ... r_7) through the
    port's COLMAP writers: PINHOLE cameras from camera_angle_x, each view's
    pose, and as its observations the gaussian centres its render weighs
    (the points a view sees); every centre a point. Returns the points."""
    from relightable3dgaussian_tpu_torch.scene import colmap_loader as colmap
    from relightable3dgaussian_tpu_torch.utils.quaternions import \
        rotmat_to_quaternion
    with open(data / "transforms_test.json") as f:
        meta = json.load(f)
    focal = SIZE_MAIN / (2 * math.tan(meta["camera_angle_x"] / 2))
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", SIZE_MAIN, SIZE_MAIN,
                                   np.array([focal, focal, SIZE_MAIN / 2,
                                             SIZE_MAIN / 2]))}
    cfg = RasterConfig(SIZE_MAIN, SIZE_MAIN)
    images = {}
    for i, frame in enumerate(meta["frames"]):
        R, T = _blender_pose(frame)                  # camera-to-world R
        cam = make_camera_params(R, T, SIZE_MAIN, SIZE_MAIN,
                                 fovx=meta["camera_angle_x"],
                                 fovy=meta["camera_angle_x"], device=device)
        zeros = torch.zeros((3, SIZE_MAIN, SIZE_MAIN), device=device)
        with torch.no_grad():
            w = render(ViewInputs(cam, zeros, zeros[:1] + 1, zeros[:1], zeros),
                       model, cfg, torch.zeros(3, device=device))["weights"]
        seen = torch.nonzero(w[:, 0] > 0).flatten().cpu().numpy()
        q = rotmat_to_quaternion(torch.tensor(R.T[None])).numpy()[0]
        images[i + 1] = colmap.ColmapImage(
            i + 1, q, np.asarray(T, np.float64), 1,
            frame["file_path"].split("/")[-1] + ".png",
            np.zeros((len(seen), 2)), seen.astype(np.int64))
    xyz = model.xyz.detach().cpu().numpy().astype(np.float64)
    sparse = dense / "sparse" / "0"
    sparse.mkdir(parents=True)
    colmap.write_cameras_binary(str(sparse / "cameras.bin"), cams)
    colmap.write_images_binary(str(sparse / "images.bin"), images)
    colmap.write_points3d_binary(str(sparse / "points3D.bin"), xyz,
                                 np.full((len(xyz), 3), 128, np.uint8))
    return len(xyz)


def mvs_phase(cli: dict, gt_model: GaussianModel, device) -> None:
    """cli.mvs.main --layout blender on a dense folder holding the COLMAP
    model of the cli phase's test views (write_colmap_model; their images
    by --image_dir), its extra/ copied into a copy of the cli phase's scene
    (a scene root holding sparse/ reads as COLMAP), then cli.eval_nvs on
    that scene: every artifact, the readers load it, the test cameras carry
    finite depth and normals; the median relative error against the port's
    own rendered depth is printed, not gated (a cloud of 100k blobs has no
    single surface)."""
    from relightable3dgaussian_tpu_torch.cli import mvs as mvs_cli
    from relightable3dgaussian_tpu_torch.scene import Scene
    from relightable3dgaussian_tpu_torch.scene.image_io import (load_depth,
                                                                load_pfm)
    root = WORK / "mvs"
    if root.exists():
        shutil.rmtree(root)
    data, dense = root / "nerf_synthetic", root / "dense"
    shutil.copytree(cli["data"], data)
    dense.mkdir()
    t0 = time.perf_counter()
    points = write_colmap_model(dense, data, gt_model, device)
    colmap_s = time.perf_counter() - t0
    _, wall, peak = run_cli(lambda: mvs_cli.main(
        ["--dense_folder", str(dense), "--image_dir", str(data / "test"),
         "--layout", "blender", "--pthresh", MVS_PTHRESH], device=device))
    names = (dense / "names.txt").read_text().split()
    missing = [f for n in names for f in (
        f"cams/{n}_cam.txt", f"extra/depths/{n}.tiff",
        f"extra/normals/{n}.pfm", f"extra/masks/{n}.png",
        f"vis_mvsnet/{n}_flow3.pfm") if not (dense / f).exists()]
    if names != [f"r_{i}" for i in range(CLI_TEST_VIEWS)] or missing or not (
            dense / "pair.txt").exists():
        raise AssertionError(f"mvs: views {names}, missing {missing}")
    shutil.copytree(dense / "extra", data / "extra")
    launches, eval_wall, _ = run_cli(lambda: eval_nvs.main(
        ["-s", str(data), "-m", str(cli["stage2"]), "-t", "neilf",
         "-c", str(cli["stage2"] / f"chkpnt{cli['n2']}.npz"), "--skip_train",
         "--sample_num", str(SAMPLE_NUM)], device=device))
    test = Scene(str(data), "", eval_split=True, shuffle=False) \
        .get_test_cameras()
    kept, errs = [], []
    cfg = RasterConfig(SIZE_MAIN, SIZE_MAIN)
    for cam, name in zip(test, names):
        depth = load_depth(str(data / "extra" / "depths" / f"{name}.tiff"))
        normal = load_pfm(str(data / "extra" / "normals" / f"{name}.pfm"))
        if cam.depth is None or cam.normal is None or not (
                np.isfinite(cam.depth).all() and np.isfinite(cam.normal).all()
                and depth.shape == (SIZE_MAIN, SIZE_MAIN)
                and normal.shape == (SIZE_MAIN, SIZE_MAIN, 3)):
            raise AssertionError(f"mvs: test camera {cam.image_name} carries "
                                 "no finite depth and normal")
        m = cam.depth > 0
        kept.append(float(m.mean()))
        with torch.no_grad():
            ours = render(cam.view_inputs(device), gt_model, cfg,
                          torch.zeros(3, device=device))["depth"][0]
        ours = ours.cpu().numpy()
        ok = m & (ours > 0)
        errs.append(float(np.median(np.abs(cam.depth[ok] - ours[ok])
                                    / ours[ok])) if ok.any() else float("nan"))
    if not max(kept) > 0:
        raise AssertionError(f"mvs: no test view kept a pixel ({kept})")
    say("mvs", views=len(names), points=points, colmap_write_s=f"{colmap_s:.2f}",
        mvs_wall_s=f"{wall:.2f}", eval_wall_s=f"{eval_wall:.2f}",
        peak_mem_gib=f"{peak:.3f}", eval_launches=launches,
        kept_share=[round(k, 4) for k in kept],
        median_rel_err_vs_rendered_depth=[round(e, 4) for e in errs])


def gui_phase(cli: dict, device) -> dict:
    """cli.gui.main --headless, GUI_FRAMES frames at 800x800: -t render on
    the slice phase's checkpoint (100k gaussians), -t neilf on the cli
    phase's stage-2 checkpoint (its visibility traced once, a fresh env
    light); every PNG, K1 once a frame and K3 once for neilf, K1 on the
    first frame's inputs under k1-main's gate (gui-k1); ms a frame (CUDA
    events around each render, median after the first) against the 30 FPS
    bar. Returns the launches of each run."""
    from relightable3dgaussian_tpu_torch.cli import gui
    root = WORK / "gui"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    runs = {"render": ["-m", str(root), "-c", str(WORK / f"scene_{N_MAIN}.npz")],
            "neilf": ["-m", str(cli["stage2"]), "-c",
                      str(cli["stage2"] / f"chkpnt{cli['n2']}.npz"),
                      "--sample_num", str(SAMPLE_NUM)]}
    out = {}
    for kind, args in runs.items():
        fn = "render" if kind == "render" else "render_neilf"
        with CallTimer(gui, fn) as frames, \
                CallTimer(composite_cuda, "composite_k1", keep=k1_inputs,
                          timed=False) as k1:
            launches, wall, peak = run_cli(lambda: gui.main(
                args + ["-t", kind, "--headless", "--size", str(SIZE_MAIN),
                        "--frames", str(GUI_FRAMES), "--out",
                        str(root / kind)], device=device))
        missing = [i for i in range(GUI_FRAMES) if not (
            root / kind / f"render_{i:04d}.png").exists()]
        expect = {"K1": GUI_FRAMES, "K3": int(kind == "neilf"), "K2": 0,
                  "K4-fwd": 0, "K5": 0,
                  "K6": GUI_FRAMES if kind == "neilf" else 0}
        if missing or any(launches[k] != v for k, v in expect.items()):
            raise AssertionError(f"gui {kind}: launches {launches} "
                                 f"(expected {expect}), missing frames "
                                 f"{missing}")
        with torch.no_grad():
            check_k1(k1.kept, "gui-k1", k1_reps=3, plain_reps=1)
        med = float(np.median(frames.ms[1:]))
        say(f"gui-{kind}", frames=GUI_FRAMES, size=f"{SIZE_MAIN}x{SIZE_MAIN}",
            ms_per_frame_median=f"{med:.3f}", fps=f"{1e3 / med:.2f}",
            fps_bar=FPS_BAR, meets_bar=1e3 / med >= FPS_BAR,
            frame_ms=[round(ms, 3) for ms in frames.ms], wall_s=f"{wall:.2f}",
            peak_mem_gib=f"{peak:.3f}", launches=launches)
        out[kind] = launches
    return out


class StubDPG:
    """A stand-in for dearpygui.dearpygui (not installed on the card's
    machine) on the pattern of tests/test_gui_window.py's: it records the
    window's calls, keeps the texture and runs until closed."""

    mvFormat_Float_rgb, mvMouseButton_Left, mvMouseButton_Middle = 0, 0, 2

    def __init__(self):
        self.values, self.frames, self.closed = {}, 0, False

    def _ctx(self, *args, **kwargs):
        return contextlib.nullcontext()

    texture_registry = window = group = handler_registry = _ctx

    def _noop(self, *args, **kwargs):
        return None

    (create_context, add_image, add_text, add_mouse_drag_handler,
     add_mouse_wheel_handler, create_viewport, setup_dearpygui,
     show_viewport, configure_item) = (_noop,) * 9

    def add_raw_texture(self, w, h, data, format=None, tag=None):
        self.values[tag] = data

    def add_combo(self, items, default_value=None, tag=None, width=None,
                  callback=None):
        self.values[tag] = default_value

    def set_value(self, tag, value):
        self.values[tag] = value

    def is_dearpygui_running(self):
        return not self.closed

    def render_dearpygui_frame(self):
        self.frames += 1

    def is_mouse_button_down(self, button):
        return False

    def destroy_context(self):
        self.closed = True


def train_gui_phase(cli: dict, device) -> dict:
    """cli.train --gui for TRAIN_GUI_STEPS stage-1 steps on the cli phase's
    scene with StubDPG as dearpygui: one viewer frame a step (K1 twice a
    step: the step's and the viewer's), the window closed at the end, the
    texture a finite image. Returns the launches."""
    import types
    stub = StubDPG()
    package = types.ModuleType("dearpygui")
    package.dearpygui = stub
    saved = {k: sys.modules.get(k) for k in ("dearpygui",
                                             "dearpygui.dearpygui")}
    sys.modules["dearpygui"], sys.modules["dearpygui.dearpygui"] = (package,
                                                                   stub)
    out = WORK / "train_gui"
    if out.exists():
        shutil.rmtree(out)
    try:
        launches, wall, peak = run_cli(lambda: train_cli.main(
            ["-s", str(cli["data"]), "-m", str(out), "--iterations",
             str(TRAIN_GUI_STEPS), "--save_interval", str(TRAIN_GUI_STEPS),
             "--checkpoint_interval", str(TRAIN_GUI_STEPS), "--gui"],
            device=device))
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    tex = np.asarray(stub.values.get("_tex", []))
    expect = {"K1": 2 * TRAIN_GUI_STEPS, "K2": TRAIN_GUI_STEPS, "K3": 0}
    if stub.frames != TRAIN_GUI_STEPS or not stub.closed or any(
            launches[k] != v for k, v in expect.items()) or not (
            tex.size == SIZE_MAIN * SIZE_MAIN * 3 and np.isfinite(tex).all()
            and tex.std() > 0):
        raise AssertionError(f"train-gui: {stub.frames} viewer frames for "
                             f"{TRAIN_GUI_STEPS} steps, closed {stub.closed}, "
                             f"launches {launches} (expected {expect}), "
                             f"texture {tex.shape}")
    say("train-gui", steps=TRAIN_GUI_STEPS, viewer_frames=stub.frames,
        wall_s=f"{wall:.2f}", peak_mem_gib=f"{peak:.3f}", launches=launches,
        texture_mean=f"{float(tex.mean()):.4f}")
    return launches


def rotate_about(dirs: torch.Tensor, axis: torch.Tensor,
                 angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' rotation of dirs [P, S, 3] about the unit axes [P, 3] by
    the angles [P]."""
    k = axis[:, None, :]
    c, s = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    return (dirs * c + torch.linalg.cross(k.expand_as(dirs), dirs) * s
            + k * (k * dirs).sum(-1, keepdim=True) * (1 - c))


def k4_seeds_phase(s2: dict, seeds: int = K4_SEEDS) -> None:
    """k4-main's gate over `seeds` fresh sample directions on the stage-2
    model: seed s turns each point's samples about its normal by a seeded
    angle and takes the view s mod VIEWS and a seeded cotangent."""
    t0 = time.perf_counter()
    model, vis = s2["model"], s2["vis"]
    normal = model.get_normal.detach()
    normal = normal / normal.norm(dim=-1, keepdim=True)
    rows = []
    for s in range(seeds):
        gen = torch.Generator(device=normal.device).manual_seed(SEED + 200 + s)
        angle = 2 * math.pi * torch.rand(normal.shape[0], generator=gen,
                                         device=normal.device)
        dirs = rotate_about(vis.incident_dirs, normal, angle)
        fresh = neilf.VisibilityCache(vis.visibility, dirs.contiguous(),
                                      vis.incident_areas)
        x = train_shading_case(model, s2["env"], fresh,
                               s2["views"][s % VIEWS])
        _, _, info = check_k4(x, f"k4-seeds-{s}", SEED + 300 + s,
                              timed=False)
        rows.append(info)
    worst = max(range(len(rows)), key=lambda i: float(
        rows[i]["errs"]["bwd.viewdirs"][0]))
    say("k4-seeds", seeds=seeds, points=int(normal.shape[0]),
        wall_s=f"{time.perf_counter() - t0:.2f}",
        viewdirs_err_kernel=[r["errs"]["bwd.viewdirs"][0] for r in rows],
        viewdirs_err_plain=[r["errs"]["bwd.viewdirs"][1] for r in rows],
        worst_seed_errs=rows[worst]["errs"],
        float32_sign_flips=[r["float32_sign_flips"] for r in rows])


# ---------------------------------------------------------------------------
# The dense oracle, the facade, multi-GPU training and the sharded eval
# ---------------------------------------------------------------------------

# (gaussians, image size, seed): tests/test_rasterizer_parity.py's scene and
# a larger one.
DENSE_SCENES = ((300, 64, 0), (2000, 128, 1))
DENSE_BG = (0.1, 0.2, 0.3)
# tests/test_rasterizer_parity.py's bounds, the tiled rasterizer (K1, K2)
# against the dense oracle in float32. They hold outside the crossing
# pixels. The two round alpha and T in float32 in other orders (the oracle's
# T is a cumulative product), so where a pair's alpha lies at 1/255 or its
# incoming T at 1e-4 within rounding, one side may blend it and the other
# not (as between K1 and the plain compositor: split pixels), which moves
# the pixel by up to 2/255 and may leave the counts equal. Crossing pixels:
# the counts differ, or a pair lies within DENSE_NEAR (relative) of either
# threshold in the float64 oracle and a field is past its bound there. The
# count bound caps their share: at most 1 - DENSE_COUNT_AGREE of pixels.
DENSE_NEAR = 1e-4
DENSE_TOL = {"color": 2e-5, "opacity": 2e-5, "depth": 1e-4, "feature": 5e-5}
DENSE_W_TOL, DENSE_COUNT_AGREE, DENSE_GRAD_TOL = 1e-3, 0.999, 2e-3
# The parallel phases' rank layouts (dp_layouts): with two or more cards,
# one rank a card over NCCL at 1 rank (the single-rank step, the baseline of
# the scaling numbers), 2 and min(count, DP_MAX_RANKS); with one card, two
# ranks on it over gloo (parallel.spawn's own processes), which measure no
# scaling.
DP_MAX_RANKS = 4
# Seconds a rank of the parallel and cli-ranks phases waits in one
# collective before it fails (parallel.spawn's collective_timeout_s).
DP_COLLECTIVE_TIMEOUT_S = 180.0
DP_ALLREDUCE_REPS = 10
DP1_STEPS, DP1_DENSIFY_AT, DP1_RESET_AT = 20, 8, 14
DP2_STEPS = 10
# One data-parallel step against the hand combination: tests/
# test_torch_train.py's tolerances (parameters 0.01 of each learning rate,
# gradients 1e-3 and statistics 1e-4 of each field's largest entry).
DP_PARAM_LR, DP_GRAD_TOL, DP_STAT_TOL = 0.01, 1e-3, 1e-4
SHARDED_SHADE_ATOL = 1e-6


def dense_scene(n: int, seed: int, device) -> list[torch.Tensor]:
    """tests/test_rasterizer_parity.py's random_scene in numpy: means in
    [-1.2, 1.2]^3, scales in [0.02, 0.15], unit quaternions, opacity in
    [0.2, 0.95], SH degree 0 of uniform colours, 5 features N(0, 0.5²)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    rots = rng.normal(size=(n, 4))
    colors = rng.uniform(size=(n, 3))
    arrays = (rng.uniform(-1.2, 1.2, (n, 3)), rng.uniform(0.02, 0.15, (n, 3)),
              rots / np.linalg.norm(rots, axis=-1, keepdims=True),
              rng.uniform(0.2, 0.95, (n, 1)), ((colors - 0.5) / C0)[:, None],
              rng.normal(size=(n, 5)) * 0.5)
    return [torch.as_tensor(a.astype(f32), device=device) for a in arrays]


def near_threshold_pixels(x, cam, cfg: RasterConfig) -> torch.Tensor:
    """[H, W] bool: the pixels where, in float64, a pair's alpha lies within
    DENSE_NEAR (relative) of 1/255 while its incoming T is at least 1e-4, or
    a blended pair's incoming T lies within DENSE_NEAR of 1e-4."""
    means, scales, rots, opacity, shs, _ = (t.detach().double() for t in x)
    cam = CameraParams(*(t.double() for t in cam))
    prep = preprocess(means, scales, rots, shs, cam, cfg)
    order = torch.argsort(prep.depth, stable=True)
    sp = Preprocessed(*(t[order] for t in prep))
    H, W = cfg.height, cfg.width
    px = torch.arange(W, dtype=torch.float64, device=means.device).repeat(H)
    py = torch.arange(H, dtype=torch.float64,
                      device=means.device).repeat_interleave(W)
    op = opacity[order, 0]
    lo, mid, hi = (_alpha_at(sp, px, py, op * f, cfg)
                   for f in (1 - DENSE_NEAR, 1.0, 1 + DENSE_NEAR))
    through = torch.cumprod(1.0 - mid, dim=0)
    T = torch.cat([torch.ones_like(through[:1]), through[:-1]])
    reached = T >= 1e-4 * (1 - DENSE_NEAR)
    near = ((lo == 0) & (hi > 0) & reached) | (
        (mid > 0) & ((T - 1e-4).abs() <= DENSE_NEAR * 1e-4))
    return near.any(0).reshape(H, W)


def dense_loss(out):
    """The parity test's loss: colour MSE plus the features' variance."""
    return (out.color ** 2).mean() + out.feature.var()


def dense_phase(device) -> dict:
    """The tiled rasterizer (K1 forward, K2 backward) against the dense
    oracle on the card in float32 under tests/test_rasterizer_parity.py's
    bounds, values and gradients, on its scene and a larger one, the colour
    before the background; K1's and the float32 oracle's error from the
    float64 oracle printed. Returns K1's and K2's launches."""
    launches = {"K1": 0, "K2": 0}
    for n, size, seed in DENSE_SCENES:
        x = dense_scene(n, seed, device)
        cam = make_camera_params(np.eye(3), np.array([0.0, 0.0, 4.0]), size,
                                 size, fovx=0.9, fovy=0.9, device=device)
        cfg = RasterConfig(size, size, sh_degree=0)
        bg = torch.tensor(DENSE_BG, device=device)
        outs, grads, ms = {}, {}, {}
        for name, raster in (("tiled", rasterize), ("dense", rasterize_dense)):
            xs = [t.clone().requires_grad_(i != 2) for i, t in enumerate(x)]
            reset_launches()
            with Timing(device=device) as tm:
                out = raster(*xs, cam=cam, cfg=cfg, bg_color=bg)
                dense_loss(out).backward()
            if name == "tiled":
                for k in launches:
                    launches[k] += read_launches()[k]
                if read_launches()["K1"] != 1 or read_launches()["K2"] != 1:
                    raise AssertionError(f"dense: the tiled rasterizer "
                                         f"launched {read_launches()}")
            outs[name], ms[name] = out, tm.elapsed_ms
            grads[name] = [t.grad for i, t in enumerate(xs) if i != 2]
        with torch.no_grad():
            exact = rasterize_dense(*(t.double() for t in x), cam=cam,
                                    cfg=cfg, bg_color=bg)
        tiled, dense = (type(o)(*(t.detach() if isinstance(t, torch.Tensor)
                                  else t for t in o))
                        for o in (outs["tiled"], outs["dense"]))
        # The colour before the background: the oracle composites the
        # background by the product of every (1 - alpha), the tiled
        # rasterizer by 1 - opacity, its T at the 1e-4 cut (as the JAX
        # package's two do), which differ where a pixel reaches the cut.
        fields = {f: (getattr(tiled, f), getattr(dense, f)) for f in DENSE_TOL}
        fields["color"] = tuple(o.color - o.final_T[None] * bg[:, None, None]
                                for o in (tiled, dense))
        bg_term = float(((tiled.final_T - dense.final_T).abs()).max())
        op_diff = (tiled.opacity - dense.opacity).abs()[0]
        past = torch.zeros_like(op_diff, dtype=torch.bool)
        for field, tol in DENSE_TOL.items():
            a, b = fields[field]
            past |= ((a - b).abs() > tol).any(0)
        near = near_threshold_pixels(x, cam, cfg)
        crossing = (tiled.n_contrib != dense.n_contrib) | (near & past)
        n_crossing = int(crossing.sum())
        if (n_crossing > (1 - DENSE_COUNT_AGREE) * size * size
                or float(op_diff.max()) > 2 / 255):
            raise AssertionError(f"dense {n}: {n_crossing} crossing pixels, "
                                 f"opacity apart by {float(op_diff.max())}")
        errs = {}
        for field, tol in DENSE_TOL.items():
            a, b = fields[field]
            err = float((a - b)[:, ~crossing].abs().max())
            if not err <= tol:
                raise AssertionError(f"dense {n}: {field} {err} > {tol}")
            errs[field] = f"{err:.3e}"
        torch.testing.assert_close(tiled.weights, dense.weights,
                                   rtol=DENSE_W_TOL, atol=DENSE_W_TOL)
        agree = float((tiled.n_contrib == dense.n_contrib).float().mean())
        if agree < DENSE_COUNT_AGREE or not torch.equal(tiled.radii,
                                                        dense.radii):
            raise AssertionError(f"dense {n}: n_contrib equal on {agree}, "
                                 "or the radii differ")
        grad_err = {}
        for name, g, w in zip(("means", "scales", "opacity", "shs",
                               "features"), grads["tiled"], grads["dense"]):
            rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            if not (rel <= DENSE_GRAD_TOL and bool(torch.isfinite(g).all())):
                raise AssertionError(f"dense {n}: d{name} {rel} of its "
                                     f"largest entry > {DENSE_GRAD_TOL}")
            grad_err[name] = f"{rel:.3e}"
        exact_color = exact.color - exact.final_T[None] * bg[:, None, None]
        from64 = {
            who: {**{f: f"{float((getattr(o, f).double() - getattr(exact, f)).abs().max()):.3e}"
                     for f in ("opacity", "depth", "feature")},
                  "color": f"{float((c.double() - exact_color).abs().max()):.3e}"}
            for who, o, c in (("k1", tiled, fields["color"][0]),
                              ("dense32", dense, fields["color"][1]))}
        say("dense", gaussians=n, size=f"{size}x{size}", pairs=tiled.num_rendered,
            n_contrib_equal=f"{agree:.6f}", crossing_pixels=n_crossing,
            near_threshold_pixels=int(near.sum()),
            crossing_opacity_max=f"{float(op_diff.max()):.3e}",
            tiled_vs_dense=errs, background_T_apart_max=f"{bg_term:.3e}",
            grad_rel_err=grad_err, k1_from_float64=from64["k1"],
            dense32_from_float64=from64["dense32"],
            tiled_fwd_bwd_ms=f"{ms['tiled']:.3f}",
            dense_fwd_bwd_ms=f"{ms['dense']:.3f}")
    return launches


@torch.no_grad()
def facade_phase(model: GaussianModel, view: ViewInputs) -> dict:
    """raster.GaussianRasterizer on the card against ops.rasterize on the
    same inputs (the 10-tuple; the weights, summed by K1's atomics, under
    k1-main's weights bounds, the rest bitwise), with the SH colour and the
    covariance given precomputed, packed [P, 6] (get_covariance()) and full
    [P, 3, 3] (it unpacked) (k1-main's gate: the covariance's packing may
    move a last bit), and mark_visible against view z > 0.2. K2's gradient
    reaches both layouts: the full one's, symmetrized, is the packed one's
    within K2_TOL of its largest entry. Returns K1's launches by the facade,
    and K1's and K2's with the full layout."""
    cam = view.cam
    size = SIZE_MAIN
    settings = GaussianRasterizationSettings(
        image_height=size, image_width=size,
        tanfovx=float(cam.tan_fov[0]), tanfovy=float(cam.tan_fov[1]),
        cx=float(cam.center[0]), cy=float(cam.center[1]),
        bg=torch.zeros(3, device=cam.world_view.device), scale_modifier=1.0,
        viewmatrix=cam.world_view, projmatrix=cam.full_proj, sh_degree=3,
        campos=cam.campos)
    r = GaussianRasterizer(settings, buffer_multiple=16, chunk=128,
                           max_chunks_per_tile=64, use_pallas=True)
    feats = view_features(model, cam)
    common = dict(means3D=model.xyz, opacities=model.get_opacity,
                  features=feats)
    inputs = dict(shs=model.get_shs, scales=model.get_scaling,
                  rotations=model.get_rotation)
    cfg = RasterConfig(size, size)
    want = rasterize(model.xyz, model.get_scaling, model.get_rotation,
                     model.get_opacity, model.get_shs, feats, cam=r.cam,
                     cfg=cfg, bg_color=settings.bg)
    want = (want.num_rendered, want.n_contrib, want.color, want.opacity,
            want.depth, want.feature, want.pseudo_normal, want.surface_xyz,
            want.weights, want.radii)
    prep = preprocess(model.xyz, model.get_scaling, model.get_rotation,
                      model.get_shs, r.cam, cfg)
    packed = model.get_covariance().detach()
    cases = {"shs": inputs,
             "colors_precomp": {**inputs, "shs": None,
                                "colors_precomp": prep.rgb},
             "cov3d_precomp": {**inputs, "scales": None, "rotations": None,
                               "cov3D_precomp": packed},
             "cov3d_full": {**inputs, "scales": None, "rotations": None,
                            "cov3D_precomp": unpack_symmetric(packed)}}
    launches, report, outs = [], {}, {}
    for name, kw in cases.items():
        reset_launches()
        got, ms = timed_ms(lambda: r(**common, **kw))
        outs[name] = got
        launches.append(trace.counter("k1.launches"))
        if len(got) != 10 or got[0] != want[0] or launches[-1] != 1:
            raise AssertionError(f"facade {name}: {len(got)} outputs, "
                                 f"{got[0]} pairs ({want[0]}), K1 launched "
                                 f"{launches[-1]} times")
        bitwise = [bool(torch.equal(a, b)) for a, b in zip(got[1:], want[1:])]
        torch.testing.assert_close(got[8], want[8], rtol=W_RTOL, atol=W_ATOL)
        if name.startswith("cov3d"):
            agree = got[1] == want[1]
            if float(agree.float().mean()) < COUNT_AGREE:
                raise AssertionError(f"facade {name}: n_contrib")
            for i in (2, 3, 4, 5):
                torch.testing.assert_close(got[i][:, agree], want[i][:, agree],
                                           atol=IMG_ATOL, rtol=IMG_RTOL)
        elif not all(bitwise[:7] + bitwise[8:]):
            raise AssertionError(f"facade {name}: outputs apart from "
                                 f"rasterize's: bitwise {bitwise}")
        report[name] = {"bitwise": "".join("1" if b else "0"
                                           for b in bitwise),
                        "max_abs_err": f"{float((got[2] - want[2]).abs().max()):.3e}",
                        "ms": f"{ms:.3f}"}
    # the full layout renders as the packed one, but the weights' atomics
    layouts = list(zip(outs["cov3d_full"], outs["cov3d_precomp"]))
    if not all(torch.equal(a, b) for i, (a, b) in enumerate(layouts[1:], 1)
               if i != 8):
        raise AssertionError("facade: the full layout's render apart from "
                             "the packed one's")
    # K2's gradient into each layout, for one seeded colour cotangent
    gen = torch.Generator(device=packed.device).manual_seed(SEED + 9)
    g_color = torch.randn((3, size, size), generator=gen, device=packed.device)
    fixed = {k: v.detach() for k, v in {**common, **inputs}.items()}
    grads, full_launches = {}, {}
    for name, cov in (("cov3d_precomp", packed),
                      ("cov3d_full", unpack_symmetric(packed))):
        x = cov.clone().requires_grad_(True)
        reset_launches()
        with torch.enable_grad():
            out = r(**{**fixed, "scales": None, "rotations": None},
                    cov3D_precomp=x)
            (out[2] * g_color).sum().backward()
        if trace.counter("k2.launches") != 1 or not bool(
                torch.isfinite(x.grad).all()):
            raise AssertionError(f"facade {name}: K2 launched "
                                 f"{trace.counter("k2.launches")} times, "
                                 f"gradient finite: "
                                 f"{bool(torch.isfinite(x.grad).all())}")
        grads[name] = x.grad
        if name == "cov3d_full":
            full_launches = {"K1": launches[-1] + trace.counter("k1.launches"),
                             "K2": trace.counter("k2.launches")}
    full_g = grads["cov3d_full"]
    sym = strip_symmetric(full_g + full_g.transpose(-1, -2))
    sym[:, [0, 3, 5]] /= 2
    want_g = grads["cov3d_precomp"]
    g_rel = float((sym - want_g).abs().max() / want_g.abs().max())
    if not g_rel <= K2_TOL:
        raise AssertionError(f"facade: the full layout's gradient, "
                             f"symmetrized, {g_rel} from the packed one's "
                             f"> {K2_TOL}")
    xyz1 = torch.cat([model.xyz, torch.ones_like(model.xyz[:, :1])], -1)
    visible = (xyz1 @ cam.world_view)[:, 2] > 0.2
    far = torch.cat([model.xyz, model.xyz * -20.0 - torch.tensor(
        [0.0, 0.0, 70.0], device=model.xyz.device)])
    far_visible = (torch.cat([far, torch.ones_like(far[:, :1])], -1)
                   @ cam.world_view)[:, 2] > 0.2
    marks = (r.markVisible(model.xyz), mark_visible(far, cam.world_view,
                                                    cam.full_proj))
    if not (torch.equal(marks[0], visible) and torch.equal(marks[1],
                                                          far_visible)):
        raise AssertionError("facade: mark_visible apart from view z > 0.2")
    say("facade", size=f"{size}x{size}", pairs=want[0], cases=report,
        k1_launches=launches,
        mark_visible=f"{int(marks[1].sum())}/{far.shape[0]}",
        full_grad_rel_err_from_packed=f"{g_rel:.3e}",
        full_layout_launches=full_launches)
    return {"K1": sum(launches), "full": full_launches}


def dp_layouts(count: int) -> list[tuple[str, ...]]:
    """The rank layouts of the parallel phases on `count` cards: one rank a
    card at 1, 2 and min(count, DP_MAX_RANKS) ranks, or two ranks on cuda:0
    with one card."""
    if count < 2:
        return [("cuda:0", "cuda:0")]
    return [tuple(f"cuda:{r}" for r in range(n))
            for n in sorted({1, 2, min(count, DP_MAX_RANKS)})]


def layout_name(devices) -> str:
    """"nccl-2", "gloo-2" (ranks sharing a card), "single" (one rank)."""
    if len(devices) == 1:
        return "single"
    return f"{choose_backend(devices)}-{len(devices)}"


def allreduce_reading(group, grads) -> dict:
    """The gradient all_reduce of a data-parallel step (parallel.mean_'s
    flat buffer of `grads`): its bytes and its ms, CUDA events around each
    of DP_ALLREDUCE_REPS launches after a warm-up (none for one rank)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    out = {"allreduce_bytes": nbytes(flat), "allreduce_ms": None}
    if group.size > 1:
        out["allreduce_ms"] = cuda_ms(lambda: all_reduce_(flat, group),
                                      DP_ALLREDUCE_REPS)
    return out


def timed_replicate(group, *replica) -> float:
    """parallel.replicate(group, *replica) and its ms (host clock, the
    card synchronized before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replicate(group, *replica)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def step_state(model: GaussianModel, env=None) -> dict:
    """The fields, their gradients and the statistics as numpy arrays."""
    out = {f"params.{k}": getattr(model, k).detach().cpu().numpy()
           for k in model.fields}
    out.update({f"grad.{k}": getattr(model, k).grad.cpu().numpy()
                for k in model.fields})
    out.update({f"stats.{k}": getattr(model, k).cpu().numpy()
                for k in G_STATS})
    if env is not None:
        out["params.env"] = env.env.detach().cpu().numpy()
        out["grad.env"] = env.env.grad.cpu().numpy()
    return out


def dp_views(views_file: Path, device) -> list[ViewInputs]:
    with np.load(views_file) as data:
        return [orbit_view(i, VIEWS, SIZE_MAIN, device)._replace(
            image=torch.as_tensor(data["image"][i], device=device),
            image_mask=torch.as_tensor(data["mask"][i], device=device))
            for i in range(VIEWS)]


def dp_batch(i: int, size: int) -> list[int]:
    """The views of step i, one a rank."""
    return [(size * i + r) % VIEWS for r in range(size)]


def dp_stage1_rank(group, ckpt: str, views_file: str, step1_file: str
                   ) -> dict:
    """A rank of dp-stage1: DP1_STEPS data-parallel steps from the train
    phase's checkpoint, a densify after step DP1_DENSIFY_AT and an opacity
    reset after DP1_RESET_AT; the state after step 1 (rank 0 writes it),
    each step's digest, ms (utils.timing) and K1/K2 launches."""
    device = group.device
    it0, model, optimizer = load_train_state(ckpt, TRAIN_OPT,
                                             1.1 * CAM_RADIUS, device=device)
    replicate_ms = timed_replicate(group, model, optimizer)
    views = dp_views(Path(views_file), device)
    step = make_dp_train_step(group, cfg=RasterConfig(SIZE_MAIN, SIZE_MAIN),
                              opt=TRAIN_OPT, spatial_lr_scale=1.1 * CAM_RADIUS)
    generator = torch.Generator(device=device).manual_seed(SEED)
    digests, ms, losses, points = [], [], [], []
    torch.cuda.synchronize()
    reset_launches()
    for i in range(DP1_STEPS):
        batch = [views[v] for v in dp_batch(i, group.size)]
        with Timing(device=device) as tm:
            metrics = step(model, optimizer, batch, it0 + 1 + i)
        ms.append(tm.elapsed_ms)
        losses.append(float(metrics["loss"]))
        if i == 0 and group.rank == 0:
            np.savez(step1_file, **step_state(model))
        if i + 1 == DP1_DENSIFY_AT:
            densify_step(model, optimizer, generator,
                         TRAIN_OPT.densify_grad_normal_threshold, 20.0,
                         1.1 * CAM_RADIUS, opt=TRAIN_OPT)
        if i + 1 == DP1_RESET_AT:
            reset_opacity_step(model, optimizer)
        points.append(model.num_points)
        digests.append(replica_digest(model, optimizer))
    launches = read_launches()
    return {"launches": launches, "digests": digests, "ms": ms,
            "loss": losses, "points": points, "it0": it0,
            "replicate_ms": replicate_ms, **allreduce_reading(
                group, [getattr(model, k).grad for k in model.fields])}


def dp_stage2_rank(group, ckpt: str, env_ckpt: str, views_file: str,
                   step1_file: str) -> dict:
    """A rank of dp-stage2: the stage-2 phase's state, its visibility traced
    anew through the ray-sharded trace, DP2_STEPS data-parallel stage-2
    steps; as dp_stage1_rank, with the env map."""
    device = group.device
    it0, model, optimizer = load_train_state(ckpt, STAGE2_OPT,
                                             1.1 * CAM_RADIUS, device=device)
    _, env, env_optimizer = load_env_checkpoint(env_ckpt, STAGE2_OPT,
                                                device=device)
    replicate_ms = timed_replicate(group, model, optimizer, env,
                                   env_optimizer)
    vis = update_visibility(model, SAMPLE_NUM,
                            sharded_trace=make_sharded_trace(group))
    views = dp_views(Path(views_file), device)
    step = make_dp_train_step_stage2(
        group, cfg=RasterConfig(SIZE_MAIN, SIZE_MAIN), opt=STAGE2_OPT,
        spatial_lr_scale=1.1 * CAM_RADIUS)
    digests, ms, losses = [], [], []
    torch.cuda.synchronize()
    reset_launches()
    for i in range(DP2_STEPS):
        batch = [views[v] for v in dp_batch(i, group.size)]
        with Timing(device=device) as tm:
            metrics = step(model, optimizer, env, env_optimizer, vis, batch,
                           it0 + 1 + i)
        ms.append(tm.elapsed_ms)
        losses.append(float(metrics["loss"]))
        if i == 0 and group.rank == 0:
            np.savez(step1_file, **step_state(model, env))
        digests.append(replica_digest(model, optimizer, env, env_optimizer))
    launches = read_launches()
    grads = [getattr(model, k).grad for k in model.fields] + [env.env.grad]
    return {"launches": launches, "digests": digests, "ms": ms,
            "loss": losses, "it0": it0, "replicate_ms": replicate_ms,
            "env_digest": hashlib.sha256(
                env.env.detach().cpu().numpy().tobytes()).hexdigest(),
            **allreduce_reading(group, grads)}


@torch.no_grad()
def sharded_rank(group, ckpt: str, env_ckpt: str, out_file: str) -> dict:
    """A rank of the sharded phase: the stage-2 model's visibility rays
    through make_sharded_trace, its eval shading through
    make_sharded_shading(full_extras=True) on view 0's directions, and
    render_neilf(is_training=False) of view 0 with both hooks; rank 0 writes
    them. Returns the launches of each part and their ms."""
    device = group.device
    _, model = load_checkpoint(ckpt, device=device)
    _, env, _ = load_env_checkpoint(env_ckpt, STAGE2_OPT, device=device)
    out, ms, launches = {}, {}, {}
    dirs, _ = fibonacci_sphere_sampling(model.get_normal, SAMPLE_NUM)
    bvh, rays_o, rays_d = visibility_rays(model, dirs)
    tracer = make_sharded_trace(group)
    reset_launches()
    with Timing(device=device) as tm:
        out["trace"] = tracer(bvh, rays_o, rays_d)
    ms["trace"], launches["trace"] = tm.elapsed_ms, read_launches()
    vis = update_visibility(model, SAMPLE_NUM, sharded_trace=tracer)
    shading = make_sharded_shading(group, full_extras=True)
    args = sharded_shading_args(model, env, vis, orbit_view(0, VIEWS,
                                                            SIZE_MAIN, device))
    reset_launches()
    with Timing(device=device) as tm:
        out["pbr"], extras = neilf._shade_points(*args,
                                                 sharded_shading=shading)
    ms["shading"], launches["shading"] = tm.elapsed_ms, read_launches()
    out.update({f"extra.{k}": v for k, v in extras.items()})
    reset_launches()
    with Timing(device=device) as tm:
        res = render_neilf(orbit_view(0, VIEWS, SIZE_MAIN, device), model,
                           RasterConfig(SIZE_MAIN, SIZE_MAIN),
                           torch.zeros(3, device=device), env, vis,
                           is_training=False, sharded_shading=shading)
    ms["render"], launches["render"] = tm.elapsed_ms, read_launches()
    out.update({f"render.{k}": res[k] for k in SHARDED_RENDER_KEYS})
    if group.rank == 0:
        np.savez(out_file, **{k: v.cpu().numpy() for k, v in out.items()})
    return {"launches": launches, "ms": ms}


SHARDED_RENDER_KEYS = ("render", "pbr", "base_color", "roughness",
                       "visibility", "specular", "lights", "opacity",
                       "num_contrib")


def sharded_shading_args(model, env, vis, view) -> tuple:
    """_shade_points' inputs as render_neilf's eval hands them over."""
    viewdirs = view.cam.campos[None, :] - model.xyz
    viewdirs = viewdirs / torch.clamp(
        torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
    return (model.get_base_color, model.get_roughness, model.get_normal,
            viewdirs, model.get_incidents, env, vis)


def run_rank_jobs(group, jobs: list) -> list:
    """One spawn for the dp-stage1, dp-stage2 and sharded ranks: each job
    (function name, arguments) in turn."""
    return [globals()[name](group, *args) for name, args in jobs]


def hand_step(ckpt: str, env_ckpt: str | None, opt: OptimizationConfig,
              views: list[ViewInputs], vis=None) -> dict:
    """One step as the hand combination: each view's gradients and
    statistics alone from the checkpoint's state (K1, K2, and in stage 2 K4),
    the gradients (the env map's too) averaged, the statistics summed (the
    radii: max), one Adam step."""
    extent = 1.1 * CAM_RADIUS
    cfg = RasterConfig(SIZE_MAIN, SIZE_MAIN)
    grads, contribs = [], []
    for v in views:
        it0, model, _ = load_train_state(ckpt, opt, extent, device=v.image.device)
        env = (load_env_checkpoint(env_ckpt, opt, device=v.image.device)[1]
               if env_ckpt else None)
        m2d = torch.zeros((model.num_points, 2), device=v.image.device,
                          requires_grad=True)
        bg = torch.zeros(3, device=v.image.device)
        res = (render(v, model, cfg, bg, opt, is_training=True,
                      iteration=it0 + 1, mean2d_offset=m2d) if env is None
               else render_neilf(v, model, cfg, bg, env, vis, opt,
                                 is_training=True, mean2d_offset=m2d))
        backward_or_zero_grads(res["loss"], model, m2d)
        g = {k: getattr(model, k).grad for k in model.fields}
        if env is not None:
            g["env"] = env.env.grad
        grads.append(g)
        contribs.append(densification_contribs(
            m2d.grad, model.normal.grad, res["weights"][:, 0].detach(),
            res["radii"], (SIZE_MAIN, SIZE_MAIN)))
    it0, model, optimizer = load_train_state(ckpt, opt, extent,
                                             device=views[0].image.device)
    for k in model.fields:
        getattr(model, k).grad = sum(g[k] for g in grads) / len(grads)
    set_learning_rates(optimizer, learning_rates(opt, it0 + 1, extent))
    optimizer.step()
    env = None
    if env_ckpt:
        _, env, env_optimizer = load_env_checkpoint(
            env_ckpt, opt, device=views[0].image.device)
        env.env.grad = sum(g["env"] for g in grads) / len(grads)
        env_optimizer.step()
    apply_stat_contribs(model, StatContribs(
        *(sum(c[i] for c in contribs) for i in range(4)),
        radii=torch.stack([c.radii for c in contribs]).amax(0)))
    return {**step_state(model, env), "lrs": {
        **learning_rates(opt, it0 + 1, extent), "env": opt.env_lr}}


def check_hand_step(label: str, got_file: str, want: dict) -> dict:
    """The first data-parallel step (rank 0's state) against the hand
    combination, under DP_PARAM_LR, DP_GRAD_TOL, DP_STAT_TOL (denom and the
    radii exactly); returns the worst errors in units of their bounds."""
    worst = {}
    with np.load(got_file) as got:
        for key, w in want.items():
            if key == "lrs":
                continue
            kind, name = key.split(".")
            g = got[key]
            if kind == "params":
                err = float(np.abs(g - w).max()) / (DP_PARAM_LR
                                                    * want["lrs"][name])
            elif kind == "stats" and name in ("denom", "max_radii2d"):
                err = 0.0 if np.array_equal(g, w) else float("inf")
            else:
                tol = DP_GRAD_TOL if kind == "grad" else DP_STAT_TOL
                err = float(np.abs(g - w).max()) / (
                    tol * max(float(np.abs(w).max()), 1e-30))
            worst[key] = err
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"{label}: step 1 apart from the hand "
                             f"combination (in units of the bound): {bad}")
    return {kind: f"{max(v for k, v in worst.items() if k.startswith(kind)):.3f}"
            for kind in ("params", "grad", "stats")}


def parallel_files(trained: dict, s2: dict) -> dict:
    """The parallel phases' inputs on disk: the train phase's views and
    checkpoint, the stage2 phase's checkpoint and env map."""
    root = WORK / "parallel"
    root.mkdir(parents=True, exist_ok=True)
    views = trained["views"]
    files = {"views": root / "views.npz",
             "ckpt1": root / f"chkpnt{TRAIN_OPT.iterations}.npz",
             "ckpt2": root / f"chkpnt{STAGE2_OPT.iterations}.npz",
             "env2": root / f"env_light_chkpnt{STAGE2_OPT.iterations}.npz"}
    np.savez(files["views"],
             image=torch.stack([v.image for v in views]).cpu().numpy(),
             mask=torch.stack([v.image_mask for v in views]).cpu().numpy())
    save_checkpoint(str(files["ckpt1"]), TRAIN_OPT.iterations,
                    trained["model"], trained["optimizer"])
    save_checkpoint(str(files["ckpt2"]), STAGE2_OPT.iterations, s2["model"],
                    s2["optimizer"])
    save_env_checkpoint(str(files["env2"]), STAGE2_OPT.iterations, s2["env"],
                        s2["env_optimizer"])
    return {k: str(v) for k, v in files.items()}


def parallel_phases(trained: dict, s2: dict, device) -> dict:
    """dp-stage1, dp-stage2 and sharded at each rank layout of dp_layouts
    (one spawn of parallel.spawn a layout), each gated against this
    process's own computation, then the scaling line. Returns each layout's
    launches of each phase (a list, one entry a rank), by layout name."""
    os.environ.pop("R3DG_BWD_TWO_WALK", None)
    files = parallel_files(trained, s2)
    count = torch.cuda.device_count()
    layouts = dp_layouts(count)
    if count < 2:
        say("parallel", cards=count, layouts=[list(d) for d in layouts],
            nccl="not run: the NCCL layouts need two cards (one rank a card)")
    with torch.no_grad():
        _, model2 = load_checkpoint(files["ckpt2"], device=device)
        vis2 = update_visibility(model2, SAMPLE_NUM)
    out, readings = {}, {}
    for devices in layouts:
        name = layout_name(devices)
        out[name], readings[name] = parallel_layout(
            devices, files, trained["views"], model2, vis2, device)
    base = readings.get("single")
    scaling = {}
    for name, r in readings.items():
        scaling[name] = {
            "ranks": r["ranks"],
            "stage1_ms_per_step": f"{r['dp1_ms']:.3f}",
            "stage1_views_per_s": f"{r['ranks'] * 1e3 / r['dp1_ms']:.2f}",
            "stage2_ms_per_step": f"{r['dp2_ms']:.3f}",
            "stage2_views_per_s": f"{r['ranks'] * 1e3 / r['dp2_ms']:.2f}",
            "allreduce_ms_stage1": r["allreduce1_ms"],
            "allreduce_bytes_stage1": r["allreduce1_bytes"],
            "allreduce_ms_stage2": r["allreduce2_ms"],
            "allreduce_bytes_stage2": r["allreduce2_bytes"],
            "replicate_ms_stage1": r["replicate1_ms"],
            "replicate_ms_stage2": r["replicate2_ms"],
            "trace_ms_per_rank": r["trace_ms"],
            "trace_ms_one_launch": r["trace_one_ms"]}
        if base is not None:
            for st in ("stage1", "stage2"):
                scaling[name][f"{st}_views_per_s_over_one_rank"] = (
                    f"{r['ranks'] * base[f'dp{st[-1]}_ms'] / r[f'dp{st[-1]}_ms']:.3f}")
    say("parallel-scaling", card=CARD, cards=count, layouts=scaling)
    return out


def parallel_layout(devices, files: dict, views: list, model2, vis2,
                    device) -> tuple[dict, dict]:
    """dp-stage1, dp-stage2 and sharded on one rank a `devices` entry, in
    one spawn; each phase's line names the layout. Returns the launches of
    each phase a rank, and the readings of the scaling line."""
    n, name = len(devices), layout_name(devices)
    backend = None if n == 1 else choose_backend(devices)
    root = Path(files["views"]).parent / name
    root.mkdir(parents=True, exist_ok=True)
    out = {k: str(root / f"{k}.npz") for k in ("dp1_step1", "dp2_step1",
                                               "sharded")}
    ckpt1, ckpt2, env2 = files["ckpt1"], files["ckpt2"], files["env2"]
    jobs = [("dp_stage1_rank", (ckpt1, files["views"], out["dp1_step1"])),
            ("dp_stage2_rank", (ckpt2, env2, files["views"],
                                out["dp2_step1"])),
            ("sharded_rank", (ckpt2, env2, out["sharded"]))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = spawn(run_rank_jobs, devices, jobs, timeout_s=600,
                  collective_timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    dp1, dp2, shr = ([r[k] for r in ranks] for k in range(3))
    d1, d2 = dp1[0], dp2[0]
    layout = {"layout": name, "ranks": n, "devices": list(devices),
              "backend": backend}

    # dp-stage1
    for r in dp1[1:]:
        apart = [i + 1 for i, (a, b) in enumerate(zip(d1["digests"],
                                                      r["digests"])) if a != b]
        if apart:
            raise AssertionError(f"dp-stage1 {name}: replicas apart after "
                                 f"steps {apart}")
    for r in dp1:
        if (r["launches"]["K1"], r["launches"]["K2"]) != (DP1_STEPS, DP1_STEPS):
            raise AssertionError(f"dp-stage1 {name}: {DP1_STEPS} steps "
                                 f"launched {r['launches']} on a rank")
    if not np.isfinite(d1["loss"]).all() or d1["points"][-1] == d1["points"][0]:
        raise AssertionError(f"dp-stage1 {name}: loss {d1['loss'][:3]}..., "
                             f"points {d1['points'][0]} -> {d1['points'][-1]}")
    hand1 = hand_step(ckpt1, None, TRAIN_OPT, [
        views[v] for v in dp_batch(0, n)])
    worst1 = check_hand_step(f"dp-stage1 {name}", out["dp1_step1"], hand1)
    dp1_ms = float(np.median(d1["ms"][1:]))
    say("dp-stage1", **layout, steps=DP1_STEPS, densify_after=DP1_DENSIFY_AT,
        reset_after=DP1_RESET_AT, points=f"{d1['points'][0]}->{d1['points'][-1]}",
        replicas_bitwise_equal_every_step=True,
        launches=[r["launches"] for r in dp1],
        step1_vs_hand_in_bound_units=worst1,
        ms_per_dp_step_median=f"{dp1_ms:.3f}",
        views_per_s=f"{n * 1e3 / dp1_ms:.2f}",
        ms_per_dp_step=[round(m, 3) for m in d1["ms"]],
        allreduce_ms=d1["allreduce_ms"], allreduce_bytes=d1["allreduce_bytes"],
        replicate_ms=[round(r["replicate_ms"], 3) for r in dp1],
        loss_first=f"{d1['loss'][0]:.5f}", loss_last=f"{d1['loss'][-1]:.5f}")

    # dp-stage2
    if any(r["digests"] != d2["digests"] or r["env_digest"] != d2["env_digest"]
           for r in dp2):
        raise AssertionError(f"dp-stage2 {name}: replicas (or env maps) apart")
    for r in dp2:
        per_step = [r["launches"][k] for k in ("K1", "K2", "K4-fwd", "K4-bwd")]
        if per_step != [DP2_STEPS] * 4:
            raise AssertionError(f"dp-stage2 {name}: {DP2_STEPS} steps "
                                 f"launched {r['launches']} on a rank")
    hand2 = hand_step(ckpt2, env2, STAGE2_OPT,
                      [views[v] for v in dp_batch(0, n)], vis2)
    worst2 = check_hand_step(f"dp-stage2 {name}", out["dp2_step1"], hand2)
    dp2_ms = float(np.median(d2["ms"][1:]))
    say("dp-stage2", **layout, steps=DP2_STEPS,
        replicas_bitwise_equal_every_step=True, env_maps_bitwise_equal=True,
        launches=[r["launches"] for r in dp2],
        step1_vs_hand_in_bound_units=worst2,
        ms_per_dp_step_median=f"{dp2_ms:.3f}",
        views_per_s=f"{n * 1e3 / dp2_ms:.2f}",
        ms_per_dp_step=[round(m, 3) for m in d2["ms"]],
        allreduce_ms=d2["allreduce_ms"], allreduce_bytes=d2["allreduce_bytes"],
        replicate_ms=[round(r["replicate_ms"], 3) for r in dp2],
        loss_first=f"{d2['loss'][0]:.5f}", loss_last=f"{d2['loss'][-1]:.5f}")

    # sharded: against one K3 launch, the unsharded shading and render
    with torch.no_grad(), np.load(out["sharded"]) as got:
        _, env_model, _ = load_env_checkpoint(env2, STAGE2_OPT, device=device)
        dirs, _ = fibonacci_sphere_sampling(model2.get_normal, SAMPLE_NUM)
        bvh, rays_o, rays_d = visibility_rays(model2, dirs)
        reset_launches()
        whole, trace_ms = timed_ms(lambda: ray_trace.trace_visibility(
            bvh, rays_o, rays_d))
        if not np.array_equal(got["trace"], whole.cpu().numpy()):
            diff = int((got["trace"] != whole.cpu().numpy()).sum())
            raise AssertionError(f"sharded {name}: {diff} rays' T apart from "
                                 "one K3 launch on all rays")
        view0 = orbit_view(0, VIEWS, SIZE_MAIN, device)
        pbr, extras = neilf._shade_points(*sharded_shading_args(
            model2, env_model, vis2, view0))
        shade_err = {k: float(np.abs(got[key] - v.cpu().numpy()).max())
                     for k, key, v in [("pbr", "pbr", pbr)] + [
                         (k, f"extra.{k}", v) for k, v in extras.items()]}
        if max(shade_err.values()) > SHARDED_SHADE_ATOL:
            raise AssertionError(f"sharded {name}: shading apart from "
                                 f"_shade_points {shade_err} > "
                                 f"{SHARDED_SHADE_ATOL}")
        res = render_neilf(view0, model2, RasterConfig(SIZE_MAIN, SIZE_MAIN),
                           torch.zeros(3, device=device), env_model, vis2,
                           is_training=False)
        want_count = res["num_contrib"].cpu().numpy()
        agree = got["render.num_contrib"] == want_count
        if agree.mean() < COUNT_AGREE:
            raise AssertionError(f"sharded {name}: n_contrib equal on "
                                 f"{agree.mean()}")
        render_err = {}
        for k in SHARDED_RENDER_KEYS[:-1]:
            w = res[k].cpu().numpy()
            g = got[f"render.{k}"]
            if not np.allclose(g[:, agree], w[:, agree], atol=IMG_ATOL,
                               rtol=IMG_RTOL):
                raise AssertionError(f"sharded {name}: render {k} apart from "
                                     "the unsharded view beyond k1-main's "
                                     "gate")
            render_err[k] = f"{float(np.abs(g - w)[:, agree].max()):.3e}"
    for r in shr:
        if (r["launches"]["trace"]["K3"], r["launches"]["render"]["K1"]) != (1, 1):
            raise AssertionError(f"sharded {name}: launches {r['launches']}")
    say("sharded", **layout, rays=int(rays_o.shape[0]),
        rays_per_rank=int(rays_o.shape[0]) // n,
        trace_bitwise_equal_one_launch=True,
        trace_ms_per_rank=[round(r["ms"]["trace"], 3) for r in shr],
        trace_ms_one_launch=f"{trace_ms:.3f}",
        shading_max_abs_err={k: f"{v:.3e}" for k, v in shade_err.items()},
        shading_bitwise_equal=max(shade_err.values()) == 0.0,
        shading_ms=[round(r["ms"]["shading"], 3) for r in shr],
        render_n_contrib_equal=f"{agree.mean():.6f}",
        render_max_abs_err=render_err,
        render_ms=[round(r["ms"]["render"], 3) for r in shr],
        launches=[r["launches"] for r in shr],
        spawn_s=f"{spawn_s:.2f}")
    readings = {"ranks": n, "dp1_ms": dp1_ms, "dp2_ms": dp2_ms,
                "allreduce1_ms": d1["allreduce_ms"],
                "allreduce1_bytes": d1["allreduce_bytes"],
                "allreduce2_ms": d2["allreduce_ms"],
                "allreduce2_bytes": d2["allreduce_bytes"],
                "replicate1_ms": round(max(r["replicate_ms"] for r in dp1), 3),
                "replicate2_ms": round(max(r["replicate_ms"] for r in dp2), 3),
                "trace_ms": [round(r["ms"]["trace"], 3) for r in shr],
                "trace_one_ms": round(trace_ms, 3)}
    return ({"dp-stage1": [r["launches"] for r in dp1],
             "dp-stage2": [r["launches"] for r in dp2],
             "sharded": [r["launches"] for r in shr]}, readings)


# cli-ranks (two or more cards): the cli phase's scene through the CLIs'
# mains at --n_devices min(count, DP_MAX_RANKS), one rank a card over NCCL:
# cli.train stage 1 for CLI_RANKS_STEPS1 steps from the scene's points (a
# densify at step CLI_RANKS_DENSIFY_AT), -t neilf for CLI_RANKS_STEPS2 more,
# cli.eval_nvs -t neilf on that checkpoint at n ranks and at one, and
# cli.relighting on the relight phase's composition; every rank in cli_rank.
CLI_RANKS_STEPS1, CLI_RANKS_DENSIFY_AT, CLI_RANKS_STEPS2 = 20, 10, 10


class CheckedTrace:
    """A ray-sharded trace (point_sharded.make_sharded_trace) that holds
    what it gathers against one K3 launch on all of the call's rays,
    bitwise; that launch is left out of the launch counts."""

    def __init__(self, tracer):
        self.tracer, self.group, self.calls = tracer, tracer.group, []
        self.last_stats = tracer.last_stats

    def __call__(self, bvh, rays_o, rays_d, *args, **kwargs):
        out = self.tracer(bvh, rays_o, rays_d, *args, **kwargs)
        self.last_stats = self.tracer.last_stats
        vis = out[0] if isinstance(out, tuple) else out
        launches = trace.counter("k3.launches")
        whole = ray_trace.trace_visibility(bvh, rays_o, rays_d)
        trace.set_counter("k3.launches", launches)
        self.calls.append({"rays": int(rays_o.shape[0]),
                           "bitwise_one_launch": bool(torch.equal(vis, whole))})
        return out


def cli_rank(fn, record: str, args, device, group):
    """A rank of a CLI's run_ranks: the CLI's rank function fn(args,
    device, group), its sharded traces checked (CheckedTrace) and its
    launches counted from 0, both written to `record`.rank<r>.json; returns
    fn's result."""
    module = sys.modules[fn.__module__]
    real, checked = module.sharded_trace_from_args, []

    def traced(a, g):
        tracer = real(a, g)
        if tracer is not None:
            checked.append(CheckedTrace(tracer))
            return checked[-1]
        return None

    module.sharded_trace_from_args = traced
    reset_launches()
    try:
        result = fn(args, device, group)
    finally:
        module.sharded_trace_from_args = real
    with open(f"{record}.rank{group.rank}.json", "w") as f:
        json.dump({"launches": read_launches(),
                   "traces": [c for t in checked for c in t.calls]}, f)
    return result


def cli_on_ranks(cli_module, argv: list[str], n: int, record: Path,
                 device) -> tuple:
    """cli_module.main(argv + --n_devices n) on `device`, its run_ranks
    running each rank in cli_rank: (main's result, each rank's record, wall
    seconds)."""
    real = cli_module.run_ranks
    cli_module.run_ranks = lambda fn, args, device: real(
        functools.partial(cli_rank, fn, str(record)), args, device)
    t0 = time.perf_counter()
    try:
        result = cli_module.main(argv + ["--n_devices", str(n)],
                                 device=device)
    finally:
        cli_module.run_ranks = real
    wall = time.perf_counter() - t0
    records = []
    for r in range(n):
        with open(f"{record}.rank{r}.json") as f:
            records.append(json.load(f))
    return result, records, wall


def losses_of(model_path: Path) -> list[float]:
    """The per-step losses cli.train logged to metrics.jsonl."""
    with open(model_path / "metrics.jsonl") as f:
        recs = sorted((r for r in map(json.loads, f) if "loss" in r),
                      key=lambda r: r["step"])
    return [r["loss"] for r in recs]


def pngs_apart(a: Path, b: Path) -> dict:
    """Of the PNGs under `a`, against the same names under `b`: how many
    differ, their largest difference in u8 levels and their share of
    values that differ."""
    files = sorted(x.relative_to(a) for x in a.rglob("*.png"))
    if not files or any(not (b / f).exists() for f in files):
        raise AssertionError(f"{a}: PNGs missing against {b}")
    diffs = [np.abs(read_png(str(a / f)).astype(np.int64)
                    - read_png(str(b / f)).astype(np.int64)) for f in files]
    return {"files": len(files),
            "files_apart": sum(int(d.any()) for d in diffs),
            "max_u8": max(int(d.max()) for d in diffs),
            "values_apart_share": float(np.mean([(d > 0).mean()
                                                 for d in diffs]))}


def cli_ranks_phase(cli: dict, relight: dict, device) -> dict:
    """The CLIs at --n_devices n over NCCL, gated: the replicas bitwise
    equal after each training (parallel.check_replicas in cli.train), the
    losses finite and falling, every sharded trace bitwise one K3 launch on
    its rays, K1 and K2 a step on every rank (and K4 in stage 2), the eval
    at n ranks the one-rank eval's images bitwise (or, where not, within
    one u8 level and 1e-4 dB: the one-rank eval shades in chunks of
    SHADE_CHUNK_SAMPLES, a rank its whole share in one call, and the
    card's reductions over the samples may take another order at another
    size), the relit frames those of the relight phase's one-rank run
    bitwise (or as the eval). Returns each run's launches a rank."""
    n = min(torch.cuda.device_count(), DP_MAX_RANKS)
    devices = rank_devices(n, torch.device(device))
    root = WORK / "cli_ranks"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    os.environ.pop("R3DG_BWD_TWO_WALK", None)
    data, out1, out2 = cli["data"], root / "stage1", root / "stage2"
    n1, n2 = CLI_RANKS_STEPS1, CLI_RANKS_STEPS1 + CLI_RANKS_STEPS2
    opt1 = dataclasses.replace(
        TRAIN_OPT, iterations=n1, position_lr_max_steps=n1,
        densify_from_iter=CLI_RANKS_DENSIFY_AT - 1,
        densification_interval=CLI_RANKS_DENSIFY_AT,
        densify_until_iter=CLI_RANKS_DENSIFY_AT + 1)
    opt2 = OptimizationConfig(**{**STAGE2_NERF_SYNTHETIC, "iterations": n2})
    saved_timeout = data_parallel.COLLECTIVE_TIMEOUT_S
    data_parallel.COLLECTIVE_TIMEOUT_S = DP_COLLECTIVE_TIMEOUT_S
    try:
        digests1, recs1, wall1 = cli_on_ranks(train_cli, [
            "-s", str(data), "-m", str(out1), "--log_interval", "1",
            "--save_interval", str(n1), "--checkpoint_interval", str(n1)]
            + opt_flags(opt1), n, root / "stage1", device)
        digests2, recs2, wall2 = cli_on_ranks(train_cli, [
            "-s", str(data), "-m", str(out2), "-t", "neilf",
            "-c", str(out1 / f"chkpnt{n1}.npz"), "--sample_num",
            str(SAMPLE_NUM), "--log_interval", "1",
            "--save_interval", str(n2), "--checkpoint_interval", str(n2)]
            + opt_flags(opt2), n, root / "stage2", device)
        eval_argv = ["-s", str(data), "-m", str(out2), "-t", "neilf",
                     "-c", str(out2 / f"chkpnt{n2}.npz"), "--skip_train",
                     "--sample_num", str(SAMPLE_NUM)]
        reset_launches()
        one = eval_nvs.main(eval_argv + ["--n_devices", "1"],
                            device=device)["test"]
        (out2 / "test").rename(out2 / "test_one_rank")
        evaluated, recs3, wall3 = cli_on_ranks(eval_nvs, eval_argv, n,
                                               root / "eval", device)
        many = evaluated["test"]
        _, recs4, wall4 = cli_on_ranks(relighting, [
            "-co", str(relight["root"]), "-e", str(relight["env"]),
            "--output", str(root / "relight"), "--sample_num",
            str(SAMPLE_NUM), "--capture_list", ",".join(RELIGHT_CAPTURES)],
            n, root / "relight", device)
    finally:
        data_parallel.COLLECTIVE_TIMEOUT_S = saved_timeout

    runs = {"stage1": recs1, "neilf": recs2, "eval_nvs": recs3,
            "relighting": recs4}
    for label, digests in (("stage 1", digests1), ("neilf", digests2)):
        if len(digests) != n or len(set(digests)) != 1:
            raise AssertionError(f"cli-ranks {label}: replica digests "
                                 f"{digests}")
    want = {"stage1": {"K1": n1, "K2": n1},
            "neilf": {"K1": CLI_RANKS_STEPS2, "K2": CLI_RANKS_STEPS2,
                      "K4-fwd": CLI_RANKS_STEPS2, "K4-bwd": CLI_RANKS_STEPS2}}
    for label, expect in want.items():
        for r, rec in enumerate(runs[label]):
            if any(rec["launches"][k] != v for k, v in expect.items()):
                raise AssertionError(f"cli-ranks {label}: rank {r} launched "
                                     f"{rec['launches']}, expected {expect}")
    traces = {label: [c for rec in recs for c in rec["traces"]]
              for label, recs in runs.items()}
    for label in ("neilf", "eval_nvs", "relighting"):
        per_rank = [len(rec["traces"]) for rec in runs[label]]
        if min(per_rank) < 1 or not all(c["bitwise_one_launch"]
                                        for c in traces[label]):
            raise AssertionError(f"cli-ranks {label}: sharded traces "
                                 f"{per_rank} a rank, {traces[label]}")
        if any(rec["launches"]["K3"] < 1 for rec in runs[label]):
            raise AssertionError(f"cli-ranks {label}: a rank launched no K3")
    losses = {}
    for label, out in (("stage1", out1), ("neilf", out2)):
        values = losses_of(out)
        if not np.isfinite(values).all() or not (
                np.mean(values[-3:]) < np.mean(values[:3])):
            raise AssertionError(f"cli-ranks {label}: losses {values} not "
                                 "finite and falling")
        losses[label] = f"{values[0]:.5f}->{values[-1]:.5f}"
    evals = pngs_apart(out2 / "test", out2 / "test_one_rank")
    evals_bitwise = evals["files_apart"] == 0 and all(
        one[k] == many[k] for k in ("psnr", "ssim"))
    if not evals_bitwise and (evals["max_u8"] > 1 or any(
            abs(one[k] - many[k]) > 1e-4 for k in ("psnr", "ssim"))):
        raise AssertionError(f"cli-ranks eval_nvs: {n} ranks against one: "
                             f"{evals}, {many} against {one}")
    frames = pngs_apart(root / "relight", relight["root"] / "capture")
    if frames["max_u8"] > 1:
        raise AssertionError(f"cli-ranks relighting: frames against the "
                             f"one-rank run {frames}")
    say("cli-ranks", card=CARD, ranks=n, devices=[str(d) for d in devices],
        backend=choose_backend(devices),
        stage1_steps=n1, stage2_steps=CLI_RANKS_STEPS2,
        replicas_bitwise_equal=True, losses=losses,
        sharded_traces_bitwise_one_launch={
            k: len(v) for k, v in traces.items() if v},
        eval_images_bitwise_one_rank=evals_bitwise, eval_pngs_apart=evals,
        eval_psnr=f"{many['psnr']:.6f}", eval_psnr_one_rank=f"{one['psnr']:.6f}",
        eval_ms_per_view_median=f"{float(np.median(many['view_ms'][1:])):.3f}",
        eval_ms_per_view_median_one_rank=
        f"{float(np.median(one['view_ms'][1:])):.3f}",
        relit_frames_apart_from_one_rank=frames,
        wall_s={"stage1": f"{wall1:.2f}", "neilf": f"{wall2:.2f}",
                "eval_nvs": f"{wall3:.2f}", "relighting": f"{wall4:.2f}"},
        launches={k: [rec["launches"] for rec in v] for k, v in runs.items()})
    return {k: [rec["launches"] for rec in v] for k, v in runs.items()}


# prune-only: stage-1 steps of a copy of cell 2's trained 800x800 model (a
# model from random points has radii of ~40 pixels, so a screen-size prune
# at 20 takes nearly all of it), PRUNE_STEPS before each prune_only (its
# statistics live: a prune zeroes weights_accum, so a second one at once
# would prune every point), with the reference's min_opacity and
# max_screen_size inf, then PRUNE_SCREEN (the training loop's size
# threshold); PRUNE_MORE_STEPS after.
PRUNE_STEPS, PRUNE_MORE_STEPS, PRUNE_SCREEN, PRUNE_MIN_OPACITY = 10, 20, 20.0, 0.005


def host_prune(model: GaussianModel, optimizer, extent: float,
               max_screen_size: float) -> dict:
    """What prune_only must leave, selected on the host from the model's
    tensors as the card holds them: the kept rows' parameters, Adam state
    and statistics (weights_accum zero), and the count pruned."""
    cpu = {k: getattr(model, k).detach().cpu() for k in model.fields + G_STATS}
    opacity = model.get_opacity[:, 0].detach().cpu()
    max_scale = model.get_scaling.detach().max(-1).values.cpu()
    prune = ((opacity < PRUNE_MIN_OPACITY)
             | (cpu["weights_accum"] < WEIGHTS_PRUNE)
             | (cpu["max_radii2d"] > max_screen_size))
    if max_screen_size < math.inf:
        prune |= max_scale > 0.1 * extent
    keep = ~prune
    state = {}
    for g in optimizer.param_groups:
        st = optimizer.state.get(g["params"][0], {})
        state[g["name"]] = {k: (v.cpu()[keep] if k.startswith("exp_avg")
                                else v.clone()) for k, v in st.items()}
    rows = {k: v[keep] for k, v in cpu.items()}
    rows["weights_accum"] = torch.zeros_like(rows["weights_accum"])
    return {"rows": rows, "state": state, "pruned": int(prune.sum())}


def check_prune(model: GaussianModel, optimizer, want: dict, pruned: int,
                label: str) -> None:
    """prune_only's result against host_prune's, bitwise."""
    apart = [k for k, v in want["rows"].items()
             if not torch.equal(getattr(model, k).detach().cpu(), v)]
    for g in optimizer.param_groups:
        p = g["params"][0]
        if p is not getattr(model, g["name"]):
            apart.append(f"{g['name']} (the optimizer's tensor)")
        st = optimizer.state.get(p, {})
        for k, v in want["state"][g["name"]].items():
            if k not in st or not torch.equal(st[k].cpu(), v):
                apart.append(f"{g['name']}.{k}")
    if pruned != want["pruned"] or apart:
        raise AssertionError(f"{label}: pruned {pruned} (host {want['pruned']}); "
                             f"apart from the host's rows: {apart}")


def prune_only_phase(trained: dict, device) -> dict:
    """prune_only on the card between stage-1 steps (PRUNE_STEPS' note),
    each prune held bitwise to host_prune, some points pruned and none
    leaving the model empty; the loss finite after it.
    Returns K1's and K2's launches."""
    views, cfg, extent = trained["views"], trained["cfg"], trained["extent"]
    path = WORK / "prune_only_start.npz"
    save_checkpoint(str(path), TRAIN_OPT.iterations, trained["model"],
                    trained["optimizer"])
    it, model, optimizer = load_train_state(str(path), TRAIN_OPT, extent,
                                            device=device)
    losses = []

    def steps(n: int) -> None:
        nonlocal it
        for _ in range(n):
            it += 1
            m = train_step(model, optimizer, views[it % VIEWS], it, cfg=cfg,
                           opt=TRAIN_OPT, spatial_lr_scale=extent)
            losses.append(float(m["loss"]))

    reset_launches()
    report = []
    for max_screen_size in (math.inf, PRUNE_SCREEN):
        steps(PRUNE_STEPS)
        before = model.num_points
        want = host_prune(model, optimizer, extent, max_screen_size)
        pruned, ms = timed_ms(lambda: prune_only(
            model, optimizer, min_opacity=PRUNE_MIN_OPACITY, extent=extent,
            max_screen_size=max_screen_size))
        check_prune(model, optimizer, want, pruned,
                    f"prune-only {max_screen_size}")
        report.append({"max_screen_size": max_screen_size, "points": before,
                       "pruned": pruned, "left": model.num_points,
                       "ms": f"{ms:.3f}"})
    steps(PRUNE_MORE_STEPS)
    launches = {"K1": trace.counter("k1.launches"),
                "K2": trace.counter("k2.launches")}
    n_steps = 2 * PRUNE_STEPS + PRUNE_MORE_STEPS
    if not np.isfinite(losses).all() or launches != {"K1": n_steps,
                                                      "K2": n_steps}:
        raise AssertionError(f"prune-only: losses finite "
                             f"{bool(np.isfinite(losses).all())}, launches "
                             f"{launches} for {n_steps} steps")
    if sum(r["pruned"] for r in report) == 0 or any(
            r["left"] == 0 for r in report):
        raise AssertionError(f"prune-only: pruned none or all: {report}")
    say("prune-only", size=f"{cfg.width}x{cfg.height}", steps=n_steps,
        prunes=report, loss_before=f"{losses[2 * PRUNE_STEPS - 1]:.5f}",
        loss_last=f"{losses[-1]:.5f}", k1_launches=launches["K1"],
        k2_launches=launches["K2"])
    return launches


def print_interconnect() -> None:
    """One line on how the cards are joined: `nvidia-smi topo -m` (or its
    error), `nvidia-smi nvlink --status` per card and which pairs of cards
    reach each other's memory (torch.cuda.can_device_access_peer)."""
    def smi(*args) -> str:
        proc = subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=60)
        return (proc.stdout + proc.stderr).strip()

    n = torch.cuda.device_count()
    links = smi("nvlink", "--status")
    say("interconnect", cards=n, topo_m=repr(smi("topo", "-m")),
        nvlinks_per_card=[line.count("GB/s") for line in
                          links.split("GPU ")[1:]] if links else [],
        nvlink_status=repr(links.splitlines()[:3]),
        peer_access=[[i, j] for i in range(n) for j in range(n)
                     if i != j and torch.cuda.can_device_access_peer(i, j)])


def build_phase(ptxas_also: tuple[str, ...] = ()) -> None:
    """Builds K1 to K6 and the check kernel composite_decisions from the
    checkout's sources, one nvcc each, all at once, and prints ptxas's
    report of K3's, K4's, K5's and K6's sources and of each source in
    `ptxas_also`, compiled beside them."""
    t0 = time.perf_counter()
    kernels = (composite_cuda.KERNEL, composite_cuda.BWD_KERNEL,
               ray_trace_cuda.KERNEL, shading_cuda.KERNEL,
               composite_cuda.TWO_WALK_KERNEL, composite_cuda.DECISIONS_KERNEL,
               shading_eval_cuda.KERNEL)
    ptxas_sources = (*(str(_build.CSRC / f"{k}.cu") for k in (
        ray_trace_cuda.KERNEL, shading_cuda.KERNEL,
        composite_cuda.TWO_WALK_KERNEL, shading_eval_cuda.KERNEL)),
        *ptxas_also)
    with ThreadPoolExecutor(len(kernels) + len(ptxas_sources)) as pool:
        reports = pool.map(_build.ptxas_report, ptxas_sources)
        list(pool.map(_build.load_library, kernels))
        reports = list(reports)
    say("build", kernels=list(kernels),
        build_s=f"{time.perf_counter() - t0:.2f}")
    for src, report in zip(ptxas_sources, reports):
        say("ptxas", source=src, kernels=report)


def main(device: str = "cuda:0", ptxas_also: tuple[str, ...] = (),
         k4_seeds: int = K4_SEEDS) -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke needs an NVIDIA GPU")
    device = torch.device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    global CARD
    card = CARD = smi.strip().splitlines()[0]
    print_interconnect()
    print(card, flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=f"'{card}'")

    # The phases before cli check K2 on the default backward.
    os.environ.pop("R3DG_BWD_TWO_WALK", None)

    # 2. build K1 to K6 from the checkout's sources
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
        render_launches = (trace.counter("k1.launches"), trace.counter("k2.launches"))
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
    # K2 against the float64 replay of K1's decisions at split pixels
    k2_split = k2_split_phase(main_args, s2)
    with torch.no_grad():
        # 13. K3 against the plain tracer on the stage's rays
        model = s2["model"]
        dirs = s2["vis"].incident_dirs
        main_k3 = check_k3(*visibility_rays(model, dirs), "k3-main",
                           subset=K3_SUBSET, seed=SEED + 5,
                           samples=dirs.shape[1])
        # 14. K4 at the train step's shapes
        main_k4f, main_k4b, _ = check_k4(train_shading_case(
            model, s2["env"], s2["vis"], s2["views"][0]), "k4-main", SEED + 6)
        # K6 at s2-relight's shapes
        main_k6 = k6_eval_phase(device)
    # 15. the stage-2 eval render
    eval_launches = stage2_eval_phase(s2, device)
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
                         "K4-bwd": "shade_bwd_kernel",
                         "K4-bwd-fix": "shade_bwd_fix_kernel"})

    # 17. the README's commands through the CLIs
    cli = cli_phase(scene_model, device)
    cli_launches = cli["launches"]
    # 18. composition and relighting through cli.relighting
    relight = relight_phase(s2, cli, device)
    # 19. the Synthetic4Relight eval through cli.eval_relighting_syn4
    relight_eval = relight_eval_phase(cli, device)
    # one scored view of it at the benchmark's S = 384, 300,000 points
    syn4_view = syn4_view_phase(device)
    # 20. the visibility SH fit
    finetune = finetune_vis_phase(s2, device)
    # 21. MVS on the analytic plane at 800x800, through cli.mvs
    mvs_plane_phase(device)
    # 22. MVS on the cli phase's test views, then cli.eval_nvs
    mvs_phase(cli, scene_model, device)
    # 23. the viewer, headless, -t render and -t neilf
    gui_launches = gui_phase(cli, device)
    # 24. cli.train --gui with a stub dearpygui
    train_gui_launches = train_gui_phase(cli, device)
    # 25. K4's gate over fresh sample directions on the stage-2 model
    with torch.no_grad():
        k4_seeds_phase(s2, k4_seeds)
        # K4's float32 clips forced, against float64
        k4_branches_phase(device)
    # 26. the dense oracle against K1 and K2
    dense = dense_phase(device)
    # 27. the reference-API facade against rasterize
    facade = facade_phase(scene_model, orbit_view(0, VIEWS, SIZE_MAIN, device))
    # 28-30. data-parallel stages 1 and 2 and the sharded eval at each rank
    # layout (dp_layouts)
    par = parallel_phases(trained, s2, device)
    # 31. the CLIs at --n_devices n, one rank a card (two or more cards)
    if torch.cuda.device_count() >= 2:
        cli_ranks = cli_ranks_phase(cli, relight, device)
    else:
        cli_ranks = {}
        say("cli-ranks", cards=torch.cuda.device_count(),
            nccl="not run: the CLIs' --n_devices N needs N cards, one rank "
                 "a card")
    # 32. prune_only between stage-1 steps
    prune = prune_only_phase(trained, device)

    def per_rank(phase, kernel, part=None):
        """{layout: [each rank's launches]} of a parallel phase."""
        return {name: [(r[part] if part else r)[kernel] for r in phases[phase]]
                for name, phases in par.items()}

    def cli_per_rank(kernel):
        """{CLI run: [each rank's launches]} of the cli-ranks phase."""
        return {run: [r[kernel] for r in ranks]
                for run, ranks in cli_ranks.items()}

    s2_launches = s2["launches"]
    print(json.dumps({"kernels": [
        {"name": "K1 composite_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["K1"], **main_k1,
         "relight_launches": relight["launches"]["K1"],
         "relight_eval_launches": relight_eval["launches"]["K1"],
         "gui_render_launches": gui_launches["render"]["K1"],
         "gui_neilf_launches": gui_launches["neilf"]["K1"],
         "train_gui_launches": train_gui_launches["K1"],
         "dense_launches": dense["K1"], "facade_launches": facade["K1"],
         "facade_full_launches": facade["full"]["K1"],
         "prune_only_launches": prune["K1"],
         "dp_stage1_launches": per_rank("dp-stage1", "K1"),
         "dp_stage2_launches": per_rank("dp-stage2", "K1"),
         "sharded_launches": per_rank("sharded", "K1", "render"),
         "cli_ranks_launches": cli_per_rank("K1")},
        {"name": "K2 composite_bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"], **main_k2,
         "dense_launches": dense["K2"],
         "facade_full_launches": facade["full"]["K2"],
         "prune_only_launches": prune["K2"], **k2_split,
         "dp_stage1_launches": per_rank("dp-stage1", "K2"),
         "dp_stage2_launches": per_rank("dp-stage2", "K2"),
         "cli_ranks_launches": cli_per_rank("K2")},
        {"name": "K3 ray_trace", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": s2_launches["K3"], **main_k3,
         "relight_launches": relight["launches"]["K3"],
         "relight_rays": relight["k3_rays"], "relight_ms": relight["k3_ms"],
         "relight_max_abs_err": relight["k3_max_abs_err"],
         "relight_bound_ms": relight["k3_bound_ms"],
         "relight_bound_by": relight["k3_bound_by"],
         "relight_eval_launches": relight_eval["launches"]["K3"],
         "relight_eval_rays": relight_eval["k3_rays"],
         "relight_eval_ms": relight_eval["k3_ms"],
         "relight_eval_max_abs_err": relight_eval["k3_max_abs_err"],
         "relight_eval_bound_ms": relight_eval["k3_bound_ms"],
         "relight_eval_bound_by": relight_eval["k3_bound_by"],
         "gui_neilf_launches": gui_launches["neilf"]["K3"],
         "finetune_vis_launches": finetune["launches"]["K3"],
         "sharded_launches": per_rank("sharded", "K3", "trace"),
         "cli_ranks_launches": cli_per_rank("K3")},
        {"name": "K4 shade_fwd", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4F_REPLACES, "launches": s2_launches["K4-fwd"],
         **main_k4f, "dp_stage2_launches": per_rank("dp-stage2", "K4-fwd"),
         "cli_ranks_launches": cli_per_rank("K4-fwd")},
        {"name": "K4 shade_bwd", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4B_REPLACES, "launches": s2_launches["K4-bwd"],
         **main_k4b, "dp_stage2_launches": per_rank("dp-stage2", "K4-bwd"),
         "cli_ranks_launches": cli_per_rank("K4-bwd")},
        {"name": "K5 composite_bwd_two_walk", "route": "cuda",
         "source": K5_SOURCE, "replaces": K5_REPLACES,
         "launches": cli_launches["K5"], **main_k5,
         "dp_stage1_launches": per_rank("dp-stage1", "K5"),
         "cli_ranks_launches": cli_per_rank("K5")},
        {"name": "K6 shade_eval", "route": "cuda", "source": K6_SOURCE,
         "replaces": K6_REPLACES, "launches": eval_launches["K6"], **main_k6,
         "relight_launches": relight["launches"]["K6"],
         "relight_eval_launches": relight_eval["launches"]["K6"],
         "gui_neilf_launches": gui_launches["neilf"]["K6"],
         "syn4_view_ms": syn4_view["ms"],
         "syn4_view_bound_ms": syn4_view["bound_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ptxas-also", nargs="*", default=[],
                        help="other kernel sources to print ptxas's report of")
    parser.add_argument("--k4-seeds", type=int, default=K4_SEEDS,
                        help="fresh sample sets for the k4-seeds phase")
    args = parser.parse_args()
    sys.exit(main(ptxas_also=tuple(args.ptxas_also), k4_seeds=args.k4_seeds))
