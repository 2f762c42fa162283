"""Training entry point: the two-stage relightable 3DGS training CLI, on the card.

Port of relightable3dgaussian_tpu/cli/train.py: the same flag surface
(-s/-m/-t/-c, the config groups, the schedules) and the same artifact layout
(point_cloud/iteration_N/point_cloud.ply, chkpnt<N>.npz,
env_light_chkpnt<N>.npz, best_chkpnt.npz with best.json, cfg_args.json,
metrics.jsonl, metric_test.txt), driving the port's train/stage1.py and
train/stage2.py steps.

Usage:
  python -m relightable3dgaussian_tpu_torch.cli.train -s <data> -m <out>
  python -m relightable3dgaussian_tpu_torch.cli.train -s <data> -m <out> \
      -t neilf -c <out_stage1>/chkpnt30000.npz

Stage 1's backward runs kernel K2, or K5 where the environment sets
R3DG_BWD_TWO_WALK=1 (the JAX package's switch). It runs on the card, where
metrics.jsonl also holds each step's times from CUDA events (step_ms and
its forward_ms, backward_ms and optimizer_ms parts);
`main(argv, device=...)` takes another device only from a caller. The JAX
CLI's TPU mechanisms have no counterpart: the port sizes its buffers per
call, so there is no capacity, binning plan, re-plan or overflow streak, and
its tracer is exact, so it has no caps. Their flags (--capacity,
--buffer_multiple, --no_auto_plan, --chunk, --max_chunks_per_tile,
--max_tiles_per_gaussian, --trace_max_clusters, --trace_max_supers) are
accepted and have no effect; --max_capacity > 0 is refused, as there is no
capacity to cap. --n_devices > 1 and --gui are refused: multi-GPU training
and the viewer are ROADMAP queue 1 item 4. The final metrics add LPIPS
where it has weights (losses/lpips.py), as the JAX CLI's do.
"""
from __future__ import annotations

import glob
import json
import os
import re
import time

import numpy as np
import torch

from .. import losses
from ..losses import lpips
from ..models import gaussians as G
from ..models import lights
from ..models.render import render
from ..models.render_neilf import render_neilf, update_visibility
from ..ops.config import RasterConfig
from ..scene import Scene
from ..scene.image_io import save_image_u8
from ..train import checkpoint as ckpt
from ..train import stage1, stage2
from ..train.optim import make_env_optimizer, make_optimizer, start_state
from ..utils.image import psnr as psnr_fn, visualize_depth
from ..utils.logging import MetricsLogger, debug_dump, save_training_vis
from .arguments import (MULTI_GPU_QUEUE, NO_EFFECT, add_tpu_flags,
                        build_parser, extract_all, refuse_multi_gpu,
                        save_cfg_args)


class ModelCollapseError(RuntimeError):
    """Raised when the active point count collapses during densification.

    A mis-ported prune once cascaded 62k -> 0 points over ~3k iterations
    while training went on and wrote metrics from the empty model. The guard
    turns that into an immediate non-zero exit with the checkpoints past the
    best one quarantined, so a retry resumes from pre-collapse state.
    """


def raster_config(cameras, white_background: bool) -> RasterConfig:
    h, w = cameras[0].height, cameras[0].width
    if any(c.height != h or c.width != w for c in cameras):
        raise ValueError("mixed-resolution camera sets need per-resolution "
                         "configs")
    return RasterConfig(height=h, width=w, sh_degree=3,
                        white_background=white_background)


def background(cfg: RasterConfig, device) -> torch.Tensor:
    return (torch.ones(3, device=device) if cfg.white_background
            else torch.zeros(3, device=device))


def refuse_unsupported(args) -> None:
    refuse_multi_gpu(args, "training")
    if getattr(args, "gui", False):
        raise SystemExit(f"--gui: the viewer is not ported yet "
                         f"({MULTI_GPU_QUEUE})")
    if getattr(args, "max_capacity", 0):
        raise SystemExit("--max_capacity: the port keeps only the live "
                         "gaussians and has no capacity to cap")


def _restore(args, is_pbr: bool, opt, spatial_lr_scale: float, device):
    """The checkpoint's model and Adam state; a stage-1 state entering
    stage 2 gets zero PBR fields and Adam restarts with zero moments for
    every field, the step count carried (the JAX CLI's restore)."""
    it, model, optimizer = ckpt.load_train_state(
        args.checkpoint, opt, spatial_lr_scale, device=device)
    print(f"Restored checkpoint {args.checkpoint} at iteration {it}; "
          f"{model.num_points} active gaussians")
    if model.num_points < args.collapse_min_points:
        raise SystemExit(
            f"restored checkpoint has only {model.num_points} active "
            f"gaussians (< {args.collapse_min_points}) — refusing to train "
            "a collapsed model; resume from best_chkpnt.npz or an earlier "
            "checkpoint")
    if is_pbr and not model.has_pbr:
        count = int(next(iter(optimizer.state.values()))["step"])
        G.add_pbr_params(model)
        optimizer = make_optimizer(model, opt, spatial_lr_scale)
        start_state(optimizer, count)
    return it, model, optimizer


def require_device(device: torch.device) -> None:
    """Fail before any work where the card was asked for and is missing."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CLIs run on the card (a "
                           "caller may pass device='cpu' to main)")


def training(args, device) -> None:
    require_device(device)
    refuse_unsupported(args)
    model_cfg, pipe, opt = extract_all(args)
    is_pbr = args.type == "neilf"
    t0 = time.time()

    scene = Scene(model_cfg.source_path, model_cfg.model_path,
                  images=model_cfg.images,
                  white_background=model_cfg.white_background,
                  eval_split=model_cfg.eval, resolution=model_cfg.resolution,
                  debug=pipe.debug)
    save_cfg_args(model_cfg.model_path, args)
    spatial_lr_scale = extent = scene.cameras_extent
    generator = torch.Generator(device=device).manual_seed(args.seed)

    first_iter = 0
    if args.checkpoint:
        # Iteration counting continues across stages: --iterations is the
        # total (a stage-1 checkpoint at 30k and --iterations 40000 train
        # 10k more, script/run_nerf.sh:31).
        first_iter, model, optimizer = _restore(args, is_pbr, opt,
                                                spatial_lr_scale, device)
    else:
        pcd = scene.scene_info.point_cloud
        pts, cols, nrms = pcd.points, pcd.colors, pcd.normals
        if args.max_init_points and pts.shape[0] > args.max_init_points:
            sel = np.random.default_rng(0).choice(
                pts.shape[0], args.max_init_points, replace=False)
            pts, cols, nrms = pts[sel], cols[sel], nrms[sel]
        model = G.create_from_pcd(*(torch.as_tensor(
            np.asarray(x, np.float32), device=device)
            for x in (pts, cols, nrms)))
        if is_pbr:
            G.add_pbr_params(model)
        optimizer = make_optimizer(model, opt, spatial_lr_scale)
        print(f"Initialized {model.num_points} gaussians")

    train_cams = scene.get_train_cameras()
    views = [c.view_inputs(device) for c in train_cams]
    cfg = raster_config(train_cams, model_cfg.white_background)
    bg = background(cfg, device)

    env = env_optimizer = vis = None
    if is_pbr:
        print(f"Tracing visibility ({pipe.sample_num} samples)...")
        vis = update_visibility(model, pipe.sample_num)
        env = lights.DirectLightMap(
            model_cfg.env_resolution, opt.light_init,
            torch.Generator(device=device).manual_seed(args.seed + 1),
            device=device)
        env_optimizer = make_env_optimizer(env, opt)
        env_path = (ckpt.env_checkpoint_path(args.checkpoint)
                    if args.checkpoint else None)
        if env_path and os.path.exists(env_path):
            _, env, env_optimizer = ckpt.load_env_checkpoint(env_path, opt,
                                                             device=device)
            print(f"Loaded env light from {env_path}")

    logger = MetricsLogger(model_cfg.model_path)
    state = {"model": model, "optimizer": optimizer, "env": env,
             "env_optimizer": env_optimizer, "vis": vis}
    best = {"psnr": -1.0, "iter": 0}
    test_views = None
    ema: dict[str, float] = {}

    @torch.no_grad()
    def render_eval(view):
        if is_pbr:
            return render_neilf(view, state["model"], cfg, bg, state["env"],
                                state["vis"], is_training=False)
        return render(view, state["model"], cfg, bg)

    def save_best(iteration):
        path = os.path.join(model_cfg.model_path, "best_chkpnt")
        ckpt.save_checkpoint(path, iteration, state["model"],
                             state["optimizer"])
        if is_pbr:
            ckpt.save_env_checkpoint(
                os.path.join(model_cfg.model_path, "env_light_best_chkpnt"),
                iteration, state["env"], state["env_optimizer"])
        with open(os.path.join(model_cfg.model_path, "best.json"), "w") as f:
            json.dump(best, f)

    def training_report(iteration):
        """Periodic test PSNR over the test cameras (reference
        training_report, train.py:209-273); the best one is checkpointed."""
        nonlocal test_views
        test_cams = scene.get_test_cameras()
        if not test_cams:
            return
        if test_views is None:
            cap = args.report_max_views or len(test_cams)
            test_views = [c.view_inputs(device) for c in test_cams[:cap]]
        psnrs = []
        for tv in test_views:
            res = render_eval(tv)
            img = res["pbr"] if is_pbr else res["render"]
            psnrs.append(float(psnr_fn(img[None], tv.image[None]).mean()))
        value = float(np.mean(psnrs))
        logger.scalars(iteration, {"test_psnr": value})
        print(f"[ITER {iteration}] test PSNR {value:.3f} ({len(psnrs)} views)")
        if value > best["psnr"]:
            best.update(psnr=value, iter=iteration)
            save_best(iteration)

    pending: list = []
    # On the card each step's phases are timed with CUDA events and logged
    # beside its metrics (step_ms, forward_ms, backward_ms, optimizer_ms).
    timer = stage1.StepTimer() if device.type == "cuda" else None

    def flush():
        """Read the buffered metrics in one transfer (a host sync per
        boundary, not per step), log them, and stop on a non-finite loss."""
        tensors = [(j, k, v) for j, (_, m) in enumerate(pending)
                   for k, v in m.items() if isinstance(v, torch.Tensor)]
        host = (torch.stack([v.float().reshape(()) for *_, v in tensors])
                .tolist() if tensors else [])
        numbers = [{k: float(v) for k, v in m.items()
                    if isinstance(v, (int, float))} for _, m in pending]
        for (j, k, _), x in zip(tensors, host):
            numbers[j][k] = x
        if timer is not None:           # one timed step per pending entry
            timer.steps[-1]["end"].synchronize()
            for values, split in zip(numbers, timer.split_ms()):
                values.update({("step" if k == "total" else k) + "_ms": v
                               for k, v in split.items()})
            timer.steps.clear()
        last = {}
        for (it_i, metrics), values in zip(pending, numbers):
            for k in ("psnr", "psnr_pbr"):
                if k in values:
                    ema[k] = 0.4 * values[k] + 0.6 * ema.get(k, 0.0)
            if not np.isfinite(values["loss"]):
                flush_it = pending[-1][0]
                dump = debug_dump(os.path.join(model_cfg.model_path,
                                               f"snapshot_{flush_it}"),
                                  model=state["model"])
                raise FloatingPointError(
                    f"non-finite loss at iteration {it_i}; state as of "
                    f"iteration {flush_it} (post-divergence) dumped to {dump}")
            logger.scalars(it_i, values)
            last = metrics
        pending.clear()
        return last

    def callback(iteration, metrics):
        pending.append((iteration, metrics))
        boundary = (iteration % 8 == 0
                    or iteration % args.log_interval == 0
                    or iteration == first_iter + 1
                    or iteration % args.save_interval == 0
                    or iteration % args.checkpoint_interval == 0
                    or iteration == opt.iterations
                    or "densify" in metrics)
        if not boundary:
            return
        metrics = flush()
        if (pipe.save_training_vis
                and iteration % pipe.save_training_vis_iteration == 0):
            save_training_vis(os.path.join(model_cfg.model_path, "visualize",
                                           f"{iteration:06d}.png"),
                              render_eval(views[0]))
        if iteration % args.test_interval == 0:
            training_report(iteration)
        if iteration % args.log_interval == 0 or iteration == first_iter + 1:
            msg = (f"iter {iteration:6d} loss {float(metrics['loss']):.4f} "
                   f"psnr {ema.get('psnr', 0):.2f}")
            if "psnr_pbr" in ema:
                msg += f" psnr_pbr {ema['psnr_pbr']:.2f}"
            if "densify" in metrics:
                d = metrics["densify"]
                msg += f" | densify +{d.n_cloned}c/{d.n_split}s -{d.n_pruned}p"
            msg += (f" | {state['model'].num_points} pts | "
                    f"{time.time() - t0:.0f}s")
            print(msg, flush=True)
        if iteration % args.save_interval == 0 or iteration == opt.iterations:
            print(f"[ITER {iteration}] Saving gaussians")
            scene.save(iteration, state["model"].to_numpy())
        if (iteration % args.checkpoint_interval == 0
                or iteration == opt.iterations):
            print(f"[ITER {iteration}] Saving checkpoint")
            ckpt.save_checkpoint(
                os.path.join(model_cfg.model_path, f"chkpnt{iteration}"),
                iteration, state["model"], state["optimizer"])
            if is_pbr:
                ckpt.save_env_checkpoint(
                    os.path.join(model_cfg.model_path,
                                 f"env_light_chkpnt{iteration}"),
                    iteration, state["env"], state["env_optimizer"])

    try:
        if not is_pbr:
            _run_stage1(state, views, cfg, opt, spatial_lr_scale, extent,
                        first_iter, callback, generator, timer,
                        collapse_min_points=(0 if args.no_collapse_guard
                                             else args.collapse_min_points))
        else:
            ups = tuple(int(v) for v in args.env_upsample_iters.split(",")
                        if v)
            _run_stage2(state, views, cfg, opt, spatial_lr_scale, first_iter,
                        callback, timer, env_upsample_iters=ups,
                        vis_refresh=args.vis_refresh_interval,
                        sample_num=pipe.sample_num)
    except ModelCollapseError as e:
        _quarantine_checkpoints(model_cfg.model_path, best["iter"])
        print(f"MODEL COLLAPSE: {e}\nCheckpoints newer than the best "
              f"(iter {best['iter']}, test PSNR {best['psnr']:.2f}) "
              "were quarantined as collapsed_chkpnt*.npz; resume from "
              "best_chkpnt.npz or an earlier numbered checkpoint.")
        raise SystemExit(3)
    finally:
        logger.close()
    print(f"Training complete in {time.time() - t0:.0f}s; "
          f"{state['model'].num_points} gaussians")

    if model_cfg.eval and scene.get_test_cameras():
        evaluate(scene, state["model"], state["env"], state["vis"],
                 model_cfg, device)


def _quarantine_checkpoints(model_path: str, best_iter: int) -> None:
    """Rename chkpnt<iter>.npz newer than best_iter to collapsed_* so a
    crash-resume (which globs chkpnt*.npz for the newest) can never land on
    post-collapse state."""
    for path in glob.glob(os.path.join(model_path, "*chkpnt*.npz")):
        name = os.path.basename(path)
        if name.startswith("collapsed_"):
            continue
        m = re.search(r"chkpnt(\d+)\.npz$", name)
        if m and int(m.group(1)) > best_iter:
            os.rename(path, os.path.join(os.path.dirname(path),
                                         "collapsed_" + name))
            print(f"[collapse] quarantined {name}")


def _run_stage1(state, views, cfg, opt, spatial_lr_scale, extent, first_iter,
                callback, generator, timer, collapse_min_points=32) -> None:
    """The JAX CLI's stage-1 loop (cli/train.py:504-632) from first_iter:
    cameras from a numpy permutation (seed 0), densify and opacity reset on
    its schedule, and the collapse guard after each densify."""
    model, optimizer = state["model"], state["optimizer"]
    rng = np.random.default_rng(0)
    stack: list[int] = []
    n_prev = peak_pts = model.num_points
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if not stack:
            stack = list(rng.permutation(len(views)))
        metrics = stage1.train_step(
            model, optimizer, views[stack.pop()], iteration, cfg=cfg, opt=opt,
            spatial_lr_scale=spatial_lr_scale, timer=timer)
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0):
                size_thresh = (20.0 if iteration > opt.opacity_reset_interval
                               else float("inf"))
                gn_thresh = (opt.densify_grad_normal_threshold
                             if iteration > opt.normal_densify_from_iter
                             else 99999.0)
                dstats = stage1.densify_step(model, optimizer, generator,
                                             gn_thresh, size_thresh, extent,
                                             opt=opt)
                metrics["densify"] = dstats
                # A healthy run never bleeds points in steady state (after
                # the first opacity reset).
                n_after = dstats.n_active
                peak_pts = max(peak_pts, n_after)
                if collapse_min_points:
                    steady = iteration > opt.opacity_reset_interval
                    if (n_after < collapse_min_points
                            or (steady and n_after < 0.45 * n_prev)
                            or (steady and n_after < 0.3 * peak_pts)):
                        raise ModelCollapseError(
                            f"active points {n_prev} -> {n_after} at "
                            f"iteration {iteration} (peak {peak_pts}, "
                            f"floor {collapse_min_points})")
                n_prev = n_after
            if iteration % opt.opacity_reset_interval == 0 or (
                    cfg.white_background
                    and iteration == opt.densify_from_iter):
                stage1.reset_opacity_step(model, optimizer)
        callback(iteration, metrics)


def upsample_env(env: lights.DirectLightMap,
                 env_optimizer: torch.optim.Optimizer) -> lights.DirectLightMap:
    """The env map at twice the resolution (direct_light_map.py:85-101), its
    Adam moments bilinearly upsampled alike and its step count kept; the new
    parameter takes the old one's place in `env_optimizer`."""
    new = lights.upsample(env)
    state = env_optimizer.state.pop(env.env, {})
    for k in ("exp_avg", "exp_avg_sq"):
        if k in state:
            state[k] = lights.bilinear_resize_2x(state[k]).contiguous()
    env_optimizer.param_groups[0]["params"][0] = new.env
    if state:
        env_optimizer.state[new.env] = state
    return new


def _run_stage2(state, views, cfg, opt, spatial_lr_scale, first_iter,
                callback, timer, env_upsample_iters=(), vis_refresh=0,
                sample_num=64) -> None:
    """The JAX CLI's stage-2 loop (cli/train.py:650-718): no densify, the
    visibility re-traced every `vis_refresh` steps (from the second step on,
    at the steps after a multiple of it) and the env map upsampled at the
    steps of `env_upsample_iters`."""
    model, optimizer = state["model"], state["optimizer"]
    rng = np.random.default_rng(0)
    stack: list[int] = []
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if (vis_refresh and iteration > first_iter + 1
                and (iteration - 1) % vis_refresh == 0):
            old = float(state["vis"].visibility.mean())
            state["vis"] = update_visibility(model, sample_num)
            print(f"[ITER {iteration}] re-traced visibility ({sample_num} "
                  f"samples): mean_vis {old:.4f} -> "
                  f"{float(state['vis'].visibility.mean()):.4f}", flush=True)
        if iteration in env_upsample_iters:
            state["env"] = upsample_env(state["env"], state["env_optimizer"])
            print(f"[ITER {iteration}] env map upsampled to "
                  f"{state['env'].env.shape[0]}x{state['env'].env.shape[1]}")
        if not stack:
            stack = list(rng.permutation(len(views)))
        metrics = stage2.train_step(
            model, optimizer, state["env"], state["env_optimizer"],
            state["vis"], views[stack.pop()], iteration, cfg=cfg, opt=opt,
            spatial_lr_scale=spatial_lr_scale, timer=timer)
        callback(iteration, metrics)


@torch.no_grad()
def evaluate(scene, model, env, vis, model_cfg, device) -> None:
    """Final test metrics and per-image dumps (reference eval_render,
    train.py:319-380): the SH render's PSNR, SSIM and (with weights) LPIPS
    over every test camera, and the PBR render's and its BRDF maps when
    stage 2 ran."""
    test_cams = scene.get_test_cameras()
    is_pbr = env is not None and vis is not None
    cfg = raster_config(test_cams, model_cfg.white_background)
    bg = background(cfg, device)
    out_dir = os.path.join(model_cfg.model_path, "eval", "test")
    os.makedirs(out_dir, exist_ok=True)

    def to_hwc(x):
        return np.clip(x.detach().cpu().numpy().transpose(1, 2, 0), 0, 1)

    use_lpips = lpips.available()
    m = {"psnr": [], "ssim": [], "lpips": [], "psnr_pbr": [], "ssim_pbr": [],
         "lpips_pbr": []}
    for i, cam in enumerate(test_cams):
        view = cam.view_inputs(device)
        res = render(view, model, cfg, bg)
        img = res["render"]
        m["psnr"].append(float(psnr_fn(img[None], view.image[None]).mean()))
        m["ssim"].append(float(losses.ssim(img, view.image)))
        if use_lpips:
            m["lpips"].append(float(lpips.lpips(img, view.image)))
        save_image_u8(os.path.join(out_dir, f"{i:03d}_render.png"),
                      to_hwc(img))
        save_image_u8(os.path.join(out_dir, f"{i:03d}_gt.png"),
                      to_hwc(view.image))
        save_image_u8(os.path.join(out_dir, f"{i:03d}_normal.png"),
                      to_hwc(res["normal"] * 0.5 + 0.5))
        save_image_u8(os.path.join(out_dir, f"{i:03d}_depth.png"),
                      visualize_depth(res["depth"][0].cpu().numpy())
                      .transpose(1, 2, 0))
        if is_pbr:
            pres = render_neilf(view, model, cfg, bg, env, vis,
                                is_training=False)
            pbr = pres["pbr"]
            m["psnr_pbr"].append(
                float(psnr_fn(pbr[None], view.image[None]).mean()))
            m["ssim_pbr"].append(float(losses.ssim(pbr, view.image)))
            if use_lpips:
                m["lpips_pbr"].append(float(lpips.lpips(pbr, view.image)))
            for key in ("pbr", "base_color", "roughness", "lights",
                        "visibility"):
                if key in pres:
                    im = to_hwc(pres[key])
                    if im.shape[-1] == 1:
                        im = np.repeat(im, 3, axis=-1)
                    save_image_u8(
                        os.path.join(out_dir, f"{i:03d}_{key}.png"), im)

    lp = lpips.metric_name()
    lines = [f"psnr: {np.mean(m['psnr'])}", f"ssim: {np.mean(m['ssim'])}"]
    if m["lpips"]:
        lines.append(f"{lp}: {np.mean(m['lpips'])}")
    if m["psnr_pbr"]:
        lines += [f"psnr_pbr: {np.mean(m['psnr_pbr'])}",
                  f"ssim_pbr: {np.mean(m['ssim_pbr'])}"]
        if m["lpips_pbr"]:
            lines.append(f"{lp}_pbr: {np.mean(m['lpips_pbr'])}")
    print("[EVAL] " + "  ".join(lines) + f"  ({len(test_cams)} views)")
    with open(os.path.join(model_cfg.model_path, "metric_test.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")


def build_train_parser():
    parser = build_parser("relightable3dgaussian_tpu_torch trainer")
    parser.add_argument("-t", "--type", choices=["render", "neilf"],
                        default="render")
    parser.add_argument("-c", "--checkpoint", default=None)
    add_tpu_flags(parser)
    parser.add_argument("--capacity", type=int, default=0, help=NO_EFFECT)
    parser.add_argument("--max_capacity", type=int, default=0,
                        help="refused when > 0: the port has no capacity")
    parser.add_argument("--max_init_points", type=int, default=0)
    parser.add_argument("--buffer_multiple", type=int, default=0,
                        help=NO_EFFECT)
    parser.add_argument("--chunk", type=int, default=0, help=NO_EFFECT)
    parser.add_argument("--max_chunks_per_tile", type=int, default=0,
                        help=NO_EFFECT)
    parser.add_argument("--max_tiles_per_gaussian", type=int, default=0,
                        help=NO_EFFECT)
    parser.add_argument("--save_interval", type=int, default=5000)
    parser.add_argument("--checkpoint_interval", type=int, default=5000)
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--test_interval", type=int, default=2500)
    parser.add_argument("--report_max_views", type=int, default=0,
                        help="cap periodic test-PSNR views (0 = all)")
    parser.add_argument("--vis_refresh_interval", type=int, default=0,
                        help="stage-2: re-trace the visibility cache every "
                             "N iterations (reference train.py:110-112, "
                             "left commented there for cost; 0 = never)")
    parser.add_argument("--env_upsample_iters", default="",
                        help="comma-separated stage-2 iterations at which "
                             "to 2x-upsample the learnable env map "
                             "(progressive refinement, "
                             "direct_light_map.py:85-101)")
    parser.add_argument("--gui", action="store_true",
                        help=f"refused ({MULTI_GPU_QUEUE})")
    parser.add_argument("--collapse_min_points", type=int, default=32,
                        help="abort (exit 3) when active gaussians fall "
                             "below this floor, drop >55%% in one densify "
                             "cycle, or fall below 30%% of their peak "
                             "(post-first-opacity-reset); post-best "
                             "checkpoints are quarantined")
    parser.add_argument("--no_collapse_guard", action="store_true",
                        help="disable the densification collapse guard")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv=None, device: torch.device | str = "cuda") -> None:
    """Parse `argv` (sys.argv when None) and train on `device`."""
    args = build_train_parser().parse_args(argv)
    np.random.seed(args.seed)
    training(args, torch.device(device))


if __name__ == "__main__":
    main()
