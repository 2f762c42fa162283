"""Synthetic4Relight relighting benchmark CLI, on the card.

Port of relightable3dgaussian_tpu/cli/eval_relighting_syn4.py (the
reference's eval_relighting_syn4.py): traces the trained model's visibility
once (kernel K3), renders the test poses under the envmap6 and envmap12 HDR
environments (kernel K1 at the eval width), and compares the relit PBR
render with the ground truth (PSNR, SSIM, LPIPS), the base colour, under the
per-scene albedo scale, with the ground-truth albedo, and the roughness by
MSE, each over the object's mask. A view's render and scores are
`relight_view` (the benchmark's cell s2-eval.syn4 calls it too); the CLI
writes its images as PNGs and test_rli/<task>/metric.txt with the
reference's seven field names; the log names the LPIPS backbone
(`lpips(random-vgg)` under LPIPS_WEIGHTS=random). With --n_devices N the
trace and the shading are split over N ranks, one process a card
(cli.run_ranks), and rank 0 scores and writes.

Usage:
  python -m relightable3dgaussian_tpu_torch.cli.eval_relighting_syn4 \
      -m <model_dir> -c <ckpt> -s <Synthetic4Relight/scene> \
      -e <dir holding env_map/> --sample_num 384
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import losses
from ..losses import lpips
from ..models.lights import load_env_light
from ..models.render_neilf import render_neilf, update_visibility
from ..ops.config import RasterConfig
from ..scene.cameras import Camera
from ..scene.dataset_readers import _blender_pose
from ..scene.image_io import load_img_rgb, save_image_u8
from ..train.config import ModelConfig, PipelineConfig
from ..utils import trace
from ..utils.graphics import focal2fov, fov2focal
from ..utils.image import psnr as psnr_fn
from . import run_ranks, sharded_shading_from_args, sharded_trace_from_args
from .arguments import add_tpu_flags, build_parser, extract, get_combined_args
from .eval_nvs import load_model
from .train import require_device

# Hand-tuned per-scene albedo scales (eval_relighting_syn4.py:95-105),
# chosen by /<scene>/ in the model path.
BASE_COLOR_SCALE = {
    "air_baloons": [1.3746, 0.6428, 0.7279],
    "chair": [1.8865, 1.9675, 1.7410],
    "hotdog": [2.6734, 2.0917, 1.2587],
    "jugs": [1.0044, 0.9253, 0.7648],
}

TASKS = {
    "env6": "env_map/envmap6.exr",
    "env12": "env_map/envmap12.exr",
}

METRICS = ("psnr_pbr", "ssim_pbr", "lpips_pbr", "psnr_albedo", "ssim_albedo",
           "lpips_albedo", "mse_roughness")


class GroundTruth(NamedTuple):
    """A test view's ground truth on the card: the relit image [3, H, W],
    the object's mask [1, H, W], the albedo [3, H, W] and the roughness
    [3, H, W] (the maps' own values, before the mask)."""
    image: torch.Tensor
    mask: torch.Tensor
    albedo: torch.Tensor
    roughness: torch.Tensor


class RelitView(NamedTuple):
    """What `relight_view` gives of one test view: the images the CLI
    writes ([C, H, W] on the card: pbr, pbr_env, base_color, roughness
    and the three ground truths, each over the mask), the seven METRICS on
    the host, and render_neilf's own results."""
    images: dict
    scores: dict
    results: dict


@torch.no_grad()
def score_view(images: dict) -> torch.Tensor:
    """The seven METRICS of a view's masked images, on the card, in
    METRICS' order: PSNR, SSIM and LPIPS of the PBR render and of the
    albedo against their ground truths, and the roughness MSE (LPIPS NaN
    without weights). Both SSIMs are one 6-channel pass and both LPIPS one
    batch of four images: channels and images are independent."""
    pbr, gt = images["pbr"], images["gt"]
    base, gt_albedo = images["base_color"], images["gt_albedo"]
    smap = losses.ssim_map(torch.cat([pbr, base]), torch.cat([gt, gt_albedo]))
    lp = lpips.lpips_each(torch.stack([pbr, base]),
                          torch.stack([gt, gt_albedo]))
    rough = images["roughness"].expand(3, -1, -1)
    return torch.stack([
        psnr_fn(pbr[None], gt[None]).mean(), smap[:3].mean(), lp[0],
        psnr_fn(base[None], gt_albedo[None]).mean(), smap[3:].mean(), lp[1],
        ((rough - images["gt_roughness"]) ** 2).mean()])


@torch.no_grad()
def relight_view(view, model, cfg: RasterConfig, env, vis,
                 gt: GroundTruth | None, *, base_color_scale: torch.Tensor,
                 background: float = 1.0,
                 sharded_shading=None) -> RelitView | None:
    """One test view of the benchmark: the relit render under `env`
    (render_neilf, eval), its images over the ground truth's mask (the
    background `background` outside, and for pbr_env the map itself), and
    their seven scores, brought to the host in one copy. Without `gt` (a
    rank past rank 0 of a sharded run) only the render runs and None is
    returned. Spans: `eval.view` (a unit) around it all, `eval.score`
    (with device events) around the scores."""
    with trace.span("eval.view", unit=True):
        bg = torch.full((3,), background, device=view.cam.campos.device)
        res = render_neilf(view, model, cfg, bg, env, vis, is_training=False,
                           base_color_scale=base_color_scale,
                           sharded_shading=sharded_shading)
        if gt is None:
            return None
        m = gt.mask
        over = lambda x: x * m + (1 - m) * background  # noqa: E731
        images = {"pbr": over(res["pbr"]),
                  "pbr_env": res["pbr"] * m + (1 - m) * res["env_only"],
                  "base_color": over(res["base_color"]),
                  "roughness": over(res["roughness"]),
                  "gt": over(gt.image), "gt_albedo": over(gt.albedo),
                  "gt_roughness": over(gt.roughness)}
        with trace.span("eval.score", device=bg.device):
            scores = score_view(images)
        trace.count("host.syncs")
        scores = dict(zip(METRICS, scores.tolist()))
        return RelitView(images, scores, res)


def build_eval_parser():
    parser = build_parser("Synthetic4Relight relighting evaluation")
    parser.add_argument("-c", "--checkpoint", default=None)
    parser.add_argument("-e", "--envmap_dir", default=".")
    parser.add_argument("-bg", "--background_color", type=float, default=1.0)
    add_tpu_flags(parser)
    return parser


def main(argv=None, device: torch.device | str = "cuda") -> dict:
    """Evaluate on `device`, on `--n_devices` ranks; returns {task:
    metrics} for each task whose map exists."""
    device = torch.device(device)
    require_device(device)
    args = get_combined_args(build_eval_parser(), argv)
    return run_ranks(evaluation, args, device)


def evaluation(args, device, group=None) -> dict:
    """The evaluation on `device`; with `group`, as one of its ranks, the
    trace and the shading split over them, rank 0 scoring and writing."""
    require_device(device)
    writer = group is None or group.rank == 0
    model_cfg = extract(ModelConfig, args)
    pipe = extract(PipelineConfig, args)

    model, it = load_model(args, model_cfg, True, device)
    print(f"Loaded model at iteration {it}")
    print(f"Tracing visibility ({pipe.sample_num} samples)...")
    vis = update_visibility(model, pipe.sample_num,
                            sharded_trace=sharded_trace_from_args(args, group))
    sharded_shading = sharded_shading_from_args(args, group)
    out = {}

    scale = [1.0, 1.0, 1.0]
    for key, val in BASE_COLOR_SCALE.items():
        if f"/{key}/" in model_cfg.model_path + "/":
            scale = val
            print(f"base_color_scale[{key}] = {val}")
    scale = torch.tensor(scale, dtype=torch.float32, device=device)

    with open(os.path.join(model_cfg.source_path,
                           "transforms_test.json")) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    frames = contents["frames"]
    bg_val = args.background_color
    use_lpips = lpips.available()
    print(f"LPIPS: {lpips.metric_name() if use_lpips else 'no weights (NaN)'}")

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    def hwc(x):
        return np.moveaxis(x.cpu().numpy(), 0, -1)

    results_dir = os.path.join(model_cfg.model_path, "test_rli")
    capture_list = ["pbr", "pbr_env", "base_color", "roughness"]
    for task, env_rel in TASKS.items():
        env_path = os.path.join(args.envmap_dir, env_rel)
        if not os.path.exists(env_path):
            print(f"[WARN] {env_path} missing; skipping task {task}")
            continue
        env = load_env_light(env_path, scale=1.0, device=device)
        envname = os.path.splitext(os.path.basename(env_path))[0]
        task_dir = os.path.join(results_dir, task)
        for sub in capture_list + ["gt", "gt_albedo", "gt_roughness"]:
            if writer:
                os.makedirs(os.path.join(task_dir, sub), exist_ok=True)

        acc = {k: [] for k in METRICS}
        cfg = None
        for idx, frame in enumerate(frames):
            stem = frame["file_path"].split("/")[-1]
            rgba = t(load_img_rgb(os.path.join(
                model_cfg.source_path, "test_rli", f"{envname}_{stem}.png")))
            gt, mask = rgba[..., :3].permute(2, 0, 1), rgba[..., 3:].permute(2, 0, 1)
            H, W = rgba.shape[:2]
            R, T = _blender_pose(frame)
            cam = Camera(uid=0, R=R, T=T, fovx=fovx,
                         fovy=focal2fov(fov2focal(fovx, W), H), width=W,
                         height=H)
            if cfg is None:
                cfg = RasterConfig(height=H, width=W, sh_degree=3)
            view = cam.view_inputs(device)
            truth = None
            if writer:
                albedo = t(load_img_rgb(os.path.join(
                    model_cfg.source_path, "test", f"{stem}_albedo.png")))
                rough_gt = t(load_img_rgb(os.path.join(
                    model_cfg.source_path, "test", f"{stem}_rough.png")))
                truth = GroundTruth(gt, mask, albedo[..., :3].permute(2, 0, 1),
                                    rough_gt[..., :3].permute(2, 0, 1))
            rv = relight_view(view, model, cfg, env, vis, truth,
                              base_color_scale=scale, background=bg_val,
                              sharded_shading=sharded_shading)
            if not writer:
                continue
            for k, v in rv.scores.items():
                if use_lpips or not k.startswith("lpips"):
                    acc[k].append(v)
            for name in ("pbr", "pbr_env", "base_color", "roughness"):
                x = hwc(rv.images[name])
                if x.shape[-1] == 1:
                    x = np.repeat(x, 3, -1)
                save_image_u8(os.path.join(task_dir, name, f"{idx}.png"), x)
            for name in ("gt", "gt_albedo", "gt_roughness"):
                save_image_u8(os.path.join(task_dir, name, f"{idx}.png"),
                              hwc(rv.images[name]))

            if idx == 0:
                ratio = rv.images["gt_albedo"] / torch.clamp(
                    rv.images["base_color"], 1e-6, 1)
                m = mask[0] > 0
                print("Albedo scale:",
                      np.median(ratio[:, m].cpu().numpy(), axis=1))

        if not writer:
            continue
        metrics = {k: float(np.mean(v)) if v else float("nan")
                   for k, v in acc.items()}
        with open(os.path.join(task_dir, "metric.txt"), "w") as f:
            for k, v in metrics.items():
                f.write(f"{k}: {v}\n")
        print(f"[{task}] " + "  ".join(
            f"{k} {v:.4f}" for k, v in metrics.items() if acc[k]))
        out[task] = metrics
    return out


if __name__ == "__main__":
    main()
