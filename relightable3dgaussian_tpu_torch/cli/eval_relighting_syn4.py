"""Synthetic4Relight relighting benchmark CLI, on the card.

Port of relightable3dgaussian_tpu/cli/eval_relighting_syn4.py (the
reference's eval_relighting_syn4.py): traces the trained model's visibility
once (kernel K3), renders the test poses under the envmap6 and envmap12 HDR
environments (kernel K1 at the eval width), and compares the relit PBR
render with the ground truth (PSNR, SSIM, LPIPS), the base colour, under the
per-scene albedo scale, with the ground-truth albedo, and the roughness by
MSE, each over the object's mask. Writes test_rli/<task>/metric.txt with the
reference's seven field names; the log names the LPIPS backbone
(`lpips(random-vgg)` under LPIPS_WEIGHTS=random).

Usage:
  python -m relightable3dgaussian_tpu_torch.cli.eval_relighting_syn4 \
      -m <model_dir> -c <ckpt> -s <Synthetic4Relight/scene> \
      -e <dir holding env_map/> --sample_num 384
"""
from __future__ import annotations

import json
import os

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
from ..utils.graphics import focal2fov, fov2focal
from ..utils.image import psnr as psnr_fn
from .arguments import (add_tpu_flags, build_parser, extract,
                        get_combined_args, refuse_multi_gpu)
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


def build_eval_parser():
    parser = build_parser("Synthetic4Relight relighting evaluation")
    parser.add_argument("-c", "--checkpoint", default=None)
    parser.add_argument("-e", "--envmap_dir", default=".")
    parser.add_argument("-bg", "--background_color", type=float, default=1.0)
    add_tpu_flags(parser)
    return parser


def main(argv=None, device: torch.device | str = "cuda") -> dict:
    """Evaluate on `device`; returns {task: metrics} for each task whose
    map exists."""
    device = torch.device(device)
    require_device(device)
    args = get_combined_args(build_eval_parser(), argv)
    refuse_multi_gpu(args, "evaluation")
    model_cfg = extract(ModelConfig, args)
    pipe = extract(PipelineConfig, args)

    model, it = load_model(args, model_cfg, True, device)
    print(f"Loaded model at iteration {it}")
    print(f"Tracing visibility ({pipe.sample_num} samples)...")
    vis = update_visibility(model, pipe.sample_num)
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
    bg = torch.full((3,), bg_val, device=device)
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
            with torch.no_grad():
                res = render_neilf(view, model, cfg, bg, env, vis,
                                   is_training=False, base_color_scale=scale)

            pbr = res["pbr"] * mask + (1 - mask) * bg_val
            pbr_env = res["pbr"] * mask + (1 - mask) * res["env_only"]
            base = res["base_color"] * mask + (1 - mask) * bg_val
            rough = res["roughness"] * mask + (1 - mask) * bg_val
            gt_img = gt * mask + bg_val * (1 - mask)
            albedo = t(load_img_rgb(os.path.join(
                model_cfg.source_path, "test", f"{stem}_albedo.png")))
            gt_albedo = (albedo[..., :3].permute(2, 0, 1) * mask
                         + bg_val * (1 - mask))
            rough_gt = t(load_img_rgb(os.path.join(
                model_cfg.source_path, "test", f"{stem}_rough.png")))
            gt_rough = (rough_gt[..., :3].permute(2, 0, 1) * mask
                        + bg_val * (1 - mask))

            acc["psnr_pbr"].append(float(psnr_fn(pbr[None],
                                                 gt_img[None]).mean()))
            acc["ssim_pbr"].append(float(losses.ssim(pbr, gt_img)))
            acc["psnr_albedo"].append(float(psnr_fn(base[None],
                                                    gt_albedo[None]).mean()))
            acc["ssim_albedo"].append(float(losses.ssim(base, gt_albedo)))
            acc["mse_roughness"].append(float(
                ((rough.expand(3, -1, -1) - gt_rough) ** 2).mean()))
            if use_lpips:
                acc["lpips_pbr"].append(float(lpips.lpips(pbr, gt_img)))
                acc["lpips_albedo"].append(float(lpips.lpips(base,
                                                             gt_albedo)))

            for name, img in [("pbr", pbr), ("pbr_env", pbr_env),
                              ("base_color", base), ("roughness", rough)]:
                x = hwc(img)
                if x.shape[-1] == 1:
                    x = np.repeat(x, 3, -1)
                save_image_u8(os.path.join(task_dir, name, f"{idx}.png"), x)
            for name, img in [("gt", gt_img), ("gt_albedo", gt_albedo),
                              ("gt_roughness", gt_rough)]:
                save_image_u8(os.path.join(task_dir, name, f"{idx}.png"),
                              hwc(img))

            if idx == 0:
                ratio = gt_albedo / torch.clamp(base, 1e-6, 1)
                m = mask[0] > 0
                print("Albedo scale:",
                      np.median(ratio[:, m].cpu().numpy(), axis=1))

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
