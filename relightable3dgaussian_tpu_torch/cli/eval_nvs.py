"""Novel-view-synthesis evaluation CLI, on the card.

Port of relightable3dgaussian_tpu/cli/eval_nvs.py (the reference's
eval_nvs.py): load a trained model (an npz checkpoint, or the newest
point_cloud/iteration_N PLY), render the train and test splits, save the
images and write PSNR, SSIM and, where LPIPS has weights (losses/lpips.py),
LPIPS to metric_{split}.txt. With `-t neilf` the visibility is traced anew
(kernel K3) and the env light is read from env_light_<checkpoint name>.
With --n_devices N the visibility trace and the eval shading are split over
N ranks, one process a card (cli.run_ranks), and rank 0 writes.

Usage:
  python -m relightable3dgaussian_tpu_torch.cli.eval_nvs -s <data> \
      -m <model_dir> [-c <ckpt>] [-t render|neilf]
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import losses
from ..losses import lpips
from ..models import gaussians as G
from ..models.lights import DirectLightMap
from ..models.render import render
from ..models.render_neilf import render_neilf, update_visibility
from ..parallel.data_parallel import broadcast_
from ..scene import Scene, ply_io, search_max_iteration
from ..scene.image_io import save_image_u8
from ..train import checkpoint as ckpt
from ..train.config import ModelConfig, OptimizationConfig, PipelineConfig
from ..utils.image import psnr as psnr_fn, visualize_depth
from . import run_ranks, sharded_shading_from_args, sharded_trace_from_args
from .arguments import add_tpu_flags, build_parser, extract, get_combined_args
from .train import background, raster_config, require_device


def load_model(args, model_cfg: ModelConfig, is_pbr: bool,
               device) -> tuple[G.GaussianModel, int]:
    """The model of `args.checkpoint`, or of the newest exported PLY, with
    zero PBR fields where stage 2 needs them and the file has none."""
    if args.checkpoint:
        it, model = ckpt.load_checkpoint(args.checkpoint, device=device)
    else:
        ply_dir = os.path.join(model_cfg.model_path, "point_cloud")
        it = search_max_iteration(ply_dir)
        if it is None:
            raise FileNotFoundError(
                f"no checkpoint given and no PLY under {ply_dir}")
        model = G.GaussianModel.from_numpy(ply_io.load_gaussian_ply(
            os.path.join(ply_dir, f"iteration_{it}", "point_cloud.ply")),
            device=device)
    if is_pbr:
        G.add_pbr_params(model)
    return model, it


@torch.no_grad()
def render_set(out_dir: str, name: str, cams, render_one, device,
               write: bool = True) -> dict | None:
    """Render `cams`, save renders and ground truth (and the depth and
    normal maps where the render has them) under out_dir/name, and write
    out_dir/metric_<name>.txt; returns the metrics and "view_ms", the host
    milliseconds of each view's render and metrics (which wait for the
    device). Without `write` (a rank past rank 0) it only renders."""
    if not write:
        for cam in cams:
            render_one(cam.view_inputs(device))
        return None
    os.makedirs(os.path.join(out_dir, name, "renders"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, name, "gt"), exist_ok=True)
    psnrs, ssims, lpipss, view_ms = [], [], [], []
    use_lpips = lpips.available()

    def hwc(x):
        return np.moveaxis(x.detach().cpu().numpy(), 0, -1)

    for i, cam in enumerate(cams):
        view = cam.view_inputs(device)
        t0 = time.perf_counter()
        res, gt = render_one(view), view.image
        img = res["pbr"] if "pbr" in res else res["render"]
        psnrs.append(float(psnr_fn(img[None], gt[None]).mean()))
        ssims.append(float(losses.ssim(img, gt)))
        if use_lpips:
            lpipss.append(float(lpips.lpips(img, gt)))
        view_ms.append((time.perf_counter() - t0) * 1e3)
        save_image_u8(os.path.join(out_dir, name, "renders", f"{i:05d}.png"),
                      hwc(img))
        save_image_u8(os.path.join(out_dir, name, "gt", f"{i:05d}.png"),
                      hwc(gt))
        if "depth" in res:
            save_image_u8(
                os.path.join(out_dir, name, "renders", f"{i:05d}_depth.png"),
                np.moveaxis(visualize_depth(res["depth"].cpu().numpy()), 0,
                            -1))
        if "normal" in res:
            save_image_u8(
                os.path.join(out_dir, name, "renders", f"{i:05d}_normal.png"),
                hwc(res["normal"] * 0.5 + 0.5))
    metrics = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    if lpipss:
        metrics[lpips.metric_name()] = float(np.mean(lpipss))
    with open(os.path.join(out_dir, f"metric_{name}.txt"), "w") as f:
        for k, v in metrics.items():
            f.write(f"{k}: {v}\n")
    print(f"[{name}] " + "  ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    return {**metrics, "view_ms": view_ms}


def build_eval_parser():
    parser = build_parser("NVS evaluation")
    parser.add_argument("-t", "--type", choices=["render", "neilf"],
                        default="render")
    parser.add_argument("-c", "--checkpoint", default=None)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    add_tpu_flags(parser)
    return parser


def main(argv=None, device: torch.device | str = "cuda") -> dict:
    """Evaluate on `device`, on `--n_devices` ranks; returns {split:
    render_set's result}."""
    device = torch.device(device)
    require_device(device)
    args = get_combined_args(build_eval_parser(), argv)
    return run_ranks(evaluation, args, device)


def evaluation(args, device, group=None) -> dict:
    """The evaluation on `device`; with `group`, as one of its ranks."""
    require_device(device)
    model_cfg = extract(ModelConfig, args)
    pipe = extract(PipelineConfig, args)
    is_pbr = args.type == "neilf"

    scene = Scene(model_cfg.source_path, "", images=model_cfg.images,
                  white_background=model_cfg.white_background,
                  eval_split=True, resolution=model_cfg.resolution,
                  shuffle=False, debug=pipe.debug)
    model, it = load_model(args, model_cfg, is_pbr, device)
    print(f"Evaluating model at iteration {it} ({model.num_points} gaussians)")

    env = vis = sharded_shading = None
    if is_pbr:
        vis = update_visibility(model, pipe.sample_num,
                                sharded_trace=sharded_trace_from_args(
                                    args, group))
        sharded_shading = sharded_shading_from_args(args, group)
        env_path = (ckpt.env_checkpoint_path(args.checkpoint)
                    if args.checkpoint else None)
        if env_path and not env_path.endswith(".npz"):
            env_path += ".npz"
        if env_path and os.path.exists(env_path):
            _, env, _ = ckpt.load_env_checkpoint(
                env_path, OptimizationConfig(), device=device)
            print(f"Loaded env light from {env_path}")
        else:
            env = DirectLightMap(model_cfg.env_resolution, device=device)
        broadcast_([env.env.data], group)     # one unseeded map for all ranks

    results = {}
    for name, cams, skip in (("train", scene.get_train_cameras(),
                              args.skip_train),
                             ("test", scene.get_test_cameras(),
                              args.skip_test)):
        if skip or not cams:
            continue
        cfg = raster_config(cams, model_cfg.white_background)
        bg = background(cfg, device)
        if is_pbr:
            def render_one(view):
                return render_neilf(view, model, cfg, bg, env, vis,
                                    is_training=False,
                                    sharded_shading=sharded_shading)
        else:
            def render_one(view):
                return render(view, model, cfg, bg)
        results[name] = render_set(model_cfg.model_path, name, cams,
                                   render_one, device,
                                   write=group is None or group.rank == 0)
    return results


if __name__ == "__main__":
    main()
