"""Scene composition and relighting CLI, on the card.

Port of relightable3dgaussian_tpu/cli/relighting.py (the reference's
relighting.py): loads the trained PLYs that <config>/transform.json names,
each under its 4x4 transform, concatenates them, pads the visibility SH
from degree 3 to 4 and zeroes the local incident-light SH, re-traces the
visibility of the merged cloud (kernel K3, so each object shadows the
others), then renders the camera trajectory of <config>/trajectory.json
under an HDR environment map (kernel K1 at the eval width), rotating the
light each frame where <config>/light_transform.json says so, and writes
one PNG per capture type and frame. `--video` would join the frames into
mp4s; the port has no video encoder, so it says so and keeps the PNGs, as
the JAX CLI does without imageio. With --n_devices N the trace and the
shading are split over N ranks, one process a card (cli.run_ranks), and
rank 0 writes.

Usage:
  python -m relightable3dgaussian_tpu_torch.cli.relighting -co <config> \
      -e env_map/envmap12.exr --output capture --capture_list pbr_env
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

from ..models import gaussians as G
from ..models.lights import load_env_light
from ..models.render_neilf import render_neilf, update_visibility
from ..ops.camera import CameraParams
from ..ops.config import RasterConfig
from ..scene import ply_io
from ..scene.cameras import Camera
from ..scene.image_io import save_image_u8
from ..utils.graphics import focal2fov, fov2focal
from . import run_ranks, sharded_shading_from_args, sharded_trace_from_args
from .arguments import add_tpu_flags
from .train import require_device

# The Blender camera's horizontal field of view (relighting.py:155), the
# default where trajectory.json gives none.
CAMERA_ANGLE_X = 0.6911112070083618


def load_json_config(path: str):
    """The JSON object at `path`, or None where there is no file."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def scene_composition(scene_dict: dict,
                      device: torch.device | str = "cuda") -> G.GaussianModel:
    """The PLYs of `scene_dict` ({name: {"path", "transform" (16 floats)}}),
    each transformed, concatenated on `device` (relighting.py:28-52), with
    the visibility SH rest padded from 15 to 24 coefficients and zero
    incident-light SH. A PLY without PBR fields gets zero ones."""
    models = []
    for name, entry in scene_dict.items():
        d = ply_io.load_gaussian_ply(entry["path"])
        model = G.add_pbr_params(G.GaussianModel.from_numpy(d, device=device))
        transform = np.array(entry["transform"], np.float32).reshape(4, 4)
        models.append(G.set_transform(model, torch.from_numpy(transform)))
        print(f"loaded {name}: {model.num_points} points")
    composite = G.concatenate(models)
    n = composite.num_points
    print(f"Totally {n} points loaded.")
    with torch.no_grad():
        vis_rest = composite.visibility_rest
        pad = vis_rest.new_zeros((n, 5 ** 2 - 4 ** 2, 1))
        values = {k: getattr(composite, k).detach() for k in composite.fields}
        values.update(visibility_rest=torch.cat([vis_rest.detach(), pad], 1),
                      incidents_dc=torch.zeros_like(values["incidents_dc"]),
                      incidents_rest=torch.zeros_like(values["incidents_rest"]))
    return G.GaussianModel(**values)


def render_points(cam: CameraParams, model: G.GaussianModel, height: int,
                  width: int, bg: float) -> np.ndarray:
    """Z-buffered point splat of the base colours, [3, H, W] on the host
    (relighting.py:56-85)."""
    xyz = model.xyz.detach().cpu().numpy()
    color = model.get_base_color.detach().cpu().numpy()
    wv = cam.world_view.cpu().numpy()
    xyz1 = np.concatenate([xyz, np.ones_like(xyz[:, :1])], -1)
    cam_xyz = xyz1 @ wv
    z = cam_xyz[:, 2]
    fx, fy = cam.focal.cpu().numpy()
    cx, cy = cam.center.cpu().numpy()
    u = (cam_xyz[:, 0] / np.maximum(z, 1e-6) * fx + cx).astype(int)
    v = (cam_xyz[:, 1] / np.maximum(z, 1e-6) * fy + cy).astype(int)
    ok = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)
    order = np.argsort(-z)  # far to near; near overwrites
    u, v, c = u[order][ok[order]], v[order][ok[order]], color[order][ok[order]]
    img = np.full((height, width, 3), bg, np.float32)
    img[v, u] = c
    return np.moveaxis(img, -1, 0)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Composition and relighting")
    parser.add_argument("-co", "--config", required=True)
    parser.add_argument("-e", "--envmap_path", default=None)
    parser.add_argument("-bg", "--background_color", type=float, default=None)
    parser.add_argument("--sample_num", type=int, default=64)
    add_tpu_flags(parser)
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--output", default="./capture_trace")
    parser.add_argument("--capture_list", default="pbr_env")
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--base_color_scale", type=float, nargs=3,
                        default=None,
                        help="per-channel linear base-color scale applied "
                             "at render time")
    parser.add_argument("--vis_one", action="store_true",
                        help="ablation: force the traced visibility to 1")
    return parser


def main(argv=None, device: torch.device | str = "cuda") -> None:
    """Compose, trace and render on `device`, on `--n_devices` ranks."""
    device = torch.device(device)
    require_device(device)
    run_ranks(relight, build_parser().parse_args(argv), device)


def relight(args, device, group=None) -> None:
    """Compose, trace and render on `device`; with `group`, as one of its
    ranks, the trace and the shading split over them, rank 0 writing."""
    require_device(device)
    writer = group is None or group.rank == 0

    scene_dict = load_json_config(os.path.join(args.config, "transform.json"))
    traject = load_json_config(os.path.join(args.config, "trajectory.json"))
    light_dict = load_json_config(
        os.path.join(args.config, "light_transform.json"))

    env = load_env_light(args.envmap_path, device=device)
    model = scene_composition(scene_dict, device)

    print(f"Tracing visibility ({args.sample_num} samples)...")
    vis = update_visibility(model, args.sample_num,
                            sharded_trace=sharded_trace_from_args(args, group))
    sharded_shading = sharded_shading_from_args(args, group)
    if args.vis_one:
        print("ablation: visibility forced to 1")
        vis = vis._replace(visibility=torch.ones_like(vis.visibility))
    bc_scale = (torch.tensor(args.base_color_scale, dtype=torch.float32,
                             device=device)
                if args.base_color_scale is not None else None)

    capture_list = [s.strip() for s in args.capture_list.split(",")]
    for t in capture_list:
        if writer:
            os.makedirs(os.path.join(args.output, t), exist_ok=True)

    bg_val = (args.background_color if args.background_color is not None
              else (1.0 if args.white_background else 0.0))
    bg = torch.full((3,), bg_val, device=device)

    H = traject["camera"]["height"]
    W = traject["camera"]["width"]
    fovx = traject["camera"].get("camera_angle_x", CAMERA_ANGLE_X)
    fovy = focal2fov(fov2focal(fovx, W), H)
    cfg = RasterConfig(height=H, width=W, sh_degree=3)

    with torch.no_grad():
        for idx, w2c_flat in traject["trajectory"].items():
            w2c = np.array(w2c_flat, np.float32).reshape(4, 4)
            cam = Camera(uid=0, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx,
                         fovy=fovy, width=W, height=H)
            transform = None
            if light_dict is not None:
                transform = torch.tensor(
                    np.array(light_dict["transform"][idx],
                             np.float32).reshape(3, 3), device=device)
            env_i = env._replace(transform=transform)
            view = cam.view_inputs(device)
            res = render_neilf(view, model, cfg, bg, env_i, vis,
                               is_training=False, base_color_scale=bc_scale,
                               sharded_shading=sharded_shading)
            if not writer:
                continue
            opacity = res["opacity"]
            for t in capture_list:
                if t == "points":
                    img = render_points(view.cam, model, H, W, bg_val)
                else:
                    x = res[t]
                    if t == "normal":
                        x = x * 0.5 + 0.5 + (1 - opacity) * bg_val
                    elif t in ("base_color", "roughness", "visibility"):
                        x = x + (1 - opacity) * bg_val
                    img = x.cpu().numpy()
                if img.shape[0] in (1, 3):
                    img = np.moveaxis(img, 0, -1)
                if img.shape[-1] == 1:
                    img = np.repeat(img, 3, -1)
                save_image_u8(os.path.join(args.output, t,
                                           f"frame_{idx}.png"), img)
            print(f"frame {idx} done", flush=True)

    if args.video and writer:
        export_videos(args.output, capture_list, traject, W, H)


def export_videos(out_dir, capture_list, traject, w, h, fps: int = 60):
    """The port has no video encoder (the card's machine has no imageio):
    says so; the frames stay as PNGs under out_dir/<capture>/."""
    print(f"video export unavailable (no video encoder in the port); "
          f"{len(traject['trajectory'])} frames of {w}x{h} saved as PNG "
          f"under {out_dir}/{{{','.join(capture_list)}}}")


if __name__ == "__main__":
    main()
