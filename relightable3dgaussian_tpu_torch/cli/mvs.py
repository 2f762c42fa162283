"""Offline MVS data preparation on the card (the reference's run_pre.sh).

Port of relightable3dgaussian_tpu/cli/mvs.py: the four stages of the
reference's vismvsnet/run_pre.sh:6-9, COLMAP→MVS conversion, cascade depth
inference, photometric and geometric filtering and packaging, with the
weight-free plane-sweep core (mvs/plane_sweep.py) in place of the
pretrained Vis-MVSNet; the same flags, defaults, files and layouts.

Usage:
  python -m relightable3dgaussian_tpu_torch.cli.mvs --dense_folder <dir> \
      [--num_src 5] [--max_d 256] [--vthresh 2] [--pthresh .6,.6,.6] \
      [--layout blender|neilf] [--stage_planes 48,32,16]

It runs on the card; `main(argv, device=...)` takes another device only
from a caller.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from ..mvs import (colmap_to_mvs, geometric_filter, infer_depth,
                   load_cam_txt, load_pair_txt, prob_filter)
from ..mvs.formats import save_pfm
from ..mvs.prepare import prepare_blender_extra, prepare_neilf_inputs
from ..scene.image_io import load_img_rgb
from .train import require_device


def _view_names(dense_folder: str, pair_path: str, max_d: int) -> list[str]:
    """The views in pair.txt's index order: converted from COLMAP when
    pair.txt is missing, else names.txt, else the cam files sorted."""
    names_path = os.path.join(dense_folder, "names.txt")
    if not os.path.exists(pair_path):
        return colmap_to_mvs(dense_folder, max_d=max_d)
    if os.path.exists(names_path):
        # pair.txt's indices follow COLMAP's image-id order, which
        # names.txt keeps (a sorted re-derivation could permute them)
        with open(names_path) as f:
            return [line.strip() for line in f if line.strip()]
    return sorted(os.path.splitext(f)[0][:-4]
                  for f in os.listdir(os.path.join(dense_folder, "cams"))
                  if f.endswith("_cam.txt"))


def run_pipeline(dense_folder: str, num_src: int = 5, max_d: int = 256,
                 vthresh: int = 2, pthresh=(0.6, 0.6, 0.6),
                 layout: str = "blender", image_dir: str | None = None,
                 stage_planes=(48, 32, 16),
                 device: torch.device | str = "cuda") -> dict:
    """The four stages on `dense_folder`, on `device` → {"names", "depths",
    "masks", "cams"} (numpy)."""
    device = torch.device(device)
    require_device(device)
    image_dir = image_dir or os.path.join(dense_folder, "images")

    # 1. conversion (skipped where cams/ and pair.txt exist)
    pair_path = os.path.join(dense_folder, "pair.txt")
    names = _view_names(dense_folder, pair_path, max_d)
    pairs = load_pair_txt(pair_path)
    cams = {n: load_cam_txt(os.path.join(dense_folder, "cams",
                                         f"{n}_cam.txt")) for n in names}

    def load_image(name):
        for ext in (".png", ".jpg", ".jpeg", ".exr"):
            p = os.path.join(image_dir, name + ext)
            if os.path.exists(p):
                img = load_img_rgb(p)[..., :3]
                return np.ascontiguousarray(img.transpose(2, 0, 1))
        raise FileNotFoundError(f"no image for view {name} in {image_dir}")

    images = {n: load_image(n) for n in names}

    def sources(i):
        return [names[j] for j, _ in pairs[i][:num_src] if j < len(names)]

    # 2. cascade plane-sweep depth per view
    out_dir = os.path.join(dense_folder, "vis_mvsnet")
    os.makedirs(out_dir, exist_ok=True)
    depths, probs = {}, {}
    skipped = set()
    for i, name in enumerate(names):
        srcs = sources(i)
        if not srcs:
            # a view with no scored source (no shared sparse point) cannot
            # be matched: it gets an empty depth
            h, w = images[name].shape[1:]
            depths[name] = np.zeros((h, w), np.float32)
            probs[name] = [np.zeros((h, w), np.float32)]
            skipped.add(name)
            save_pfm(os.path.join(out_dir, f"{name}_flow3.pfm"),
                     depths[name])
            print(f"[mvs] {i + 1}/{len(names)} {name}: no source views — "
                  "skipped", flush=True)
            continue
        d, ps = infer_depth(images[name], [images[s] for s in srcs],
                            cams[name], [cams[s] for s in srcs],
                            stage_planes=stage_planes, device=device)
        depths[name] = d.cpu().numpy()
        probs[name] = [p.cpu().numpy() for p in ps]
        save_pfm(os.path.join(out_dir, f"{name}_flow3.pfm"), depths[name])
        for k, p in enumerate(probs[name]):
            save_pfm(os.path.join(out_dir, f"{name}_flow{k + 1}_prob.pfm"),
                     p)
        print(f"[mvs] {i + 1}/{len(names)} {name}: depth "
              f"[{depths[name].min():.3f}, {depths[name].max():.3f}]",
              flush=True)

    # 3. photometric and geometric filtering
    masks = {}
    pmasked = {n: depths[n] * prob_filter(
        [torch.from_numpy(p) for p in probs[n]], pthresh).numpy()
        for n in names}
    for i, name in enumerate(names):
        srcs = sources(i)
        if name in skipped or not srcs:
            masks[name] = np.zeros_like(depths[name], dtype=bool)
            print(f"[filter] {name}: skipped (no source views)", flush=True)
            continue
        gmask, _ = geometric_filter(
            pmasked[name], cams[name], np.stack([pmasked[s] for s in srcs]),
            [cams[s] for s in srcs], vthresh=vthresh, device=device)
        masks[name] = gmask.cpu().numpy() & (pmasked[name] > 1e-9)
        print(f"[filter] {name}: {float(masks[name].mean()) * 100:.1f}% "
              "pixels kept", flush=True)

    # 4. packaging
    if layout == "blender":
        prepare_blender_extra(dense_folder, names, depths, masks, cams)
    else:
        prepare_neilf_inputs(dense_folder, names, depths, masks, cams)
    return {"names": names, "depths": depths, "masks": masks, "cams": cams}


def build_parser() -> ArgumentParser:
    ap = ArgumentParser("mvs data preparation")
    ap.add_argument("--dense_folder", required=True)
    ap.add_argument("--num_src", type=int, default=5)
    ap.add_argument("--max_d", type=int, default=256)
    ap.add_argument("--vthresh", type=int, default=2)
    ap.add_argument("--pthresh", default=".6,.6,.6")
    ap.add_argument("--layout", choices=["blender", "neilf"],
                    default="blender")
    ap.add_argument("--image_dir", default=None)
    ap.add_argument("--stage_planes", default="48,32,16")
    return ap


def main(argv=None, device: torch.device | str = "cuda") -> dict:
    """Parse `argv` (sys.argv when None) and run the pipeline on
    `device`."""
    args = build_parser().parse_args(argv)
    return run_pipeline(
        args.dense_folder, args.num_src, args.max_d, args.vthresh,
        tuple(float(v) for v in args.pthresh.split(",")), args.layout,
        args.image_dir, tuple(int(v) for v in args.stage_planes.split(",")),
        device=device)


if __name__ == "__main__":
    main()
