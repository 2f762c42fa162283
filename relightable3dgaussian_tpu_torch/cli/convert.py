"""COLMAP preprocessing wrapper (the reference's convert.py).

Port of relightable3dgaussian_tpu/cli/convert.py: feature extraction,
matching, mapping and undistortion through the colmap binary on PATH, which
leave the sparse/0 layout the COLMAP reader expects. Without the binary it
stops with the JAX CLI's message; datasets prepared elsewhere load
unchanged. The command lines are the JAX CLI's.

Usage:
  python -m relightable3dgaussian_tpu_torch.cli.convert -s <data> \
      [--camera OPENCV] [--no_gpu] [--skip_matching]
"""
from __future__ import annotations

import os
import shutil
import subprocess
from argparse import ArgumentParser


def run(cmd: list[str]) -> None:
    print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd)
    if res.returncode != 0:
        raise SystemExit(f"command failed ({res.returncode}): {cmd[0]}")


def main(argv=None) -> None:
    parser = ArgumentParser("COLMAP conversion")
    parser.add_argument("-s", "--source_path", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--colmap_executable", default="colmap")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable
    if shutil.which(colmap) is None:
        raise SystemExit(
            "colmap binary not found on PATH. Install COLMAP or run the "
            "conversion on a machine that has it; the resulting sparse/ "
            "directory is consumed unchanged by this framework.")

    src = args.source_path
    use_gpu = "0" if args.no_gpu else "1"
    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance", "0.000001"])
    run([colmap, "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src,
         "--output_type", "COLMAP"])
    # the sparse files move into sparse/0 (the reference's layout)
    sparse0 = os.path.join(src, "sparse", "0")
    os.makedirs(sparse0, exist_ok=True)
    for fn in os.listdir(os.path.join(src, "sparse")):
        full = os.path.join(src, "sparse", fn)
        if os.path.isfile(full):
            shutil.move(full, os.path.join(sparse0, fn))
    print("Done.")


if __name__ == "__main__":
    main()
