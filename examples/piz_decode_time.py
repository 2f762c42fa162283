"""Decode time of the port's numpy PIZ decoder on a 512x1024 RGB HALF env
map, on the CPU: python examples/piz_decode_time.py [--height 512]

The map (a smooth sky with a sun and 1% noise, 16 PIZ chunks of 32 lines)
is written by the test-side PIZ encoder of tests/test_torch_piz.py, then
read by scene/exr.py::read_exr_rgb three times; prints the median seconds
of a read and of piz_decode alone over the chunks."""
import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
from test_torch_piz import write_exr_piz  # noqa: E402

from relightable3dgaussian_tpu_torch.scene import exr  # noqa: E402


def sky(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:h, 0:w] + 0.5
    theta, phi = np.pi * v / h, 2 * np.pi * u / w
    d = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                  np.sin(theta) * np.sin(phi)], -1)
    sun = np.exp(200 * (d @ np.array([0.48, 0.6, 0.64]) - 1))
    img = (np.array([0.3, 0.45, 0.8]) * (1.2 - d[..., 1:2])
           + sun[..., None] * np.array([20.0, 19.0, 17.0]))
    return (img * (1 + 0.01 * rng.normal(size=img.shape))).astype(np.float16)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=512)
    args = ap.parse_args()
    img = sky(args.height, 2 * args.height)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "sky.exr")
        t0 = time.perf_counter()
        write_exr_piz(path, img)
        write_s = time.perf_counter() - t0
        reads = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = exr.read_exr_rgb(path)
            reads.append(time.perf_counter() - t0)
        assert (got == img.astype(np.float32)).all()
        size = Path(path).stat().st_size
    print(f"map {img.shape[0]}x{img.shape[1]} RGB HALF, PIZ file {size} bytes "
          f"(raw {img.nbytes}), encode {write_s:.2f} s; read_exr_rgb "
          f"median {statistics.median(reads):.3f} s of {reads}")


if __name__ == "__main__":
    main()
