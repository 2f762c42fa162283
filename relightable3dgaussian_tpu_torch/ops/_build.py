"""Build and load the port's CUDA kernels.

Each kernel source under `relightable3dgaussian_tpu_torch/csrc/` has a plain C
interface. At first use it is compiled by `nvcc` for `sm_90a` into a shared
library under `build/torch_kernels/` next to the package directory, and
loaded with ctypes. The port is meant to run from a checkout (or an editable
install), where that is the checkout's git-ignored `build/`. The library name
carries a hash of the source, so an edited source is rebuilt and a stale
library is never loaded. A failed build raises; nothing here falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOADED: dict[str, ctypes.CDLL] = {}     # name -> library, filled at first load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if needed and return the loaded library."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"lib{name}_{digest}.{os.getpid()}.tmp.so"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    _LOADED[name] = ctypes.CDLL(str(lib_path))
    return _LOADED[name]
