"""Build, load, call and check the port's CUDA kernels.

Each kernel source under `relightable3dgaussian_tpu_torch/csrc/` has a plain C
interface. At first use it is compiled by `nvcc` for `sm_90a` into a shared
library under `build/torch_kernels/` next to the package directory, and
loaded with ctypes. The port is meant to run from a checkout (or an editable
install), where that is the checkout's git-ignored `build/`. The library name
carries a hash of the source and of the headers beside it (`csrc/*.cuh`), so
an edited source or header is rebuilt and a stale library is never loaded.
A failed build raises; nothing here falls back. `ptxas_report` compiles a
source once more with `-Xptxas -v` for its kernels' registers, spills and
shared memory.

This module is the port's one caller of foreign code. Each C entry point is
an `Entry`, declared once beside its wrapper: calling it passes tensors as
data pointers and None as NULL, launches on the device's current stream,
raises on a `cudaError_t` and counts the entry's tracer counters.
`check_tensors` is the check a wrapper makes of its inputs before a launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..utils import trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOADED: dict[str, ctypes.CDLL] = {}     # name -> library, filled at first load
# An entry's argument kinds, one letter each: a pointer, an int, an int64_t,
# a float.
_KINDS = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_int64,
          "f": ctypes.c_float}


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
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def prebuild() -> None:
    """Compile every kernel source that is not built yet, one nvcc each,
    all at once, without loading them (before processes that each load
    them start: they then find them built)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(library_path, names))


def library_path(name: str) -> Path:
    """The shared library of `csrc/<name>.cu`, compiled if needed."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
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
    return lib_path


def ptxas_report(src: str | Path) -> dict[str, str]:
    """{kernel: ptxas's registers, shared memory and spills} for the kernels
    of one source, compiled with the build's flags and `-Xptxas -v` into a
    throwaway object (the library is not touched)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        proc = subprocess.run([_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                               os.path.join(tmp, "k.o"), str(src)],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    report, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"(?:entry function|Function properties for) '?([^' ]+)",
                          line)
        if entry:
            name = _unqualified(entry.group(1))
        elif name and ("Used" in line or "spill" in line):
            fact = line.split(":", 1)[-1].strip()
            report[name] = f"{report[name]}; {fact}" if name in report else fact
    return report


def _unqualified(mangled: str) -> str:
    """The last name of a mangled nested name (_ZN <len><name>... E), e.g.
    shade_fwd_kernel for a kernel in an anonymous namespace; other names as
    they are."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, last = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        last, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    return last


class Entry:
    """The C entry point `symbol` of `csrc/<source>.cu`: `int symbol(<kinds>,
    void* stream)`, returning a `cudaError_t`. `kinds` spells the arguments
    before the stream in `_KINDS`' letters (spaces group them). `label`
    names it in errors; `counters` are the tracer's counters a launch adds
    one to (`utils/trace.py`)."""
    __slots__ = ("source", "symbol", "kinds", "label", "counters")

    def __init__(self, source: str, symbol: str, kinds: str, label: str,
                 counters: tuple[str, ...] = ()):
        self.source, self.symbol, self.label = source, symbol, label
        self.kinds = kinds.replace(" ", "")
        self.counters = counters

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream with `args`: Python ints and
        floats as they are, None as NULL, a tensor as its data pointer. The
        library is loaded (and built) at the first call."""
        if len(args) != len(self.kinds):
            raise TypeError(f"{self.label}: {len(args)} arguments, the entry "
                            f"takes {len(self.kinds)}")
        fn = getattr(load_library(self.source), self.symbol)
        if fn.argtypes is None:
            fn.argtypes = [_KINDS[k] for k in self.kinds] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        # one class test an argument: this is every launch's host path
        args = [a if a is None or a.__class__ in (int, float)
                else a.data_ptr() for a in args]
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.label} launch failed: cudaError_t {rc}")
        for name in self.counters:
            trace.count(name)


def check_tensors(label: str, device: torch.device, expect: dict) -> None:
    """Raises ValueError unless each `name: (tensor, shape[, dtype])` of
    `expect` is a contiguous tensor of that shape and dtype (float32 where
    none is given) on `device`."""
    for name, spec in expect.items():
        t, shape = spec[0], spec[1]
        dtype = spec[2] if len(spec) > 2 else torch.float32
        if t.device != device or t.dtype != dtype or t.shape != shape:
            want = str(dtype).removeprefix("torch.")
            raise ValueError(f"{label} {name}: got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}, expected {want} {shape} on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{label} {name}: not contiguous")
