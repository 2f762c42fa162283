"""The port imports without jax, builds nothing at import, and chip_smoke.py
refuses to run without a CUDA device or outside a checkout."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_ops import share_cpu_threads  # noqa: F401  (torch threads)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "relightable3dgaussian_tpu_torch"


def run_python(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    """Every module of the port, scene/ and cli/ included, and chip_smoke.py
    import with jax and the JAX package blocked, and build nothing."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['relightable3dgaussian_tpu'] = None\n"
        "import relightable3dgaussian_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__,\n"
        "                                               port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from relightable3dgaussian_tpu_torch.ops import _build\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                ('jax', 'jaxlib', 'flax', 'relightable3dgaussian_tpu'))\n"
        "print('modules', len(names), 'cli' in str(names), 'scene' in str(names))\n"
        "print('relighting', sorted(n for n in names if n.endswith(\n"
        "    ('relighting', 'relighting_syn4', 'lpips'))))\n"
        "print('loaded', loaded, 'built', len(_build._LOADED))\n")
    proc = run_python(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout and "True True" in proc.stdout, proc.stdout
    n_modules = int(proc.stdout.split("modules ")[1].split()[0])
    assert n_modules >= 48, proc.stdout
    assert ("relighting ['relightable3dgaussian_tpu_torch.cli."
            "eval_relighting_syn4', 'relightable3dgaussian_tpu_torch.cli."
            "relighting', 'relightable3dgaussian_tpu_torch.losses.lpips']"
            in proc.stdout), proc.stdout
    assert ("loaded ['jax', 'relightable3dgaussian_tpu'] built 0"
            in proc.stdout), proc.stdout


def test_viewer_and_mvs_modules_import_without_jax_or_dearpygui():
    """cli.gui, cli.mvs, cli.convert and mvs/ import with jax, the JAX
    package and dearpygui blocked (the viewer imports dearpygui only in its
    window code), and build nothing."""
    code = (
        "import sys, importlib\n"
        "for blocked in ('jax', 'relightable3dgaussian_tpu', 'dearpygui',\n"
        "                'imageio'):\n"
        "    sys.modules[blocked] = None\n"
        "names = ['cli.gui', 'cli.mvs', 'cli.convert', 'mvs',\n"
        "         'mvs.formats', 'mvs.colmap_to_mvs', 'mvs.plane_sweep',\n"
        "         'mvs.filter_fuse', 'mvs.prepare']\n"
        "for name in names:\n"
        "    importlib.import_module('relightable3dgaussian_tpu_torch.' + name)\n"
        "from relightable3dgaussian_tpu_torch.ops import _build\n"
        "print('imported', len(names), 'built', len(_build._LOADED))\n")
    proc = run_python(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "imported 9 built 0" in proc.stdout, proc.stdout


def test_parallel_raster_dense_and_timing_import_without_jax():
    """parallel/, raster/, ops/rasterize_dense.py and utils/timing.py import
    with jax and the JAX package blocked, build nothing, and start no
    process group."""
    code = (
        "import sys, importlib\n"
        "for blocked in ('jax', 'relightable3dgaussian_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        "names = ['parallel', 'parallel.data_parallel',\n"
        "         'parallel.point_sharded', 'raster', 'ops.rasterize_dense',\n"
        "         'utils.timing']\n"
        "for name in names:\n"
        "    importlib.import_module('relightable3dgaussian_tpu_torch.' + name)\n"
        "import torch.distributed as dist\n"
        "from relightable3dgaussian_tpu_torch.ops import _build\n"
        "print('imported', len(names), 'built', len(_build._LOADED),\n"
        "      'group', dist.is_initialized())\n")
    proc = run_python(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "imported 6 built 0 group False" in proc.stdout, proc.stdout


def test_sources_never_import_the_jax_package():
    pattern = re.compile(r"^\s*(import relightable3dgaussian_tpu\b(?!_torch)"
                         r"|from relightable3dgaussian_tpu\b(?!_torch))",
                         re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_sources_never_import_imageio():
    """The card's machine has no imageio: the port's PNG codec and EXR and
    HDR readers stand in for it, and the relighting CLI keeps its frames as
    PNGs."""
    pattern = re.compile(r"^\s*(import imageio|from imageio)", re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_tf32_is_off_after_import():
    import relightable3dgaussian_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_source_exports_the_bound_symbol():
    src = (PORT / "csrc" / "composite_fwd.cu").read_text()
    assert 'extern "C" int r3dg_composite_fwd(' in src
    assert "composite_pallas.py::_kernel" in src      # the TPU kernel it replaces
    assert "__expf" not in src.replace("(not __expf)", "")


def test_backward_kernel_source_exports_the_bound_symbol():
    src = (PORT / "csrc" / "composite_bwd.cu").read_text()
    assert 'extern "C" int r3dg_composite_bwd(' in src
    # the TPU kernel it replaces
    assert "composite_pallas_bwd.py::_bwd_kernel_single" in src
    assert "__expf" not in src.replace("(not __expf)", "")


def test_two_walk_kernel_source_exports_the_bound_symbol():
    src = (PORT / "csrc" / "composite_bwd_two_walk.cu").read_text()
    assert 'extern "C" int r3dg_composite_bwd_two_walk(' in src
    # the TPU kernel it replaces
    assert "composite_pallas_bwd.py::_bwd_kernel\n" in src
    assert "__expf" not in src.replace("(not __expf)", "")
    # K1, K2 and K5 take the alpha step from one header
    for source in ("composite_fwd.cu", "composite_bwd.cu",
                   "composite_bwd_two_walk.cu"):
        assert '#include "composite_step.cuh"' in (PORT / "csrc" /
                                                   source).read_text()
    header = (PORT / "csrc" / "composite_step.cuh").read_text()
    assert "expf(" in header and "__expf(" not in header
    # K2 and K5 take the gradient reduction from one header
    for source in ("composite_bwd.cu", "composite_bwd_two_walk.cu"):
        src = (PORT / "csrc" / source).read_text()
        assert '#include "composite_grad.cuh"' in src
        assert "r3dg::reduce_pair(" in src and "r3dg::flush_slot(" in src
        assert "__shfl_xor_sync" not in src


def dispatched_widths(source: str) -> tuple[int, ...]:
    """The attribute widths a compositor source's `switch (a_dim)` builds
    apart."""
    src = (PORT / "csrc" / source).read_text()
    body = src.split("switch (a_dim) {", 1)[1].split("default:", 1)[0]
    return tuple(int(w) for w in re.findall(r"case (\d+):", body))


def test_specialised_widths_cover_the_main_paths():
    """K1, K2 and K5 build the main paths' attribute widths apart, and
    ops/composite_cuda.py names the same widths: a config change that would
    put a main path on the general build fails here."""
    import numpy as np

    from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel
    from relightable3dgaussian_tpu_torch.models.render import view_features
    from relightable3dgaussian_tpu_torch.models.render_neilf import (
        EVAL_FEATURE_DIM, train_feature_dim)
    from relightable3dgaussian_tpu_torch.ops import composite_cuda
    from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
    from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
    from relightable3dgaussian_tpu_torch.ops.rasterize import prepare
    from relightable3dgaussian_tpu_torch.train.config import (
        STAGE2_NERF_SYNTHETIC, OptimizationConfig)

    fwd = dispatched_widths("composite_fwd.cu")
    bwd = dispatched_widths("composite_bwd.cu")
    assert fwd == composite_cuda.SPECIALISED_WIDTHS[composite_cuda.KERNEL]
    assert bwd == composite_cuda.SPECIALISED_WIDTHS[composite_cuda.BWD_KERNEL]
    assert dispatched_widths("composite_bwd_two_walk.cu") == (
        composite_cuda.SPECIALISED_WIDTHS[composite_cuda.TWO_WALK_KERNEL])
    assert max(fwd + bwd) <= composite_cuda.MAX_ATTRS

    # stage 1: the width prepare gives the render's attributes
    rng = np.random.default_rng(0)
    n = 8
    model = GaussianModel.from_numpy({
        "xyz": rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        "normal": rng.normal(size=(n, 3)).astype(np.float32),
        "shs_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "shs_rest": np.zeros((n, 15, 3), np.float32),
        "scaling": np.full((n, 3), -3.0, np.float32),
        "rotation": np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
        "opacity": np.zeros((n, 1), np.float32)}, device="cpu")
    cam = make_camera_params(np.eye(3), np.array([0.0, 0.0, 3.0]), 32, 32,
                             fovx=0.9, fovy=0.9, device="cpu")
    _, _, attrs = prepare(model.xyz, model.get_scaling, model.get_rotation,
                          model.get_opacity, model.get_shs,
                          view_features(model, cam), cam, RasterConfig(32, 32))
    stage1 = attrs.shape[1]
    assert stage1 == 3 + 4 + 2
    stage2_train = 3 + train_feature_dim(
        OptimizationConfig(**STAGE2_NERF_SYNTHETIC)) + 2
    stage2_eval = 3 + EVAL_FEATURE_DIM + 2
    assert {stage1, stage2_train, stage2_eval} <= set(fwd)
    assert {stage1, stage2_train} <= set(bwd)


@pytest.mark.parametrize("source,symbols,replaces", [
    ("ray_trace.cu", ["r3dg_trace"], "ray_trace.py::_trace_eval_kernel"),
    ("shading.cu", ["r3dg_shade_fwd", "r3dg_shade_bwd"],
     "shading_pallas.py::_fwd_kernel and ::_bwd_kernel"),
])
def test_stage2_kernel_sources_export_the_bound_symbols(source, symbols,
                                                        replaces):
    src = (PORT / "csrc" / source).read_text()
    for symbol in symbols:
        assert f'extern "C" int {symbol}(' in src
    assert replaces in src.replace("\n// ", "")      # the TPU kernel replaced
    assert "__expf" not in src and "use_fast_math" not in src


def test_shading_launch_plan_matches_the_source():
    """K4's block of points, as ops/shading_cuda.py names it for the card
    tests, is csrc/shading.cu's, and its shared memory (kStages chunk
    buffers of dirs, light, visibility and area rows, and the SH rows) fits
    the 48 KB a block has without an attribute."""
    from relightable3dgaussian_tpu_torch.ops import shading_cuda

    src = (PORT / "csrc" / "shading.cu").read_text()
    const = {name: int(value) for name, value in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kPoints"] == shading_cuda.POINTS_PER_BLOCK
    assert const["kGroup"] * const["kPoints"] % 32 == 0     # whole warps
    assert 32 % const["kGroup"] == 0                         # groups in a warp
    row3, row1 = 3 * const["kChunk"] + 4, const["kChunk"] + 4
    smem = 4 * (const["kStages"] * const["kPoints"] * (2 * row3 + 2 * row1)
                + const["kPoints"] * (48 + 4))
    assert smem <= 48 * 1024
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" not in src
    assert f"is {smem:,} bytes a block" in src.replace("\n// ", " ")  # the note


PTXAS_TRANSCRIPT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__711c6463_10_shading_cu_aa6ed2ef16shade_bwd_kernelEPKfS1_S1_S1_S1_S1_S1_S1_S1_S1_S1_S1_iiPfS2_S2_S2_S2_' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__711c6463_10_shading_cu_aa6ed2ef16shade_bwd_kernelEPKfS1_S1_S1_S1_S1_S1_S1_S1_S1_S1_S1_iiPfS2_S2_S2_S2_
    32 bytes stack frame, 32 bytes spill stores, 76 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 32 bytes cumulative stack size, 43520 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120composite_fwd_kernelILi9EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120composite_fwd_kernelILi9EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 9216 bytes smem
"""


def test_ptxas_report_reads_each_kernel(monkeypatch):
    """_build.ptxas_report names each kernel of nvcc's -Xptxas -v report
    (mangled in an anonymous namespace, templated or not) with its
    registers, spills and shared memory; nvcc is faked with a transcript of
    the form it prints."""
    import subprocess as sp

    from relightable3dgaussian_tpu_torch.ops import _build

    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        return sp.CompletedProcess(cmd, 0, "", PTXAS_TRANSCRIPT)

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    report = _build.ptxas_report(PORT / "csrc" / "shading.cu")
    assert sorted(report) == ["composite_fwd_kernel", "shade_bwd_kernel"]
    assert report["shade_bwd_kernel"] == (
        "32 bytes stack frame, 32 bytes spill stores, 76 bytes spill loads; "
        "Used 128 registers, used 1 barriers, 32 bytes cumulative stack "
        "size, 43520 bytes smem")
    assert "Used 64 registers" in report["composite_fwd_kernel"]
    assert "-Xptxas" in calls[0] and "-shared" not in calls[0]


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run_python(["chip_smoke.py"], ROOT, env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = run_python(["chip_smoke.py"], tmp_path, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
