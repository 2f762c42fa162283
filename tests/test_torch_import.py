"""The port imports without jax, builds nothing at import, and chip_smoke.py
refuses to run without a CUDA device or outside a checkout."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "relightable3dgaussian_tpu_torch"


def run_python(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import relightable3dgaussian_tpu_torch.models.render\n"
        "import relightable3dgaussian_tpu_torch.train.checkpoint\n"
        "import relightable3dgaussian_tpu_torch.ops.composite_cuda\n"
        "import chip_smoke\n"
        "from relightable3dgaussian_tpu_torch.ops import _build\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                ('jax', 'jaxlib', 'flax', 'relightable3dgaussian_tpu'))\n"
        "print('loaded', loaded, 'built', len(_build._LOADED))\n")
    proc = run_python(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "loaded ['jax'] built 0" in proc.stdout, proc.stdout


def test_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
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
