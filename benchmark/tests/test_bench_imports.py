"""What the benchmark loads: nothing of JAX or the JAX package (compared by
whole top-level module name: the port's name begins with the JAX
package's), and the reference nothing of the port either."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "relightable3dgaussian_tpu"}

LOAD_ALL = """
import importlib, pkgutil, sys
import benchmark, benchmark.kinds, benchmark.reference
from benchmark import harness
for pkg in (benchmark, benchmark.kinds, benchmark.reference):
    for m in pkgutil.iter_modules(pkg.__path__):
        if not m.name.startswith("_") and m.name != "tests":
            importlib.import_module(f"{pkg.__name__}.{m.name}")
for m in (harness.HERE / "metrics").glob("*.py"):
    harness.metric_reader(m.stem)
import relightable3dgaussian_tpu_torch.train.stage1, relightable3dgaussian_tpu_torch.train.stage2
import relightable3dgaussian_tpu_torch.models.render_neilf
print(" ".join(sorted({k.split(".")[0] for k in sys.modules})))
"""

LOAD_REFERENCE = """
import importlib, pkgutil, sys
import benchmark.reference
for m in pkgutil.iter_modules(benchmark.reference.__path__):
    importlib.import_module(f"benchmark.reference.{m.name}")
print(" ".join(sorted({k.split(".")[0] for k in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_benchmark_loads_no_jax():
    loaded = _top_level(LOAD_ALL)
    assert "relightable3dgaussian_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level(LOAD_REFERENCE)
    assert "torch" in loaded
    assert not loaded & (FORBIDDEN | {"relightable3dgaussian_tpu_torch"})


def test_the_harness_refuses_a_loaded_jax_package(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "relightable3dgaussian_tpu.ops", object())
    assert harness.forbidden_modules() == ["relightable3dgaussian_tpu"]
