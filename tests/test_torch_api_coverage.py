"""Every public name of the JAX package has a counterpart in the port, read
from the sources by AST (neither package is imported).

A public name is a top-level function, class or assignment of a module not
starting with "_" (and, in an `__init__.py`, a name it imports), or such a
member of one of its classes. Its counterpart is a name bound in the port's
module of the same path: at top level, in a class body, as a `self.<name>`
attribute, by an import (with the members of a class imported from another
module of the port), or as a string in a module-level tuple or dict literal
(the fields a class sets by name, as `GaussianModel` its PBR fields). Two
lists name the rest, each entry with its reason: NOT_TO_PORT, ROADMAP.md
queue 1's not-to-port list (the TPU workarounds of its ground rules), and
RENAMED, the names the port gives another form in PyTorch's idiom, each
with the port's counterpart, which must exist.
"""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "relightable3dgaussian_tpu"
PORT = ROOT / "relightable3dgaussian_tpu_torch"

TIERS = "binning tier plans, pair budgets and their overflow counts"
CAPS = "the TPU tracer's candidate caps, their probes and overflow counts"
PADDED = "padded capacity with an active mask"
RANKS = ("rank-space binning and the chunk work list (no fast gathers on "
         "the TPU): the port bins to sorted ids per call")

NOT_TO_PORT = {
    "train/autotune.py": "binning auto-tune for static TPU buffers",
    "utils/compile_cache.py": "XLA's persistent compilation cache",
    "native/__init__.py": "native PLY and PIZ helpers; the port has numpy ones",
    "ops/tiles.py::auto_tier_plan": TIERS,
    "ops/tiles.py::work_capacity": TIERS,
    "ops/tiles.py::Binning.overflow_pairs": TIERS,
    "ops/tiles.py::Binning.overflow_chunks": TIERS,
    "ops/tiles.py::Binning.overflow_budget": TIERS,
    "ops/tiles.py::Binning.buffer_size": TIERS,
    "ops/tiles.py::Binning.sorted_rank": RANKS,
    "ops/tiles.py::Binning.depth_order": RANKS,
    "ops/tiles.py::Binning.rank_of": RANKS,
    "ops/tiles.py::Binning.sorted_gauss": RANKS,
    "ops/tiles.py::Binning.work_tile": RANKS,
    "ops/tiles.py::Binning.work_offset": RANKS,
    "ops/config.py::RasterConfig.binning_tiers": TIERS,
    "ops/config.py::RasterConfig.bg_depth": "read by no code of the JAX package",
    "cli/__init__.py::auto_plan_config": TIERS,
    "cli/__init__.py::add_trace_args": CAPS,
    "cli/__init__.py::trace_caps_from_args": CAPS,
    "cli/train.py::report_trace_stats": CAPS,
    "cli/train.py::pick_capacity": PADDED,
    "ops/ray_trace.py::probe_trace_caps": CAPS,
    "ops/ray_trace.py::trace_visibility_adaptive": CAPS + " (K3 is exact)",
    "ops/ray_trace.py::FEAT_DIM": "the TPU tracer's quad feature tiles",
    "ops/ray_trace.py::QUAD": "the TPU tracer's quad feature tiles",
    "ops/ray_trace.py::GaussianBVH.feat": "the TPU tracer's quad feature tiles",
    "models/render_neilf.py::VisibilityCache.overflow_rays": CAPS,
    "models/render_neilf.py::VisibilityCache.overflow_total": CAPS,
    "models/render_neilf.py::VisibilityCache.uncertain_rays": CAPS,
    "models/gaussians.py::grow_capacity": PADDED,
    "models/gaussians.py::init_aux": PADDED,
    "models/gaussians.py::mask_grads": PADDED,
    "models/gaussians.py::GaussianParams.capacity": PADDED,
    "models/gaussians.py::GaussianAux.active": PADDED,
    "models/gaussians.py::DensifyStats.n_dropped": PADDED,
}

ADAM = "train/optim.py::make_optimizer"      # one torch.optim.Adam a model
ENV_ADAM = "train/optim.py::make_env_optimizer"
RENAMED = {
    # Pallas kernels: hand-written CUDA behind a wrapper module
    "ops/composite_pallas.py": "ops/composite_cuda.py",
    "ops/composite_pallas_bwd.py": "ops/composite_cuda.py",
    "ops/shading_pallas.py": "ops/shading_cuda.py",
    # pytrees of arrays: nn.Modules of parameters and buffers
    "models/gaussians.py::GaussianParams": "models/gaussians.py::GaussianModel",
    "models/gaussians.py::GaussianAux": "models/gaussians.py::GaussianModel",
    "models/__init__.py::GaussianParams": "models/__init__.py::GaussianModel",
    "models/__init__.py::GaussianAux": "models/__init__.py::GaussianModel",
    "models/lights.py::DirectLightParams": "models/lights.py::DirectLightMap",
    "models/lights.py::DirectLightParams.env": "models/lights.py::DirectLightMap",
    "models/lights.py::init_direct_light": "models/lights.py::DirectLightMap",
    "models/lights.py::upsample_direct_light": "models/lights.py::upsample",
    "cli/train.py::params_from_ply_dict": "models/gaussians.py::GaussianModel",
    # the package's `render` names its module, not the function in it
    "models/__init__.py::render": "models/render.py::render",
    # the functional Adam states: torch.optim.Adam (step, exp_avg, exp_avg_sq)
    "train/optim.py::AdamState": ADAM,
    "train/optim.py::AdamState.count": ADAM,
    "train/optim.py::AdamState.mu": ADAM,
    "train/optim.py::AdamState.nu": ADAM,
    "train/optim.py::init_adam": ADAM,
    "train/optim.py::adam_step": ADAM,
    "train/optim.py::ArrayAdamState": ENV_ADAM,
    "train/optim.py::ArrayAdamState.count": ENV_ADAM,
    "train/optim.py::ArrayAdamState.mu": ENV_ADAM,
    "train/optim.py::ArrayAdamState.nu": ENV_ADAM,
    "train/optim.py::init_array_adam": ENV_ADAM,
    "train/optim.py::array_adam_step": ENV_ADAM,
    "train/__init__.py::AdamState": "train/__init__.py::make_optimizer",
    "train/__init__.py::init_adam": "train/__init__.py::make_optimizer",
    "train/__init__.py::adam_step": "train/__init__.py::make_optimizer",
    # a JAX mesh over devices: a torch.distributed group, a process a rank
    "parallel/__init__.py::make_mesh": "parallel/__init__.py::make_group",
    "parallel/data_parallel.py::make_mesh": "parallel/data_parallel.py::make_group",
    "parallel/data_parallel.py::DP_AXIS": "parallel/data_parallel.py::make_group",
    "parallel/data_parallel.py::stack_views": "parallel/data_parallel.py::shard_views",
    # the BVH's per-gaussian arrays: K3's packed records and constants
    "ops/ray_trace.py::GaussianBVH.xyz": "ops/ray_trace.py::RECORD",
    "ops/ray_trace.py::GaussianBVH.cov_inv": "ops/ray_trace.py::RECORD",
    "ops/ray_trace.py::GaussianBVH.opacity": "ops/ray_trace.py::RECORD",
    "ops/ray_trace.py::GaussianBVH.normal": "ops/ray_trace.py::RECORD",
    "ops/ray_trace.py::GaussianBVH.cluster_size": "ops/ray_trace.py::CLUSTER_SIZE",
    "ops/ray_trace.py::GaussianBVH.super_size": "ops/ray_trace.py::SUPER_SIZE",
    # the attribute width comes from the features given
    "ops/config.py::RasterConfig.feature_dim": "ops/rasterize.py::rasterize",
    # a once-only message: warnings.warn, which the default filter shows once
    "scene/cameras.py::WARNED": "scene/cameras.py::resolve_resolution",
}


def public_names(path: Path) -> list[str]:
    """The module's public top-level names and class members."""
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out.append(node.name)
            for b in node.body:
                out += [f"{node.name}.{n}" for n in _bound(b)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out += _bound(node)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out += [a.asname or a.name for a in node.names]
    return [n for n in out if not n.split(".")[-1].startswith("_")]


def _bound(node) -> list[str]:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return [node.name]
    targets = (node.targets if isinstance(node, ast.Assign)
               else [node.target] if isinstance(node, ast.AnnAssign) else [])
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def port_names(path: Path, follow: bool = True) -> set[str]:
    """Every name the port's module binds, as the module docstring says."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        names.update(_bound(node))
        if isinstance(node, ast.ClassDef):
            for b in node.body:
                names.update(_bound(b))
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        if follow and isinstance(node, ast.ImportFrom) and node.level:
            source = _sibling(path, node)
            if source is not None:
                members = port_class_members(source)
                for a in node.names:
                    names.update(members.get(a.name, ()))
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value:
            for lit in ast.walk(node.value):
                items = (lit.keys if isinstance(lit, ast.Dict)
                         else lit.elts if isinstance(lit, (ast.Tuple, ast.List,
                                                           ast.Set)) else [])
                names.update(x.value for x in items
                             if isinstance(x, ast.Constant)
                             and isinstance(x.value, str))
    for node in ast.walk(tree):
        for t in getattr(node, "targets", [getattr(node, "target", None)]):
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                names.add(t.attr)
    return names


def port_class_members(path: Path) -> dict[str, set[str]]:
    tree = ast.parse(path.read_text())
    return {node.name: {n for b in node.body for n in _bound(b)}
            for node in tree.body if isinstance(node, ast.ClassDef)}


def _sibling(path: Path, node: ast.ImportFrom) -> Path | None:
    base = path.parent
    for _ in range(node.level - 1):
        base = base.parent
    target = base.joinpath(*(node.module or "").split("."))
    for candidate in (target.with_suffix(".py"), target / "__init__.py"):
        if candidate.exists() and PORT in candidate.parents:
            return candidate
    return None


def jax_modules() -> list[str]:
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def test_every_public_jax_name_has_a_counterpart_in_the_port():
    missing = []
    for rel in jax_modules():
        if rel in NOT_TO_PORT or rel in RENAMED:
            continue
        port_file = PORT / rel
        if not port_file.exists():
            missing.append(rel)
            continue
        have = port_names(port_file)
        for name in public_names(JAX / rel):
            key = f"{rel}::{name}"
            if (name.split(".")[-1] not in have and key not in NOT_TO_PORT
                    and key not in RENAMED):
                missing.append(key)
    assert not missing, f"JAX names without a counterpart in the port: {missing}"


def test_the_lists_name_jax_names_and_port_counterparts_that_exist():
    """No entry of either list is stale: each names a JAX module or a public
    name of one, and each RENAMED counterpart exists in the port (a module,
    or a name that module binds)."""
    modules = set(jax_modules())
    public = {f"{rel}::{n}" for rel in modules for n in public_names(JAX / rel)}
    for key in (*NOT_TO_PORT, *RENAMED):
        assert key in modules or key in public, key
    for key, target in RENAMED.items():
        rel, _, name = target.partition("::")
        assert (PORT / rel).exists(), (key, target)
        assert not name or name in port_names(PORT / rel), (key, target)
    assert not set(NOT_TO_PORT) & set(RENAMED)
