"""K2 against the plain backward on trained stage-1 models, on the card.

    python3 examples/k2_against_plain.py [--trainings 12] [--other PATH]

Trains chip_smoke.py's stage-1 model (800x800, 300 steps; the training is
not bit-reproducible, K2 sums with atomics) `--trainings` times. On each of
its 8 orbit views K2 is held against the plain backward under a seeded image
cotangent (no weights cotangent) with two masks: zero where K1's and the
plain n_contrib differ (`count`), and zero where they differ or where the
images differ past chip_smoke.IMG_ATOL/IMG_RTOL (`count_or_image`, what
chip_smoke.backward_case uses). One line per view: the pixels each mask
zeroes and K2's largest relative error over the gradient fields under each.
With --other PATH (another checkout, e.g. a `git archive` of an earlier
commit), that checkout's K1 and K2 are built from its csrc/ and launched
through this checkout's wrappers on the same inputs: whether its walk state
equals this K1's bit for bit, and its K2's errors beside this one's.
Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel  # noqa: E402
from relightable3dgaussian_tpu_torch.ops import _build, composite_cuda  # noqa: E402
from relightable3dgaussian_tpu_torch.ops.composite import composite, composite_backward  # noqa: E402
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig  # noqa: E402


@contextlib.contextmanager
def kernels_of(csrc: Path):
    """composite_cuda's wrappers launch the kernels built from `csrc`."""
    saved, loaded = _build.CSRC, dict(_build._LOADED)
    _build.CSRC, _build._LOADED = csrc, {}
    try:
        yield
    finally:
        _build.CSRC, _build._LOADED = saved, loaded


def worst_rel(args, walk, g_image) -> float:
    got = composite_cuda.composite_k2(*args[:5], walk, g_image, None, args[5])
    want = composite_backward(*args[:5], g_image, None, args[5])
    return max(cs.grad_errors("k2", "K2", got, want)[0].values())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trainings", type=int, default=12)
    parser.add_argument("--other", type=Path)
    opts = parser.parse_args()
    dev = torch.device("cuda", 0)
    other = (opts.other / "relightable3dgaussian_tpu_torch" / "csrc"
             if opts.other else None)
    worst = {}
    for run in range(opts.trainings):
        with torch.no_grad():
            scene = GaussianModel.from_numpy(cs.make_scene(cs.N_MAIN, cs.SEED),
                                             device=dev)
        model = cs.train_phase(scene, cs.SIZE_MAIN, cs.VIEWS, cs.N_INIT,
                               cs.TRAIN_OPT, dev)["model"]
        with torch.no_grad():
            for v in range(cs.VIEWS):
                args = cs.compositor_args(
                    model, cs.orbit_view(v, cs.VIEWS, cs.SIZE_MAIN, dev),
                    RasterConfig(cs.SIZE_MAIN, cs.SIZE_MAIN))
                out, walk = composite_cuda.composite_k1(*args)
                plain = composite(*args)
                count = out.n_contrib == plain.n_contrib
                both = cs.backward_case(args, "k2", False, 0)[2]
                gen = torch.Generator(device=dev).manual_seed(9 + v)
                noise = torch.randn(out.image.shape, generator=gen, device=dev)
                masks = {"count": count, "count_or_image": both}
                line = {f"masked_{k}": int((~m).sum()) for k, m in masks.items()}
                kernels = [("this", contextlib.nullcontext())]
                if other is not None:
                    kernels.append(("other", kernels_of(other)))
                for name, ctx in kernels:
                    with ctx:
                        k_walk = composite_cuda.composite_k1(*args)[1]
                        if name == "other":
                            line["walk_equal"] = bool(
                                torch.equal(k_walk.final_T, walk.final_T)
                                and torch.equal(k_walk.stop, walk.stop))
                        for k, m in masks.items():
                            e = worst_rel(args, k_walk, noise * m[..., None])
                            line[f"{name}_{k}"] = f"{e:.3e}"
                            worst[f"{name}_{k}"] = max(worst.get(f"{name}_{k}", 0.0), e)
                cs.say("k2-against-plain", training=run, view=v, **line)
    cs.say("k2-against-plain-worst", views=opts.trainings * cs.VIEWS,
           **{k: f"{e:.3e}" for k, e in worst.items()})


if __name__ == "__main__":
    main()
