"""K4 at grazing views against float64, on the card.

    python3 examples/k4_grazing.py

On chip_smoke.py's seeded K4 inputs (20,000 points, 64 samples), the view
direction of the first 200 points is set at V.N = +-eps (alternating signs)
for eps from 0 to 2e-6. The shading turns each normal to the viewer's side
by sign(V.N), and float32 alone turns some of those normals the other way
or zeroes them (shading_cuda.view_side); K4 takes the sign, and NoV's clip
decision, from float64. Each run prints how many points float32 alone
would have flipped and, per gradient field, K4's and the plain float32
version's largest error from float64 over the 200 points (in units of the
field's largest entry there), then holds K4 forward and backward against
the plain shading in float64 under chip_smoke.check_k4's gate, every point
in (three seeds each). Ends with a count of the runs that failed, and exits
1 if any did. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from k4_conditioning import field_errors  # noqa: E402
from relightable3dgaussian_tpu_torch.ops import shading_cuda  # noqa: E402

GRAZING, P, S = 200, 20_000, 64


def grazing_case(eps: float, seed: int, dev) -> tuple:
    """cs.shading_case with the first GRAZING points viewed at V.N =
    +-eps."""
    x = list(cs.shading_case(P, S, 100 + seed, dev))
    n, v = x[2][:GRAZING], x[3].clone()
    g = torch.Generator().manual_seed(seed)
    t = torch.linalg.cross(n, torch.randn((GRAZING, 3), generator=g).to(dev))
    t = t / t.norm(dim=-1, keepdim=True)
    sign = 1.0 - 2.0 * (torch.arange(GRAZING, device=dev) % 2)
    w = t + (sign * eps)[:, None] * n
    v[:GRAZING] = w / w.norm(dim=-1, keepdim=True)
    x[3] = v.contiguous()
    return tuple(x)


def main() -> int:
    dev = torch.device("cuda:0")
    cs.build_phase()
    runs, failed = 0, []
    for eps in (0.0, 1e-9, 1e-8, 5e-8, 1e-7, 5e-7, 1e-6, 2e-6):
        for seed in range(3):
            x = grazing_case(eps, seed, dev)
            side32, side64 = shading_cuda.view_side(x[2], x[3])
            flips = int(((side32 == 0) | (side32 != side64)).sum())
            errs = field_errors(x, GRAZING, seed)
            print(f"[k4-grazing] eps={eps:g} seed={seed} "
                  f"float32_sign_flips={flips} "
                  + " ".join(f"{f}_err_k4={k:.3e} {f}_err_plain={p:.3e}"
                             for f, (k, p) in errs.items()), flush=True)
            runs += 1
            try:
                cs.check_k4(x, f"k4-grazing eps={eps:g} seed={seed}", seed,
                            reps=1, plain_reps=1)
            except AssertionError as e:
                failed.append((eps, seed))
                print("FAIL", e, flush=True)
    print(f"[k4-grazing] runs={runs} failed={failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
