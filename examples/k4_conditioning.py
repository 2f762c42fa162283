"""K4 where float32 is ill-conditioned, against float64, on the card.

    python3 examples/k4_conditioning.py

Two cases on chip_smoke.py's seeded K4 inputs (20,000 points, 64
samples), each over its first 2000 points, each printing the field's
largest error from float64 (in units of its largest entry over those
points) for K4 and for the plain float32 version, and then holding the
whole case under chip_smoke.check_k4's gate:

* antipodal: the points are viewed from an angle theta off the opposite
  of their last sample (the Fibonacci ring 10 degrees above the horizon,
  so V.N is about -0.17, far from grazing). The half vector
  h0 = (d + V) / 2 nearly cancels, and the view-direction gradient scales
  as 1 / |h0|: float32's rounding of V moves it by eps / |h0| of itself.
  theta from 1e-4 to 1e-1; field viewdirs.
* light-zero: the constant SH coefficient of each channel is set so that
  the local light e = sum_k Y_k shs_k at sample 5 is delta (alternating in
  sign) before float32 rounding. max(e, 0) passes the SH gradient by the
  sign of e, and float32's e can have the other sign than float64's.
  delta from 0 to 1e-5; field shs.

Four more, the lower clips of K4's float32 chain (chip_smoke.k4_branch_case,
2000 points x 64 samples, all forced, three seeds each): the GGX
denominator q (q-clip, roughness 0.09-0.15), NoV (nov-clip), NoH
(noh-clip) and VoH (voh-clip) at 1e-6 (1 + delta) in float64, |delta| each
of chip_smoke.K4_BRANCH_DELTAS (1e-8 to 2e-3), alternating in sign point by
point. Each prints, per gradient field, K4's and the plain float32
version's error from float64 (units of the field's largest entry), and how
many decisions K4 (by its rule, shading_cuda.k4_clip_passes), K4's float32
chain alone and the plain float32 version take otherwise than float64;
then the case is held under chip_smoke.check_k4's gate, every point in,
and q-clip, nov-clip and voh-clip on K4's tolerance alone
(chip_smoke.K4_SLACK_FREE).

Ends with a count of the runs that failed the gate, and exits 1 if any
did. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from relightable3dgaussian_tpu_torch.ops import shading_cuda  # noqa: E402
from relightable3dgaussian_tpu_torch.utils.sh import eval_sh_basis  # noqa: E402

NEAR, P, S = 2000, 20_000, 64
FIELDS = ("base_color", "roughness", "viewdirs", "shs", "gl")


def antipodal_case(P: int, S: int, near: int, theta: float, seed: int,
                   device) -> tuple:
    """cs.shading_case with the first `near` points viewed from `theta`
    (radians, about a seeded axis) off the opposite of their last sample."""
    x = list(cs.shading_case(P, S, seed, device))
    d = x[7][:near, -1].double()
    g = torch.Generator().manual_seed(seed)
    a = torch.linalg.cross(d, torch.randn((near, 3), generator=g,
                                          dtype=torch.float64).to(device))
    a = a / a.norm(dim=-1, keepdim=True)
    v = -(d * math.cos(theta) + a * math.sin(theta))
    x[3] = x[3].clone()
    x[3][:near] = (v / v.norm(dim=-1, keepdim=True)).float()
    return tuple(x)


def light_zero_case(P: int, S: int, near: int, delta: float, seed: int,
                    device, sample: int = 5) -> tuple:
    """cs.shading_case with the first `near` points' local light at
    `sample` set to +-delta (alternating) in each channel, through the
    constant SH coefficient, before it is rounded to float32."""
    x = list(cs.shading_case(P, S, seed, device))
    Y = eval_sh_basis(3, x[7][:near, sample].double())           # [near, 16]
    shs = x[4][:near].double()                                    # [near, 16, 3]
    rest = (Y[:, 1:, None] * shs[:, 1:]).sum(1)                   # [near, 3]
    sign = 1.0 - 2.0 * (torch.arange(near, device=device) % 2)
    x[4] = x[4].clone()
    x[4][:near, 0] = ((delta * sign[:, None] - rest) / Y[:, :1]).float()
    return tuple(x)


def field_errors(x: tuple, near: int, seed: int) -> dict:
    """{field: (K4, plain float32) error from float64 (check_k4's
    reference: VoH's clip exact where K4 takes it past float64)} of every
    gradient field over the first `near` points, in units of their largest
    float64 entry."""
    gen = torch.Generator().manual_seed(seed)
    cot = [torch.randn((x[0].shape[0], 3), generator=gen).to(x[0].device)
           for _ in range(3)]
    got = shading_cuda.shade_bwd(*shading_cuda.kernel_inputs(*x), *cot)
    with torch.enable_grad():
        leaves, loss = cs.plain_shading_graph(x, cot)
        plain = torch.autograd.grad(loss, leaves)
        leaves, loss = cs.plain_shading_graph([t.double() for t in x],
                                              [c.double() for c in cot],
                                              cs.reference_voh_pass(x)[0])
        exact = torch.autograd.grad(loss, leaves)
    out = {}
    for field, g, p, e in zip(FIELDS, got, plain, exact):
        g, p, e = g.reshape(e.shape)[:near], p[:near], e[:near]
        scale = float(e.abs().max())
        out[field] = (float((g.double() - e).abs().max()) / scale,
                      float((p.double() - e).abs().max()) / scale)
    return out


FAILED: list[str] = []


def gate(x: tuple, label: str, seed: int, slack: bool = True) -> None:
    try:
        cs.check_k4(x, label, seed, timed=False, slack=slack)
    except AssertionError as e:
        FAILED.append(label)
        print("FAIL", e, flush=True)


def run(name: str, make, values, field: str, dev) -> None:
    for value in values:
        for seed in range(3):
            x = make(P, S, NEAR, value, 400 + seed, dev)
            k4, plain = field_errors(x, NEAR, seed)[field]
            print(f"[k4-{name}] value={value:g} seed={seed} "
                  f"{field}_err_k4={k4:.3e} {field}_err_plain={plain:.3e}",
                  flush=True)
            gate(x, f"k4-{name} value={value:g} seed={seed}", seed)


def run_branch(case: str, dev) -> None:
    """One forced clip case at each |delta| of cs.K4_BRANCH_DELTAS."""
    for delta in cs.K4_BRANCH_DELTAS:
        for seed in range(3):
            x, _, reached = cs.k4_branch_case(case, NEAR, S, 600 + seed, dev,
                                              (delta,))
            errs = field_errors(x, NEAR, seed)
            apart = cs.clip_decisions_apart(x)
            print(f"[k4-{case}] delta={delta:g} seed={seed} "
                  f"reached={float(abs(reached).min()):.3e}-"
                  f"{float(abs(reached).max()):.3e} "
                  f"decisions_apart_k4={apart['k4']} "
                  f"decisions_apart_k4_float32={apart['k4_float32']} "
                  f"decisions_apart_plain={apart['plain']} "
                  f"k4_double_branch_samples="
                  f"{apart['k4_double_branch_samples']} "
                  + " ".join(f"{f}_err_k4={k:.3e} {f}_err_plain={p:.3e}"
                             for f, (k, p) in errs.items()), flush=True)
            gate(x, f"k4-{case} delta={delta:g} seed={seed}", seed,
                 slack=case not in cs.K4_SLACK_FREE)


def main() -> int:
    dev = torch.device("cuda:0")
    cs.build_phase()
    run("antipodal", antipodal_case,
        (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1), "viewdirs", dev)
    run("light-zero", light_zero_case, (0.0, 1e-8, 1e-7, 1e-6, 1e-5),
        "shs", dev)
    for case in cs.K4_BRANCH_CASES:
        run_branch(case, dev)
    print(f"[k4-conditioning] failed={FAILED}", flush=True)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
