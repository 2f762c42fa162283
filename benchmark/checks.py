"""The numbers that decide `correct`, each the program's reading against
the plain reference's, and the limits they are held to
(`limits/<cell>.json`).

Training (the first steps set-up drives, followed by the reference):
  loss    the largest |program − reference| / |reference| of each step's loss;
  grad    the first gradient as Adam got it (its first moment after one
          step over 1 − β1), by the worst leaf: |‖g_p‖ − ‖g_r‖| over the
          larger of the reference leaf's norm and the median leaf's;
  change  the parameters' change after the steps, by the same measure, over
          the leaves whose reference gradient is not nought to rounding
          (under a thousandth of the median leaf's: they move under Adam by
          round-off alone);
  stats   the densification statistics after the steps, by the same measure.
Frames (a sample of the window's frames, drawn from the seed):
  image_mae   the worst frame's mean |program − reference| of the image;
  depth_rel   the worst frame's mean |Δ depth| over its mean |depth|;
  normal_mae  the worst frame's mean |Δ| of the normal map.
"""
from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parent / "limits"
ZERO_GRAD = 1e-3      # a leaf's gradient under this share of the median's


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in leaves.items()}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    pn, rn = norms(prog), norms(ref)
    keys = [k for k in rn if keep is None or k in keep]
    med = statistics.median(rn[k] for k in keys)
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def moving_leaves(ref_grads: dict) -> set:
    """The leaves whose reference gradient is at least ZERO_GRAD of the
    median leaf's."""
    n = norms(ref_grads)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= ZERO_GRAD * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """{loss, grad, change, stats} from the two sides' readings: each a dict
    with "losses" [steps], "grads", "change" and "stats" ({leaf: tensor})."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    keep = moving_leaves(ref["grads"])
    return {"loss": loss,
            "grad": worst_leaf_gap(prog["grads"], ref["grads"]),
            "change": worst_leaf_gap(prog["change"], ref["change"], keep),
            "stats": worst_leaf_gap(prog["stats"], ref["stats"])}


def frame_numbers(prog: dict, ref: dict) -> dict:
    """{image_mae, depth_rel, normal_mae} of one frame's maps."""
    dp, dr = prog["depth"].double(), ref["depth"].double()
    return {
        "image_mae": float((prog["image"].double() - ref["image"].double())
                           .abs().mean()),
        "depth_rel": float((dp - dr).abs().mean() / dr.abs().mean().clamp(
            min=1e-30)),
        "normal_mae": float((prog["normal"].double() - ref["normal"].double())
                            .abs().mean()),
    }


def worst(readings: list[dict]) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def limits(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= lim[k] for k, v in numbers.items())
    return ok, shown
