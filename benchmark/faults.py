"""Faults planted under the timed path, for the calibration of the limits
(`calibrate.py`) and the benchmark's tests: each must make `correct` come
out false.

  unchanged   Adam's step returns the parameters unchanged;
  half_batch  the loss reads the top half of the view only (half of a
              step's pixels left out, the mean over the rest);
  altered     a frame's image altered where it is produced (a 0.05 offset
              on the rendered colour).
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")


def _half(x, H: int, W: int):
    import torch
    if isinstance(x, torch.Tensor) and x.dim() >= 2 and tuple(x.shape[-2:]) == (H, W):
        return x[..., : H // 2, :]
    return x


def _half_loss(loss_fn):
    def wrapped(view, model, results, opt, *rest):
        H, W = view.image.shape[-2:]
        view = type(view)(*(_half(x, H, W) for x in view))
        results = {k: _half(v, H, W) for k, v in results.items()}
        return loss_fn(view, model, results, opt, *rest)
    return wrapped


@contextlib.contextmanager
def planted(fault: str | None):
    """Plant `fault` in the program for the duration (None: nothing)."""
    if fault is None:
        yield
        return
    import torch
    from relightable3dgaussian_tpu_torch.models import render, render_neilf
    saved = []

    def swap(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "unchanged":
        swap(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        swap(render, "calculate_loss", _half_loss(render.calculate_loss))
        swap(render_neilf, "calculate_loss",
             _half_loss(render_neilf.calculate_loss))
    elif fault == "altered":
        def offset(fn, key):
            def wrapped(*a, **kw):
                res = fn(*a, **kw)
                if key in res:
                    res[key] = res[key] + 0.05
                return res
            return wrapped
        swap(render, "render_view", offset(render.render_view, "render"))
        swap(render_neilf, "render_view",
             offset(render_neilf.render_view, "pbr_env"))
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)

