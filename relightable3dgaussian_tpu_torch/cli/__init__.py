"""Command-line entry points of the port: `cli.train` (stages 1 and 2),
`cli.eval_nvs`, `cli.relighting` (scene composition and relighting),
`cli.eval_relighting_syn4` (the Synthetic4Relight benchmark), `cli.gui`,
`cli.mvs` and `cli.convert`. They run on the card; `main(argv, device=...)`
takes another device only from a caller (the CPU tests), never from a flag.

`--n_devices N` runs a CLI's body on N ranks, one process a card
(`run_ranks`): `cli.train` trains data-parallel, a camera a rank, and every
stage-2 CLI splits its visibility trace and eval shading over the ranks
(`sharded_trace_from_args`, `sharded_shading_from_args`); rank 0 alone
writes. The JAX package's CLI helpers for its compile cache, binning
auto-plan and tracer caps (`auto_plan_config`, `trace_caps_from_args`) are
TPU mechanisms and have no counterpart here; their flags are accepted with
no effect.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch

from ..ops import _build
from ..parallel import PeerRanks
from ..parallel.data_parallel import Group
from ..parallel.point_sharded import make_sharded_shading, make_sharded_trace
from .arguments import rank_devices


def _rank(group: Group, fn: Callable, args):
    """A rank of `run_ranks`; past rank 0 its prints are dropped."""
    if group.rank == 0:
        return fn(args, group.device, group)
    with open(os.devnull, "w") as devnull, \
            contextlib.redirect_stdout(devnull):
        return fn(args, group.device, group)


def run_ranks(fn: Callable, args, device: torch.device | str):
    """fn(args, device, group) once, with group None, at --n_devices 1;
    else on `--n_devices` ranks (rank r on cuda:r with NCCL, or on the CPU
    with gloo where the caller asked for the CPU), after building the
    kernels once for all of them: rank 0 in this process, ranks 1..N-1 in
    processes of their own (`parallel.PeerRanks`, with no limit on the
    whole run; each collective has its timeout). Returns rank 0's result;
    a failed rank fails the call. `fn` must be a module-level function."""
    device = torch.device(device)
    n = getattr(args, "n_devices", 1) or 1
    if n <= 1:
        return fn(args, device, None)
    devices = rank_devices(n, device)
    if device.type == "cuda":
        _build.prebuild()
    with PeerRanks(_rank, devices, fn, args, timeout_s=None) as group:
        return _rank(group, fn, args)


def _group_for(args, group: Group | None, what: str) -> Group | None:
    n = getattr(args, "n_devices", 1) or 1
    if n <= 1:
        return None
    if group is None or group.size != n:
        raise ValueError(f"--n_devices {n}: {what} needs the group of {n} "
                         "ranks run_ranks starts")
    print(f"{what} split over {n} ranks")
    return group


def sharded_shading_from_args(args, group: Group | None):
    """The point-sharded eval shading over the ranks of `--n_devices N`
    (N > 1), else None (the chunked single-rank shading)."""
    group = _group_for(args, group, "Eval shading")
    return None if group is None else make_sharded_shading(group,
                                                           full_extras=True)


def sharded_trace_from_args(args, group: Group | None):
    """The ray-sharded visibility trace over the ranks of `--n_devices N`
    (N > 1), else None (one K3 launch over every ray)."""
    group = _group_for(args, group, "Visibility tracing")
    return None if group is None else make_sharded_trace(group)
