"""CLI flag groups generated from the config dataclasses.

Port of relightable3dgaussian_tpu/cli/arguments.py over the port's own
`train/config.py` (the reference's ParamGroup, arguments/__init__.py:10-36):
every dataclass field becomes a `--flag`; a shorthand table adds the
reference's single-letter aliases. `get_combined_args` replays training-time
flags from the cfg_args.json the trainer writes next to the model
(arguments/__init__.py:139-158).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from argparse import ArgumentParser, Namespace

from ..train.config import ModelConfig, OptimizationConfig, PipelineConfig

_SHORTHAND = {
    "source_path": "-s",
    "model_path": "-m",
    "images": "-i",
    "resolution": "-r",
    "white_background": "-w",
}


def add_dataclass_args(parser: ArgumentParser, cls, name: str) -> None:
    group = parser.add_argument_group(name)
    for field in dataclasses.fields(cls):
        flag = "--" + field.name
        aliases = ([_SHORTHAND[field.name]]
                   if field.name in _SHORTHAND else [])
        if field.type in ("bool", bool):
            group.add_argument(flag, *aliases, action="store_true",
                               default=field.default)
        else:
            ftype = {int: int, float: float, str: str}.get(
                type(field.default), str)
            group.add_argument(flag, *aliases, type=ftype,
                               default=field.default)


MULTI_GPU_QUEUE = "ROADMAP queue 1 item 4"
NO_EFFECT = "accepted for the JAX CLI's flag surface; no effect here"


def add_tpu_flags(parser: ArgumentParser) -> None:
    """The JAX CLIs' TPU-only flags: --no_auto_plan and the tracer's caps
    are accepted with no effect; --n_devices > 1 is refused by
    `refuse_multi_gpu`."""
    parser.add_argument("--no_auto_plan", action="store_true", help=NO_EFFECT)
    parser.add_argument("--n_devices", type=int, default=1,
                        help=f"values > 1 are refused ({MULTI_GPU_QUEUE})")
    parser.add_argument("--trace_max_clusters", type=int, default=0,
                        help=NO_EFFECT)
    parser.add_argument("--trace_max_supers", type=int, default=0,
                        help=NO_EFFECT)


def refuse_multi_gpu(args: Namespace, what: str) -> None:
    """Raise SystemExit for --n_devices > 1: multi-GPU `what` is not
    ported."""
    if (getattr(args, "n_devices", 1) or 1) > 1:
        raise SystemExit(f"--n_devices {args.n_devices}: multi-GPU {what} "
                         f"is not ported yet ({MULTI_GPU_QUEUE})")


def extract(cls, args: Namespace):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in fields})


def build_parser(description: str = "") -> ArgumentParser:
    parser = ArgumentParser(description=description)
    add_dataclass_args(parser, ModelConfig, "Loading Parameters")
    add_dataclass_args(parser, PipelineConfig, "Pipeline Parameters")
    add_dataclass_args(parser, OptimizationConfig, "Optimization Parameters")
    return parser


def extract_all(args: Namespace):
    return (extract(ModelConfig, args), extract(PipelineConfig, args),
            extract(OptimizationConfig, args))


def save_cfg_args(model_path: str, args: Namespace) -> None:
    """Persist resolved flags for eval-side replay (system_utils.py:55-56)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
                  f, indent=2)


def get_combined_args(parser: ArgumentParser,
                      argv: list[str] | None = None) -> Namespace:
    """Parse CLI args, then overlay training-time cfg_args.json as defaults."""
    argv = sys.argv[1:] if argv is None else argv
    args_cmdline = parser.parse_args(argv)
    cfg_path = os.path.join(args_cmdline.model_path or "", "cfg_args.json")
    merged = {}
    if os.path.exists(cfg_path):
        print(f"Config file found: {cfg_path}")
        with open(cfg_path) as f:
            merged.update(json.load(f))
    # Explicit CLI values always win; detect them via each action's actual
    # option strings (covers per-parser shorthands like -c/-t).
    passed = set()
    for action in parser._actions:
        for opt in action.option_strings:
            if any(a == opt or a.startswith(opt + "=") for a in argv):
                passed.add(action.dest)
    for k, v in vars(args_cmdline).items():
        if k not in merged or k in passed:
            merged[k] = v
    return Namespace(**merged)
