"""Command-line entry points of the port: `cli.train` (stages 1 and 2),
`cli.eval_nvs`, `cli.relighting` (scene composition and relighting) and
`cli.eval_relighting_syn4` (the Synthetic4Relight benchmark). They run on
the card; `main(argv, device=...)` takes another device only from a caller
(the CPU tests), never from a flag. The JAX package's CLI helpers for its
compile cache, binning auto-plan, tracer caps and device meshes
(`auto_plan_config`, `trace_caps_from_args`, `sharded_*_from_args`) are TPU
mechanisms and have no counterpart here; their flags are accepted with no
effect.
"""
