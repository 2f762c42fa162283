"""Command-line entry points of the port: `cli.train` (stages 1 and 2) and
`cli.eval_nvs`. They run on the card; `main(argv, device=...)` takes another
device only from a caller (the CPU tests), never from a flag. The JAX
package's CLI helpers for its compile cache, binning auto-plan, tracer caps
and device meshes are TPU mechanisms and have no counterpart here.
"""
