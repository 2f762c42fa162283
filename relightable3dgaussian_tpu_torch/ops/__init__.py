"""Rasterizer ops: projection, binning, compositing (plain and kernel K1), surfaces."""
