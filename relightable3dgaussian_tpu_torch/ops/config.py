"""Rasterizer configuration (port of relightable3dgaussian_tpu/ops/config.py::RasterConfig).

Only the fields the port reads. The JAX package's budget fields
(`buffer_multiple`, `max_tiles_per_gaussian`, `chunk`, `max_chunks_per_tile`,
`tier_plan`, `use_pallas`) size static TPU buffers; the port sizes its buffers
per call instead, as the CUDA reference does, and never drops a pair.
`white_background` and `bg_depth` come with the training and eval entry
points that read them; the render takes its background colour as an argument.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    height: int
    width: int
    tile: int = 16                # tile edge in pixels; kernel K1 needs 16
    sh_degree: int = 3            # active SH degree for color
    scale_modifier: float = 1.0
    compute_pseudo_normal: bool = True
    # Accumulate per-gaussian blend weights (densification stats); a pure
    # render can skip them.
    compute_weights: bool = True

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y
