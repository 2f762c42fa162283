"""Rasterizer ops: projection, binning, compositing (plain and kernel K1), surfaces."""
from .camera import CameraParams, make_camera_params, pixel_directions  # noqa: F401
from .config import RasterConfig  # noqa: F401
from .projection import covariance3d_packed, preprocess  # noqa: F401
from .rasterize import RasterOut  # noqa: F401
from .rasterize_dense import rasterize_dense  # noqa: F401
