"""Image metrics and the depth colormap (port of relightable3dgaussian_tpu/utils/image.py)."""
from __future__ import annotations

import numpy as np
import torch


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over all but the leading batch dim ([B, 1])."""
    flat1 = img1.reshape(img1.shape[0], -1)
    flat2 = img2.reshape(img2.shape[0], -1)
    return ((flat1 - flat2) ** 2).mean(dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR in dB, treating dim 0 as channels/batch like the reference."""
    m = mse(img1, img2)
    return 20 * torch.log10(1.0 / torch.sqrt(torch.clamp(m, min=1e-12)))


# 17-knot turbo-style colormap used for depth visualisation.
_TURBO_KNOTS = np.array(
    [
        [0.18995, 0.07176, 0.23217],
        [0.25107, 0.25237, 0.63374],
        [0.27628, 0.42118, 0.89123],
        [0.25862, 0.57958, 0.99876],
        [0.15844, 0.73551, 0.92305],
        [0.09267, 0.86554, 0.7623],
        [0.19659, 0.94901, 0.59466],
        [0.42778, 0.99419, 0.38575],
        [0.64362, 0.98999, 0.23356],
        [0.80473, 0.92452, 0.20459],
        [0.93301, 0.81236, 0.22667],
        [0.99314, 0.67408, 0.23675],
        [0.9836, 0.49291, 0.12849],
        [0.92105, 0.31489, 0.05475],
        [0.81608, 0.18462, 0.01809],
        [0.66449, 0.08436, 0.00424],
        [0.4796, 0.01583, 0.01055],
    ],
    dtype=np.float32,
)


def visualize_depth(depth: np.ndarray, near: float = 0.2,
                    far: float = 13.0) -> np.ndarray:
    """Depth [H, W] or [1, H, W] (numpy) → [3, H, W] float RGB in [0, 1],
    near warm and far cold."""
    depth = np.asarray(depth).squeeze()
    x = 1.0 - np.clip((depth - near) / (far - near), 0.0, 1.0)
    pos = x * (len(_TURBO_KNOTS) - 1)
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, len(_TURBO_KNOTS) - 1)
    w = (pos - lo)[..., None]
    rgb = _TURBO_KNOTS[lo] * (1 - w) + _TURBO_KNOTS[hi] * w
    return np.moveaxis(rgb, -1, 0)
