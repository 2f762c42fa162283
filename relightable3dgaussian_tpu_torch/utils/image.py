"""Image metrics (port of relightable3dgaussian_tpu/utils/image.py: mse, psnr)."""
from __future__ import annotations

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
