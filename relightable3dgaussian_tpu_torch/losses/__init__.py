"""Photometric and smoothness losses (port of relightable3dgaussian_tpu/losses/__init__.py).

11×11 gaussian-window SSIM (separable, σ = 1.5, zero padding, with the
variance clamps), kornia-style normalized Sobel spatial gradients (first and
second order, zero padding), edge-aware, bilateral and total-variation
smoothness, l1, mse and mask entropy. All functions take channel-first
images [C, H, W]. The filters are depthwise `F.conv2d` calls: the JAX
package computes them outside any Pallas kernel, and the package keeps cuDNN
out of TF32 (`__init__.py`), so they stay float32. LPIPS is `lpips.py`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils import trace

_SOBEL_X = ((-1., 0., 1.), (-2., 0., 2.), (-1., 0., 1.))
_SOBEL_XX = ((1., -2., 1.), (2., -4., 2.), (1., -2., 1.))
_SOBEL_XY = ((-1., 0., 1.), (0., 0., 0.), (1., 0., -1.))
SSIM_WINDOW = 11   # taps of the separable gaussian window
SSIM_SIGMA = 1.5


def _gaussian_1d() -> list[float]:
    g = [math.exp(-((i - SSIM_WINDOW // 2) ** 2) / (2 * SSIM_SIGMA ** 2))
         for i in range(SSIM_WINDOW)]
    return [v / sum(g) for v in g]


def _depthwise(img: torch.Tensor, kernel) -> torch.Tensor:
    """[C, H, W] same-size (zero-padded) cross-correlation of every channel
    with one 2-D kernel (a nested sequence of rows)."""
    k = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    trace.count("host.syncs")       # a pageable copy waits for the stream
    C = img.shape[0]
    weight = k.expand(C, 1, *k.shape)
    return F.conv2d(img[None], weight, padding=(k.shape[0] // 2,
                                                k.shape[1] // 2),
                    groups=C)[0]


def _gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """Separable gaussian filter of [C, H, W]: rows, then columns."""
    g = _gaussian_1d()
    return _depthwise(_depthwise(img, [[v] for v in g]), [g])


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over an image pair ([C, H, W]), gaussian window σ = 1.5."""
    return ssim_map(img1, img2).mean()


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map [C, H, W]; the five windowed moments are blurred
    as one stacked [5C, H, W] pass."""
    c = img1.shape[0]
    y = _gaussian_blur(torch.cat([img1, img2, img1 * img1, img2 * img2,
                                  img1 * img2]))
    mu1, mu2 = y[0:c], y[c:2 * c]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # True variances are >= 0; the E[x^2]-mu^2 cancellation leaves only
    # float rounding below zero, and clamping keeps SSIM within [-1, 1].
    sigma1 = torch.clamp(y[2 * c:3 * c] - mu1_sq, min=0.0)
    sigma2 = torch.clamp(y[3 * c:4 * c] - mu2_sq, min=0.0)
    sigma12 = y[4 * c:5 * c] - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))


def spatial_gradient(img: torch.Tensor, order: int) -> torch.Tensor:
    """[C, H, W] → [C, D, H, W] Sobel gradients (D = 2 for order 1: gx, gy;
    D = 3 for order 2: gxx, gxy, gyy), kornia's L1-normalised kernels."""
    t = torch.tensor
    if order == 1:
        kx = t(_SOBEL_X) / 8.0
        kernels = [kx, kx.T]
    else:
        kxx = t(_SOBEL_XX) / 16.0
        kxy = t(_SOBEL_XY) / 4.0
        kernels = [kxx, kxy, kxx.T]
    return torch.stack([_depthwise(img, k) for k in kernels], dim=1)


def first_order_edge_aware_loss(data: torch.Tensor,
                                img: torch.Tensor) -> torch.Tensor:
    """(|∇data| · exp(−|∇img|)).sum(direction).mean()."""
    gd = spatial_gradient(data, 1).abs()
    gi = spatial_gradient(img, 1).abs()
    return (gd * torch.exp(-gi)).sum(1).mean()


def second_order_edge_aware_loss(data: torch.Tensor,
                                 img: torch.Tensor) -> torch.Tensor:
    """(|∇²data|_{xx,yy} · exp(−10 |∇img|)).sum(direction).mean()."""
    gd = spatial_gradient(data, 2).abs()[:, (0, 2)]
    gi = spatial_gradient(img, 1).abs()
    return (gd * torch.exp(-10.0 * gi)).sum(1).mean()


def first_order_edge_aware_norm_loss(data: torch.Tensor,
                                     img: torch.Tensor) -> torch.Tensor:
    gd = spatial_gradient(data, 1).abs()
    gi = torch.linalg.norm(spatial_gradient(img, 1), dim=0, keepdim=True)
    return (gd * torch.exp(-gi)).sum(1).mean()


def first_order_loss(data: torch.Tensor) -> torch.Tensor:
    return spatial_gradient(data, 1).abs().sum(1).mean()


def _unnormalized_grad_mag(data: torch.Tensor) -> torch.Tensor:
    """|gx| + |gy| with the unnormalised Sobel kernels."""
    kx = torch.tensor(_SOBEL_X)
    return _depthwise(data, kx).abs() + _depthwise(data, kx.T).abs()


def bilateral_smooth_loss(data: torch.Tensor, image: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    rgb_grad = _unnormalized_grad_mag(image.mean(0, keepdim=True))
    data_grad = _unnormalized_grad_mag(data.mean(0, keepdim=True))
    return (data_grad * torch.exp(-rgb_grad) * mask).mean()


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Squared total variation over the last two dims."""
    h_tv = (x[..., 1:, :] - x[..., :-1, :]).square().mean()
    w_tv = (x[..., :, 1:] - x[..., :, :-1]).square().mean()
    return h_tv + w_tv


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def mask_entropy_loss(opacity: torch.Tensor,
                      image_mask: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy pushing the rendered opacity toward the mask."""
    o = torch.clamp(opacity, 1e-6, 1 - 1e-6)
    return -(image_mask * torch.log(o)
             + (1 - image_mask) * torch.log(1 - o)).mean()
