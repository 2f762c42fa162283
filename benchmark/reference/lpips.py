"""The reference's LPIPS: VGG16's convolutions up to relu5_3, the input
z-scored, each of the five stages' last activation unit-normalised over
its channels, weighted by the stage's linear head, averaged over the
pixels and summed over the stages (the upstream lpipsPyTorch's metric).

The weights are data handed in: a dict of tensors in torchvision's
`features.<i>.weight` / `.bias` numbering and the heads as
`lin<k>.model.1.weight` [1, C, 1, 1]. Plain PyTorch in the dtype of the
images; imports nothing of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# VGG16's feature layers: channels of each 3x3 convolution, "M" a 2x2 max pool.
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512)
TAPS = (2, 4, 7, 10, 13)       # the stages' last convolutions, counted from 1
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
EPS = 1e-10                    # added to each activation's channel norm


def stage_features(x: torch.Tensor, weights: dict) -> list[torch.Tensor]:
    """The five stages' relu activations of x [N, 3, H, W] (z-scored)."""
    out, conv, layer = [], 0, 0
    for item in VGG16:
        if item == "M":
            x = F.max_pool2d(x, kernel_size=2, stride=2)
            layer += 1
            continue
        w = weights[f"features.{layer}.weight"].to(x.dtype)
        b = weights[f"features.{layer}.bias"].to(x.dtype)
        x = torch.relu(F.conv2d(x, w, b, padding=1))
        layer += 2
        conv += 1
        if conv in TAPS:
            out.append(x)
    return out


def lpips(a: torch.Tensor, b: torch.Tensor, weights: dict) -> torch.Tensor:
    """[N] distances between the images a and b [N, 3, H, W] in [0, 1]."""
    like = dict(dtype=a.dtype, device=a.device)
    shift = torch.tensor(SHIFT, **like).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, **like).view(1, 3, 1, 1)
    fa = stage_features((a - shift) / scale, weights)
    fb = stage_features((b - shift) / scale, weights)
    total = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    for k, (x, y) in enumerate(zip(fa, fb)):
        x = x / (x.square().sum(1, keepdim=True).sqrt() + EPS)
        y = y / (y.square().sum(1, keepdim=True).sqrt() + EPS)
        head = weights[f"lin{k}.model.1.weight"].to(a.dtype)
        head = head.view(1, -1, 1, 1)
        total = total + ((x - y).square() * head).sum(1).mean((1, 2))
    return total
