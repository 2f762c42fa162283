"""The counted work of one scored view of the Synthetic4Relight evaluation
(cell s2-eval.syn4), beside `work.py`'s counts: kernel K6's bytes and
operations at any S, as `chip_smoke.py::k6_eval_phase` counts them, and
the scoring's convolutions (LPIPS's VGG16, SSIM's blur), from shapes.
"""
from __future__ import annotations

from . import work
from .reference.lpips import VGG16

F32 = 4
N_SH = 16          # the local light's SH coefficients (degree 3)

# FP32 operations per (point, sample) of K6 (csrc/shading_eval.cu):
# K4-fwd's 220 (the env mix included), the env lookup's transform 15,
# angles and grid coordinates 12, corner weights 8 and blend 24, and the
# sums of the incident, local and global lights and the visibility 10.
K6_OPS = 289


def k6_work(P: int, S: int, env_h: int, env_w: int,
            transform: bool = False) -> tuple[int, int]:
    """(bytes, ops) of one K6 launch: the samples' directions, visibility
    and areas, each point's base colour, roughness, normal, view
    direction and local SH, the map (and its transform) read; the six
    [P, 3] means and the visibility's [P] written."""
    read = (P * S * (3 + 1 + 1) + P * (3 + 1 + 3 + 3 + 3 * N_SH)
            + env_h * env_w * 3 + (9 if transform else 0)) * F32
    written = P * (6 * 3 + 1) * F32
    return read + written, P * S * K6_OPS


def vgg_ops(H: int, W: int) -> int:
    """FP32 operations of one image through LPIPS's VGG16 to relu5_3: a
    multiply-add a tap of each 3x3 convolution, and its bias and relu."""
    ops, c_in, h, w = 0, 3, H, W
    for item in VGG16:
        if item == "M":
            h, w = h // 2, w // 2
            continue
        ops += 2 * c_in * item * 9 * h * w + 2 * item * h * w
        c_in = item
    return ops


def score_ops(H: int, W: int) -> int:
    """The seven scores' FP32 work: LPIPS's four images through VGG16 and
    both SSIMs' separable 11-tap blur of their 5 stacked moments of 6
    channels (the PSNRs and MSE are a few operations a pixel)."""
    return 4 * vgg_ops(H, W) + 2 * work.conv_ops(5 * 6, H, W, 11)


def view_ops(P: int, S: int, walked: int, blended: int, A: int, H: int,
             W: int) -> int:
    """The FP32 work of one scored view: the projection, K1's walk at A
    attributes, K6's shading and the scores."""
    return (P * work.PROJECTION_OPS + walked * work.WALK_OPS
            + blended * work.k1_blend_ops(A) + P * S * K6_OPS
            + score_ops(H, W))
