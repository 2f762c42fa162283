"""The yardstick's arithmetic: the H100's published peaks, the least time a
piece of work can take on them, and the bytes and FP32 operations of each
kernel and of a whole step or frame, counted from shapes and from the
reference walk's pairs (never from what a kernel reports of itself).

Peaks: NVIDIA's H100 SXM data sheet at its 700 W limit, dense FP32 outside
the tensor cores and HBM3; the card's own power limit is printed beside
every reading. A roofline share is bound_s(bytes, ops) / device seconds: each
input byte read once, each output byte written once, and the operations the
inputs need.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
F32 = I32 = 4

# Operations per (pixel, pair) of the compositor, counted from its alpha
# step (csrc/composite_step.cuh): dx, dy, the power's 3 products and 2 sums
# and its scale, expf, the alpha product, its clamp and the two tests: 15.
# A blended pair adds in the forward w = alpha T, T's update and A
# multiply-adds (3 + 2A); in the backward the T division, w, the 2A of the
# colour suffix, the chain through alpha into the 6 geometry gradients and
# the A attribute gradients (27 + 3A).
WALK_OPS = 15


def k1_blend_ops(A: int) -> int:
    return 3 + 2 * A


def k2_blend_ops(A: int) -> int:
    return 27 + 3 * A


# K4 (csrc/shading.cu) per (point, sample), counted from the plain shading's
# formula: the incident-light SH of degree 3 (16 basis terms and 3 x 16
# multiply-adds, 126), the environment mix, half vector and dots (38), GGX
# and Fresnel (40), Lambert and the sums (16): 220; the backward recomputes
# the forward and chains back through it, 3x.
K4_FWD_OPS = 220
K4_BWD_OPS = 660

# Per gaussian of the projection (ops/projection.py): the covariance from
# scale and quaternion (quaternion to matrix 24, R S 9, (RS)(RS)^T 45), the
# view and clip transforms (2 x 28), the EWA Jacobian and its clamps (16),
# T = J W (30), T Σ T^T (2x3x3 by 3x3 45, by 3x2 30), the conic and radius
# (20), the pixel mean (8), the SH colour of degree 3 (basis 30, 3 x 16
# multiply-adds 96, direction 9): 469. Its backward: 2x.
PROJECTION_OPS = 469

# Adam per parameter element: two moment updates (3 + 4), the square root,
# the bias-corrected step and the update (4): 12.
ADAM_OPS = 12


def bound_s(n_bytes: float, ops: float) -> float:
    """The least seconds the H100 could take to move `n_bytes` and do `ops`
    FP32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def compositor_in_bytes(P: int, pairs: int, tiles: int, A: int) -> int:
    """K1's and K2's common inputs: the pair list, the tile ranges, mean2d,
    conic, opacity and the attributes."""
    return (pairs * I32 + 2 * tiles * I32
            + P * (2 + 3 + 1 + A) * F32)


def k1_work(P: int, pairs: int, tiles: int, A: int, walked: int,
            blended: int, weights: bool = True) -> tuple[int, int]:
    """(bytes, ops) of one forward: the inputs; the image, counts, final T
    and stop of every pixel and (in training) the weights written."""
    px = tiles * 256
    n_bytes = (compositor_in_bytes(P, pairs, tiles, A)
               + px * (A + 3) * F32 + (P * F32 if weights else 0))
    return n_bytes, walked * WALK_OPS + blended * k1_blend_ops(A)


def k2_work(P: int, pairs: int, tiles: int, A: int, walked: int,
            blended: int) -> tuple[int, int]:
    """(bytes, ops) of one backward: the inputs, the walk state, the image
    and weight cotangents read; the four input gradients written."""
    px = tiles * 256
    n_bytes = (compositor_in_bytes(P, pairs, tiles, A)
               + px * (2 + A) * F32 + P * F32
               + P * (2 + 3 + 1 + A) * F32)
    return n_bytes, walked * WALK_OPS + blended * k2_blend_ops(A)


def k4_work(P: int, S: int, n_sh: int = 16) -> tuple[int, int]:
    """(bytes, ops) of K4's forward, backward and fix-up on one train step:
    per sample directions, visibility, area and global light read by each;
    per point base colour, roughness, normal, view direction and the local
    SH read by each; the forward's three [P, 3] outputs and their
    cotangents; the backward's per-point gradients and the light's per
    sample gradient written."""
    per_sample = (3 + 1 + 1 + 3) * F32
    per_point = (3 + 1 + 3 + 3 + 3 * n_sh) * F32
    fwd = P * S * per_sample + P * per_point + P * 9 * F32
    bwd = (P * S * per_sample + P * per_point + P * 9 * F32
           + P * (3 + 1 + 3 + 3 * n_sh) * F32 + P * S * 3 * F32)
    return fwd + bwd, P * S * (K4_FWD_OPS + K4_BWD_OPS)


def conv_ops(channels: int, H: int, W: int, taps: int) -> int:
    """A depthwise same-size convolution: one multiply-add a tap a pixel."""
    return 2 * channels * H * W * taps


def loss_ops(H: int, W: int, ssim_channels: int, edge_channels: int) -> int:
    """The loss's convolutions, forward and backward (2x): the separable
    11-tap SSIM blur of its 5 stacked moments, and the two 3x3 Sobel
    filters of each edge-aware term's data and guide."""
    ssim = 2 * conv_ops(5 * ssim_channels, H, W, 11)
    edge = 2 * conv_ops(edge_channels + 3, H, W, 9) if edge_channels else 0
    return 3 * (ssim + edge)


def step_ops(P: int, n_params: int, walked: int, blended: int, A: int,
             H: int, W: int, ssim_channels: int, edge_channels: int,
             S: int = 0) -> int:
    """The FP32 work of one train step: the projection and its backward,
    both compositor walks, the loss's convolutions, K4 where S > 0, and
    Adam over every parameter element."""
    ops = 3 * P * PROJECTION_OPS
    ops += walked * WALK_OPS + blended * k1_blend_ops(A)
    ops += walked * WALK_OPS + blended * k2_blend_ops(A)
    ops += loss_ops(H, W, ssim_channels, edge_channels)
    ops += P * S * (K4_FWD_OPS + K4_BWD_OPS)
    return ops + n_params * ADAM_OPS


def frame_ops(P: int, walked: int, blended: int, A: int,
              S: int = 0) -> int:
    """The FP32 work of one rendered frame: the projection, the forward
    walk and, where S > 0, the eval shading (K4's forward count a
    sample)."""
    return (P * PROJECTION_OPS + walked * WALK_OPS
            + blended * k1_blend_ops(A) + P * S * K4_FWD_OPS)
