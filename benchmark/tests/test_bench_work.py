"""The yardstick's counts against hand-worked cases."""
import pytest

from benchmark import work


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_k1_counts_one_tile_by_hand():
    # P = 2 gaussians, 3 pairs, 1 tile, A = 9; 256 pixels walk 2 pairs each
    # and blend 1: inputs 3*4 + 2*4 + 2*(2+3+1+9)*4 = 140 bytes; outputs
    # 256 px x (9 + 3) x 4 + the 2 weights x 4 = 12296 bytes.
    n_bytes, ops = work.k1_work(2, 3, 1, 9, walked=512, blended=256)
    assert n_bytes == 140 + 12296
    assert ops == 512 * 15 + 256 * (3 + 18)


def test_k2_counts_one_tile_by_hand():
    # inputs 140; walk state and image cotangent 256 x (2 + 9) x 4 = 11264;
    # weight cotangent 8; gradients 2 x (2+3+1+9) x 4 = 120.
    n_bytes, ops = work.k2_work(2, 3, 1, 9, walked=512, blended=256)
    assert n_bytes == 140 + 11264 + 8 + 120
    assert ops == 512 * 15 + 256 * (27 + 27)


def test_k4_counts_by_hand():
    # P = 1, S = 2: per sample 8 floats read twice (64 B a sample), per
    # point 58 floats read twice, 9 outputs and 9 cotangents, 55 per-point
    # gradients, 3 floats of light gradient a sample.
    n_bytes, ops = work.k4_work(1, 2)
    per_sample, per_point = 8 * 4, 58 * 4
    assert n_bytes == (2 * (2 * per_sample + per_point + 36)
                       + 55 * 4 + 2 * 12)
    assert ops == 2 * (220 + 660)


def test_loss_ops_count_the_blur_and_the_sobel_filters():
    # 1x1 image, 3 SSIM channels, no edge term: 2 passes of 15 channels x
    # 11 taps x 2 flops, forward and backward (x3).
    assert work.loss_ops(1, 1, 3, 0) == 3 * 2 * 2 * 15 * 11
    assert work.loss_ops(1, 1, 3, 3) == 3 * (2 * 2 * 15 * 11 + 2 * 2 * 6 * 9)


def test_step_and_frame_ops_add_their_pieces():
    ops = work.step_ops(P=10, n_params=100, walked=50, blended=20, A=9,
                        H=1, W=1, ssim_channels=3, edge_channels=0)
    assert ops == (3 * 10 * work.PROJECTION_OPS + 50 * 15 + 20 * 21
                   + 50 * 15 + 20 * 54 + work.loss_ops(1, 1, 3, 0)
                   + 100 * work.ADAM_OPS)
    assert work.frame_ops(10, 50, 20, 32, S=4) == (
        10 * work.PROJECTION_OPS + 50 * 15 + 20 * 67 + 10 * 4 * 220)
