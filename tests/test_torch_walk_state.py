"""The plain compositor's walk state (final T and stop, in kernel K1's terms)
and the split-pixel detector that chip_smoke.py's K1 and K2 gates use, on
the CPU: the walk state against the JAX compositor's image and a pixel by
pixel float32 walk in numpy, and the detector on a constructed alpha = 1/255
crossing that leaves the counts equal."""
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu_torch.ops import composite
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.tiles import Binning
from test_torch_ops import SIZE, composite_inputs, t

F32 = np.float32


def numpy_walk(binning, mean2d, conic, opacity, cfg):
    """Each pixel's front-to-back walk in float32, one pair at a time:
    (final T, stop) as K1 defines them."""
    starts, ends = binning.tile_start.numpy(), binning.tile_end.numpy()
    ids = binning.sorted_ids.numpy()
    final_T = np.ones((cfg.num_tiles, 256), F32)
    stop = np.zeros((cfg.num_tiles, 256), np.int32)
    p = np.arange(256)
    for tile in range(cfg.num_tiles):
        px = F32(tile % cfg.tiles_x * 16) + (p % 16).astype(F32)
        py = F32(tile // cfg.tiles_x * 16) + (p // 16).astype(F32)
        T = np.ones(256, F32)
        done = np.zeros(256, bool)
        stop[tile] = ends[tile] - starts[tile]
        for k, g in enumerate(ids[starts[tile]:ends[tile]]):
            dx, dy = mean2d[g, 0] - px, mean2d[g, 1] - py
            a, b, c = conic[g]
            power = F32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = np.minimum(F32(0.99), opacity[g] * np.exp(
                np.minimum(power, F32(0))))
            blend = ~done & (power <= 0) & (alpha >= F32(1 / 255))
            T = np.where(blend, T * (F32(1) - alpha), T).astype(F32)
            ended = blend & (T < F32(1e-4))
            stop[tile][ended] = k + 1
            done |= ended
        final_T[tile] = T
    return final_T, stop


def deep_tiles(seed: int, P: int = 2000, size: int = 32):
    """Every tile's range holds all P gaussians (means over the image and 2
    pixels around it, widths 0.6-2.5 pixels at random angles, opacities in
    [0.05, 0.99]), so most pixels end at T < 1e-4 inside the range."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(-2.0, size + 2.0, (P, 2)).astype(F32)
    sig = rng.uniform(0.6, 2.5, (P, 2))
    th = rng.uniform(0.0, np.pi, P)
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], -2)
    inv = np.linalg.inv(rot @ (np.eye(2) * (sig ** 2)[:, None, :])
                        @ rot.transpose(0, 2, 1))
    cfg = RasterConfig(size, size)
    n = cfg.num_tiles
    binning = Binning(torch.from_numpy(np.tile(np.arange(P), n).astype(np.int32)),
                      torch.from_numpy((np.arange(n) * P).astype(np.int32)),
                      torch.from_numpy(((np.arange(n) + 1) * P).astype(np.int32)),
                      n * P)
    return (binning, mean, inv[:, [0, 0, 1], [0, 1, 1]].astype(F32),
            rng.uniform(0.05, 0.99, P).astype(F32), cfg)


def test_walk_state_matches_a_pixel_walk():
    """Stops equal the numpy walk's on every pixel, final T to 1e-5 of
    itself (the products rounded in another order)."""
    binning, mean2d, conic, op, cfg = deep_tiles(3)
    got = composite.walk_state(binning, t(mean2d), t(conic), t(op), cfg)
    want_T, want_stop = numpy_walk(binning, mean2d, conic, op, cfg)
    assert float((want_stop < 2000).mean()) > 0.5, "pixels must end inside"
    np.testing.assert_array_equal(got.stop.numpy(), want_stop)
    np.testing.assert_allclose(got.final_T.numpy(), want_T, rtol=1e-5, atol=0)


def test_walk_state_final_T_is_one_minus_the_jax_opacity():
    """The JAX compositor's blended opacity channel is 1 - final T
    (telescoping), to 2e-5; pixels no pair reaches keep T = 1, stop 0."""
    import jax
    import jax.numpy as jnp
    from relightable3dgaussian_tpu.ops import composite as jax_composite

    prep, op, attrs, cfg_j, binning_j, binning_t = composite_inputs()
    got = composite.walk_state(binning_t, t(prep.mean2d), t(prep.conic),
                               t(op), RasterConfig(SIZE, SIZE))
    image = jax.jit(lambda: jax_composite.composite(
        binning_j, prep.mean2d, prep.conic, jnp.asarray(op),
        jnp.asarray(attrs), cfg_j).image)()
    np.testing.assert_allclose(got.final_T.numpy(),
                               1.0 - np.asarray(image)[..., -1], atol=2e-5)
    lengths = (binning_t.tile_end - binning_t.tile_start).numpy()
    np.testing.assert_array_equal(got.stop.numpy(), np.broadcast_to(
        lengths[:, None], got.stop.shape))


def crossing(op_x: float):
    """One 16x16 tile and four gaussians centred on pixel (5, 7), in depth
    order: X at opacity op_x, then Y1 at 0.99, Y2 that leaves T at 1.002e-4
    and Y3 at 0.5. X's alpha there is op_x (power 0) and below 1/255 at
    every other pixel. With X blended, T falls under 1e-4 at Y2; without
    it, at Y3: three pairs blended either way."""
    t1 = F32(1) - F32(0.99)
    ops = np.array([op_x, 0.99, 1 - 1.002e-4 / t1, 0.5], F32)
    P = ops.shape[0]
    cfg = RasterConfig(16, 16)
    binning = Binning(torch.arange(P, dtype=torch.int32),
                      torch.tensor([0], dtype=torch.int32),
                      torch.tensor([P], dtype=torch.int32), P)
    mean2d = torch.tensor([[5.0, 7.0]] * P)
    conic = torch.tensor([[1.0, 0.0, 1.0]] * P)
    args = (binning, mean2d, conic, torch.from_numpy(ops))
    out = composite.composite(*args, torch.ones((P, 1)), cfg)
    return out.n_contrib, composite.walk_state(*args, cfg)


def test_split_pixels_finds_a_count_equal_crossing():
    """X at the float32 1/255 blends, one ulp below it does not: the counts
    stay equal at pixel (5, 7), so a count mask misses it; the detector
    flags that pixel and no other."""
    on = F32(1 / 255)
    off = np.nextafter(on, F32(0))
    n_on, walk_on = crossing(on)
    n_off, walk_off = crossing(off)
    pixel = 7 * 16 + 5
    assert torch.equal(n_on, n_off)
    assert int(n_on[0, pixel]) == 3
    assert (int(walk_on.stop[0, pixel]), int(walk_off.stop[0, pixel])) == (3, 4)
    split = composite.split_pixels(n_on, walk_on, n_off, walk_off)
    assert torch.nonzero(split).tolist() == [[0, pixel]]
    assert not bool(composite.split_pixels(n_on, walk_on, n_on, walk_on).any())


@pytest.mark.parametrize("field", ["count", "stop", "final_T"])
def test_split_pixels_reads_each_field(field):
    """Each of the three marks a pixel alone: a count one apart, a stop one
    apart, a final T moved by 2e-3 of itself (and not by 5e-4)."""
    n = torch.full((2, 256), 5, dtype=torch.int32)
    walk = composite.WalkState(torch.full((2, 256), 0.5),
                               torch.full((2, 256), 9, dtype=torch.int32))
    n2, T2, stop2 = n.clone(), walk.final_T.clone(), walk.stop.clone()
    T2[0, 1] *= 1 + 5e-4
    if field == "count":
        n2[1, 3] += 1
    elif field == "stop":
        stop2[1, 3] -= 1
    else:
        T2[1, 3] *= 1 - 2e-3
    split = composite.split_pixels(n2, composite.WalkState(T2, stop2), n, walk)
    assert torch.nonzero(split).tolist() == [[1, 3]]
