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


# the float64 replay of given blend decisions (chip_smoke.py's k2-split)

def test_replay_of_the_plain_walk_matches_the_jax_vjp():
    """Every pixel replayed in float64 over the plain walk's decisions: the
    image and the VJP against JAX's composite (float32) to 1e-5 of each
    field's largest entry. The inputs overflow nothing, and JAX's walk and
    the plain walk blend the same pairs: counts equal everywhere, final T
    1 - JAX's opacity channel."""
    import jax
    import jax.numpy as jnp
    from relightable3dgaussian_tpu.ops import composite as jax_composite

    prep, op, attrs, cfg_j, binning_j, binning_t = composite_inputs()
    assert int(binning_j.overflow_pairs) == int(binning_j.overflow_chunks) == 0
    cfg = RasterConfig(SIZE, SIZE)
    A = attrs.shape[1]
    g_img = np.random.default_rng(8).normal(
        size=(cfg.num_tiles, 256, A)).astype(F32)

    def f(mean2d, conic, opacity, at):
        return jax_composite.composite(binning_j, mean2d, conic, opacity, at,
                                       cfg_j)

    want, vjp = jax.vjp(lambda *x: f(*x).image, prep.mean2d, prep.conic,
                        jnp.asarray(op), jnp.asarray(attrs))
    want_g = jax.jit(vjp)(jnp.asarray(g_img))
    n_contrib = np.asarray(jax.jit(lambda: f(
        prep.mean2d, prep.conic, jnp.asarray(op), jnp.asarray(attrs)))().n_contrib)

    inputs = (t(prep.mean2d), t(prep.conic), t(op), t(attrs))
    pixels = torch.arange(cfg.num_tiles * 256)
    dec = composite.blend_decisions(binning_t, *inputs[:3], pixels, cfg)
    np.testing.assert_array_equal(dec.n_contrib.numpy(), n_contrib.ravel())
    np.testing.assert_allclose(dec.final_T.numpy(),
                               1.0 - np.asarray(want)[..., -1].ravel(),
                               atol=2e-5)
    assert int(dec.n_contrib.max()) > 5
    image = composite.replay(binning_t, *(x.double() for x in inputs), pixels,
                             dec.codes, cfg)
    np.testing.assert_allclose(image.numpy(), np.asarray(want).reshape(-1, A),
                               atol=1e-5)
    got = composite.replay_backward(binning_t, *inputs, pixels, dec.codes,
                                    t(g_img).reshape(-1, A), cfg)
    for name, g, w in zip(("mean2d", "conic", "opacity", "attrs"), got,
                          want_g):
        assert g.dtype == torch.float64
        w = np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-5,
                                   err_msg=name)


def test_replay_follows_the_decisions_it_is_given():
    """crossing's tile with X at the float32 1/255 exactly: the plain walk
    blends X at pixel (5, 7) and ends at Y2 (codes 1, 2, 1, 0; Y1 at the
    0.99 cap); given the decisions of the walk without X (0, 2, 1, 1), the
    replay skips X and blends Y3, as it does on the inputs with X one ulp
    below 1/255, and X's opacity gets no gradient. Y1, at the cap, gets
    none from either."""
    on = F32(1 / 255)
    off = np.nextafter(on, F32(0))
    cfg = RasterConfig(16, 16)
    pixel = torch.tensor([7 * 16 + 5])

    def case(op_x):
        t1 = F32(1) - F32(0.99)
        ops = np.array([op_x, 0.99, 1 - 1.002e-4 / t1, 0.5], F32)
        binning = Binning(torch.arange(4, dtype=torch.int32),
                          torch.tensor([0], dtype=torch.int32),
                          torch.tensor([4], dtype=torch.int32), 4)
        attrs = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [2.0, 3.0]])
        return (binning, torch.tensor([[5.0, 7.0]] * 4),
                torch.tensor([[1.0, 0.0, 1.0]] * 4), torch.from_numpy(ops),
                attrs)

    args_on, args_off = case(on), case(off)
    dec_on = composite.blend_decisions(*args_on[:4], pixel, cfg)
    dec_off = composite.blend_decisions(*args_off[:4], pixel, cfg)
    assert dec_on.codes.tolist() == [[1, 2, 1, 0]]
    assert dec_off.codes.tolist() == [[0, 2, 1, 1]]
    assert (int(dec_on.stop[0]), int(dec_off.stop[0])) == (3, 4)

    def replay(args, codes):
        return composite.replay(args[0], *(x.double() for x in args[1:]),
                                pixel, codes, cfg)

    given = replay(args_on, dec_off.codes)
    assert torch.equal(given, replay(args_off, dec_off.codes))
    assert not torch.allclose(given, replay(args_on, dec_on.codes))
    g = torch.ones((1, 2), dtype=torch.float64)
    for codes, x_moves in ((dec_off.codes, False), (dec_on.codes, True)):
        _, _, g_op, _ = composite.replay_backward(*args_on, pixel, codes, g,
                                                  cfg)
        assert (float(g_op[0]) != 0.0) == x_moves
        assert float(g_op[1]) == 0.0


def test_blend_decisions_wrapper_runs_the_plain_walk_on_cpu():
    """composite_cuda.blend_decisions on CPU tensors is the plain walk's:
    its state at the pixels asked is walk_state's and its counts the
    plain compositor's."""
    from relightable3dgaussian_tpu_torch.ops import composite_cuda
    binning, mean2d, conic, op, cfg = deep_tiles(5, P=300)
    args = (binning, t(mean2d), t(conic), t(op))
    pixels = torch.tensor([0, 17, 255, 256 + 40, cfg.num_tiles * 256 - 1])
    got = composite_cuda.blend_decisions(*args, pixels, cfg)
    walk = composite.walk_state(*args, cfg)
    out = composite.composite(*args, torch.ones((300, 1)), cfg)
    assert torch.equal(got.final_T, walk.final_T.flatten()[pixels])
    assert torch.equal(got.stop, walk.stop.flatten()[pixels])
    assert torch.equal(got.n_contrib, out.n_contrib.flatten()[pixels])
    assert got.codes.shape == (5, 300)
    assert bool((got.codes[:, got.stop.max():] == 0).all())
