"""Kernels K1 to K5 on the card against their plain PyTorch versions, and
the card's stage-1 and stage-2 train steps against the CPU's.

Needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; skips without one. These tests
import no jax, so on a machine without it run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu_torch.models import render_neilf
from relightable3dgaussian_tpu_torch.models.gaussians import (PBR_FIELDS,
                                                              GaussianModel)
from relightable3dgaussian_tpu_torch.models.lights import DirectLightMap
from relightable3dgaussian_tpu_torch.models.render import render, view_features
from relightable3dgaussian_tpu_torch.models.render import ViewInputs
from relightable3dgaussian_tpu_torch.ops import (_build, composite_cuda,
                                                 ray_trace, ray_trace_cuda,
                                                 shading_cuda)
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.composite import composite as composite_plain
from relightable3dgaussian_tpu_torch.ops.composite import (composite_backward,
                                                          split_pixels,
                                                          walk_state)
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.rasterize import prepare
from relightable3dgaussian_tpu_torch.ops.tiles import Binning
from relightable3dgaussian_tpu_torch.train import stage2
from relightable3dgaussian_tpu_torch.train.checkpoint import (
    load_checkpoint, load_env_checkpoint, load_train_state,
    save_checkpoint, save_env_checkpoint)
from relightable3dgaussian_tpu_torch.train.config import (STAGE1_NERF_SYNTHETIC,
                                                          STAGE2_NERF_SYNTHETIC,
                                                          OptimizationConfig)
from relightable3dgaussian_tpu_torch.train.optim import (learning_rates,
                                                         make_env_optimizer,
                                                         make_optimizer,
                                                         start_state)
from relightable3dgaussian_tpu_torch.train.stage1 import train_step
from relightable3dgaussian_tpu_torch.utils import trace
from relightable3dgaussian_tpu_torch.utils.graphics import \
    fibonacci_sphere_sampling

pytestmark = pytest.mark.cuda
SIZE = 128
# The card's train step against the CPU's, per gradient field and
# accumulated stat (max_rel_err): the CPU path alone moves its gradients by up
# to half of this when its inputs change in the last bits
# (test_torch_train.py::test_train_step_gradients_under_a_last_bit_input_change),
# and the card rounds the forward differently.
GRAD_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def scene(seed: int, n: int = 3000) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    op = rng.uniform(0.1, 0.99, (n, 1))
    return {"xyz": rng.uniform(-1.0, 1.0, (n, 3)).astype(f32),
            "normal": rng.normal(size=(n, 3)).astype(f32),
            "shs_dc": rng.normal(size=(n, 1, 3)).astype(f32),
            "shs_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(f32),
            "scaling": np.log(rng.uniform(0.01, 0.08, (n, 3))).astype(f32),
            "rotation": rng.normal(size=(n, 4)).astype(f32),
            "opacity": np.log(op / (1 - op)).astype(f32)}


def view(device, h: int = SIZE, w: int = SIZE) -> ViewInputs:
    cam = make_camera_params(np.eye(3), np.array([0.0, 0.0, 3.0]), w, h,
                             fovx=0.9, fovy=0.9 * h / w, device=device)
    z = torch.zeros((3, h, w), device=device)
    return ViewInputs(cam=cam, image=z, image_mask=z[:1] + 1, depth=z[:1],
                      normal=z)


def k1_args(device, n_features: int, weights: bool = True, seed: int = 0):
    model = GaussianModel.from_numpy(scene(seed), device=device)
    cam = view(device).cam
    feats = view_features(model, cam)
    extra = torch.randn((model.num_points, max(n_features - 4, 0)),
                        generator=torch.Generator().manual_seed(seed)).to(device)
    feats = torch.cat([feats, extra], 1)[:, :n_features]
    cfg = RasterConfig(SIZE, SIZE, compute_weights=weights)
    prep, binning, attrs = prepare(
        model.xyz, model.get_scaling, model.get_rotation, model.get_opacity,
        model.get_shs, feats, cam, cfg)
    return (binning, prep.mean2d, prep.conic,
            model.get_opacity[:, 0].contiguous(), attrs, cfg)


@torch.no_grad()
@pytest.mark.parametrize("n_features", [4, 3, 1, 27])   # A = 9, 8, 6, 32
@pytest.mark.parametrize("weights", [True, False])
def test_k1_matches_plain(cuda, n_features, weights):
    args = k1_args(cuda, n_features, weights)
    got, walk = composite_cuda.composite_k1(*args)
    torch.cuda.synchronize()
    want = composite_plain(*args)
    agree = got.n_contrib == want.n_contrib
    # alpha = 1/255 and T = 1e-4 are threshold crossings a rounding change
    # can move; the image is compared where the counts agree.
    assert float(agree.float().mean()) >= 0.9999
    torch.testing.assert_close(got.image[agree], want.image[agree],
                               atol=1e-5, rtol=1e-5)
    # per-gaussian sums: the atomics add in another order
    torch.testing.assert_close(got.weights, want.weights, rtol=1e-4, atol=1e-6)
    assert int(got.n_contrib.max()) > 10


@torch.no_grad()
@pytest.mark.parametrize("h,w", [(SIZE, SIZE), (100, 120)])
def test_render_on_cuda_launches_k1_and_matches_cpu(cuda, h, w):
    d = scene(1)
    cfg = RasterConfig(h, w)
    before = trace.counter("k1.launches")
    gpu = render(view(cuda, h, w), GaussianModel.from_numpy(d, device=cuda),
                 cfg, torch.zeros(3, device=cuda))
    assert trace.counter("k1.launches") == before + 1
    assert gpu["render"].shape == (3, h, w)
    cpu = render(view("cpu", h, w), GaussianModel.from_numpy(d, device="cpu"),
                 cfg, torch.zeros(3))
    assert trace.counter("k1.launches") == before + 1
    agree = gpu["num_contrib"].cpu() == cpu["num_contrib"]
    assert float(agree.float().mean()) >= 0.999
    torch.testing.assert_close(gpu["render"].cpu()[:, agree],
                               cpu["render"][:, agree], atol=2e-5, rtol=0)


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|: gradients are sums over pixels, added by
    atomics in a run-dependent order, so they are compared per field
    relative to the field's largest entry."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-12))


@torch.no_grad()
@pytest.mark.parametrize("n_features", [4, 3, 1, 27])   # A = 9, 8, 6, 32
@pytest.mark.parametrize("with_g_weights", [True, False])
def test_k2_matches_plain(cuda, n_features, with_g_weights):
    """K2 from K1's walk state against the plain backward, on a scene with
    opacities up to 0.99 (where the division by 1 - alpha is worst). 1e-4 of
    the largest entry: K2 decides 'blended' by K1's stop index, the plain
    version by its own T >= 1e-4 test, and the two differ only where a
    last-bit change moves a crossing (a pair at T ~ 1e-4)."""
    binning, mean2d, conic, opacity, attrs, cfg = k1_args(cuda, n_features)
    out, walk = composite_cuda.composite_k1(binning, mean2d, conic, opacity,
                                            attrs, cfg)
    # telescoping: the blended opacity channel is 1 - the final T
    torch.testing.assert_close(walk.final_T, 1.0 - out.image[..., -1],
                               atol=1e-5, rtol=0)
    gen = torch.Generator().manual_seed(n_features)
    g_image = torch.randn(out.image.shape, generator=gen).to(cuda)
    g_weights = (torch.randn((attrs.shape[0],), generator=gen).to(cuda)
                 if with_g_weights else None)
    before = trace.counter("k2.launches")
    got = composite_cuda.composite_k2(binning, mean2d, conic, opacity, attrs,
                                      walk, g_image, g_weights, cfg)
    torch.cuda.synchronize()
    assert trace.counter("k2.launches") == before + 1
    want = composite_backward(binning, mean2d, conic, opacity, attrs,
                              g_image, g_weights, cfg)
    for name, g, w in zip(("mean2d", "conic", "opacity", "attrs"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert max_rel_err(g, w) <= 1e-4, (name, max_rel_err(g, w))


def deep_tiles(device, A: int, seed: int, P: int = 2000):
    """2x2 tiles whose every range holds all P gaussians (no cull): means
    over the image and 2 pixels around it, widths 0.6-2.5 pixels at random
    angles, opacities in [0.05, 0.99]. Pixels blend 40-100 of the 2000 pairs
    and stop between pairs ~400 and ~2000, so a walk crosses more than 4
    batches and the two pixels of a thread stop at different pairs."""
    rng = np.random.default_rng(seed)
    size = 32
    mean = rng.uniform(-2.0, size + 2.0, (P, 2))
    sig = rng.uniform(0.6, 2.5, (P, 2))
    th = rng.uniform(0.0, np.pi, P)
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], -2)
    inv = np.linalg.inv(rot @ (np.eye(2) * (sig ** 2)[:, None, :])
                        @ rot.transpose(0, 2, 1))
    cfg = RasterConfig(size, size)
    T = cfg.num_tiles

    def f(x, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(x), dtype=dtype,
                            device=device)

    binning = Binning(f(np.tile(np.arange(P), T), torch.int32),
                      f(np.arange(T) * P, torch.int32),
                      f((np.arange(T) + 1) * P, torch.int32), T * P)
    return (binning, f(mean), f(inv[:, [0, 0, 1], [0, 1, 1]]),
            f(rng.uniform(0.05, 0.99, P)), f(rng.normal(size=(P, A))), cfg)


@torch.no_grad()
@pytest.mark.parametrize("A", [9, 8])
def test_k1_and_k2_deep_tiles(cuda, A):
    """K1 and K2 against their plain versions where every pixel walks more
    than 4 batches of pairs and neighbouring pixels stop at different pairs
    inside one batch: the gates of test_k1_matches_plain and
    test_k2_matches_plain, the image cotangent zeroed where K1's and the
    plain n_contrib differ (as k5_case does)."""
    args = deep_tiles(cuda, A, seed=A)
    got, walk = composite_cuda.composite_k1(*args)
    torch.cuda.synchronize()
    want = composite_plain(*args)
    # a thread's pixels: (x, y) and (x ^ 1, y + 1), y even
    stop = walk.stop.view(-1, 8, 2, 16)          # [tile, y / 2, y % 2, x]
    partner = stop[:, :, 1][..., torch.arange(16, device=cuda) ^ 1]
    assert float((walk.stop > 4 * 128).float().mean()) > 0.9
    assert float((stop[:, :, 0] != partner).float().mean()) > 0.5
    agree = got.n_contrib == want.n_contrib
    assert float(agree.float().mean()) >= 0.999
    torch.testing.assert_close(got.image[agree], want.image[agree],
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got.weights, want.weights, rtol=1e-4, atol=1e-6)
    gen = torch.Generator().manual_seed(A)
    g_image = torch.randn(got.image.shape, generator=gen).to(cuda) * agree[..., None]
    g_weights = torch.randn((args[4].shape[0],), generator=gen).to(cuda)
    binning, mean2d, conic, opacity, attrs, cfg = args
    k2 = composite_cuda.composite_k2(binning, mean2d, conic, opacity, attrs,
                                     walk, g_image, g_weights, cfg)
    plain = composite_backward(binning, mean2d, conic, opacity, attrs,
                               g_image, g_weights, cfg)
    for name, g, w in zip(("mean2d", "conic", "opacity", "attrs"), k2, plain):
        assert bool(torch.isfinite(g).all()), name
        assert max_rel_err(g, w) <= 1e-4, (name, max_rel_err(g, w))


def k5_case(cuda, n_features: int, with_g_weights: bool):
    """K1's inputs and walk state, K1's and the plain n_contrib, and seeded
    cotangents: the image cotangent zero on pixels where the two counts
    differ (a last-bit change moved a T >= 1e-4 crossing there, which moves
    a gradient of the plain version and not of K1's or K5's decisions)."""
    args = k1_args(cuda, n_features)
    out, walk = composite_cuda.composite_k1(*args)
    agree = out.n_contrib == composite_plain(*args).n_contrib
    assert float(agree.float().mean()) >= 0.9999
    gen = torch.Generator().manual_seed(n_features + 17)
    g_image = torch.randn(out.image.shape, generator=gen).to(cuda) * agree[..., None]
    g_weights = (torch.randn((args[4].shape[0],), generator=gen).to(cuda)
                 if with_g_weights else None)
    return args, out, walk, g_image, g_weights


@torch.no_grad()
@pytest.mark.parametrize("n_features", [4, 3, 1, 27])   # A = 9, 8, 6, 32
@pytest.mark.parametrize("with_g_weights", [True, False])
def test_k5_matches_plain_and_k2(cuda, n_features, with_g_weights):
    """K5, the two-walk backward, against the plain backward and against K2
    on the same inputs (opacities up to 0.99): per field within 1e-4 of the
    largest entry, the sums over pixels taken in another order."""
    args, out, walk, g_image, g_weights = k5_case(cuda, n_features,
                                                  with_g_weights)
    binning, mean2d, conic, opacity, attrs, cfg = args
    before = (trace.counter("k2.launches"), trace.counter("k5.launches"))
    got = composite_cuda.composite_k5(binning, mean2d, conic, opacity, attrs,
                                      g_image, g_weights, cfg)
    torch.cuda.synchronize()
    assert (trace.counter("k2.launches"),
            trace.counter("k5.launches")) == (before[0], before[1] + 1)
    want = composite_backward(binning, mean2d, conic, opacity, attrs,
                              g_image, g_weights, cfg)
    k2 = composite_cuda.composite_k2(binning, mean2d, conic, opacity, attrs,
                                     walk, g_image, g_weights, cfg)
    errs = {}
    for name, g, w, g2 in zip(("mean2d", "conic", "opacity", "attrs"), got,
                              want, k2):
        assert bool(torch.isfinite(g).all()), name
        errs[name] = (max_rel_err(g, w), max_rel_err(g2, w), max_rel_err(g, g2))
    print("K5 vs plain, K2 vs plain, K5 vs K2", errs)
    for name, (k5_plain, _, k5_k2) in errs.items():
        assert k5_plain <= 1e-4 and k5_k2 <= 1e-4, (name, errs[name])


@torch.no_grad()
@pytest.mark.parametrize("n_features", [4, 27])
def test_k5_blended_count_is_k1_n_contrib(cuda, n_features):
    """K5 rebuilds K1's blend decisions and per-pixel stop from the shared
    alpha step (csrc/composite_step.cuh) without reading them: its count of
    blended pairs equals K1's n_contrib on every pixel."""
    args, out, _, g_image, _ = k5_case(cuda, n_features, False)
    count = torch.full_like(out.n_contrib, -1)
    composite_cuda.composite_k5(*args[:5], g_image, None, args[5],
                                n_blended=count)
    torch.cuda.synchronize()
    assert int(out.n_contrib.max()) > 10
    assert torch.equal(count, out.n_contrib)


@torch.no_grad()
@pytest.mark.parametrize("A", [9, 8])
@pytest.mark.parametrize("with_g_weights", [True, False])
def test_k5_deep_and_empty_tiles(cuda, A, with_g_weights):
    """K5 against the plain backward and K2 where every pixel walks more
    than 4 batches and the two pixels of a thread stop at different pairs,
    with one tile's range empty: per field within 1e-4 of the largest
    entry, the image cotangent zeroed where K1 and the plain compositor
    blended other pairs (split_pixels); its blended count equals K1's
    n_contrib on every pixel, 0 on the empty tile."""
    binning, *inputs, cfg = deep_tiles(cuda, A, seed=A + 20)
    ends = binning.tile_end.clone()
    ends[1] = binning.tile_start[1]                 # tile 1 holds no pair
    binning = binning._replace(tile_end=ends)
    args = (binning, *inputs, cfg)
    out, walk = composite_cuda.composite_k1(*args)
    plain = composite_plain(*args)
    split = split_pixels(out.n_contrib, walk, plain.n_contrib,
                         walk_state(*args[:4], cfg))
    assert float(split.float().mean()) <= 1e-2
    gen = torch.Generator().manual_seed(A + 3)
    g_image = torch.randn(out.image.shape, generator=gen).to(cuda) * ~split[..., None]
    g_weights = (torch.randn((inputs[3].shape[0],), generator=gen).to(cuda)
                 if with_g_weights else None)
    count = torch.full_like(out.n_contrib, -1)
    got = composite_cuda.composite_k5(*args[:5], g_image, g_weights, cfg,
                                      n_blended=count)
    k2 = composite_cuda.composite_k2(*args[:5], walk, g_image, g_weights, cfg)
    want = composite_backward(*args[:5], g_image, g_weights, cfg)
    torch.cuda.synchronize()
    assert torch.equal(count, out.n_contrib)
    assert int(count[1].abs().max()) == 0 and int(count.max()) > 40
    for name, g, w, g2 in zip(("mean2d", "conic", "opacity", "attrs"), got,
                              want, k2):
        assert bool(torch.isfinite(g).all()), name
        assert max_rel_err(g, w) <= 1e-4, (name, max_rel_err(g, w))
        assert max_rel_err(g, g2) <= 1e-4, (name, max_rel_err(g, g2))


def crossing_case(device, op_x: float):
    """tests/test_torch_walk_state.py::crossing on `device`: one tile, four
    gaussians centred on pixel (5, 7); X at opacity op_x blends there only at
    the float32 1/255 and moves the T = 1e-4 end by one pair."""
    t1 = np.float32(1) - np.float32(0.99)
    ops = np.array([op_x, 0.99, 1 - 1.002e-4 / t1, 0.5], np.float32)
    P = ops.shape[0]
    f = lambda x, dtype=torch.float32: torch.tensor(x, dtype=dtype,  # noqa: E731
                                                    device=device)
    binning = Binning(f(np.arange(P), torch.int32), f([0], torch.int32),
                      f([P], torch.int32), P)
    return (binning, f([[5.0, 7.0]] * P), f([[1.0, 0.0, 1.0]] * P), f(ops),
            f(np.ones((P, 1))), RasterConfig(16, 16))


@torch.no_grad()
def test_split_pixels_flags_a_count_equal_crossing_of_k1(cuda):
    """chip_smoke.py's K1 gate on the card: K1 with X at the float32 1/255
    (blended) against the plain compositor with X one ulp below it: the
    counts are equal everywhere, and split_pixels flags pixel (5, 7) and no
    other; on the same inputs it flags nothing."""
    on = np.float32(1 / 255)
    off = np.nextafter(on, np.float32(0))
    k1_args_on = crossing_case(cuda, on)
    got, walk = composite_cuda.composite_k1(*k1_args_on)
    for op_x, flagged in ((off, [[0, 7 * 16 + 5]]), (on, [])):
        args = crossing_case(cuda, op_x)
        plain = composite_plain(*args)
        assert torch.equal(got.n_contrib, plain.n_contrib)
        split = split_pixels(got.n_contrib, walk, plain.n_contrib,
                             walk_state(*args[:4], args[-1]))
        assert torch.nonzero(split).tolist() == flagged


@torch.no_grad()
@pytest.mark.parametrize("A", [9, 8])
def test_blend_decisions_walk_is_k1s_on_every_pixel(cuda, A):
    """The check kernel's walk (csrc/composite_decisions.cu) on every pixel
    of deep tiles equals K1's walk state bitwise: final T, stop and count;
    its codes blend exactly the count, none past the stop."""
    binning, mean2d, conic, op, attrs, cfg = deep_tiles(cuda, A, seed=A + 40)
    out, walk = composite_cuda.composite_k1(binning, mean2d, conic, op, attrs,
                                            cfg)
    pixels = torch.arange(cfg.num_tiles * 256, device=cuda)
    dec = composite_cuda.blend_decisions(binning, mean2d, conic, op, pixels,
                                         cfg)
    assert torch.equal(dec.final_T, walk.final_T.flatten())
    assert torch.equal(dec.stop, walk.stop.flatten())
    assert torch.equal(dec.n_contrib, out.n_contrib.flatten())
    assert torch.equal((dec.codes > 0).sum(1).int(), dec.n_contrib)
    k = torch.arange(dec.codes.shape[1], device=cuda)
    assert not bool(((dec.codes > 0) & (k >= dec.stop[:, None])).any())
    assert int((dec.stop < 2000).sum()) > 0


def test_k2_matches_the_replay_of_k1s_decisions_at_split_pixels(cuda):
    """chip_smoke.py's k2-split on its forced input at 64x64: split pixels
    exist, the decisions' walk is K1's there, and K2 is within 1e-4 of each
    field's largest entry of the float64 replay of K1's decisions."""
    cs = chip_smoke_module()
    res = cs.check_k2_split(cs.forced_split_args(cuda, n=1000, size=64),
                            "forced", 5)
    assert res["pixels"] > 0
    assert res["max_rel_err"] <= 1e-4


def test_composite_function_takes_k5_under_the_switch(cuda, monkeypatch):
    """With R3DG_BWD_TWO_WALK=1 the autograd Function's backward launches K5
    and not K2, and gives autograd's gradients through the plain
    compositor."""
    monkeypatch.setenv("R3DG_BWD_TWO_WALK", "1")
    grads = []
    for device in (cuda, torch.device("cpu")):
        binning, *inputs, cfg = k1_args(device, 4)
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        out = composite_cuda.composite(binning, *leaves, cfg)
        w = torch.linspace(-1.0, 1.0, out.weights.numel(), device=device)
        before = (trace.counter("k2.launches"), trace.counter("k5.launches"))
        (out.image.square().sum() + (w * out.weights).sum()).backward()
        on_card = int(device.type == "cuda")
        assert (trace.counter("k2.launches"),
                trace.counter("k5.launches")) == (before[0],
                                                      before[1] + on_card)
        grads.append([x.grad.cpu() for x in leaves])
    for name, got, want in zip(("mean2d", "conic", "opacity", "attrs"),
                               *grads):
        assert max_rel_err(got, want) <= 1e-4, (name, max_rel_err(got, want))


@pytest.mark.parametrize("reads", ["image", "weights", "both"])
def test_composite_function_backward_matches_autograd(cuda, reads):
    """The autograd Function (K1, then K2) against autograd through the plain
    compositor, for a loss that reads the image, the weights or both: an
    output the loss does not read reaches K2 as a None cotangent."""
    grads = []
    for device in (cuda, torch.device("cpu")):
        binning, *inputs, cfg = k1_args(device, 4)
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        out = composite_cuda.composite(binning, *leaves, cfg)
        w = torch.linspace(-1.0, 1.0, out.weights.numel(), device=device)
        loss = ((out.image.square().sum() if reads != "weights" else 0.0)
                + ((w * out.weights).sum() if reads != "image" else 0.0))
        before = trace.counter("k2.launches")
        loss.backward()
        assert trace.counter("k2.launches") == before + (device.type == "cuda")
        grads.append([torch.zeros(x.shape) if x.grad is None  # unused
                      else x.grad.cpu() for x in leaves])
    for name, got, want in zip(("mean2d", "conic", "opacity", "attrs"),
                               *grads):
        if reads == "weights" and name == "attrs":
            assert float(got.abs().max()) == float(want.abs().max()) == 0.0
            continue
        assert float(want.abs().max()) > 0, name
        assert max_rel_err(got, want) <= 1e-4, (name, max_rel_err(got, want))


def test_render_of_loaded_checkpoint_backpropagates_through_k2(cuda, tmp_path):
    """A loaded model's parameters require grad; render() on the card runs
    K1 and its .backward() runs K2, giving the CPU path's gradients."""
    path = str(tmp_path / "chkpnt1.npz")
    save_checkpoint(path, 1, GaussianModel.from_numpy(scene(3), device="cpu"))
    grads = {}
    for device in (cuda, torch.device("cpu")):
        _, model = load_checkpoint(path, device=device)
        before = (trace.counter("k1.launches"), trace.counter("k2.launches"))
        out = render(view(device), model, RasterConfig(SIZE, SIZE),
                     torch.zeros(3, device=device))
        loss = out["render"].square().mean() + out["opacity"].mean()
        loss.backward()
        launched = int(device.type == "cuda")
        assert (trace.counter("k1.launches"), trace.counter("k2.launches")) == (
            before[0] + launched, before[1] + launched)
        grads[device.type] = {k: getattr(model, k).grad.cpu() for k in
                              ("xyz", "scaling", "opacity", "shs_dc")}
    for k, want in grads["cpu"].items():
        assert float(want.abs().max()) > 0, k
        assert max_rel_err(grads["cuda"][k], want) <= 1e-3, k


GRAD_FIELDS = ("xyz", "normal", "shs_dc", "shs_rest", "scaling", "rotation",
               "opacity")
TRAIN_OPT = OptimizationConfig(**STAGE1_NERF_SYNTHETIC)


def train_state(tmp_path) -> tuple[str, ViewInputs]:
    """A STAGE1_NERF_SYNTHETIC train state one CPU step in (so Adam's moments
    are not zero), saved as a checkpoint, and the view it trains on."""
    d = scene(4)
    cfg = RasterConfig(SIZE, SIZE)
    # The ground truth: the points moved and their colours swapped, so the
    # L1 residual is nowhere exactly 0 (where it is, sign() flips on a last
    # bit and the gradients with it).
    jitter = np.random.default_rng(9).normal(0, 0.03, d["xyz"].shape)
    with torch.no_grad():
        gt = render(view("cpu"), GaussianModel.from_numpy(
            dict(d, xyz=d["xyz"] + jitter.astype(np.float32),
                 shs_dc=d["shs_dc"][:, :, ::-1].copy()), device="cpu"), cfg,
            torch.zeros(3))
    gt_view = view("cpu")._replace(image=gt["render"],
                                   image_mask=(gt["opacity"] > 0.5).float())
    model = GaussianModel.from_numpy(d, device="cpu")
    optimizer = make_optimizer(model, TRAIN_OPT, 1.0)
    train_step(model, optimizer, gt_view, 1, cfg=cfg, opt=TRAIN_OPT,
               spatial_lr_scale=1.0)
    path = str(tmp_path / "chkpnt1.npz")
    save_checkpoint(path, 1, model, optimizer)
    return path, gt_view


def step_from_state(path: str, gt_view: ViewInputs, device,
                    rel_change: float = 0.0):
    """Train step 2 from the saved state on `device`, with every parameter
    first scaled by (1 + rel_change); returns (metrics, model)."""
    _, m, o = load_train_state(path, TRAIN_OPT, 1.0, device=device)
    with torch.no_grad():
        for k in GRAD_FIELDS:
            getattr(m, k).mul_(1.0 + rel_change)
    v = gt_view._replace(cam=view(device).cam,
                         image=gt_view.image.to(device),
                         image_mask=gt_view.image_mask.to(device))
    metrics = train_step(m, o, v, 2, cfg=RasterConfig(SIZE, SIZE),
                         opt=TRAIN_OPT, spatial_lr_scale=1.0)
    return metrics, m


def test_train_step_on_cuda_matches_cpu(cuda, tmp_path):
    """One STAGE1_NERF_SYNTHETIC train step from the same state on the card,
    through K1 and K2, and on the CPU: loss, gradients, Adam update and
    densification stats."""
    path, gt_view = train_state(tmp_path)
    runs = []
    for device in (cuda, torch.device("cpu")):
        before = (trace.counter("k1.launches"), trace.counter("k2.launches"))
        runs.append(step_from_state(path, gt_view, device))
        launched = int(device.type == "cuda")
        assert (trace.counter("k1.launches"), trace.counter("k2.launches")) == (
            before[0] + launched, before[1] + launched)
    (got, m_gpu), (want, m_cpu) = runs
    for k, v in want.items():
        # float32 sums in another order (atomics on the card)
        assert float(got[k]) == pytest.approx(float(v), rel=1e-4), k
    lrs = learning_rates(TRAIN_OPT, 2, 1.0)
    errs = {k: max_rel_err(getattr(m_gpu, k).grad.cpu(),
                           getattr(m_cpu, k).grad) for k in GRAD_FIELDS}
    stats = ("xyz_grad_accum", "normal_grad_accum", "weights_accum")
    errs.update({k: max_rel_err(getattr(m_gpu, k).cpu(), getattr(m_cpu, k))
                 for k in stats})
    print("card vs CPU max_rel_err", errs)
    for k in GRAD_FIELDS:
        assert errs[k] <= GRAD_TOL, k
        # Adam divides by sqrt(nu): gradient noise shows as a share of lr
        torch.testing.assert_close(getattr(m_gpu, k).detach().cpu(),
                                   getattr(m_cpu, k).detach(),
                                   atol=0.01 * lrs[k], rtol=0)
    for k in stats:
        assert errs[k] <= GRAD_TOL, k
    for k in ("denom", "max_radii2d"):
        assert torch.equal(getattr(m_gpu, k).cpu(), getattr(m_cpu, k))


@torch.no_grad()
def test_k1_refuses_wide_attributes(cuda):
    binning, mean2d, conic, opacity, attrs, cfg = k1_args(cuda, 4)
    wide = torch.zeros((attrs.shape[0], 33), device=cuda)
    with pytest.raises(ValueError, match="attribute channels"):
        composite_cuda.composite_k1(binning, mean2d, conic, opacity, wide, cfg)


@torch.no_grad()
def test_k1_empty_scene(cuda):
    d = scene(2)
    d["xyz"][:, 2] = -10.0              # every gaussian behind the camera
    out = render(view(cuda), GaussianModel.from_numpy(d, device=cuda),
                 RasterConfig(SIZE, SIZE), torch.zeros(3, device=cuda))
    torch.cuda.synchronize()
    assert out["num_rendered"] == 0
    assert float(out["opacity"].abs().max()) == 0.0
    assert int(out["num_contrib"].max()) == 0


# ---------------------------------------------------------------------------
# K3, the ray tracer, and K4, the fused shading
# ---------------------------------------------------------------------------

def shell(seed: int, n: int, device) -> list[torch.Tensor]:
    """An occluding bowl (tests/test_torch_ray_trace.py::shell_scene):
    points on the lower half of the unit sphere, normals inward, flat
    gaussians, opacities in [0.3, 0.95]. Activated xyz, scaling, unit
    rotation, opacity [P] and normal."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2])
    rot = rng.normal(size=(n, 4))
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in (
        d * (1.0 + 0.03 * rng.normal(size=(n, 1))),
        np.tile([0.06, 0.06, 0.012], (n, 1)),
        rot / np.linalg.norm(rot, axis=-1, keepdims=True),
        rng.uniform(0.3, 0.95, n), -d)]


def surface_rays(xyz, normal, S: int):
    """S Fibonacci directions around each normal, from its point."""
    dirs, _ = fibonacci_sphere_sampling(normal, S)
    P = xyz.shape[0]
    return (xyz[:, None].expand(P, S, 3).reshape(-1, 3).contiguous(),
            dirs.reshape(-1, 3).contiguous())


def assert_visibility_close(T_kernel, T_plain):
    """K3's transmittance against the plain version's: |Δvis| <= 1e-5 where
    both lie on the same side of 0.9 (the products are taken in another
    order); rays on different sides are at most 1e-4 of all rays, each with
    its plain T within 1e-4 of 0.9."""
    side_k, side_p = T_kernel >= ray_trace.T_MIN, T_plain >= ray_trace.T_MIN
    same = side_k == side_p
    diff = (torch.where(side_k, T_kernel, 0.0)
            - torch.where(side_p, T_plain, 0.0))[same]
    assert float(diff.abs().max()) <= 1e-5
    split = ~same
    assert int(split.sum()) <= 1e-4 * T_plain.numel()
    assert bool(((T_plain[split] - ray_trace.T_MIN).abs() < 1e-4).all())


@torch.no_grad()
@pytest.mark.parametrize("n", [4096, 300_000])
def test_k3_matches_plain(cuda, n):
    """On an occluding bowl, 16 rays from each of 256 points, laid out by
    point in Morton order as update_visibility lays them out; 300k gaussians
    take more super boxes than K3 stages in shared memory at once."""
    xyz, scaling, rot, op, nrm = shell(n, n, cuda)
    bvh = ray_trace.build_bvh(xyz, scaling, rot, op, nrm)
    rays_o, rays_d = surface_rays(xyz[bvh.order][:256], nrm[bvh.order][:256], 16)
    before = trace.counter("k3.launches")
    vis = ray_trace.trace_visibility(bvh, rays_o, rays_d)
    o = rays_o + ray_trace.RAY_OFFSET * rays_d
    T = ray_trace_cuda.trace_k3(bvh, o, rays_d)
    torch.cuda.synchronize()
    assert trace.counter("k3.launches") == before + 2
    assert torch.equal(vis[:, 0], torch.where(T >= ray_trace.T_MIN, T, 0.0))
    want = ray_trace.trace_transmittance_plain(bvh, o, rays_d)
    assert_visibility_close(T, want)
    blocked = float((want < ray_trace.T_MIN).float().mean())
    assert 0.02 < blocked < (0.98 if n == 4096 else 1.0), blocked


@torch.no_grad()
def test_k3_needles_and_single_gaussian_rules(cuda):
    """tests/test_torch_ray_trace.py's needles far from the origin and the
    single-gaussian rules, through K3."""
    def bvh(pos, scale, normal=(0.0, 0.0, -1.0)):
        f = lambda x: torch.tensor([x], dtype=torch.float32, device=cuda)  # noqa: E731
        return ray_trace.build_bvh(f(pos), f([scale] * 3), f([1.0, 0, 0, 0]),
                                   f(0.95), f(list(normal)))

    def one(b, o, d) -> float:
        return float(ray_trace.trace_visibility(
            b, torch.tensor([o], device=cuda), torch.tensor([d], device=cuda))[0, 0])

    z = [0.0, 0.0, 1.0]
    assert one(bvh([2.0, 2.0, 2.5], 2e-6), [2.1, 2.0, 0.0], z) == 1.0
    s = 1e-4
    assert one(bvh([2.0, 2.0, 2.5], s), [2.0 + 6 * s, 2.0, 0.0], z) > 0.999
    assert one(bvh([2.0, 2.0, 2.5], s), [2.0, 2.0, 0.0], z) == 0.0
    g = bvh([0.0, 0.0, 1.0], 0.1)
    assert one(g, [0.0, 0.0, 0.0], z) == 0.0
    assert one(g, [0.0, 0.0, 3.0], z) == 1.0
    assert one(bvh([0.0, 0.0, 1.0], 0.1, (0.0, 0.0, 1.0)), [0.0, 0.0, 0.0], z) == 1.0


@torch.no_grad()
def test_k3_is_bitwise_independent_of_ray_order(cuda):
    """A ray's T from K3 is a function of that ray alone: traced in coherent
    order, in the order given, and shuffled and traced both ways, every T is
    bit for bit the same."""
    xyz, scaling, rot, op, nrm = shell(5, 20_000, cuda)
    bvh = ray_trace.build_bvh(xyz, scaling, rot, op, nrm)
    rays_o, rays_d = surface_rays(xyz[bvh.order][::8], nrm[bvh.order][::8], 16)
    o = rays_o + ray_trace.RAY_OFFSET * rays_d
    T = ray_trace_cuda.trace_k3(bvh, o, rays_d)
    perm = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(0)
                          ).to(cuda)
    for sort in (True, False):
        shuffled = torch.empty_like(T)
        shuffled[perm] = ray_trace_cuda.trace_k3(bvh, o[perm], rays_d[perm],
                                                 sort=sort)
        assert torch.equal(shuffled, T)
        assert torch.equal(ray_trace_cuda.trace_k3(bvh, o, rays_d, sort=sort), T)
    blocked = float((T < ray_trace.T_MIN).float().mean())
    assert 0.05 < blocked < 0.95, blocked
    assert_visibility_close(T, ray_trace.trace_transmittance_plain(bvh, o, rays_d))


def blocked_rays(seed: int, n: int, device):
    """Rays from near the bowl's centre into it (z of the direction below
    -0.5): each meets the bowl's inward-facing gaussians."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.5 * np.linalg.norm(d[:, :2], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.2, 0.2, (n, 3))
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in (o, d)]


@torch.no_grad()
@pytest.mark.parametrize("case", ["one_ray", "odd_rays", "all_blocked",
                                  "odd_gaussians"])
def test_k3_edge_shapes(cuda, case):
    """K3 against the plain tracer: one ray; 1000 rays (not a multiple of a
    warp's 32 or the block's 128); rays that are all blocked; 1000
    gaussians (not a multiple of the cluster's 32) in a random cloud."""
    if case == "odd_gaussians":
        rng = np.random.default_rng(3)
        rot = rng.normal(size=(1000, 4))
        nrm = rng.normal(size=(1000, 3))
        cloud = [torch.tensor(x, dtype=torch.float32, device=cuda) for x in (
            rng.uniform(-1, 1, (1000, 3)), rng.uniform(0.01, 0.05, (1000, 3)),
            rot / np.linalg.norm(rot, axis=-1, keepdims=True),
            rng.uniform(0.1, 0.9, 1000),
            nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))]
        bvh = ray_trace.build_bvh(*cloud)
        rays_o, rays_d = surface_rays(cloud[0][:64], cloud[4][:64], 16)
    else:
        xyz, scaling, rot, op, nrm = shell(6, 20_000, cuda)
        bvh = ray_trace.build_bvh(xyz, scaling, rot, op, nrm)
        if case == "all_blocked":
            rays_o, rays_d = blocked_rays(4, 4096, cuda)
        else:
            rays_o, rays_d = surface_rays(xyz[bvh.order], nrm[bvh.order], 4)
            rays_o, rays_d = (rays_o[:1], rays_d[:1]) if case == "one_ray" else (
                rays_o[5:1005], rays_d[5:1005])
    o = (rays_o + ray_trace.RAY_OFFSET * rays_d).contiguous()
    rays_d = rays_d.contiguous()
    T = ray_trace_cuda.trace_k3(bvh, o, rays_d)
    want = ray_trace.trace_transmittance_plain(bvh, o, rays_d)
    torch.cuda.synchronize()
    assert T.shape == want.shape
    if case == "all_blocked":
        assert bool((want < ray_trace.T_MIN).all())
        assert bool((T < ray_trace.T_MIN).all())
    assert_visibility_close(T, want)


def shading_inputs(P: int, S: int, seed: int, device, rough: float | None = None,
                   dark: bool = False, zero_shs: bool = False) -> tuple:
    """rendering_equation_train's inputs, seeded (tests/test_torch_shading.py
    pattern): roughness uniform in [0.05, 0.95] with the activation's bounds
    0.09 and 0.99 on two points (or `rough` everywhere), visibility in
    [0, 1) (zero everywhere when `dark`), local-light SH 0.3·N(0, 1) (zero,
    as at the stage-2 start, with `zero_shs`), global light in [0, 2)."""
    rng = np.random.default_rng(seed)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    normals = f(unit(P))
    dirs, areas = fibonacci_sphere_sampling(normals, S)
    roughness = rng.uniform(0.05, 0.95, (P, 1))
    roughness[-2:, 0] = (0.09, 0.99)[2 - min(P, 2):]
    if rough is not None:
        roughness[:] = rough
    vis = rng.uniform(size=(P, S, 1)) * (not dark)
    return (f(rng.uniform(size=(P, 3))), f(roughness), normals, f(unit(P)),
            f(0.3 * rng.normal(size=(P, 16, 3)) * (not zero_shs)),
            f(2.0 * rng.uniform(size=(P, S, 3))), f(vis), dirs, areas)


def plain_shading_grads(x: tuple, cot: list) -> list[torch.Tensor]:
    """Autograd of the plain version: d(base_color, roughness, viewdirs,
    shs, global_light) of Σ cot · outputs."""
    leaves = [x[i].detach().clone().requires_grad_() for i in (0, 1, 3, 4, 5)]
    bc, rough, vdir, shs, gl = leaves
    outs = shading_cuda.rendering_equation_train_reference(
        bc, rough, x[2], vdir, shs, gl, *x[6:])
    return list(torch.autograd.grad(
        sum((c * o).sum() for c, o in zip(cot, outs)), leaves))


# K4 against the plain version. At the GGX peak of a smooth surface
# nom0 = 1 - NoH^2 (1 - alpha^2) cancels as NoH -> 1, so a last-bit change of
# NoH moves the specular term by ~1e-3 of itself: no two float32
# implementations agree there to the JAX suite's rtol 1e-4 / atol 1e-5 (on
# test_k4_matches_plain's inputs the plain float32 version is up to 3.2x that
# tolerance from the float64 answer, and its gradients up to 6.9e-4 of their
# largest entry). So K4 and the plain float32 version are both held against
# the plain version in float64: K4 within the stated tolerance, or within
# K4_SLACK times the plain float32 version's own error, whichever is larger.
K4_SLACK = 2.0


def fwd_err(x: torch.Tensor, exact: torch.Tensor) -> float:
    """The largest |x - exact| in units of atol 1e-5 + rtol 1e-4 |exact|."""
    return float(((x.double() - exact).abs()
                  / (1e-5 + 1e-4 * exact.abs())).max())


def bwd_err(x: torch.Tensor, exact: torch.Tensor) -> float:
    """max|x - exact| / max|exact| (sums over samples in another order)."""
    return float((x.double() - exact).abs().max()
                 / exact.abs().max().clamp(min=1e-30))


def assert_k4_close(name: str, got, plain, exact, err, tol: float) -> None:
    e_kernel, e_plain = err(got, exact), err(plain, exact)
    assert e_kernel <= max(tol, K4_SLACK * e_plain), (name, e_kernel, e_plain)


@pytest.mark.parametrize("case", ["mixed", "smooth_dark", "rough_dark",
                                  "no_local_light"])
def test_k4_matches_plain(cuda, case):
    """K4-fwd and K4-bwd against the plain version and the plain version in
    float64 (K4_SLACK): the forward within rtol 1e-4, atol 1e-5 (the JAX
    suite's, tests/test_shading_fused.py), the backward per field within
    1e-4 of the largest entry. The activation's roughness bounds, all-zero
    visibility, and all-zero local-light SH (the stage-2 start, where
    max(SH, 0) passes half the gradient)."""
    rough, dark, zero_shs = {
        "mixed": (None, False, False), "smooth_dark": (0.09, True, False),
        "rough_dark": (0.99, True, False),
        "no_local_light": (None, False, True)}[case]
    x = shading_inputs(1000, 64, 3, cuda, rough, dark, zero_shs)
    x64 = [t.double() for t in x]
    inputs = shading_cuda.kernel_inputs(*x)
    before = (trace.counter("k4.launches"), trace.counter("k4.bwd_launches"))
    got = shading_cuda.shade_fwd(*inputs)
    torch.cuda.synchronize()
    for name, g, p, e in zip(
            ("pbr", "diffuse", "specular"), got,
            shading_cuda.rendering_equation_train_reference(*x),
            shading_cuda.rendering_equation_train_reference(*x64)):
        assert_k4_close(name, g, p, e, fwd_err, 1.0)
    gen = torch.Generator().manual_seed(4)
    cot = [torch.randn((1000, 3), generator=gen).to(cuda) for _ in range(3)]
    dbc, drough, dvdir, dshs, dgl = shading_cuda.shade_bwd(*inputs, *cot)
    torch.cuda.synchronize()
    assert (trace.counter("k4.launches"), trace.counter("k4.bwd_launches")) == (
        before[0] + 1, before[1] + 1)
    for name, g, p, e in zip(
            ("base_color", "roughness", "viewdirs", "shs", "gl"),
            (dbc, drough[:, None], dvdir, dshs.view(-1, 16, 3), dgl),
            plain_shading_grads(x, cot),
            plain_shading_grads(x64, [c.double() for c in cot])):
        assert bool(torch.isfinite(g).all()), name
        if dark and name == "gl":
            assert float(g.abs().max()) == 0.0
            continue
        assert_k4_close(name, g, p, e, bwd_err, 1e-4)
    if zero_shs:
        assert float(dshs.abs().max()) > 0.01


def check_k4_launch(x: tuple, inputs: tuple, seed: int) -> None:
    """K4-fwd and K4-bwd on `inputs` (x in the kernel's layout, wherever in
    memory) against the plain version of x and it in float64 (K4_SLACK)."""
    P = x[0].shape[0]
    x64 = [t.double() for t in x]
    got = shading_cuda.shade_fwd(*inputs)
    gen = torch.Generator().manual_seed(seed)
    cot = [torch.randn((P, 3), generator=gen).to(x[0].device) for _ in range(3)]
    dbc, drough, dvdir, dshs, dgl = shading_cuda.shade_bwd(*inputs, *cot)
    torch.cuda.synchronize()
    for name, g, p, e in zip(
            ("pbr", "diffuse", "specular"), got,
            shading_cuda.rendering_equation_train_reference(*x),
            shading_cuda.rendering_equation_train_reference(*x64)):
        assert_k4_close(name, g, p, e, fwd_err, 1.0)
    for name, g, p, e in zip(
            ("base_color", "roughness", "viewdirs", "shs", "gl"),
            (dbc, drough[:, None], dvdir, dshs.view(-1, 16, 3), dgl),
            plain_shading_grads(x, cot),
            plain_shading_grads(x64, [c.double() for c in cot])):
        assert bool(torch.isfinite(g).all()), name
        assert_k4_close(name, g, p, e, bwd_err, 1e-4)


@pytest.mark.parametrize("S", [1, 17, 63, 64, 65, 128])
@pytest.mark.parametrize("P", [1, shading_cuda.POINTS_PER_BLOCK - 1,
                               shading_cuda.POINTS_PER_BLOCK + 1,
                               2 * shading_cuda.POINTS_PER_BLOCK + 1])
def test_k4_edge_shapes(cuda, P, S):
    """K4 where its design has edges: a block's run of points cut short
    (P around multiples of a block's 32 points) and sample counts that are
    not a whole number of 16-sample chunks, or whose rows are not 16-byte
    multiples."""
    x = shading_inputs(P, S, 20 + S, cuda)
    check_k4_launch(x, shading_cuda.kernel_inputs(*x), S)


def at_offset(t: torch.Tensor, floats: int) -> torch.Tensor:
    """A copy of t in a larger buffer, `floats` floats past its start."""
    buf = torch.zeros(t.numel() + floats, dtype=t.dtype, device=t.device)
    out = buf[floats:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("S", [17, 64])
def test_k4_inputs_at_unaligned_storage_offsets(cuda, S):
    """Every K4 input cut from a larger tensor 1, 2 or 3 floats past a
    16-byte boundary (sliced views, as a caller may pass them): the kernels
    stage the ends of each run with 4-byte copies and raise nothing."""
    P = 70
    x = shading_inputs(P, S, 30 + S, cuda)
    inputs = [at_offset(t, 1 + i % 3)
              for i, t in enumerate(shading_cuda.kernel_inputs(*x))]
    assert all(t.data_ptr() % 16 for t in inputs)
    check_k4_launch(x, tuple(inputs), S)


def test_k4_without_points_launches_nothing(cuda):
    """P = 0: empty outputs and gradients, no launch."""
    x = shading_inputs(0, 64, 7, cuda)
    leaves = [x[i].clone().requires_grad_() for i in (0, 1, 3, 4)]
    before = (trace.counter("k4.launches"), trace.counter("k4.bwd_launches"))
    outs = shading_cuda.rendering_equation_train(
        leaves[0], leaves[1], x[2], leaves[2], leaves[3], *x[5:])
    assert [tuple(o.shape) for o in outs] == [(0, 3)] * 3
    sum(o.sum() for o in outs).backward()
    assert [tuple(t.grad.shape) for t in leaves] == [(0, 3), (0, 1), (0, 3),
                                                      (0, 16, 3)]
    dgl = shading_cuda.shade_bwd(*shading_cuda.kernel_inputs(*x),
                                 *(torch.zeros((0, 3), device=cuda),) * 3)[-1]
    assert tuple(dgl.shape) == (0, 64, 3)
    assert (trace.counter("k4.launches"), trace.counter("k4.bwd_launches")) == before


def test_shade_function_gradient_matches_autograd(cuda):
    """rendering_equation_train on CUDA tensors (ShadeFunction: K4-fwd, then
    K4-bwd) against autograd through the plain version in float32 and
    float64 (K4_SLACK), from the env map's raw parameter through the
    equirect query, and to base colour, roughness, view directions and the
    local-light SH."""
    P, S = 500, 32
    x = shading_inputs(P, S, 5, cuda)
    raw = torch.rand((8, 16, 3), generator=torch.Generator().manual_seed(6)) * 3
    cot = [torch.randn((P, 3), generator=torch.Generator().manual_seed(i)).to(cuda)
           for i in range(3)]
    grads = []
    for fn, dtype, launched in (
            (shading_cuda.rendering_equation_train, torch.float32, 1),
            (shading_cuda.rendering_equation_train_reference, torch.float32, 0),
            (shading_cuda.rendering_equation_train_reference, torch.float64, 0)):
        xd = [t.to(dtype) for t in x]
        leaves = [t.detach().clone().requires_grad_() for t in
                  (xd[0], xd[1], xd[3], xd[4])]
        env = DirectLightMap.from_raw(raw.to(cuda, dtype))
        gl = env.direct_light(xd[7])
        before = (trace.counter("k4.launches"), trace.counter("k4.bwd_launches"))
        outs = fn(leaves[0], leaves[1], xd[2], leaves[2], leaves[3], gl, *xd[6:])
        sum((c.to(dtype) * o).sum() for c, o in zip(cot, outs)).backward()
        assert (trace.counter("k4.launches"), trace.counter("k4.bwd_launches")) == (
            before[0] + launched, before[1] + launched)
        grads.append([t.grad for t in leaves] + [env.env.grad])
    for name, got, plain, exact in zip(("base_color", "roughness", "viewdirs",
                                        "shs", "env"), *grads):
        assert float(exact.abs().max()) > 0, name
        assert_k4_close(name, got, plain, exact, bwd_err, 1e-4)


def test_cuda_tensors_reach_the_kernel_or_raise(cuda, monkeypatch):
    """On CUDA tensors the stage-2 wrappers launch their kernel or raise: a
    library that does not build, a launch that fails, or an input the kernel
    does not take raises, and nothing falls back to the plain version."""
    xyz, scaling, rot, op, nrm = shell(8, 512, cuda)
    bvh = ray_trace.build_bvh(xyz, scaling, rot, op, nrm)
    rays = surface_rays(xyz, nrm, 4)
    x = shading_inputs(64, 8, 9, cuda)
    inputs = shading_cuda.kernel_inputs(*x)
    with pytest.raises(ValueError, match="not contiguous"):
        shading_cuda.shade_fwd(*inputs[:-1], inputs[-1].t().contiguous().t())
    with pytest.raises(ValueError, match="expected float32"):
        ray_trace_cuda.trace_k3(bvh, rays[0].double(), rays[1])

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    class FailingLaunch:           # every entry point returns cudaError_t 1
        argtypes = ()

        def __call__(self, *args):
            return 1

    class FailingLibrary:
        r3dg_trace = r3dg_shade_fwd = r3dg_shade_bwd = FailingLaunch()

    counts = (trace.counter("k3.launches"), trace.counter("k4.launches"),
              trace.counter("k4.bwd_launches"))
    for load, match in ((no_build, "nvcc failed"),
                        (lambda name: FailingLibrary(), "launch failed")):
        monkeypatch.setattr(_build, "load_library", load)
        with pytest.raises(RuntimeError, match=match):
            ray_trace.trace_visibility(bvh, *rays)
        with pytest.raises(RuntimeError, match=match):
            shading_cuda.rendering_equation_train(*x)
        with pytest.raises(RuntimeError, match=match):
            shading_cuda.shade_bwd(*inputs, *(inputs[i] for i in (4, 6, 7)))
    assert (trace.counter("k3.launches"), trace.counter("k4.launches"),
            trace.counter("k4.bwd_launches")) == counts


# ---------------------------------------------------------------------------
# the stage-2 train step, card against CPU
# ---------------------------------------------------------------------------

STAGE2_OPT = OptimizationConfig(**STAGE2_NERF_SYNTHETIC)
STAGE2_FIRST_ITER = 30_000


def stage2_state(tmp_path):
    """A STAGE2_NERF_SYNTHETIC train state one CPU step past a stage-2 start
    (so Adam's moments are not zero), saved with its env-light file; its
    visibility cache (traced on the CPU) and the view it trains on."""
    d = scene(5)
    rng = np.random.default_rng(10)
    P = d["xyz"].shape[0]
    shapes = {"base_color": (3,), "roughness": (1,), "incidents_dc": (1, 3),
              "incidents_rest": (15, 3), "visibility_dc": (1, 1),
              "visibility_rest": (15, 1)}
    scale = {"incidents_dc": 0.5, "incidents_rest": 0.1}
    d.update({k: (scale.get(k, 1.0) * rng.normal(size=(P,) + s)).astype(np.float32)
              for k, s in shapes.items()})
    # roughness in [0.33, 0.95], off the smooth end whose GGX peak no two
    # float32 implementations agree on (K4_SLACK); test_k4_matches_plain
    # holds K4 there
    d["roughness"] = rng.uniform(-1.0, 3.0, (P, 1)).astype(np.float32)
    assert set(shapes) == set(PBR_FIELDS)
    model = GaussianModel.from_numpy(d, device="cpu")
    vis = render_neilf.update_visibility(model, 8)
    env = DirectLightMap(8, 3.0, torch.Generator().manual_seed(11),
                         device="cpu")
    # a smooth colour ramp: the L1 residuals are nowhere exactly 0
    yy, xx = torch.meshgrid(torch.linspace(0, 1, SIZE), torch.linspace(0, 1, SIZE),
                            indexing="ij")
    gt = torch.stack([0.2 + 0.5 * xx, 0.3 + 0.4 * yy, 0.6 - 0.3 * xx * yy])
    gt_view = view("cpu")._replace(image=gt)
    optimizer = make_optimizer(model, STAGE2_OPT, 1.0)
    start_state(optimizer, STAGE2_FIRST_ITER)
    env_optimizer = make_env_optimizer(env, STAGE2_OPT)
    stage2.train_step(model, optimizer, env, env_optimizer, vis, gt_view,
                      STAGE2_FIRST_ITER + 1, cfg=RasterConfig(SIZE, SIZE),
                      opt=STAGE2_OPT, spatial_lr_scale=1.0)
    path = str(tmp_path / "chkpnt30001.npz")
    save_checkpoint(path, STAGE2_FIRST_ITER + 1, model, optimizer)
    save_env_checkpoint(str(tmp_path / "env_light_chkpnt30001.npz"),
                        STAGE2_FIRST_ITER + 1, env, env_optimizer)
    return path, str(tmp_path / "env_light_chkpnt30001.npz"), vis, gt_view


def test_stage2_train_step_on_cuda_matches_cpu(cuda, tmp_path):
    """One STAGE2_NERF_SYNTHETIC train step from the same state and
    visibility cache on the card, through K4 and K1/K2, and on the CPU:
    loss terms, every gradient (the env map's included), the Adam updates
    and the densification stats."""
    path, env_path, vis, gt_view = stage2_state(tmp_path)
    runs = []
    for device in (cuda, torch.device("cpu")):
        _, m, o = load_train_state(path, STAGE2_OPT, 1.0, device=device)
        _, env, env_o = load_env_checkpoint(env_path, STAGE2_OPT, device=device)
        v = gt_view._replace(cam=view(device).cam,
                             image=gt_view.image.to(device),
                             image_mask=gt_view.image_mask.to(device))
        counts = lambda: (trace.counter("k1.launches"), trace.counter("k2.launches"),  # noqa: E731
                          trace.counter("k4.launches"), trace.counter("k4.bwd_launches"))
        before = counts()
        metrics = stage2.train_step(
            m, o, env, env_o, render_neilf.VisibilityCache(*(t.to(device) for t in vis)),
            v, STAGE2_FIRST_ITER + 2, cfg=RasterConfig(SIZE, SIZE),
            opt=STAGE2_OPT, spatial_lr_scale=1.0)
        launched = int(device.type == "cuda")
        assert counts() == tuple(b + launched for b in before)
        runs.append((metrics, m, env))
    (got, m_gpu, env_gpu), (want, m_cpu, env_cpu) = runs
    for k, v in want.items():
        # float32 sums in another order (atomics on the card)
        assert float(got[k]) == pytest.approx(float(v), rel=1e-4), k
    errs = {k: max_rel_err(getattr(m_gpu, k).grad.cpu(), getattr(m_cpu, k).grad)
            for k in m_cpu.fields}
    errs["env"] = max_rel_err(env_gpu.env.grad.cpu(), env_cpu.env.grad)
    stats = ("xyz_grad_accum", "weights_accum")
    errs.update({k: max_rel_err(getattr(m_gpu, k).cpu(), getattr(m_cpu, k))
                 for k in stats})
    print("stage-2 card vs CPU max_rel_err", errs)
    assert all(e <= GRAD_TOL for e in errs.values()), errs
    lrs = learning_rates(STAGE2_OPT, STAGE2_FIRST_ITER + 2, 1.0)
    for k in m_cpu.fields:
        # Adam divides by sqrt(nu), so an entry's update moves with its own
        # gradient's relative error, unbounded where the gradient is near 0;
        # and max(SH, 0) flips where the local light is near 0, on the card
        # and the CPU apart. So 1% of lr on all but 1e-4 of the entries,
        # 10% on every one.
        diff = (getattr(m_gpu, k).detach().cpu()
                - getattr(m_cpu, k).detach()).abs()
        assert float((diff > 0.01 * lrs[k]).float().mean()) <= 1e-4, k
        assert float(diff.max()) <= 0.1 * lrs[k], k
    torch.testing.assert_close(env_gpu.env.detach().cpu(), env_cpu.env.detach(),
                               atol=0.01 * STAGE2_OPT.env_lr, rtol=0)
    for k in ("denom", "max_radii2d", "normal_grad_accum"):
        assert torch.equal(getattr(m_gpu, k).cpu(), getattr(m_cpu, k)), k


# ---------------------------------------------------------------------------
# the CLIs on the card
# ---------------------------------------------------------------------------

def write_scene(root, n_frames: int = 6, size: int = 64):
    """A Blender-layout scene with train and test splits: cameras on a circle
    of radius 2 looking down -z, seeded RGBA PNGs by the port's writer."""
    import json
    from relightable3dgaussian_tpu_torch.scene.image_io import write_png
    rng = np.random.default_rng(0)
    frames = []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        c2w = np.eye(4)
        c2w[:3, 3] = [2 * np.sin(a), 0, 2 * np.cos(a)]
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": c2w.tolist()})
        write_png(str(root / "train" / f"r_{i}.png"),
                  rng.integers(0, 256, (size, size, 4)).astype(np.uint8))
    for split in ("train", "test"):
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


def test_cli_stages_and_eval_on_the_card(cuda, tmp_path, monkeypatch):
    """cli.train stage 1 (its backward on K5 under R3DG_BWD_TWO_WALK=1),
    stage 2 from its checkpoint (a visibility re-trace, an env upsample) and
    cli.eval_nvs at 64x64 on the card: the artifacts and the launches."""
    import json
    from relightable3dgaussian_tpu_torch.cli import eval_nvs
    from relightable3dgaussian_tpu_torch.cli import train as train_cli
    data, out1, out2 = tmp_path / "data", tmp_path / "s1", tmp_path / "s2"
    write_scene(data)

    def launches():
        return {"K1": trace.counter("k1.launches"),
                "K2": trace.counter("k2.launches"),
                "K5": trace.counter("k5.launches"),
                "K3": trace.counter("k3.launches"),
                "K4-fwd": trace.counter("k4.launches"),
                "K4-bwd": trace.counter("k4.bwd_launches")}

    def delta(before):
        return {k: v - before[k] for k, v in launches().items()}

    monkeypatch.setenv("R3DG_BWD_TWO_WALK", "1")
    before = launches()
    train_cli.main(["-s", str(data), "-m", str(out1), "--iterations", "10",
                    "--max_init_points", "2000", "--densify_from_iter", "3",
                    "--densification_interval", "6", "--save_interval", "10",
                    "--checkpoint_interval", "10", "--eval",
                    "--test_interval", "5"], device=cuda)
    d1 = delta(before)
    assert (d1["K5"], d1["K2"]) == (10, 0), d1
    monkeypatch.delenv("R3DG_BWD_TWO_WALK")
    before = launches()
    train_cli.main(["-s", str(data), "-m", str(out2), "-t", "neilf",
                    "-c", str(out1 / "chkpnt10.npz"), "--iterations", "16",
                    "--sample_num", "8", "--vis_refresh_interval", "3",
                    "--env_upsample_iters", "14", "--save_interval", "16",
                    "--checkpoint_interval", "16", "--eval"], device=cuda)
    d2 = delta(before)
    # re-traces at steps 13 and 16; K3 once more at the set-up
    assert d2["K2"] == d2["K4-fwd"] == d2["K4-bwd"] == 6 and d2["K5"] == 0, d2
    assert d2["K3"] == 3, d2
    before = launches()
    out = eval_nvs.main(["-s", str(data), "-m", str(out2), "-t", "neilf",
                         "-c", str(out2 / "chkpnt16.npz"), "--skip_train",
                         "--sample_num", "8"], device=cuda)
    assert delta(before)["K3"] == 1
    assert np.isfinite(out["test"]["psnr"])
    for path in (out1 / "chkpnt10.npz", out1 / "metric_test.txt",
                 out1 / "point_cloud" / "iteration_10" / "point_cloud.ply",
                 out2 / "env_light_chkpnt16.npz", out2 / "metric_test.txt",
                 out2 / "test" / "renders" / "00000.png"):
        assert path.exists(), path
    with np.load(out2 / "env_light_chkpnt16.npz") as f:
        assert f["env.env"].shape == (32, 64, 3)
    # the report runs at a logging boundary (the JAX CLI's rule): step 10
    with open(out1 / "metrics.jsonl") as f:
        psnr = [(r["step"], r["test_psnr"]) for r in map(json.loads, f)
                if "test_psnr" in r]
    assert [i for i, _ in psnr] == [10] and np.isfinite(psnr[0][1])


# ---------------------------------------------------------------------------
# relighting on the card
# ---------------------------------------------------------------------------

def pbr_cloud(seed: int, n: int) -> dict:
    """`scene(seed, n)` with seeded PBR fields: opaque enough to shadow."""
    d = scene(seed, n)
    rng = np.random.default_rng(seed + 100)
    f32 = np.float32
    d["opacity"] = np.abs(d["opacity"]) + 1.0
    d.update(base_color=rng.normal(size=(n, 3)).astype(f32),
             roughness=rng.normal(size=(n, 1)).astype(f32),
             incidents_dc=rng.normal(size=(n, 1, 3)).astype(f32),
             incidents_rest=(rng.normal(size=(n, 15, 3)) * 0.1).astype(f32),
             visibility_dc=rng.normal(size=(n, 1, 1)).astype(f32),
             visibility_rest=rng.normal(size=(n, 15, 1)).astype(f32))
    return d


def side_by_side(offset: float, turn: float) -> np.ndarray:
    """Scale 0.5, a turn about the vertical, a shift along x."""
    c, s = np.cos(turn), np.sin(turn)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = 0.5 * np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[0, 3] = offset
    return T


@torch.no_grad()
def test_update_visibility_of_a_composite_matches_plain(cuda):
    """Two transformed clouds concatenated: update_visibility on the card
    (one K3 launch) is K3's T under the 0.9 rule, K3's T is the plain
    tracer's on the CPU under K3's gate, and on cloud A's rays the
    composite's visibility is nowhere above A's alone (a 1e-5 share may
    cross 0.9 by float order) and lower on some. A alone is the composite
    with B's opacities below the tested 1/255, so both traces test the same
    clusters (a trace of A under a BVH of its own groups its gaussians into
    other clusters, and a gaussian outside its 3-sigma box but in a hit
    cluster then counts in one trace only)."""
    from relightable3dgaussian_tpu_torch.models import gaussians as G

    def composite(device):
        clouds = [G.set_transform(GaussianModel.from_numpy(
            pbr_cloud(seed, 2000), device=device), torch.from_numpy(
                side_by_side(x, turn)))
            for seed, x, turn in ((1, -0.6, 0.0), (2, 0.6, np.pi / 2))]
        comp = G.concatenate(clouds)
        values = {k: getattr(comp, k).detach().clone() for k in comp.fields}
        values["opacity"][clouds[0].num_points:] = -30.0
        return GaussianModel(**values), comp

    alone, comp = composite(cuda)
    before = trace.counter("k3.launches")
    vis = render_neilf.update_visibility(comp, 16)
    torch.cuda.synchronize()
    assert trace.counter("k3.launches") == before + 1
    bvh, rays_o, rays_d = render_neilf.visibility_rays(comp, vis.incident_dirs)
    o = rays_o + ray_trace.RAY_OFFSET * rays_d
    T = ray_trace_cuda.trace_k3(bvh, o, rays_d)
    got = torch.empty_like(T)
    got.view(comp.num_points, 16)[bvh.order] = torch.where(
        T >= ray_trace.T_MIN, T, 0.0).view(-1, 16)
    assert torch.equal(vis.visibility.reshape(-1), got)
    want = ray_trace.trace_transmittance_plain(
        ray_trace.GaussianBVH(*(x.cpu() for x in bvh)), o.cpu(),
        rays_d.cpu())
    assert_visibility_close(T.cpu(), want)
    vis_alone = render_neilf.update_visibility(alone, 16).visibility[:2000]
    on_a = vis.visibility[:2000]
    above = (on_a > vis_alone + 1e-6).float().mean()
    lower = (on_a < vis_alone - 1e-6).float().mean()
    assert float(above) <= 1e-5 and float(lower) >= 1e-3, (above, lower)


def test_relighting_frame_on_the_card_matches_cpu(cuda, tmp_path):
    """cli.relighting.main on the card (K3 once, K1 once a frame) and on the
    CPU, one 64x64 frame of two composed clouds under a rotated light:
    every capture within 2/255 outside split pixels (those where the card's
    and the CPU's blended counts differ)."""
    import json
    from relightable3dgaussian_tpu_torch.cli import relighting
    from relightable3dgaussian_tpu_torch.scene import exr, ply_io
    from relightable3dgaussian_tpu_torch.scene.image_io import read_png

    entries = {}
    for i, (seed, x, turn) in enumerate(((1, -0.6, 0.0), (2, 0.6, 1.2))):
        path = tmp_path / f"m{i}.ply"
        ply_io.save_gaussian_ply(str(path), pbr_cloud(seed, 1500))
        entries[f"obj{i}"] = {"path": str(path), "transform":
                              side_by_side(x, turn).reshape(-1).tolist()}
    w2c = np.eye(4)
    w2c[2, 3] = 3.0
    rot = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    for name, obj in (
            ("transform.json", entries),
            ("trajectory.json", {"camera": {"width": 64, "height": 64},
                                 "trajectory": {"0": w2c.reshape(-1).tolist()}}),
            ("light_transform.json", {"transform": {"0": rot.reshape(-1)
                                                    .tolist()}})):
        with open(tmp_path / name, "w") as f:
            json.dump(obj, f)
    rng = np.random.default_rng(3)
    exr.write_exr_zip(str(tmp_path / "env.exr"),
                      (rng.random((16, 32, 3)) * 4).astype(np.float32))
    captures = ["pbr_env", "base_color", "roughness", "visibility", "normal"]
    outs = {}
    for device in (cuda, "cpu"):
        k1, k3 = trace.counter("k1.launches"), trace.counter("k3.launches")
        out_dir = tmp_path / str(device).replace(":", "")
        relighting.main(["-co", str(tmp_path), "-e", str(tmp_path / "env.exr"),
                         "--sample_num", "8", "--output", str(out_dir),
                         "--capture_list", ",".join(captures)], device=device)
        launched = (trace.counter("k1.launches") - k1, trace.counter("k3.launches") - k3)
        assert launched == ((1, 1) if device == cuda else (0, 0)), launched
        outs[str(device)] = out_dir
    # the split pixels: the composite rendered on both devices from one
    # visibility cache
    from relightable3dgaussian_tpu_torch.models.lights import EnvLight
    from relightable3dgaussian_tpu_torch.scene.cameras import Camera
    vis = render_neilf.update_visibility(
        relighting.scene_composition(entries, cuda), 8)
    counts = []
    for dev in (cuda, torch.device("cpu")):
        view_in = Camera(uid=0, R=w2c[:3, :3].T, T=w2c[:3, 3],
                         fovx=relighting.CAMERA_ANGLE_X,
                         fovy=relighting.CAMERA_ANGLE_X, width=64,
                         height=64).view_inputs(dev)
        with torch.no_grad():
            res = render_neilf.render_neilf(
                view_in, relighting.scene_composition(entries, dev),
                RasterConfig(64, 64), torch.zeros(3, device=dev),
                EnvLight(torch.ones((4, 8, 3), device=dev)),
                render_neilf.VisibilityCache(*(x.to(dev) for x in vis)),
                is_training=False)
        counts.append(res["num_contrib"].cpu())
    ok = (counts[0] == counts[1]).numpy()
    assert ok.mean() > 0.99
    for t in captures:
        got = read_png(str(outs[str(cuda)] / t / "frame_0.png")).astype(int)
        want = read_png(str(outs["cpu"] / t / "frame_0.png")).astype(int)
        diff = np.abs(got - want).max(-1)
        assert diff[ok].max() <= 2, (t, diff[ok].max())


def test_lpips_on_the_card_matches_cpu(cuda, monkeypatch):
    """LPIPS under the random backbone on the card against the CPU, rtol
    1e-4 (TF32 off on both)."""
    from relightable3dgaussian_tpu_torch.losses import lpips
    monkeypatch.setenv("LPIPS_WEIGHTS", "random")
    lpips._CACHE.clear()
    try:
        rng = np.random.default_rng(0)
        x = torch.tensor(rng.uniform(0, 1, (3, 96, 128)), dtype=torch.float32)
        y = (x + 0.1 * torch.tensor(rng.normal(size=x.shape),
                                    dtype=torch.float32)).clamp(0, 1)
        want = float(lpips.lpips(x, y))
        got = lpips.lpips(x.to(cuda), y.to(cuda))
        assert got.device.type == "cuda"
        assert want > 0 and float(got) == pytest.approx(want, rel=1e-4)
    finally:
        lpips._CACHE.clear()


# ---------------------------------------------------------------------------
# MVS, the viewer and K4 at grazing views (chip_smoke.py's helpers)
# ---------------------------------------------------------------------------

def chip_smoke_module():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def plane_case(monkeypatch):
    """tests/test_mvs.py's analytic scene (chip_smoke.plane_view at 96x96,
    focal 110): the reference at the origin, sources at x = +-0.25."""
    from relightable3dgaussian_tpu_torch.mvs.formats import MVSCamera
    cs = chip_smoke_module()
    monkeypatch.setattr(cs, "MVS_SIZE", 96)
    monkeypatch.setattr(cs, "MVS_FOCAL", 110.0)
    K = np.array([[110.0, 0, 48], [0, 110.0, 48], [0, 0, 1]])
    views = [cs.plane_view(tx, 0.0) for tx in (0.0, 0.25, -0.25)]
    imgs = [np.repeat(img[None].astype(np.float32), 3, 0) for _, img, _ in views]
    cams = [MVSCamera(E, K, 1.8, (3.6 - 1.8) / 63, 64.0, 3.6)
            for E, _, _ in views]
    return imgs, cams, [d for *_, d in views]


def test_infer_depth_on_the_card_parts_from_cpu_as_cpu_from_itself(
        cuda, monkeypatch):
    """mvs.infer_depth on the card against the CPU: depth (relative) and
    the three probability maps at the 50th and 99th percentile and the
    largest over the pixels 12 or more from the edges within 1.5 times
    (and 1e-6 over) the CPU's own movement under a one-ulp move of the
    reference, the sources or the depth range (the cascade amplifies
    rounding: tests/test_torch_mvs_pipeline.py)."""
    from relightable3dgaussian_tpu_torch.mvs import infer_depth
    imgs, cams, gt = plane_case(monkeypatch)
    planes = (32, 16, 8)

    def run(ref, srcs, cam, dev):
        d, ps = infer_depth(ref, srcs, cam, cams[1:], stage_planes=planes,
                            device=dev)
        assert d.device.type == torch.device(dev).type
        return [d.cpu().numpy()] + [p.cpu().numpy() for p in ps]

    up = lambda x: np.nextafter(x, np.float32(2))           # noqa: E731
    down = lambda x: np.nextafter(x, np.float32(-2))        # noqa: E731
    base = run(imgs[0], imgs[1:], cams[0], "cpu")
    moved = [run(up(imgs[0]), imgs[1:], cams[0], "cpu"),
             run(down(imgs[0]), imgs[1:], cams[0], "cpu"),
             run(imgs[0], [up(s) for s in imgs[1:]], cams[0], "cpu"),
             run(imgs[0], imgs[1:], cams[0]._replace(depth_min=1.8 * (1 + 2e-7)),
                 "cpu"),
             run(imgs[0], imgs[1:], cams[0]._replace(depth_max=3.6 * (1 - 2e-7)),
                 "cpu")]
    got = run(imgs[0], imgs[1:], cams[0], cuda)
    b = np.s_[12:-12, 12:-12]
    for i, (g, want) in enumerate(zip(got, base)):
        scale = np.abs(want) if i == 0 else 1.0
        err = (np.abs(g - want) / scale)[b]
        spread = np.max([np.abs(m[i] - want) / scale for m in moved], 0)[b]
        for q in (0.5, 0.99, 1.0):
            assert np.quantile(err, q) <= (1.5 * np.quantile(spread, q)
                                           + 1e-6), (i, q)
    assert np.median(np.abs(got[0] - gt[0])[b] / gt[0][b]) < 0.01


def test_geometric_filter_on_the_card_matches_cpu(cuda, monkeypatch):
    """The mask and count on the card against the CPU on the analytic
    depths with 1% noise on the reference: equal on >= 99.9% of the
    pixels (a test within the last bit of a threshold may flip)."""
    from relightable3dgaussian_tpu_torch.mvs import geometric_filter
    _, cams, depths = plane_case(monkeypatch)
    rng = np.random.default_rng(3)
    ref = (depths[0] * (1 + 0.01 * rng.normal(size=depths[0].shape))
           ).astype(np.float32)
    srcs = np.stack(depths[1:]).astype(np.float32)
    m_cpu, c_cpu = geometric_filter(ref, cams[0], srcs, cams[1:],
                                    device="cpu")
    m_gpu, c_gpu = geometric_filter(ref, cams[0], srcs, cams[1:],
                                    device=cuda)
    assert m_gpu.device.type == "cuda"
    same = (m_gpu.cpu() == m_cpu) & (c_gpu.cpu() == c_cpu)
    assert float(same.float().mean()) >= 0.999
    assert 0.05 < float(m_cpu.float().mean()) < 0.99


def test_viewer_frame_on_the_card_matches_cpu(cuda):
    """One headless frame of cli.gui's render path on the card against the
    CPU's: within 2/255 at every pixel, within 1e-4 on >= 99.9%."""
    from relightable3dgaussian_tpu_torch.cli import gui
    frames = []
    for dev in (cuda, torch.device("cpu")):
        model = GaussianModel.from_numpy(scene(31), device=dev)

        def render_fn(camera, dev=dev, model=model):
            with torch.no_grad():
                return render(camera.view_inputs(dev), model,
                              RasterConfig(96, 96), torch.zeros(3, device=dev))

        viewer = gui.GUI(96, 96, render_fn, radius=3.0)
        viewer.orbit.orbit(0.4, 0.2)
        frames.append(viewer.render_once())
    diff = np.abs(frames[0] - frames[1])
    assert frames[0].shape == (96, 96, 3) and frames[1].std() > 0.01
    assert diff.max() <= 2 / 255 and (diff > 1e-4).mean() <= 1e-3


@pytest.mark.parametrize("eps", [0.0, 1e-9])
def test_k4_holds_float64_at_every_grazing_point(cuda, eps):
    """Inputs built as examples/k4_grazing.py builds them (the first 200 of
    2000 points viewed at V.N = +-eps): float32 alone would turn some of
    those normals the other way or zero them (shading_cuda.view_side's
    first sign, none outside the 200), and K4, which takes sign(V.N) and
    NoV's clip from float64, passes chip_smoke's K4 gate with every point
    in, on three seeds."""
    cs = chip_smoke_module()
    grazing, P = 200, 2000
    for seed in range(3):
        x = list(cs.shading_case(P, 64, 100 + seed, cuda))
        n, v = x[2][:grazing], x[3].clone()
        g = torch.Generator().manual_seed(seed)
        t = torch.linalg.cross(n, torch.randn((grazing, 3), generator=g).to(cuda))
        t = t / t.norm(dim=-1, keepdim=True)
        sign = 1.0 - 2.0 * (torch.arange(grazing, device=cuda) % 2)
        w = t + (sign * eps)[:, None] * n
        v[:grazing] = w / w.norm(dim=-1, keepdim=True)
        x[3] = v.contiguous()
        side32, side64 = shading_cuda.view_side(x[2], x[3])
        flagged = torch.nonzero((side32 == 0) | (side32 != side64)).flatten()
        assert flagged.numel() > 0 and int(flagged.max()) < grazing
        _, _, info = cs.check_k4(tuple(x), f"k4-grazing-{seed}", seed,
                                 timed=False)
        assert info["float32_sign_flips"] == flagged.numel()


@pytest.mark.parametrize("theta", [1e-4, 1e-3])
def test_k4_half_vector_keeps_its_precision_opposite_the_view(cuda, theta):
    """The first 200 of 2000 points are viewed from `theta` off the opposite
    of their last sample (the Fibonacci ring, V.N about -0.17), built as
    examples/k4_conditioning.py builds them. There h0 = (d + V) / 2 nearly
    cancels and the view-direction gradient scales as 1 / |h0|, so the
    float32 rounding of V moves it by eps / |h0| of itself: the plain
    float32 version is off by up to ~1e-2 of the largest entry at
    theta = 1e-4. K4 adds V's rounding error back into h0: it stays within
    1e-5 and a tenth of the plain version's error, and chip_smoke's K4 gate
    passes on the whole case. (Before, K4 carried the same error as the
    plain version, and at theta = 3e-3 2.8 times it.)"""
    cs = chip_smoke_module()
    near, P = 200, 2000
    for seed in range(2):
        x = list(shading_inputs(P, 64, 40 + seed, cuda))
        d = x[7][:near, -1].double()
        g = torch.Generator().manual_seed(seed)
        a = torch.linalg.cross(d, torch.randn((near, 3), generator=g,
                                              dtype=torch.float64).to(cuda))
        a = a / a.norm(dim=-1, keepdim=True)
        v = -(d * np.cos(theta) + a * np.sin(theta))
        x[3] = x[3].clone()
        x[3][:near] = (v / v.norm(dim=-1, keepdim=True)).float()
        gen = torch.Generator().manual_seed(seed)
        cot = [torch.randn((P, 3), generator=gen).to(cuda) for _ in range(3)]
        dvdir = shading_cuda.shade_bwd(*shading_cuda.kernel_inputs(*x), *cot)[2]
        torch.cuda.synchronize()
        plain = plain_shading_grads(tuple(x), cot)[2][:near]
        exact = plain_shading_grads(tuple(t.double() for t in x),
                                    [c.double() for c in cot])[2][:near]
        e_kernel, e_plain = bwd_err(dvdir[:near], exact), bwd_err(plain, exact)
        assert e_kernel <= min(1e-5, 0.1 * e_plain), (
            theta, seed, e_kernel, e_plain)
        _, _, info = cs.check_k4(tuple(x), f"k4-antipodal-{seed}", seed,
                                 timed=False)
        assert info["float32_sign_flips"] == 0


@pytest.mark.parametrize("delta", [0.0, 1e-7])
def test_k4_takes_the_local_lights_sign_from_float64_near_zero(cuda, delta):
    """The first 200 of 2000 points get the constant SH coefficient that
    puts the local light e at sample 5 at +-delta in each channel before
    float32 rounding, as examples/k4_conditioning.py builds them. max(e, 0)
    passes the SH gradient by e's sign, which float32 rounding can flip:
    the plain float32 version's SH gradient is off by up to ~9e-2 of the
    largest entry at delta = 0. K4 takes e's sign from float64 where
    |e| is within float32's rounding: its SH gradient stays within 1e-5
    and a tenth of the plain version's error, and chip_smoke's K4 gate
    passes on the whole case."""
    from relightable3dgaussian_tpu_torch.utils.sh import eval_sh_basis
    cs = chip_smoke_module()
    near, P = 200, 2000
    for seed in range(2):
        x = list(shading_inputs(P, 64, 50 + seed, cuda))
        Y = eval_sh_basis(3, x[7][:near, 5].double())
        rest = (Y[:, 1:, None] * x[4][:near, 1:].double()).sum(1)
        sign = 1.0 - 2.0 * (torch.arange(near, device=cuda) % 2)
        x[4] = x[4].clone()
        x[4][:near, 0] = ((delta * sign[:, None] - rest) / Y[:, :1]).float()
        gen = torch.Generator().manual_seed(seed)
        cot = [torch.randn((P, 3), generator=gen).to(cuda) for _ in range(3)]
        dshs = shading_cuda.shade_bwd(*shading_cuda.kernel_inputs(*x), *cot)[3]
        torch.cuda.synchronize()
        plain = plain_shading_grads(tuple(x), cot)[3][:near]
        exact = plain_shading_grads(tuple(t.double() for t in x),
                                    [c.double() for c in cot])[3][:near]
        got = dshs.view(P, 16, 3)[:near]
        e_kernel, e_plain = bwd_err(got, exact), bwd_err(plain, exact)
        assert e_kernel <= min(1e-5, 0.1 * e_plain), (
            delta, seed, e_kernel, e_plain)
        cs.check_k4(tuple(x), f"k4-light-zero-{seed}", seed, timed=False)


@pytest.mark.parametrize("delta", [1e-8, 1e-6, 1e-5, 5e-4, 2e-3])
@pytest.mark.parametrize("case", ["q-clip", "nov-clip", "noh-clip",
                                  "voh-clip"])
def test_k4_holds_float64_at_its_clips(cuda, case, delta):
    """2000 points built as chip_smoke.k4_branch_case builds them (as
    examples/k4_conditioning.py and the k4-branches phase do): the GGX
    denominator q, NoV, NoH or VoH of each at 1e-6 (1 + delta) in float64,
    alternating in sign, where float32 can decide the clip either way
    (5e-4 at the edge of K4's band for q, 2e-3 beyond it). K4 takes the
    clips of q, NoV and VoH from float64 where float32 could err, so there
    chip_smoke's K4 gate passes on K4's tolerance alone, without K4_SLACK;
    at NoH's clip, whose jump carries the factor NoH = 1e-6, as the gate
    stands. No point is viewed at grazing."""
    cs = chip_smoke_module()
    x, _, reached = cs.k4_branch_case(case, 2000, 64, 700, cuda, (delta,))
    assert (abs(reached) <= delta).all()
    _, _, info = cs.check_k4(x, f"k4-{case}-{delta:g}", 7, timed=False,
                             slack=case not in cs.K4_SLACK_FREE)
    assert info["float32_sign_flips"] == 0


# ---------------------------------------------------------------------------
# the dense oracle and two ranks sharing the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_dense_oracle_on_the_card_matches_the_cpu(cuda, dtype, atol):
    """ops.rasterize_dense on the card against the CPU on 300 gaussians at
    64x64: the same function, its sums in the card's order."""
    from relightable3dgaussian_tpu_torch.ops.rasterize_dense import \
        rasterize_dense
    rng = np.random.default_rng(4)
    n = 300
    rots = rng.normal(size=(n, 4))
    arrays = (rng.uniform(-1.2, 1.2, (n, 3)), rng.uniform(0.02, 0.15, (n, 3)),
              rots / np.linalg.norm(rots, axis=-1, keepdims=True),
              rng.uniform(0.2, 0.95, (n, 1)), rng.normal(size=(n, 1, 3)),
              rng.normal(size=(n, 5)))
    cfg = RasterConfig(64, 64, sh_degree=0)
    outs = []
    for dev in ("cpu", cuda):
        cam = make_camera_params(np.eye(3), np.array([0.0, 0.0, 4.0]), 64, 64,
                                 fovx=0.9, fovy=0.9, device=dev)
        x = [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]
        outs.append(rasterize_dense(*x, cam=cam, cfg=cfg,
                                    bg_color=torch.zeros(3, device=dev)))
    got, want = outs[1], outs[0]
    assert got.color.dtype == dtype and got.color.device.type == cuda.type
    for name in ("color", "opacity", "depth", "feature", "weights"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), atol=atol, rtol=0)
    assert torch.equal(got.n_contrib.cpu(), want.n_contrib)
    assert torch.equal(got.radii.cpu(), want.radii)


@pytest.fixture
def two_cards(cuda):
    """cuda:0 and cuda:1, one rank a card (NCCL)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: one rank a card over NCCL")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_two_ranks_share_the_card_over_gloo(cuda):
    """parallel.spawn with two ranks on cuda:0 (gloo, whose all_reduce and
    broadcast take CUDA tensors): the ray-sharded visibility bitwise one K3
    launch's on all rays, update_visibility through it bitwise the
    one-launch cache, the sharded shading the unsharded shading's within
    1e-6."""
    check_sharded_ranks([cuda, cuda], cuda)


def test_nccl_sharded_trace_is_one_k3_launch(two_cards):
    """As test_two_ranks_share_the_card_over_gloo, one rank on each of two
    cards over NCCL."""
    from relightable3dgaussian_tpu_torch.parallel.data_parallel import \
        choose_backend
    assert choose_backend(two_cards) == "nccl"
    check_sharded_ranks(two_cards, two_cards[0])


def check_sharded_ranks(devices, cuda):
    """The sharded trace, update_visibility and shading on `devices` (one
    rank an entry) against one K3 launch and the unsharded shading on
    `cuda`."""
    import test_torch_ranks as torch_ranks
    from relightable3dgaussian_tpu_torch.parallel import spawn
    from relightable3dgaussian_tpu_torch.utils.graphics import \
        fibonacci_sphere_sampling as fib

    assert _build.load_library(ray_trace_cuda.KERNEL)   # built before spawn
    d = scene(8, 2000)
    model = GaussianModel.from_numpy(d, device=cuda)
    rng = np.random.default_rng(9)
    n, S = 61, 16
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    dirs, areas = fib(torch.from_numpy(normals), S)
    view_d = rng.normal(size=(n, 3)).astype(np.float32)
    shading = dict(base=rng.uniform(size=(n, 3)).astype(np.float32),
                   rough=rng.uniform(0.1, 0.9, (n, 1)).astype(np.float32),
                   normals=normals,
                   view=view_d / np.linalg.norm(view_d, axis=-1,
                                                keepdims=True),
                   incidents=(rng.normal(size=(n, 16, 3)) * 0.1
                              ).astype(np.float32),
                   vis=rng.uniform(size=(n, S, 1)).astype(np.float32),
                   dirs=dirs.numpy(), areas=areas.numpy(),
                   env=rng.uniform(size=(8, 16, 3)).astype(np.float32))
    with torch.no_grad():
        sdirs, _ = fibonacci_sphere_sampling(model.get_normal, 8)
        bvh, rays_o, rays_d = render_neilf.visibility_rays(model, sdirs)
        trace = dict(xyz=model.xyz.cpu().numpy(),
                     scaling=model.get_scaling.cpu().numpy(),
                     rot=model.get_rotation.cpu().numpy(),
                     op=model.get_opacity[:, 0].cpu().numpy(),
                     nrm=model.get_normal.cpu().numpy(),
                     rays_o=rays_o.cpu().numpy(), rays_d=rays_d.cpu().numpy())
        whole = ray_trace.trace_visibility(bvh, rays_o, rays_d).cpu().numpy()
        cache = render_neilf.update_visibility(model, 8).visibility
    r0, r1 = spawn(torch_ranks.sharded, devices, shading, trace,
                   d, 8, timeout_s=300, collective_timeout_s=120)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["trace"], whole)
        np.testing.assert_array_equal(r["visibility"], cache.cpu().numpy())
        assert r["last_stats"] == {"rounds": 0, "retraced_rays": 0}
    x = {k: torch.as_tensor(v, device=cuda) for k, v in shading.items()}
    env = DirectLightMap.from_raw(x.pop("env"))
    with torch.no_grad():
        pbr, extras = render_neilf._shade_points(
            x["base"], x["rough"], x["normals"], x["view"], x["incidents"],
            env, render_neilf.VisibilityCache(x["vis"], x["dirs"],
                                              x["areas"]))
    np.testing.assert_allclose(r0["eval_pbr"], pbr.cpu().numpy(), atol=1e-6)
    for k, v in extras.items():
        np.testing.assert_allclose(r0[f"eval.{k}"], v.cpu().numpy(),
                                   atol=1e-6, err_msg=k)


def test_nccl_replicas_stay_bitwise_equal(two_cards, tmp_path):
    """Three data-parallel stage-1 steps on two cards over NCCL from a
    seeded 3000-gaussian state at 128x128 (two views a step): rank 0's
    model replicated, then every replica's digest equal after every
    step."""
    import test_torch_ranks as torch_ranks
    from relightable3dgaussian_tpu_torch.parallel import spawn
    from relightable3dgaussian_tpu_torch.train.checkpoint import \
        save_checkpoint
    from relightable3dgaussian_tpu_torch.train.optim import make_optimizer
    assert _build.load_library(composite_cuda.KERNEL)
    assert _build.load_library(composite_cuda.BWD_KERNEL)
    opt = OptimizationConfig(**STAGE1_NERF_SYNTHETIC)
    target = GaussianModel.from_numpy(scene(11), device="cpu")
    model = GaussianModel.from_numpy(scene(12), device="cpu")
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, 3, model, make_optimizer(model, opt, 3.0))
    views = []
    for a in (0.0, 0.5, 1.0, 1.5, 2.0, 2.5):
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        cam = make_camera_params(R, np.array([0.0, 0.0, 3.0]), SIZE, SIZE,
                                 fovx=0.9, fovy=0.9, device="cpu")
        z = torch.zeros((3, SIZE, SIZE))
        with torch.no_grad():
            img = render(ViewInputs(cam, z, z[:1] + 1, z[:1], z), target,
                         RasterConfig(SIZE, SIZE), torch.zeros(3))["render"]
        views.append({"R": R, "T": np.array([0.0, 0.0, 3.0]), "size": SIZE,
                      "fov": 0.9, "image": img.numpy(),
                      "mask": np.ones((1, SIZE, SIZE), np.float32)})
    batches = [views[0:2], views[2:4], views[4:6]]
    r0, r1 = spawn(torch_ranks.dp_steps, two_cards, path, dict(vars(opt)),
                   3.0, SIZE, batches, 4, timeout_s=300,
                   collective_timeout_s=120)
    assert r0 == r1 and len(r0) == 3
    assert all(len(set(d)) == 1 and len(d) == 2 for d in r0)


def test_eval_nvs_on_two_cards_matches_one(two_cards, tmp_path):
    """cli.eval_nvs -t neilf --n_devices 2 (one rank a card, NCCL) on a
    short stage-2 run's checkpoint: the one-rank metrics and test renders,
    bitwise."""
    from relightable3dgaussian_tpu_torch.cli import eval_nvs
    from relightable3dgaussian_tpu_torch.cli import train as train_cli
    from relightable3dgaussian_tpu_torch.scene.image_io import read_png
    data, out1, out2 = tmp_path / "data", tmp_path / "s1", tmp_path / "s2"
    write_scene(data)
    train_cli.main(["-s", str(data), "-m", str(out1), "--iterations", "6",
                    "--max_init_points", "2000", "--save_interval", "6",
                    "--checkpoint_interval", "6"], device=two_cards[0])
    train_cli.main(["-s", str(data), "-m", str(out2), "-t", "neilf",
                    "-c", str(out1 / "chkpnt6.npz"), "--iterations", "10",
                    "--sample_num", "8", "--save_interval", "10",
                    "--checkpoint_interval", "10"], device=two_cards[0])
    argv = ["-s", str(data), "-m", str(out2), "-t", "neilf", "-c",
            str(out2 / "chkpnt10.npz"), "--skip_train", "--sample_num", "8"]
    one = eval_nvs.main(argv + ["--n_devices", "1"], device=two_cards[0])
    (out2 / "test").rename(out2 / "test_one")
    two = eval_nvs.main(argv + ["--n_devices", "2"], device=two_cards[0])
    for k in ("psnr", "ssim"):
        assert two["test"][k] == one["test"][k], k
    pngs = sorted(p.name for p in (out2 / "test_one" / "renders").iterdir())
    assert pngs
    for name in pngs:
        np.testing.assert_array_equal(
            read_png(str(out2 / "test" / "renders" / name)),
            read_png(str(out2 / "test_one" / "renders" / name)), name)

