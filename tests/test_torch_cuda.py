"""Kernels K1 and K2 on the card against their plain PyTorch versions.

Needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; skips without one. These tests
import no jax, so on a machine without it run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel
from relightable3dgaussian_tpu_torch.models.render import render, view_features
from relightable3dgaussian_tpu_torch.models.render import ViewInputs
from relightable3dgaussian_tpu_torch.ops import composite_cuda
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.ops.composite import composite as composite_plain
from relightable3dgaussian_tpu_torch.ops.composite import composite_backward
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.rasterize import prepare
from relightable3dgaussian_tpu_torch.train.checkpoint import (load_checkpoint,
                                                              load_train_state,
                                                              save_checkpoint)
from relightable3dgaussian_tpu_torch.train.config import (STAGE1_NERF_SYNTHETIC,
                                                          OptimizationConfig)
from relightable3dgaussian_tpu_torch.train.optim import (learning_rates,
                                                         make_optimizer)
from relightable3dgaussian_tpu_torch.train.stage1 import train_step

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
@pytest.mark.parametrize("n_features", [4, 1, 27])      # A = 9, 6, 32
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
    before = composite_cuda.LAUNCHES
    gpu = render(view(cuda, h, w), GaussianModel.from_numpy(d, device=cuda),
                 cfg, torch.zeros(3, device=cuda))
    assert composite_cuda.LAUNCHES == before + 1
    assert gpu["render"].shape == (3, h, w)
    cpu = render(view("cpu", h, w), GaussianModel.from_numpy(d), cfg,
                 torch.zeros(3))
    assert composite_cuda.LAUNCHES == before + 1
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
@pytest.mark.parametrize("n_features", [4, 1, 27])      # A = 9, 6, 32
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
    before = composite_cuda.BWD_LAUNCHES
    got = composite_cuda.composite_k2(binning, mean2d, conic, opacity, attrs,
                                      walk, g_image, g_weights, cfg)
    torch.cuda.synchronize()
    assert composite_cuda.BWD_LAUNCHES == before + 1
    want = composite_backward(binning, mean2d, conic, opacity, attrs,
                              g_image, g_weights, cfg)
    for name, g, w in zip(("mean2d", "conic", "opacity", "attrs"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert max_rel_err(g, w) <= 1e-4, (name, max_rel_err(g, w))


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
        before = composite_cuda.BWD_LAUNCHES
        loss.backward()
        assert composite_cuda.BWD_LAUNCHES == before + (device.type == "cuda")
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
    save_checkpoint(path, 1, GaussianModel.from_numpy(scene(3)))
    grads = {}
    for device in (cuda, torch.device("cpu")):
        _, model = load_checkpoint(path, device=device)
        before = (composite_cuda.LAUNCHES, composite_cuda.BWD_LAUNCHES)
        out = render(view(device), model, RasterConfig(SIZE, SIZE),
                     torch.zeros(3, device=device))
        loss = out["render"].square().mean() + out["opacity"].mean()
        loss.backward()
        launched = int(device.type == "cuda")
        assert (composite_cuda.LAUNCHES, composite_cuda.BWD_LAUNCHES) == (
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
                 shs_dc=d["shs_dc"][:, :, ::-1].copy())), cfg,
            torch.zeros(3))
    gt_view = view("cpu")._replace(image=gt["render"],
                                   image_mask=(gt["opacity"] > 0.5).float())
    model = GaussianModel.from_numpy(d)
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
        before = (composite_cuda.LAUNCHES, composite_cuda.BWD_LAUNCHES)
        runs.append(step_from_state(path, gt_view, device))
        launched = int(device.type == "cuda")
        assert (composite_cuda.LAUNCHES, composite_cuda.BWD_LAUNCHES) == (
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
