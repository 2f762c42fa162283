"""Kernel K1 on the card against its plain PyTorch version.

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
from relightable3dgaussian_tpu_torch.ops.config import RasterConfig
from relightable3dgaussian_tpu_torch.ops.rasterize import prepare
from relightable3dgaussian_tpu_torch.train.checkpoint import (load_checkpoint,
                                                              save_checkpoint)

pytestmark = pytest.mark.cuda
SIZE = 128


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
    got = composite_cuda.composite_k1(*args)
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


def test_k1_refuses_inputs_that_require_grad(cuda):
    with torch.no_grad():
        binning, mean2d, conic, opacity, attrs, cfg = k1_args(cuda, 4)
    with pytest.raises(NotImplementedError, match="K2"):
        composite_cuda.composite(binning, mean2d.requires_grad_(), conic,
                                 opacity, attrs, cfg)


def test_render_of_loaded_checkpoint_needs_no_grad_on_cuda(cuda, tmp_path):
    """A loaded model's parameters require grad; the forward-only slice
    refuses them on the card instead of taking the plain path."""
    path = str(tmp_path / "chkpnt1.npz")
    save_checkpoint(path, 1, GaussianModel.from_numpy(scene(3)))
    _, model = load_checkpoint(path, device=cuda)
    args = (view(cuda), model, RasterConfig(SIZE, SIZE),
            torch.zeros(3, device=cuda))
    before = composite_cuda.LAUNCHES
    with pytest.raises(NotImplementedError, match="K2"):
        render(*args)
    assert composite_cuda.LAUNCHES == before
    with torch.no_grad():
        out = render(*args)
    assert composite_cuda.LAUNCHES == before + 1
    assert out["num_rendered"] > 0


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
