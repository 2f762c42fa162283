"""The plain reference against itself at a tiny size: its Adam against
torch's, its batch-wise compositor backward against autograd through the
plain compositor, and its render in float32 against float64."""
import math

import numpy as np
import torch

from benchmark import scene
from benchmark.reference import composite as RC
from benchmark.reference import render as RR
from benchmark.reference import train as RT
from benchmark.reference.camera import make_camera_params
from benchmark.reference.config import RasterConfig


def _scene(P=400, size=32, seed=0, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    p = {k: v.to(dtype) for k, v in scene.make_points(P, gen, "cpu").items()}
    R, T = scene.hemisphere_cameras(4, 4.03)[1]
    fov = 0.6911112070083618
    cam = make_camera_params(R, T, size, size, fovx=fov, fovy=fov,
                             device="cpu")
    cam = type(cam)(*(x.to(dtype) for x in cam))
    return p, cam, RasterConfig(height=size, width=size)


def test_adam_is_torchs():
    torch.manual_seed(0)
    for start in (0, 30_000):
        a = torch.randn(50, dtype=torch.float64)
        b = a.clone().requires_grad_(True)
        ours = RT.Adam({"x": a}, step=start)
        theirs = torch.optim.Adam([b], lr=1e-2, betas=RT.BETAS, eps=RT.EPS)
        for _ in range(3):
            g = torch.randn(50, dtype=torch.float64)
            if start and not theirs.state:
                theirs.state[b] = {"step": torch.tensor(float(start)),
                                   "exp_avg": torch.zeros_like(b),
                                   "exp_avg_sq": torch.zeros_like(b)}
            b.grad = g.clone()
            theirs.step()
            ours.step({"x": g}, {"x": 1e-2})
        torch.testing.assert_close(a, b.detach(), rtol=1e-12, atol=1e-12)


def test_batchwise_backward_is_autograds():
    p, cam, cfg = _scene()
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    prep, binning, attrs = RR.prepare(
        leaves["xyz"], RR.act_scaling(leaves), RR.act_rotation(leaves),
        RR.act_opacity(leaves), RR.act_shs(leaves),
        torch.zeros((400, 0), dtype=torch.float64), cam, cfg)
    args = (prep.mean2d, prep.conic, RR.act_opacity(leaves)[:, 0], attrs)
    g = torch.randn((cfg.num_tiles, 256, attrs.shape[1]), dtype=torch.float64)
    image, weights, _ = RR._Composite.apply(*args, binning, cfg)
    ours = torch.autograd.grad((image * g).sum() + weights.sum(), args,
                               retain_graph=True)
    plain = RC.composite(binning, *args, cfg)
    theirs = torch.autograd.grad((plain.image * g).sum()
                                 + plain.weights.sum(), args)
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_render_float32_is_float64_to_rounding():
    p, cam, cfg = _scene()
    bg = torch.zeros(3, dtype=torch.float64)
    want = RR.render_view(p, cam, cfg, bg)
    p32 = {k: v.float() for k, v in p.items()}
    cam32 = type(cam)(*(x.float() for x in cam))
    got = RR.render_view(p32, cam32, cfg, bg.float())
    assert want["num_rendered"] > 0 and float(want["opacity"].max()) > 0.5
    for k in ("render", "depth", "normal"):
        err = float((got[k].double() - want[k]).abs().mean())
        assert err < 1e-5, (k, err)


def test_ground_truth_sees_the_object():
    R, T = scene.hemisphere_cameras(100, 4.03)[50]
    img, mask = scene.ground_truth((R, T), 64, 64, 0.6911112070083618, "cpu")
    assert 0.2 < float(mask.mean()) < 0.9
    assert math.isclose(float(img[:, mask[0] == 0].abs().max()), 0.0)
    centres = np.stack([-R @ T for R, T in scene.hemisphere_cameras(100, 4.03)])
    assert np.allclose(np.linalg.norm(centres, axis=1), 4.03)
    assert (centres[:, 2] > 0).all()
