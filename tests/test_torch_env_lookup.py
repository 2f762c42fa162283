"""The env light's lookup on the card (`ops/env_lookup_cuda.py`,
`csrc/env_lookup.cu`): on the CPU, a plain explicit-bilinear mirror of the
kernels' arithmetic (taps, weights, zero padding, the per-block partials
and their fixed-order sum) against `F.grid_sample`'s forward and autograd
gradient in float64, the backward's branch and grid by map size, the
wrapper's refusals, and that CPU tensors take the plain path; on the card
the kernels against the plain path, the gradient's bitwise reproducibility
and the counters.

The card tests (marker `cuda`) skip without an NVIDIA GPU; they import no
jax, so on a machine without it run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_env_lookup.py`.
"""
import math

import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu_torch.models import lights
from relightable3dgaussian_tpu_torch.ops import env_lookup_cuda as elc
from relightable3dgaussian_tpu_torch.utils import trace

H100_SMS = 132
COUNTERS = ("env.lookup_launches", "env.lookup_bwd_launches",
            "env.bwd_private")
# Directions where the lookup is delicate: both poles (+z: phi = -1e-6, so
# the top row's taps lie outside the map, zero padding), both sides of the
# seam (theta = +pi: gx = -1, ix = 0; theta = -pi: gx = 1, ix = W - 1 and
# the right taps outside), and next to them.
SPECIAL = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.0],
           [-1.0, -0.0, 0.0], [-1.0, 1e-9, 0.0], [-1.0, -1e-9, 0.0],
           [1e-9, 0.0, 1.0], [-1.0, -1e-7, 1e-3], [1.0, 0.0, 0.0],
           [0.0, 1.0, 0.0]]


def directions(n: int, seed: int, dtype=torch.float64) -> torch.Tensor:
    """n seeded unit directions, SPECIAL first."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d[:len(SPECIAL)] = SPECIAL
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.tensor(d, dtype=dtype)


def env_map(H: int, seed: int, dtype=torch.float64) -> torch.Tensor:
    return torch.tensor(0.5 + np.random.default_rng(seed).uniform(
        size=(H, 2 * H, 3)), dtype=dtype)


def turn(angle: float, dtype=torch.float64) -> torch.Tensor:
    """A rotation about +z and then +x (an EnvLight's transform)."""
    c, s = math.cos(angle), math.sin(angle)
    rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
    return (rx @ rz).to(dtype)


# ------------------------------------------------ the mirror, on the CPU

def mirror_taps(dirs, transform, H: int, W: int):
    """The kernels' taps: texel indices y W + x (-1 outside the map) [N, 4]
    and weights [N, 4] in grid_sample's order nw, ne, sw, se."""
    d = dirs if transform is None else dirs @ transform.T
    phi = torch.arccos(torch.clamp(d[:, 2], -1.0, 1.0)) - 1e-6
    theta = torch.atan2(d[:, 1], d[:, 0])
    gy = (phi / math.pi) * 2.0 - 1.0
    gx = -theta / math.pi
    ix = ((gx + 1) / 2) * (W - 1)
    iy = ((gy + 1) / 2) * (H - 1)
    fx, fy = torch.floor(ix), torch.floor(iy)
    wx = (fx + 1 - ix, ix - fx)
    wy = (fy + 1 - iy, iy - fy)
    idx, w = [], []
    for c in range(4):
        xi, yi = fx.long() + (c & 1), fy.long() + (c >> 1)
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx.append(torch.where(inside, yi * W + xi, -1))
        w.append(wx[c & 1] * wy[c >> 1])
    return torch.stack(idx, 1), torch.stack(w, 1)


def mirror_forward(envmap, dirs, transform=None):
    """The forward kernel's sum over the taps inside the map."""
    H, W = envmap.shape[:2]
    idx, w = mirror_taps(dirs, transform, H, W)
    texels = envmap.reshape(-1, 3)
    out = torch.zeros((dirs.shape[0], 3), dtype=envmap.dtype)
    for c in range(4):
        inside = idx[:, c] >= 0
        out = out + torch.where(inside[:, None],
                                texels[idx[:, c].clamp(min=0)] * w[:, c, None],
                                0.0)
    return out


def mirror_backward(dirs, transform, g_out, H: int, W: int,
                    sms: int = H100_SMS):
    """The backward kernels' sum: sample i in block (i // THREADS) % blocks
    (the grid-stride walk), each block's partial, then the reduce's order:
    the blocks in REDUCE_WARPS contiguous shares, each summed in order, the
    shares added in order."""
    n = dirs.shape[0]
    blocks = elc.backward_blocks(n, H, W, sms)
    idx, w = mirror_taps(dirs, transform, H, W)
    block = (torch.arange(n) // elc.THREADS) % blocks
    partial = torch.zeros((blocks, H * W, 3), dtype=g_out.dtype)
    for c in range(4):
        ok = idx[:, c] >= 0
        partial.index_put_((block[ok], idx[ok, c]),
                           w[ok, c, None] * g_out[ok], accumulate=True)
    per = -(-blocks // 8)                     # csrc kReduceWarps = 8
    shares = []
    for b0 in range(0, 8 * per, per):
        s = torch.zeros((H * W, 3), dtype=g_out.dtype)
        for b in range(b0, min(b0 + per, blocks)):
            s = s + partial[b]
        shares.append(s)
    total = torch.zeros((H * W, 3), dtype=g_out.dtype)
    for s in shares:
        total = total + s
    return total.reshape(H, W, 3)


@pytest.mark.parametrize("H,n", [(16, 3000), (64, 3000), (512, 3000)])
@pytest.mark.parametrize("turned", [False, True])
def test_mirror_matches_grid_sample_forward_and_gradient(H, n, turned):
    """In float64 the mirror's radiance and map gradient equal grid_sample's
    (equirect_query_plain and autograd through it) at 16 x 32 (s2-train's
    map), 64 x 128 and 512 x 1024 (the relighting maps), at the poles, on
    the seam and with taps outside the map."""
    dirs = directions(n, H + n)
    tf = turn(0.7) if turned else None
    env = env_map(H, H).requires_grad_()
    g = torch.tensor(np.random.default_rng(H + 1).normal(size=(n, 3)))
    want = lights.equirect_query_plain(env, dirs, tf)
    (want * g).sum().backward()
    got = mirror_forward(env.detach(), dirs, tf)
    torch.testing.assert_close(got, want.detach(), rtol=1e-12, atol=1e-12)
    grad = mirror_backward(dirs, tf, g, H, 2 * H)
    torch.testing.assert_close(grad, env.grad, rtol=1e-10, atol=1e-10)


def test_mirror_covers_the_edge_cases():
    """The special directions take the zero padding: +z's top taps lie
    outside the map, theta = -pi's right taps too, and every inside tap of
    theta = +pi is in column 0."""
    H, W = 16, 32
    idx, w = mirror_taps(directions(len(SPECIAL), 0), None, H, W)
    assert (idx[0, :2] == -1).all() and (idx[0, 2:] >= 0).all()   # +z
    assert (idx[3, 1::2] == -1).all() and (idx[3, ::2] % W == W - 1).all()
    assert (idx[2, ::2] % W == 0).all()                            # +pi
    torch.testing.assert_close(w.sum(1), torch.ones(len(SPECIAL),
                                                    dtype=torch.float64))


@pytest.mark.parametrize("H,W,private,blocks", [
    (16, 32, True, 4 * H100_SMS),     # s2-train's map: 48 KB a block
    (32, 64, True, H100_SMS),         # one upsample: 192 KB, a block an SM
    (64, 128, False, 8 * H100_SMS),   # beyond: global atomics
    (128, 256, False, 8 * H100_SMS),
    (512, 1024, False, 8 * H100_SMS),
])
def test_branch_and_grid_follow_the_map_size(H, W, private, blocks):
    assert elc.private_branch(H, W) == private
    assert elc.backward_blocks(19_200_000, H, W, H100_SMS) == blocks
    # never more blocks than the samples fill
    assert elc.backward_blocks(1000, H, W, H100_SMS) == 4
    assert elc.backward_blocks(1, H, W, H100_SMS) == 1


def test_private_copies_fit_the_block_budget():
    """The largest private map's copies fit the 227 KB a block may hold,
    and the first map past it does not fit the budget."""
    assert elc.WARPS * 3 * 2048 * 4 == elc.PRIVATE_BYTES <= 227 * 1024
    assert not elc.private_branch(1, 2049)


def _good_inputs():
    return (torch.rand(16, 32, 3), torch.rand(100, 3), torch.eye(3))


@pytest.mark.parametrize("case,match", [
    ("map_float64", "envmap: got torch.float64"),
    ("map_flat", r"envmap: got torch.float32 \(512, 3\)"),
    ("dirs_float64", "dirs: got torch.float64"),
    ("dirs_4", r"dirs: got torch.float32 \(100, 4\)"),
    ("transform_4x4", r"transform: got torch.float32 \(4, 4\)"),
    ("dirs_strided", "dirs: not contiguous"),
    ("map_strided", "envmap: not contiguous"),
    ("dirs_grad", "dirs: requires grad"),
    ("transform_grad", "transform: requires grad"),
    ("on_cpu", "envmap: on cpu, expected the map's CUDA device"),
])
def test_wrapper_refuses_before_any_launch(case, match):
    env, dirs, tf = _good_inputs()
    if case == "map_float64":
        env = env.double()
    elif case == "map_flat":
        env = env.reshape(-1, 3)
    elif case == "dirs_float64":
        dirs = dirs.double()
    elif case == "dirs_4":
        dirs = torch.rand(100, 4)
    elif case == "transform_4x4":
        tf = torch.eye(4)
    elif case == "dirs_strided":
        dirs = torch.rand(3, 100).T
    elif case == "map_strided":
        env = torch.rand(32, 16, 3).transpose(0, 1)
    elif case == "dirs_grad":
        dirs.requires_grad_()
    elif case == "transform_grad":
        tf.requires_grad_()
    before = [trace.counter(c) for c in COUNTERS]
    with pytest.raises(ValueError, match=match):
        elc.env_lookup(env, dirs, tf)
    assert [trace.counter(c) for c in COUNTERS] == before


@pytest.mark.parametrize("light", ["map", "env"])
def test_cpu_tensors_take_the_plain_path(light):
    """On CPU tensors equirect_query is the plain version bitwise, forward
    and gradient, and no launch is counted."""
    before = [trace.counter(c) for c in COUNTERS]
    dirs = directions(500, 5, torch.float32).reshape(20, 25, 3)
    raw = env_map(16, 6, torch.float32)
    if light == "map":
        model = lights.DirectLightMap.from_raw(raw)
    else:
        model = lights.EnvLight(raw.requires_grad_(), turn(0.3, torch.float32))
    got = lights.query_light(model, dirs)
    got.square().sum().backward()
    param = model.env if light == "map" else model.envmap
    grad, param.grad = param.grad, None
    want = lights.query_light(model, dirs, plain=True)
    want.square().sum().backward()
    assert got.shape == (20, 25, 3)
    assert torch.equal(got, want) and torch.equal(grad, param.grad)
    assert [trace.counter(c) for c in COUNTERS] == before


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


# The kernels (float32) against the plain path in float64 on the card: the
# largest error within TOL of the scale, or within SLACK times the plain
# float32 path's own error on the same inputs. Forward: scale the map's
# largest entry; both round the tap coordinates in float32 (acosf, atan2f,
# the source index ((g + 1) / 2) (W - 1): up to ~1e-4 texel at W = 1024),
# which moves a sample by that much of its texels' difference. Gradient:
# scale the float64 gradient's largest entry; both sum ~4 N / (H W) terms a
# texel in float32 in another order (the plain path's atomics; the kernel's
# warp copies, then its blocks, or its atomics), over the same coordinates.
FWD_TOL, BWD_TOL, SLACK = 1e-6, 1e-5, 2.0


def _card_case(H: int, n: int, turned: bool, seed: int, device):
    dirs = directions(n, seed).to(device)
    env = env_map(H, seed + 1).to(device)
    tf = turn(0.3).to(device) if turned else None
    g = torch.tensor(np.random.default_rng(seed + 2).normal(size=(n, 3)),
                     device=device)
    return env, dirs, tf, g


def _f32(*xs):
    return tuple(None if x is None else x.float().contiguous() for x in xs)


def _within(name, got, want64, plain32, tol, scale):
    e_k = float((got.double() - want64).abs().max())
    e_p = float((plain32.double() - want64).abs().max())
    assert e_k <= max(tol * scale, SLACK * e_p), (
        f"{name}: kernel {e_k:.3e}, plain float32 {e_p:.3e}, scale "
        f"{scale:.3e}")


def _run(env, dirs, tf, g, plain: bool):
    """(radiance, the map's gradient) through equirect_query, or the plain
    version."""
    env = env.detach().clone().requires_grad_()
    fn = lights.equirect_query_plain if plain else lights.equirect_query
    out = fn(env, dirs, tf)
    (out * g).sum().backward()
    return out.detach(), env.grad


@pytest.mark.cuda
@pytest.mark.parametrize("H,n,turned", [
    (16, 1_000_003, False),       # s2-train's map, odd n
    (16, 300_000, True),
    (64, 300_000, False),
    (512, 640_000, True),         # s2-relight's background
])
def test_forward_matches_plain(cuda, H, n, turned):
    env, dirs, tf, _ = _card_case(H, n, turned, H + n, cuda)
    want = lights.equirect_query_plain(env, dirs, tf)
    e32, d32, t32 = _f32(env, dirs, tf)
    before = trace.counter("env.lookup_launches")
    with torch.no_grad():
        got = lights.equirect_query(e32, d32, t32)
    torch.cuda.synchronize()
    assert trace.counter("env.lookup_launches") == before + 1
    assert got.shape == (n, 3) and got.is_contiguous()
    plain = lights.equirect_query_plain(e32, d32, t32)
    _within("forward", got, want, plain, FWD_TOL, float(env.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("H,turned", [(16, False), (16, True), (32, False),
                                      (64, False), (64, True), (128, False),
                                      (128, True)])
def test_gradient_matches_plain(cuda, H, turned):
    """16 x 32 and 32 x 64 take the private branch, 64 x 128 and 128 x 256
    the global one."""
    n = 500_000
    env, dirs, tf, g = _card_case(H, n, turned, 7 * H, cuda)
    _, want = _run(env, dirs, tf, g, plain=True)
    x32 = _f32(env, dirs, tf, g)
    before = [trace.counter(c) for c in COUNTERS]
    out, got = _run(*x32, plain=False)
    torch.cuda.synchronize()
    private = int(elc.private_branch(H, 2 * H))
    assert [trace.counter(c) for c in COUNTERS] == [
        before[0] + 1, before[1] + 1, before[2] + private]
    _, plain = _run(*x32, plain=True)
    _within("gradient", got, want, plain, BWD_TOL, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 32])
def test_private_gradient_is_bitwise_reproducible(cuda, H):
    """Two backward runs on the same inputs give the same bits: the private
    branch's sums fall in one order, fixed by the samples and the grid."""
    env, dirs, tf, g = _f32(*_card_case(H, 2_000_000, True, 3 * H, cuda))
    grads = [_run(env, dirs, tf, g, plain=False)[1] for _ in range(3)]
    torch.cuda.synchronize()
    assert float(grads[0].abs().max()) > 0
    assert all(torch.equal(grads[0], x) for x in grads[1:])


@pytest.mark.cuda
def test_counters_count_each_launch(cuda):
    """Forward and backward each count one launch a call, the private
    branch its own; a call without grad launches no backward."""
    before = [trace.counter(c) for c in COUNTERS]
    for H in (16, 64):
        env, dirs, tf, g = _f32(*_card_case(H, 10_000, False, H, cuda))
        _run(env, dirs, tf, g, plain=False)
        with torch.no_grad():
            lights.equirect_query(env, dirs)
    assert [trace.counter(c) for c in COUNTERS] == [
        before[0] + 4, before[1] + 2, before[2] + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "dirs_grad", "mixed", "strided"])
def test_card_refusals_launch_nothing(cuda, case):
    env, dirs, tf, _ = _f32(*_card_case(16, 100, True, 1, cuda))
    if case == "float64":
        env = env.double()
    elif case == "dirs_grad":
        dirs.requires_grad_()
    elif case == "mixed":
        tf = tf.cpu()
    elif case == "strided":
        dirs = dirs.T.contiguous().T
    before = [trace.counter(c) for c in COUNTERS]
    with pytest.raises(ValueError):
        if case == "strided":
            elc.env_lookup(env, dirs, tf)
        else:
            lights.equirect_query(env, dirs, tf)
    assert [trace.counter(c) for c in COUNTERS] == before


@pytest.mark.cuda
def test_direct_light_map_trains_through_the_kernel(cuda):
    """A DirectLightMap upsampled in training (a strided raw map) on the
    card: the raw parameter's gradient through softplus and the kernel
    against the plain path, [P, S, 3] directions."""
    raw = lights.upsample(lights.DirectLightMap.from_raw(
        env_map(8, 4).float())).env.detach().to(cuda)
    dirs = directions(64 * 999, 9, torch.float32).reshape(999, 64, 3).to(cuda)
    g = torch.randn((999, 64, 3), generator=torch.Generator().manual_seed(2)
                    ).to(cuda)
    grads, outs = [], []
    for plain in (False, True):
        light = lights.DirectLightMap.from_raw(raw)
        out = lights.query_light(light, dirs, plain=plain)
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append(light.env.grad)
    exact = lights.DirectLightMap.from_raw(raw.double())
    out64 = lights.query_light(exact, dirs.double(), plain=True)
    (out64 * g.double()).sum().backward()
    _within("forward", outs[0], out64.detach(), outs[1], FWD_TOL,
            float(exact.get_env().detach().abs().max()))
    _within("gradient", grads[0], exact.env.grad, grads[1], BWD_TOL,
            float(exact.env.grad.abs().max()))
