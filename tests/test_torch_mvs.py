"""The port's MVS modules (relightable3dgaussian_tpu_torch/mvs/) against the
JAX package's, on the CPU: the cam, pair, PFM and TIFF files, the COLMAP
writers and colmap_to_mvs, the plane sweep's pieces on the same inputs,
the filters and depth_to_normal. Tolerances are stated at each comparison.

The analytic scene of tests/test_mvs.py maps a reference pixel's row to a
source row that is an integer up to the last bit, so at the first and last
rows the floor in the warp, and with it the in-bounds test, flips with the
rounding of either package. Where the two compute the same function in
float32 but in another order (XLA contracts a·b + c into one FMA, torch on
the CPU does not), the sweep's outputs are compared against the JAX
package's own movement when its inputs move by one ulp, at pixels BORDER or
more from the edges."""
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from relightable3dgaussian_tpu.mvs.colmap_to_mvs import \
    colmap_to_mvs as jax_colmap_to_mvs
from relightable3dgaussian_tpu.mvs import filter_fuse as jax_ff
from relightable3dgaussian_tpu.mvs import formats as jax_formats
from relightable3dgaussian_tpu.mvs import plane_sweep as jps
from relightable3dgaussian_tpu.mvs import prepare as jax_prepare
from relightable3dgaussian_tpu.scene import colmap_loader as jax_colmap
from relightable3dgaussian_tpu.scene import image_io as jax_image_io
from relightable3dgaussian_tpu_torch.mvs import (filter_fuse, formats,
                                                 plane_sweep, prepare)
from relightable3dgaussian_tpu_torch.mvs.colmap_to_mvs import colmap_to_mvs
from relightable3dgaussian_tpu_torch.scene import colmap_loader, image_io
from test_mvs import FOCAL, SIZE, _K, _extrinsic, _plane_depth, _render
from test_torch_ops import share_cpu_threads  # noqa: F401  (torch threads)

imageio = pytest.importorskip("imageio.v2")
BORDER = 6          # at the sweep's 48² scale of the 96² scene


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def cams():
    exts = [_extrinsic(t) for t in (0.0, 0.25, -0.25)]
    return exts, [formats.MVSCamera(e, _K(), 1.8, (3.6 - 1.8) / 63, 64.0, 3.6)
                  for e in exts]


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def test_cam_pair_and_pfm_files_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    cam = (rng.normal(size=(4, 4)), _K() + rng.normal(size=(3, 3)) * 1e-3,
           1.25, 0.0512345678, 64.0, 4.75)
    formats.write_cam_txt(str(tmp_path / "t_cam.txt"), formats.MVSCamera(*cam))
    jax_formats.write_cam_txt(str(tmp_path / "j_cam.txt"),
                              jax_formats.MVSCamera(*cam))
    assert (tmp_path / "t_cam.txt").read_bytes() == (
        tmp_path / "j_cam.txt").read_bytes()
    back = formats.load_cam_txt(str(tmp_path / "j_cam.txt"))
    want = jax_formats.load_cam_txt(str(tmp_path / "j_cam.txt"))
    for a, b in zip(back, want):
        np.testing.assert_array_equal(a, b)
    sel = [[(1, 2.5), (2, 1.0)], [(0, 2.5)], [], [(0, 1.0), (1, 0.123456)]]
    formats.write_pair_txt(str(tmp_path / "t_pair.txt"), sel)
    jax_formats.write_pair_txt(str(tmp_path / "j_pair.txt"), sel)
    assert (tmp_path / "t_pair.txt").read_bytes() == (
        tmp_path / "j_pair.txt").read_bytes()
    assert formats.load_pair_txt(str(tmp_path / "j_pair.txt")) == \
        jax_formats.load_pair_txt(str(tmp_path / "j_pair.txt"))
    for shape in ((7, 9), (7, 9, 3)):
        x = rng.normal(size=shape).astype(np.float32)
        formats.save_pfm(str(tmp_path / "t" / "x.pfm"), x)
        jax_formats.save_pfm(str(tmp_path / "j" / "x.pfm"), x)
        assert (tmp_path / "t" / "x.pfm").read_bytes() == (
            tmp_path / "j" / "x.pfm").read_bytes()
        np.testing.assert_array_equal(
            formats.load_pfm(str(tmp_path / "j" / "x.pfm")), x)


def write_strips(path, img: np.ndarray, rows: int, order: str) -> None:
    """A float32 TIFF of `rows` rows a strip in byte order `order` ("<"
    or ">"), the strip offsets and counts out of line (in line for one
    strip, as the format wants)."""
    h, w = img.shape
    starts = list(range(0, h, rows))
    counts = [4 * w * (min(y + rows, h) - y) for y in starts]
    arrays = 8 + 2 + 12 * 10 + 4
    pixels = arrays + 8 * len(starts)
    offsets = [pixels + sum(counts[:i]) for i in range(len(starts))]
    one = lambda tag, kind, v: struct.pack(              # noqa: E731
        order + "HHI", tag, kind, 1) + struct.pack(
        order + ("H" if kind == 3 else "I"), v).ljust(4, b"\0")
    n = len(starts)
    ifd = struct.pack(order + "H", 10) + b"".join((
        one(256, 4, w), one(257, 4, h), one(258, 3, 32), one(259, 3, 1),
        one(262, 3, 1),
        struct.pack(order + "HHII", 273, 4, n, arrays) if n > 1 else one(
            273, 4, offsets[0]),
        one(277, 3, 1), one(278, 4, rows),
        struct.pack(order + "HHII", 279, 4, n, arrays + 4 * n) if n > 1
        else one(279, 4, counts[0]),
        one(339, 3, 3))) + struct.pack(order + "I", 0)
    with open(path, "wb") as f:
        f.write((b"II" if order == "<" else b"MM")
                + struct.pack(order + "HI", 42, 8) + ifd)
        f.write(struct.pack(f"{order}{len(starts)}I", *offsets))
        f.write(struct.pack(f"{order}{len(starts)}I", *counts))
        f.write(img.astype(order + "f4").tobytes())


@pytest.mark.parametrize("shape", [(37, 53), (96, 96), (1, 4)])
def test_tiff_round_trips_bit_exactly_with_imageio(tmp_path, shape):
    """The port's TIFF files read by imageio, and imageio's by the port,
    bit for bit (NaN, inf and negative zero included); files in several
    strips, either byte order, read bit for bit."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    x.flat[:3] = (np.nan, np.inf, -0.0)
    path = str(tmp_path / "t.tiff")
    image_io.write_tiff_float(path, x)
    assert np.asarray(imageio.imread(path)).view(np.uint32).tolist() == \
        x.view(np.uint32).tolist()
    imageio.imwrite(str(tmp_path / "i.tiff"), x)
    got = image_io.load_depth(str(tmp_path / "i.tiff"))
    assert got.dtype == np.float32
    assert got.view(np.uint32).tolist() == x.view(np.uint32).tolist()
    for rows, order in ((5, "<"), (1, ">"), (shape[0], ">")):
        write_strips(str(tmp_path / "s.tiff"), x, rows, order)
        got = image_io.load_depth(str(tmp_path / "s.tiff"))
        assert got.view(np.uint32).tolist() == x.view(np.uint32).tolist()


def test_tiff_reader_refuses_other_layouts(tmp_path):
    imageio.imwrite(str(tmp_path / "u8.tiff"), np.zeros((4, 4), np.uint8))
    with pytest.raises(NotImplementedError, match="float32"):
        image_io.load_depth(str(tmp_path / "u8.tiff"))
    (tmp_path / "x.tiff").write_bytes(b"not a tiff")
    with pytest.raises(ValueError):
        image_io.load_depth(str(tmp_path / "x.tiff"))


def colmap_model(root, with_ids_on=(1, 2, 3)):
    """tests/test_mvs.py:139's model: 60 points, three PINHOLE views, the
    second seeing 40 of them."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (60, 3)) + np.array([0, 0, 2.5])
    cam = {1: (1, "PINHOLE", SIZE, SIZE,
               np.array([FOCAL, FOCAL, SIZE / 2, SIZE / 2]))}
    imgs = {}
    for i, tx in zip(with_ids_on, (0.0, 0.3, -0.3)):
        obs = np.arange(60) if i != 2 else np.arange(40)
        imgs[i] = (i, np.array([1.0, 0, 0, 0]), np.array([tx, 0.0, 0.0]), 1,
                   f"view_{i}.png", rng.normal(size=(len(obs), 2)),
                   obs.astype(np.int64))
    return pts, cam, imgs


def write_model(mod, root, pts, cam, imgs):
    os.makedirs(root / "sparse" / "0", exist_ok=True)
    mod.write_cameras_binary(str(root / "sparse/0/cameras.bin"),
                             {k: mod.ColmapCamera(*v) for k, v in cam.items()})
    mod.write_images_binary(str(root / "sparse/0/images.bin"),
                            {k: mod.ColmapImage(*v) for k, v in imgs.items()})
    mod.write_points3d_binary(str(root / "sparse/0/points3D.bin"), pts,
                              np.full((len(pts), 3), 128, np.uint8),
                              np.linspace(0, 1, len(pts)))


def test_colmap_writers_and_colmap_to_mvs_match_jax(tmp_path):
    """The COLMAP writers' bytes, the readers with point ids, and
    colmap_to_mvs's cams/, pair.txt and names.txt, all byte for byte."""
    model = colmap_model(tmp_path)
    write_model(colmap_loader, tmp_path / "t", *model)
    write_model(jax_colmap, tmp_path / "j", *model)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "t/sparse/0" / name).read_bytes() == (
            tmp_path / "j/sparse/0" / name).read_bytes(), name
    got = colmap_loader.read_points3d_binary(
        str(tmp_path / "t/sparse/0/points3D.bin"), with_ids=True)
    want = jax_colmap.read_points3d_binary(
        str(tmp_path / "j/sparse/0/points3D.bin"), with_ids=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    names = colmap_to_mvs(str(tmp_path / "t"), max_d=32)
    assert names == jax_colmap_to_mvs(str(tmp_path / "j"), max_d=32)
    assert names == ["view_1", "view_2", "view_3"]
    files = ["pair.txt", "names.txt"] + [f"cams/{n}_cam.txt" for n in names]
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (
            tmp_path / "j" / f).read_bytes(), f


def test_colmap_text_readers_give_point_ids(tmp_path):
    (tmp_path / "points3D.txt").write_text(
        "# comment\n7 0.5 1 2 10 20 30 0.25 1 2\n11 -1 0 3 1 2 3 0.5\n")
    got = colmap_loader.read_points3d_text(str(tmp_path / "points3D.txt"),
                                           with_ids=True)
    want = jax_colmap.read_points3d_text(str(tmp_path / "points3D.txt"),
                                         with_ids=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[3].tolist() == [7, 11]


# ---------------------------------------------------------------------------
# the plane sweep's pieces
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage1():
    """The first cascade stage's inputs as the JAX package forms them (the
    48² level of the 96² scene)."""
    exts, mcams = cams()
    imgs = [_render(e) for e in exts]
    ref = jps._gray(jnp.asarray(imgs[0]))
    srcs = jnp.stack([jps._gray(jnp.asarray(s)) for s in imgs[1:]])
    rg, sg = jps._resize2d(ref, 48, 48), jps._resize2d(srcs, 48, 48)
    rel = np.stack([e @ np.linalg.inv(exts[0]) for e in exts[1:]]
                   ).astype(np.float32)
    Kr = jps._scale_K(jnp.asarray(_K(), jnp.float32), 0.5)
    depths = 1.0 / jnp.linspace(1 / 3.6, 1 / 1.8, 32)[::-1]
    return dict(imgs=imgs, ref=ref, srcs=srcs, rg=rg, sg=sg, rel=rel,
                Ks=jnp.stack([Kr, Kr]), Kinv=jnp.linalg.inv(Kr),
                depths=depths)


def uv_at(s, depth):
    """The JAX package's source coordinates of the 48² reference pixels at
    one depth (its _sweep's score_at)."""
    H, W = s["rg"].shape
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32) + 0.5,
                          jnp.arange(W, dtype=jnp.float32) + 0.5,
                          indexing="ij")
    rays = jnp.einsum("ij,jhw->ihw", s["Kinv"],
                      jnp.stack([xs, ys, jnp.ones_like(xs)]))
    ph = jnp.concatenate([rays * depth, jnp.ones((1, H, W))], 0)
    ps = jnp.einsum("vij,jhw->vihw", jnp.asarray(s["rel"]), ph)[:, :3]
    uvw = jnp.einsum("vij,vjhw->vihw", s["Ks"], ps)
    z = uvw[:, 2]
    return jnp.stack([uvw[:, 0] / jnp.maximum(z, 1e-6) - 0.5,
                      uvw[:, 1] / jnp.maximum(z, 1e-6) - 0.5], -1), z


def test_gray_box_and_pixel_rays_match_jax(stage1):
    """Luminance exact; the box filter within 2e-7 of JAX's (it sums with
    FMAs), its `full` window test on a 0/1 mask exact; the pixel rays
    exact."""
    img = stage1["imgs"][0]
    np.testing.assert_array_equal(plane_sweep._gray(T(img)).numpy(),
                                  np.asarray(jps._gray(jnp.asarray(img))))
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(3, 40, 37)).astype(np.float32)
    for k in (5, 7):
        np.testing.assert_allclose(plane_sweep._box(T(x), k).numpy(),
                                   np.asarray(jps._box(jnp.asarray(x), k)),
                                   rtol=0, atol=2e-7)
        m = (rng.uniform(size=(3, 40, 37)) < 0.97).astype(np.float32)
        want = np.asarray(jps._box(jnp.asarray(m), k)) > 1 - 0.5 / (k * k)
        got = plane_sweep._box(T(m), k).numpy() > 1 - 0.5 / (k * k)
        np.testing.assert_array_equal(got, want)
    H, W = 48, 48
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32) + 0.5,
                          jnp.arange(W, dtype=jnp.float32) + 0.5,
                          indexing="ij")
    want = jnp.einsum("ij,jhw->ihw", stage1["Kinv"],
                      jnp.stack([xs, ys, jnp.ones_like(xs)]))
    np.testing.assert_array_equal(
        plane_sweep._pixel_rays(T(stage1["Kinv"]), H, W).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("depth_index", [0, 9, 20, 31])
def test_warp_and_zncc_match_jax_on_the_same_coordinates(stage1,
                                                         depth_index):
    """_warp on JAX's coordinates: values within 1e-6, the in-bounds mask
    exact; _zncc on JAX's warped views and mask: the eff mask exact, the
    correlation within 1e-3 where both windows' variances exceed 1e-4
    (the one-pass variance E[x²] - E[x]² loses ~3e-8 / var of its digits
    to cancellation)."""
    s = stage1
    uv, z = uv_at(s, s["depths"][depth_index])
    warped, inb = jax.vmap(jps._warp)(s["sg"], uv)
    got, got_inb = plane_sweep._warp(T(s["sg"]), T(uv[..., 0]),
                                     T(uv[..., 1]))
    np.testing.assert_array_equal(got_inb.numpy(), np.asarray(inb))
    np.testing.assert_allclose(got.numpy(), np.asarray(warped), rtol=0,
                               atol=1e-6)
    valid = inb & (z > 1e-4)
    ncc, eff = jps._zncc(s["rg"], warped, valid, k=7)
    stats = plane_sweep._ref_stats(T(s["rg"]), 7)
    tncc, teff = plane_sweep._zncc(stats, T(warped), T(valid), k=7)
    np.testing.assert_array_equal(teff.numpy(), np.asarray(eff))
    assert np.asarray(eff).any()
    var_r = stats[2].numpy()
    mu_w = plane_sweep._box(T(warped), 7)
    var_w = (plane_sweep._box(T(warped) ** 2, 7) - mu_w ** 2).numpy()
    ok = np.asarray(eff) & (var_r > 1e-4) & (var_w > 1e-4)
    assert ok.mean() > 0.3
    np.testing.assert_allclose(tncc.numpy()[ok], np.asarray(ncc)[ok],
                               rtol=0, atol=1e-3)


def ulp_spread(fn, inputs, perturb=(0, 1)):
    """max over one-ulp moves (up, down) of the named inputs of |fn(moved)
    - fn(inputs)| for each output."""
    base = [np.asarray(o) for o in fn(**inputs)]
    spread = [np.zeros_like(b) for b in base]
    for name in perturb:
        for direction in (np.inf, -np.inf):
            moved = dict(inputs)
            moved[name] = jnp.asarray(np.nextafter(
                np.asarray(inputs[name]), np.float32(direction)))
            for sp, b, o in zip(spread, base, fn(**moved)):
                np.maximum(sp, np.abs(np.asarray(o) - b), out=sp)
    return base, spread


def test_sweep_matches_jax(stage1):
    """_sweep on the same inputs: depth within rtol 1e-4 at every pixel
    BORDER or more from the edges; prob there at the 50th and 99th
    percentile and the largest within twice (and 1e-6 over) the movement
    JAX's own prob shows when the reference or the sources move by one
    ulp."""
    s = stage1
    inputs = dict(ref_g=s["rg"], srcs_g=s["sg"], K_ref_inv=s["Kinv"],
                  K_srcs=s["Ks"], rel=jnp.asarray(s["rel"]),
                  depths=s["depths"], beta=20.0)
    (jd, jp), (_, sp) = ulp_spread(jps._sweep, inputs, ("ref_g", "srcs_g"))
    td, tp = plane_sweep._sweep(*(T(v) for v in list(inputs.values())[:6]),
                                20.0)
    b = np.s_[BORDER:-BORDER, BORDER:-BORDER]
    np.testing.assert_allclose(td.numpy()[b], jd[b], rtol=1e-4)
    err = np.abs(tp.numpy() - jp)[b]
    for q in (0.5, 0.99, 1.0):
        assert np.quantile(err, q) <= 2 * np.quantile(sp[b], q) + 1e-6, q


def test_sweep_local_matches_jax(stage1):
    """_sweep_local (the band sweep and its parabola) on the same inputs,
    around JAX's stage-1 depth: depth and prob at the 50th and 99th
    percentile and the largest over the pixels BORDER or more from the
    edges within twice (and 1e-6 over) JAX's own movement under a one-ulp
    move of the reference, the sources or the previous depth."""
    s = stage1
    prev, _ = jps._sweep(s["rg"], s["sg"], s["Kinv"], s["Ks"],
                         jnp.asarray(s["rel"]), s["depths"], 20.0)
    half = 9.0 * (3.6 - 1.8) / 32
    inputs = dict(ref_g=s["rg"], srcs_g=s["sg"], K_ref_inv=s["Kinv"],
                  K_srcs=s["Ks"], rel=jnp.asarray(s["rel"]), prev_depth=prev,
                  offs=jnp.linspace(-half, half, 16), beta=20.0, dmin=1.8,
                  dmax=3.6)
    base, spread = ulp_spread(jps._sweep_local, inputs,
                              ("ref_g", "srcs_g", "prev_depth"))
    got = plane_sweep._sweep_local(
        *(T(v) for v in list(inputs.values())[:7]), 20.0, 1.8, 3.6)
    b = np.s_[BORDER:-BORDER, BORDER:-BORDER]
    for g, want, sp in zip(got, base, spread):
        err = np.abs(g.numpy() - want)[b]
        for q in (0.5, 0.99, 1.0):
            assert np.quantile(err, q) <= 2 * np.quantile(sp[b], q) + 1e-6, q


def test_linspace_and_scale_k_match_jax():
    """_linspace within two ulps of its larger end of jnp.linspace (XLA
    rounds start (1 - t) + stop t with FMAs), the ends exact."""
    for a, b, n in ((1 / 3.6, 1 / 1.8, 48), (-0.3, 0.3, 16), (0.1, 0.7, 9)):
        want = np.asarray(jnp.linspace(a, b, n))
        got = plane_sweep._linspace(a, b, n, "cpu").numpy()
        assert got[0] == want[0] and got[-1] == want[-1]
        ulp = np.spacing(np.float32(max(abs(a), abs(b))))
        assert np.abs(got - want).max() <= 2 * ulp
    K = _K().astype(np.float32)
    np.testing.assert_array_equal(
        plane_sweep._scale_K(T(K), 0.25).numpy(),
        np.asarray(jps._scale_K(jnp.asarray(K), 0.25)))


@pytest.mark.parametrize("hw", [(96, 96), (800, 800), (37, 61)])
def test_resize_at_the_sweep_scales_matches_jax(hw):
    """resize2d (image_io) as the cascade resizes, to 1/4, 1/2 and the
    48-pixel floor and back, within 3e-7 of jax.image.resize."""
    H, W = hw
    x = np.random.default_rng(3).uniform(size=(2, H, W)).astype(np.float32)
    for sc in (0.25, 0.5):
        h = min(max(int(round(H * sc)), 48), H)
        w = min(max(int(round(W * sc)), 48), W)
        small = jax.image.resize(jnp.asarray(x), (2, h, w), "bilinear")
        np.testing.assert_allclose(image_io.resize2d(T(x), h, w).numpy(),
                                   np.asarray(small), rtol=0, atol=3e-7)
        np.testing.assert_allclose(
            image_io.resize2d(T(small), H, W).numpy(),
            np.asarray(jax.image.resize(small, (2, H, W), "bilinear")),
            rtol=0, atol=3e-7)


# ---------------------------------------------------------------------------
# the filters and the normals
# ---------------------------------------------------------------------------

def test_prob_filter_matches_jax():
    """Exact where every stage's probability is more than 1e-6 from its
    threshold."""
    rng = np.random.default_rng(4)
    probs = [rng.uniform(size=(40, 50)).astype(np.float32) for _ in range(3)]
    th = (0.6, 0.5, 0.7)
    want = np.asarray(jax_ff.prob_filter(probs, th))
    got = filter_fuse.prob_filter([T(p) for p in probs], th).numpy()
    far = np.all([np.abs(p - t) > 1e-6 for p, t in zip(probs, th)], 0)
    np.testing.assert_array_equal(got[far], want[far])
    assert got.dtype == bool and 0.05 < got.mean() < 0.5


def near_thresholds(ref_depth, ref_cam, src_depths, src_cams):
    """The pixels where some source's test is within reach of the float32
    rounding in float64: reprojection distance within 1e-3 of 1 px, the
    relative depth gap within 1e-5 of 1%, or a source coordinate within
    1e-3 of an in-bounds edge (-1, 0, W - 1, W)."""
    H, W = ref_depth.shape
    Er, Kr = (np.asarray(m, np.float64) for m in (ref_cam.extrinsic,
                                                  ref_cam.intrinsic))
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    pc = np.linalg.inv(Kr) @ np.stack([xs.ravel(), ys.ravel(),
                                       np.ones(H * W)]) * ref_depth.ravel()
    world = np.linalg.inv(Er) @ np.vstack([pc, np.ones(H * W)])
    near = np.zeros(H * W, bool)
    for d_src, cam in zip(src_depths, src_cams):
        Es, Ks = (np.asarray(m, np.float64) for m in (cam.extrinsic,
                                                      cam.intrinsic))
        ps = (Es @ world)[:3]
        z = np.maximum(ps[2], 1e-6)
        u = Ks[0, 0] * ps[0] / z + Ks[0, 2] - 0.5
        v = Ks[1, 1] * ps[1] / z + Ks[1, 2] - 0.5
        for c, n in ((u, W), (v, H)):
            near |= np.min([np.abs(c - e) for e in (-1, 0, n - 1, n)],
                           0) < 1e-3
        x0, y0 = np.floor(u), np.floor(v)
        wx, wy = u - x0, v - y0
        xi = np.clip(x0.astype(int), 0, W - 2)
        yi = np.clip(y0.astype(int), 0, H - 2)
        ds = (d_src[yi, xi] * (1 - wx) * (1 - wy) + d_src[yi, xi + 1] * wx
              * (1 - wy) + d_src[yi + 1, xi] * (1 - wx) * wy
              + d_src[yi + 1, xi + 1] * wx * wy)
        pcs = np.linalg.inv(Ks) @ np.stack([u + 0.5, v + 0.5,
                                            np.ones(H * W)]) * ds
        back = (Er @ np.linalg.inv(Es) @ np.vstack([pcs, np.ones(H * W)]))[:3]
        zb = np.maximum(back[2], 1e-6)
        dist = np.hypot(Kr[0, 0] * back[0] / zb + Kr[0, 2] - xs.ravel(),
                        Kr[1, 1] * back[1] / zb + Kr[1, 2] - ys.ravel())
        rel = np.abs(ref_depth.ravel() - back[2]) / np.maximum(
            np.maximum(ref_depth.ravel(), back[2]), 1e-12)
        near |= (np.abs(dist - 1.0) < 1e-3) | (np.abs(rel - 0.01) < 1e-5)
    return near.reshape(H, W)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_geometric_filter_matches_jax(noise):
    """Mask and count exact at every pixel whose tests are not within
    float32 reach of a threshold (near_thresholds); the analytic depths,
    and the same with 1% noise on the reference depth."""
    _, mcams = cams()
    gt0, _ = _plane_depth(mcams[0].extrinsic)
    d1, _ = _plane_depth(mcams[1].extrinsic)
    d2, _ = _plane_depth(mcams[2].extrinsic)
    rng = np.random.default_rng(5)
    ref = (gt0 * (1 + noise * rng.normal(size=gt0.shape))).astype(np.float32)
    srcs = np.stack([d1, d2]).astype(np.float32)
    jcams = [jax_formats.MVSCamera(*c) for c in mcams]
    want_m, want_c = jax_ff.geometric_filter(ref, jcams[0], srcs, jcams[1:],
                                             vthresh=2)
    got_m, got_c = filter_fuse.geometric_filter(ref, mcams[0], srcs,
                                                mcams[1:], vthresh=2,
                                                device="cpu")
    far = ~near_thresholds(ref, mcams[0], srcs, mcams[1:])
    assert far.mean() > 0.9
    np.testing.assert_array_equal(got_m.numpy()[far], np.asarray(want_m)[far])
    np.testing.assert_array_equal(got_c.numpy()[far], np.asarray(want_c)[far])
    assert 0.05 < float(got_m.float().mean()) < 0.99


def test_depth_to_normal_matches_jax():
    """To 1e-10 (both numpy float64), world and camera space, a noisy
    depth with holes."""
    _, mcams = cams()
    gt, _ = _plane_depth(mcams[1].extrinsic)
    rng = np.random.default_rng(6)
    depth = gt * (1 + 0.01 * rng.normal(size=gt.shape))
    depth[rng.uniform(size=gt.shape) < 0.05] = 0.0
    for world in (True, False):
        got = prepare.depth_to_normal(depth, mcams[1], world_space=world)
        want = jax_prepare.depth_to_normal(depth, jax_formats.MVSCamera(
            *mcams[1]), world_space=world)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_prepare_layouts_are_read_by_both_packages(tmp_path):
    """prepare_blender_extra and prepare_neilf_inputs against the JAX
    package's: the TIFF depths bit for bit both ways (the JAX files,
    written by imageio, read by the port's load_depth; the port's by the
    JAX package's imageio reader), the PFM normals and the PNG masks
    byte for byte."""
    _, mcams = cams()
    names = ["a", "b"]
    rng = np.random.default_rng(7)
    depths = {n: _plane_depth(c.extrinsic)[0].astype(np.float32)
              for n, c in zip(names, mcams)}
    masks = {n: rng.uniform(size=(SIZE, SIZE)) < 0.7 for n in names}
    cm = dict(zip(names, mcams))
    jcm = {n: jax_formats.MVSCamera(*c) for n, c in cm.items()}
    prepare.prepare_blender_extra(str(tmp_path / "t"), names, depths, masks,
                                  cm)
    jax_prepare.prepare_blender_extra(str(tmp_path / "j"), names, depths,
                                      masks, jcm)
    prepare.prepare_neilf_inputs(str(tmp_path / "t"), names, depths, masks,
                                 cm)
    jax_prepare.prepare_neilf_inputs(str(tmp_path / "j"), names, depths,
                                     masks, jcm)
    for n in names:
        jt = image_io.load_depth(str(tmp_path / f"j/extra/depths/{n}.tiff"))
        tj = jax_image_io.load_depth(str(tmp_path / f"t/extra/depths/{n}.tiff"))
        want = depths[n] * masks[n]
        assert jt.view(np.uint32).tolist() == want.view(np.uint32).tolist()
        assert tj.view(np.uint32).tolist() == want.view(np.uint32).tolist()
        for f in (f"extra/normals/{n}.pfm", f"inputs/depths/{n}.pfm",
                  f"inputs/normals/{n}.pfm"):
            assert (tmp_path / "t" / f).read_bytes() == (
                tmp_path / "j" / f).read_bytes(), f
        for f in (f"extra/masks/{n}.png", f"inputs/pmasks/{n}.png"):
            np.testing.assert_array_equal(
                image_io.read_png(str(tmp_path / "t" / f)),
                np.asarray(imageio.imread(str(tmp_path / "j" / f))))


def test_mvs_exports_the_jax_names():
    from relightable3dgaussian_tpu import mvs as jax_mvs
    from relightable3dgaussian_tpu_torch import mvs
    assert mvs.__all__ == jax_mvs.__all__
    assert all(hasattr(mvs, n) for n in mvs.__all__)


@pytest.mark.parametrize("call", ["infer_depth", "geometric_filter"])
def test_mvs_entry_points_default_to_the_card(call):
    assert not torch.cuda.is_available()
    exts, mcams = cams()
    img = np.zeros((3, 48, 48), np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        if call == "infer_depth":
            plane_sweep.infer_depth(img, [img], mcams[0], mcams[1:2])
        else:
            filter_fuse.geometric_filter(img[0], mcams[0], img[:1],
                                         mcams[1:2])
