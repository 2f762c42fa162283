"""The port's scene layer against the JAX package's, on the CPU: its PNG codec
against imageio, the Blender and COLMAP readers, the resize, the random
initial cloud and the PLY files. Tolerances are stated at each comparison."""
import json
import os
import random
import shutil

import numpy as np
import pytest

from relightable3dgaussian_tpu.scene import Scene as JaxScene
from relightable3dgaussian_tpu.scene import cameras as jax_cameras
from relightable3dgaussian_tpu.scene import colmap_loader as jax_colmap
from relightable3dgaussian_tpu.scene import image_io as jax_image_io
from relightable3dgaussian_tpu.scene import ply_io as jax_ply_io
from relightable3dgaussian_tpu_torch.scene import Scene, cameras, image_io, ply_io
from test_scene_io import make_params, write_blender_dataset
from test_torch_ops import share_cpu_threads  # noqa: F401  (torch threads)

imageio = pytest.importorskip("imageio.v2")


def smooth_image(shape, seed: int) -> np.ndarray:
    """uint8 image with gradients and noise, so that an encoder picks
    several row filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = (np.sin(xx / 5.0) * 100 + yy * 3).astype(np.int64)
    c = shape[2] if len(shape) == 3 else 1
    img = (base[..., None] + rng.integers(0, 20, shape[:2] + (c,))) % 256
    img = img.astype(np.uint8)
    return img[..., 0] if len(shape) == 2 else img


SHAPES = [(33, 47), (33, 47, 3), (33, 47, 4), (20, 30, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_png_reads_imageio_files_bit_exactly(tmp_path, shape):
    img = smooth_image(shape, 1)
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, img)
    got = image_io.read_png(path)
    assert got.dtype == np.uint8 and np.array_equal(got, img)


@pytest.mark.parametrize("shape", SHAPES)
def test_png_files_read_by_imageio_bit_exactly(tmp_path, shape):
    img = smooth_image(shape, 2)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, img)
    assert np.array_equal(np.asarray(imageio.imread(path)), img)


def filtered_rows(img: np.ndarray, ftypes, bpp: int) -> np.ndarray:
    """The PNG row filters applied by the spec's formulas (the encoder side),
    one filter type per row: [h, 1 + w·bpp]."""
    rows = img.reshape(img.shape[0], -1).astype(np.int64)
    out, prev = [], np.zeros_like(rows[0])
    for y, f in enumerate(ftypes):
        r = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = [0 * r, a, prev, (a + prev) // 2, paeth][f]
        out.append(np.concatenate([[f], (r - pred) % 256]))
        prev = r
    return np.asarray(out, np.uint8)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", ["none_sub_up", "all_five"])
def test_png_unfilters_every_filter_type(bpp, filters):
    rng = np.random.default_rng(bpp)
    img = rng.integers(0, 256, (17, 13, bpp)).astype(np.uint8)
    ftypes = rng.integers(0, 3 if filters == "none_sub_up" else 5, 17)
    got = image_io._unfilter(filtered_rows(img, ftypes, bpp), 17, 13, bpp)
    assert np.array_equal(got, img)


def test_mask_conversion_is_imageios_mode_l(tmp_path):
    for c in (3, 4):
        img = np.random.default_rng(c).integers(0, 256, (20, 20, c)).astype(
            np.uint8)
        path = str(tmp_path / f"m{c}.png")
        imageio.imwrite(path, img)
        want = np.asarray(imageio.imread(path, mode="L"))
        assert np.array_equal(image_io._to_grey(image_io.read_png(path)), want)
        np.testing.assert_array_equal(image_io.load_mask_bool(path),
                                      jax_image_io.load_mask_bool(path))


@pytest.mark.parametrize("src,dst", [((64, 48, 3), (24, 32)),
                                     ((64, 48), (24, 32)),
                                     ((65, 47, 3), (23, 33)),
                                     ((30, 20, 3), (40, 60))])
def test_resize_matches_jax_image_resize(src, dst):
    """A 2x (and an uneven) downscale and an upscale: antialiased bilinear,
    as jax.image.resize computes it, to 1e-6 (float32 sums of the filter
    taps in another order)."""
    img = np.random.default_rng(3).random(src).astype(np.float32)
    want = jax_image_io.resize_image(img, *dst)
    got = image_io.resize_image(img, *dst)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def with_test_split(root):
    with open(root / "transforms_train.json") as f:
        meta = json.load(f)
    with open(root / "transforms_test.json", "w") as f:
        json.dump(meta, f)


def assert_scenes_agree(js, ts):
    """Camera count and order, images and masks exactly, cameras_extent
    within 1e-6 relative, the initial cloud exactly, each camera's
    view_inputs camera params within 1e-6."""
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-6)
    jcams = js.get_train_cameras() + js.get_test_cameras()
    tcams = ts.get_train_cameras() + ts.get_test_cameras()
    assert [c.image_name for c in tcams] == [c.image_name for c in jcams]
    assert len(ts.get_test_cameras()) == len(js.get_test_cameras())
    for a, b in zip(jcams, tcams):
        np.testing.assert_array_equal(b.image, a.image)
        np.testing.assert_array_equal(b.image_mask, a.image_mask)
        va, vb = a.view_inputs(), b.view_inputs("cpu")
        for k in va.cam._fields:
            np.testing.assert_allclose(getattr(vb.cam, k).numpy(),
                                       np.asarray(getattr(va.cam, k)),
                                       atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(vb.image.numpy(), np.asarray(va.image))
        np.testing.assert_array_equal(vb.image_mask.numpy(),
                                      np.asarray(va.image_mask))
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(ts.scene_info.point_cloud, k),
                                      getattr(js.scene_info.point_cloud, k))


def test_blender_scene_matches_jax(tmp_path):
    """Each package reads its own copy of the dataset, so each writes its
    own random initial cloud: the two files are byte-identical too."""
    data_j, data_t = tmp_path / "jax", tmp_path / "port"
    write_blender_dataset(data_j, n_frames=4, size=32)
    with_test_split(data_j)
    shutil.copytree(data_j, data_t)
    random.seed(5)
    js = JaxScene(str(data_j), str(tmp_path / "out_j"), eval_split=True)
    random.seed(5)
    ts = Scene(str(data_t), str(tmp_path / "out_t"), eval_split=True)
    assert len(ts.get_train_cameras()) == 4
    assert_scenes_agree(js, ts)
    assert (data_t / "points3d.ply").read_bytes() == (
        data_j / "points3d.ply").read_bytes()
    for name in ("input.ply", "cameras.json"):
        assert (tmp_path / "out_t" / name).read_bytes() == (
            tmp_path / "out_j" / name).read_bytes()


def test_blender_reader_loads_the_mvs_extra_dir(tmp_path):
    """Test views with an extra/ MVS directory (TIFF depths written by the
    JAX package's prepare_blender_extra through imageio, PFM normals): the
    port's test cameras carry the JAX reader's depth and normal maps
    exactly."""
    from relightable3dgaussian_tpu.mvs.formats import MVSCamera
    from relightable3dgaussian_tpu.mvs.prepare import prepare_blender_extra
    data_j, data_t = tmp_path / "jax", tmp_path / "port"
    write_blender_dataset(data_j, n_frames=2, size=16)
    with_test_split(data_j)
    rng = np.random.default_rng(9)
    names = ["r_0", "r_1"]
    K = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]])
    prepare_blender_extra(
        str(data_j), names,
        {n: rng.uniform(1, 3, (16, 16)).astype(np.float32) for n in names},
        {n: rng.uniform(size=(16, 16)) < 0.8 for n in names},
        {n: MVSCamera(np.eye(4), K, 1.0, 0.1, 32.0, 4.0) for n in names})
    shutil.copytree(data_j, data_t)
    js = JaxScene(str(data_j), "", eval_split=True, shuffle=False)
    ts = Scene(str(data_t), "", eval_split=True, shuffle=False)
    jcams, tcams = js.get_test_cameras(), ts.get_test_cameras()
    assert len(tcams) == 2
    for a, b in zip(jcams, tcams):
        assert b.depth.shape == (16, 16) and b.normal.shape == (16, 16, 3)
        np.testing.assert_array_equal(b.depth, a.depth)
        np.testing.assert_array_equal(b.normal, a.normal)
        assert (b.depth > 0).mean() > 0.5
    assert all(c.depth is None for c in ts.get_train_cameras())


def write_colmap_dataset(root, n_images: int = 9, size: int = 24):
    """A tiny COLMAP binary scene written by the JAX package's writers (as
    tests/test_scene_io.py does): PINHOLE cameras on a circle, RGB images,
    a mask for one image, 40 points."""
    rng = np.random.default_rng(4)
    sparse = root / "sparse" / "0"
    os.makedirs(sparse)
    os.makedirs(root / "images")
    os.makedirs(root / "masks")
    cams = {1: jax_colmap.ColmapCamera(
        1, "PINHOLE", size, size, np.array([30.0, 31.0, 12.0, 11.5]))}
    images = {}
    for i in range(n_images):
        a = 2 * np.pi * i / n_images
        q = np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0])
        name = f"img_{i:03d}.png"
        images[i + 1] = jax_colmap.ColmapImage(
            i + 1, q, np.array([0.1 * i, 0.0, 3.0]), 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))
        imageio.imwrite(root / "images" / name,
                        rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
    imageio.imwrite(root / "masks" / "img_002.png",
                    rng.integers(0, 256, (size, size)).astype(np.uint8))
    jax_colmap.write_cameras_binary(str(sparse / "cameras.bin"), cams)
    jax_colmap.write_images_binary(str(sparse / "images.bin"), images)
    jax_colmap.write_points3d_binary(
        str(sparse / "points3D.bin"), rng.random((40, 3)) - 0.5,
        rng.integers(0, 256, (40, 3)).astype(np.uint8))


def test_colmap_scene_matches_jax(tmp_path):
    data_j, data_t = tmp_path / "jax", tmp_path / "port"
    write_colmap_dataset(data_j)
    shutil.copytree(data_j, data_t)
    js = JaxScene(str(data_j), "", eval_split=True, shuffle=False)
    ts = Scene(str(data_t), "", eval_split=True, shuffle=False)
    assert len(ts.get_test_cameras()) == 2      # llffhold 8 of 9
    assert_scenes_agree(js, ts)
    assert (data_t / "sparse" / "0" / "points3D.ply").read_bytes() == (
        data_j / "sparse" / "0" / "points3D.ply").read_bytes()


def test_camera_json_matches_jax():
    cam = cameras.Camera(uid=3, R=np.eye(3), T=np.array([0.1, 0.2, 3.0]),
                         fovx=0.8, fovy=0.7, width=40, height=30,
                         image_name="x")
    js = jax_cameras.camera_to_json(3, cam)
    assert cameras.camera_to_json(3, cam) == js
    back, back_j = cameras.camera_from_json(js), jax_cameras.camera_from_json(js)
    np.testing.assert_array_equal(back.R, back_j.R)
    np.testing.assert_array_equal(back.T, back_j.T)
    assert (back.fovx, back.fovy) == (back_j.fovx, back_j.fovy)


@pytest.mark.parametrize("w,h,r", [(3200, 2400, -1), (800, 600, 2),
                                   (800, 600, 400), (1000, 700, -1)])
def test_resolve_resolution_matches_jax(w, h, r):
    assert cameras.resolve_resolution(w, h, r) == \
        jax_cameras.resolve_resolution(w, h, r)


@pytest.mark.parametrize("use_pbr", [True, False])
def test_ply_files_are_byte_identical_and_interchange(tmp_path, use_pbr):
    params = make_params(n=12, use_pbr=use_pbr, key=3)
    fields = {k: np.asarray(v) for k, v in vars(params).items()
              if np.asarray(v).shape[0] == 12}
    path_j, path_t = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jax_ply_io.save_gaussian_ply(path_j, params)
    ply_io.save_gaussian_ply(path_t, fields)
    assert open(path_t, "rb").read() == open(path_j, "rb").read()
    # each package loads the other's file, and the port's model the JAX one's
    got, want = ply_io.load_gaussian_ply(path_j), jax_ply_io.load_gaussian_ply(
        path_t)
    assert got.keys() == want.keys() == fields.keys()
    for k in fields:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], fields[k])
    from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel
    model = GaussianModel.from_numpy(got, device="cpu")
    assert model.has_pbr == use_pbr
    for k, v in model.to_numpy().items():
        np.testing.assert_array_equal(v, fields[k])


def test_ply_active_mask_matches_jax(tmp_path):
    params = make_params(n=10)
    active = np.zeros(10, bool)
    active[[1, 4, 7]] = True
    fields = {k: np.asarray(v) for k, v in vars(params).items()}
    jax_ply_io.save_gaussian_ply(str(tmp_path / "j.ply"), params, active)
    ply_io.save_gaussian_ply(str(tmp_path / "t.ply"), fields, active)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_exr_images_match_jax(tmp_path):
    """A ZIP-compressed EXR (the JAX package's writer) read as the reference
    loader reads it, linear → sRGB unclipped: to 2 float32 ulps of 1 (the
    two frameworks' pow round differently)."""
    from relightable3dgaussian_tpu.scene import exr as jax_exr
    img = np.random.default_rng(0).random((8, 9, 4)).astype(np.float32) * 2
    path = str(tmp_path / "a.exr")
    jax_exr.write_exr_zip(path, img)
    np.testing.assert_allclose(image_io.load_img_rgb(path),
                               jax_image_io.load_img_rgb(path),
                               atol=2.4e-7, rtol=2.4e-7)
