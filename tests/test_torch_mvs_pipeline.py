"""The port's cascade (mvs.infer_depth), cli.mvs and cli.convert against the
JAX package's, on the CPU.

The cascade amplifies the last bits of float32: its one-pass window
variance cancels, the soft-argmin sharpens by beta = 20, and a pixel's
stage-1 winner seeds the band of stages 2 and 3. Two float32
implementations that round in another order (XLA contracts a·b + c into
one FMA, torch on the CPU does not) so part at the level the JAX package
parts from itself when an input moves by one ulp (on the pipeline of
tests/test_mvs_pipeline.py, a few percent of the mask pixels and ~1% of
the kept depth at the 99th percentile when the intrinsics move by one
ulp). Each comparison here holds the port to that movement of the JAX
package's, measured in the test itself."""
import os
import shutil
import stat
import sys

import numpy as np
import pytest

from relightable3dgaussian_tpu.cli import convert as jax_convert
from relightable3dgaussian_tpu.cli.mvs import run_pipeline as jax_run
from relightable3dgaussian_tpu.mvs import infer_depth as jax_infer
from relightable3dgaussian_tpu.mvs import formats as jax_formats
from relightable3dgaussian_tpu_torch.cli import convert
from relightable3dgaussian_tpu_torch.cli import mvs as mvs_cli
from relightable3dgaussian_tpu_torch.mvs import formats, infer_depth
from relightable3dgaussian_tpu_torch.scene import image_io
from test_mvs import _K, _extrinsic, _render
from test_mvs_pipeline import dataset  # noqa: F401  (the JAX test's scene)
from test_torch_ops import share_cpu_threads  # noqa: F401  (torch threads)

BORDER = 12         # pixels of the 96² scene (the sweep's 6 at 48²)
PIPELINE = dict(num_src=2, vthresh=2, pthresh=(0.05, 0.05, 0.05),
                stage_planes=(32, 16, 8))


def test_infer_depth_parts_from_jax_as_jax_from_itself():
    """Depth (relative) and the three probability maps at the 50th and
    99th percentile and the largest over the pixels BORDER or more from
    the edges: the port's distance from JAX within 1.5 times (and 1e-6
    over) the largest distance of JAX from itself under a one-ulp move of
    the reference, the sources, the depth range or the intrinsics."""
    exts = [_extrinsic(t) for t in (0.0, 0.25, -0.25)]
    imgs = [_render(e) for e in exts]
    jc = [jax_formats.MVSCamera(e, _K(), 1.8, (3.6 - 1.8) / 63, 64.0, 3.6)
          for e in exts]
    planes = PIPELINE["stage_planes"]

    def run(ref, srcs, cam):
        d, ps = jax_infer(ref, srcs, cam, jc[1:], stage_planes=planes)
        return [np.asarray(d)] + [np.asarray(p) for p in ps]

    up = lambda x: np.nextafter(x, np.float32(2))           # noqa: E731
    down = lambda x: np.nextafter(x, np.float32(-2))        # noqa: E731
    base = run(imgs[0], imgs[1:], jc[0])
    moved = [run(up(imgs[0]), imgs[1:], jc[0]),
             run(down(imgs[0]), imgs[1:], jc[0]),
             run(imgs[0], [up(s) for s in imgs[1:]], jc[0]),
             run(imgs[0], [down(s) for s in imgs[1:]], jc[0]),
             run(imgs[0], imgs[1:], jc[0]._replace(depth_min=1.8 * (1 + 2e-7))),
             run(imgs[0], imgs[1:], jc[0]._replace(depth_max=3.6 * (1 - 2e-7))),
             run(imgs[0], imgs[1:], jc[0]._replace(intrinsic=_K() * (1 + 1e-7)))]
    d, ps = infer_depth(imgs[0], imgs[1:], formats.MVSCamera(*jc[0]),
                        [formats.MVSCamera(*c) for c in jc[1:]],
                        stage_planes=planes, device="cpu")
    got = [d.numpy()] + [p.numpy() for p in ps]
    b = np.s_[BORDER:-BORDER, BORDER:-BORDER]
    for i, (g, want) in enumerate(zip(got, base)):
        scale = np.abs(want) if i == 0 else 1.0       # depth: relative
        err = (np.abs(g - want) / scale)[b]
        spread = np.max([np.abs(m[i] - want) / scale for m in moved], 0)[b]
        for q in (0.5, 0.99, 1.0):
            assert np.quantile(err, q) <= (1.5 * np.quantile(spread, q)
                                           + 1e-6), (i, q)
    gt = base[0][b]
    assert np.median(np.abs(got[0][b] - gt) / gt) < 1e-3


def write_intrinsics_moved(src: str, dst: str, names) -> None:
    """A copy of the dataset with every view's intrinsics moved by one
    float32 ulp (1e-7 relative)."""
    shutil.copytree(src, dst)
    for n in names:
        path = os.path.join(dst, "cams", f"{n}_cam.txt")
        cam = jax_formats.load_cam_txt(path)
        jax_formats.write_cam_txt(path, cam._replace(
            intrinsic=cam.intrinsic * (1 + 1e-7)))


def test_run_pipeline_parts_from_jax_as_jax_from_itself(dataset,  # noqa: F811
                                                        tmp_path):
    """cli.mvs.run_pipeline against the JAX CLI's on the dataset of
    tests/test_mvs_pipeline.py: the same names and files; per view, the
    share of pixels whose masks differ at most 1.5 times the JAX
    pipeline's own under a one-ulp move of the intrinsics (and at most
    5%), and the relative depth where both keep a pixel at the median
    and the 99th percentile within 1.5 times its own (and 1e-4 over);
    the depth files and the masks the port wrote are what it returned."""
    root, names = dataset
    for d in ("j", "t"):
        shutil.copytree(root, tmp_path / d, ignore=shutil.ignore_patterns(
            "extra", "vis_mvsnet"))
    write_intrinsics_moved(str(tmp_path / "j"), str(tmp_path / "j2"), names)
    want = jax_run(str(tmp_path / "j"), layout="blender", **PIPELINE)
    moved = jax_run(str(tmp_path / "j2"), layout="blender", **PIPELINE)
    got = mvs_cli.run_pipeline(str(tmp_path / "t"), layout="blender",
                               device="cpu", **PIPELINE)
    assert got["names"] == want["names"] == names
    for n in names:
        wm, mm, gm = want["masks"][n], moved["masks"][n], got["masks"][n]
        wd, md, gd = want["depths"][n], moved["depths"][n], got["depths"][n]
        assert (gm != wm).mean() <= min(0.05, 1.5 * (mm != wm).mean()), n
        err = (np.abs(gd - wd) / wd)[gm & wm]
        own = (np.abs(md - wd) / wd)[mm & wm]
        for q in (0.5, 0.99):
            assert np.quantile(err, q) <= 1.5 * np.quantile(own, q) + 1e-4
        depth = image_io.load_depth(str(tmp_path / f"t/extra/depths/{n}.tiff"))
        np.testing.assert_array_equal(depth, (gd * gm).astype(np.float32))
        mask = image_io.read_png(str(tmp_path / f"t/extra/masks/{n}.png"))
        np.testing.assert_array_equal(mask > 0, gm)
        for f in (f"vis_mvsnet/{n}_flow3.pfm",
                  f"vis_mvsnet/{n}_flow1_prob.pfm",
                  f"extra/normals/{n}.pfm"):
            assert (tmp_path / "t" / f).exists(), f


def test_cli_mvs_main_takes_the_jax_flags(dataset, tmp_path):  # noqa: F811
    """cli.mvs.main with the JAX CLI's flags and --layout neilf writes the
    NeILF inputs; names.txt orders the views when present."""
    root, names = dataset
    shutil.copytree(root, tmp_path / "d", ignore=shutil.ignore_patterns(
        "extra", "vis_mvsnet", "inputs"))
    (tmp_path / "d" / "names.txt").write_text("\n".join(names) + "\n")
    out = mvs_cli.main(["--dense_folder", str(tmp_path / "d"), "--num_src",
                        "2", "--pthresh", ".05,.05,.05", "--stage_planes",
                        "16,8,8", "--layout", "neilf"], device="cpu")
    assert out["names"] == names
    for n in names:
        for f in (f"inputs/depths/{n}.pfm", f"inputs/normals/{n}.pfm",
                  f"inputs/pmasks/{n}.png"):
            assert (tmp_path / "d" / f).exists(), f
    args = mvs_cli.build_parser().parse_args(["--dense_folder", "x"])
    assert (args.num_src, args.max_d, args.vthresh, args.pthresh,
            args.layout, args.stage_planes) == (5, 256, 2, ".6,.6,.6",
                                                "blender", "48,32,16")


def test_cli_mvs_defaults_to_the_card(dataset):  # noqa: F811
    root, _ = dataset
    with pytest.raises((RuntimeError, AssertionError)):
        mvs_cli.main(["--dense_folder", root])


def fake_colmap(tmp_path):
    """A `colmap` on PATH that logs its arguments and, as
    image_undistorter, leaves a sparse model in the output directory."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    script = bin_dir / "colmap"
    script.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "with open(os.environ['COLMAP_LOG'], 'a') as f:\n"
        "    f.write(' '.join(sys.argv[1:]) + '\\n')\n"
        "if sys.argv[1] == 'image_undistorter':\n"
        "    out = sys.argv[sys.argv.index('--output_path') + 1]\n"
        "    os.makedirs(os.path.join(out, 'sparse'), exist_ok=True)\n"
        "    for n in ('cameras.bin', 'images.bin', 'points3D.bin'):\n"
        "        open(os.path.join(out, 'sparse', n), 'w').close()\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return bin_dir


@pytest.mark.parametrize("flags", [[], ["--no_gpu", "--camera", "PINHOLE"],
                                   ["--skip_matching"]])
def test_convert_runs_the_jax_command_lines(tmp_path, monkeypatch, capsys,
                                            flags):
    """On a fake colmap, the port's and the JAX CLI's commands, printed and
    run, are the same, and both leave sparse/0."""
    monkeypatch.setenv("PATH", f"{fake_colmap(tmp_path)}{os.pathsep}"
                       f"{os.environ['PATH']}")
    logs = {}
    for name, main in (("t", convert.main), ("j", jax_convert.main)):
        src = tmp_path / name
        (src / "input").mkdir(parents=True)
        if "--skip_matching" in flags:
            (src / "distorted" / "sparse" / "0").mkdir(parents=True)
        monkeypatch.setenv("COLMAP_LOG", str(tmp_path / f"{name}.log"))
        main(["-s", str(src)] + flags)
        printed = [line for line in capsys.readouterr().out.splitlines()
                   if line.startswith("+ ")]
        logs[name] = (printed, (tmp_path / f"{name}.log").read_text()
                      .replace(str(src), "SRC"))
        assert sorted(os.listdir(src / "sparse" / "0")) == [
            "cameras.bin", "images.bin", "points3D.bin"]
    printed_t, printed_j = (
        [line.replace(str(tmp_path / n), "SRC") for line in logs[n][0]]
        for n in ("t", "j"))
    assert printed_t == printed_j
    assert logs["t"][1] == logs["j"][1]
    assert len(printed_t) == (1 if "--skip_matching" in flags else 4)


def test_convert_without_colmap_stops_with_the_jax_message(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(SystemExit) as port:
        convert.main(["-s", str(tmp_path)])
    with pytest.raises(SystemExit) as jax:
        jax_convert.main(["-s", str(tmp_path)])
    assert str(port.value) == str(jax.value)
    assert "colmap binary not found on PATH" in str(port.value)
