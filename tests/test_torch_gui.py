"""The port's viewer (cli/gui.py) and `cli.train --gui` against the JAX
package's, on the CPU: the orbit camera's poses, headless frames of a tiny
model (-t render and -t neilf), and the window loop and the trainer's
embedded viewer against the stub dearpygui of tests/test_gui_window.py
(dearpygui is not installed here). Tolerances are stated at each
comparison."""
import json
import sys

import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, which reads __file__
# of every module in sys.modules: import it before the stub dearpygui
# (whose every attribute is a function) is there.
import torch._dynamo  # noqa: F401

import jax.numpy as jnp

from relightable3dgaussian_tpu.cli import gui as jax_gui
from relightable3dgaussian_tpu.models import gaussians as jax_gaussians
from relightable3dgaussian_tpu.models.lights import init_direct_light
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu_torch.cli import gui
from relightable3dgaussian_tpu_torch.cli import train as train_cli
from relightable3dgaussian_tpu_torch.models.lights import DirectLightMap
from relightable3dgaussian_tpu_torch.scene.image_io import read_png
from test_gui_window import FakeDPG, fake_dpg  # noqa: F401
from test_scene_io import write_blender_dataset
from test_torch_ops import share_cpu_threads  # noqa: F401  (torch threads)

N, SIZE, FRAMES = 400, 40, 3

MOVES = [("orbit", (0.7, 0.3)), ("zoom", (2.0,)), ("pan", (5.0, -3.0)),
         ("orbit", (-2.1, 1.9)), ("zoom", (-7.5,)), ("pan", (-40.0, 12.0)),
         ("orbit", (0.0, -4.0))]


@pytest.mark.parametrize("center", [None, (0.1, -0.2, 0.3)])
def test_orbit_camera_poses_match_jax(center):
    """R, T and the fields of view after each move to 1e-12 (both numpy
    float64), with the frame loop's azimuths."""
    ours = gui.OrbitCamera(64, 48, center=None if center is None
                           else np.array(center), radius=3.0)
    theirs = jax_gui.OrbitCamera(64, 48, center=None if center is None
                                 else np.array(center), radius=3.0)
    for name, args in MOVES + [("azimuth", (2 * np.pi * i / FRAMES,))
                               for i in range(FRAMES)]:
        for orbit in (ours, theirs):
            if name == "azimuth":
                orbit.azimuth = args[0]
            else:
                getattr(orbit, name)(*args)
        a, b = ours.camera(), theirs.camera()
        np.testing.assert_allclose(a.R, b.R, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.T, b.T, rtol=0, atol=1e-12)
        assert abs(a.fovx - b.fovx) < 1e-12 and abs(a.fovy - b.fovy) < 1e-12
        assert (a.width, a.height) == (b.width, b.height) == (64, 48)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A JAX-format stage-2 checkpoint of N seeded gaussians around the
    origin, and cfg_args.json with the JAX viewer's binning plan off."""
    rng = np.random.default_rng(31)
    f32 = np.float32
    params = jax_gaussians.GaussianParams(
        xyz=jnp.asarray(rng.uniform(-0.8, 0.8, (N, 3)).astype(f32)),
        normal=jnp.asarray(rng.normal(size=(N, 3)).astype(f32)),
        shs_dc=jnp.asarray(rng.normal(size=(N, 1, 3)).astype(f32)),
        shs_rest=jnp.asarray((rng.normal(size=(N, 15, 3)) * 0.1).astype(f32)),
        scaling=jnp.asarray(np.log(rng.uniform(0.05, 0.2, (N, 3))).astype(f32)),
        rotation=jnp.asarray(rng.normal(size=(N, 4)).astype(f32)),
        opacity=jnp.asarray(rng.normal(0.5, 1.5, (N, 1)).astype(f32)),
        base_color=jnp.asarray(rng.normal(size=(N, 3)).astype(f32)),
        roughness=jnp.asarray(rng.normal(size=(N, 1)).astype(f32)),
        incidents_dc=jnp.asarray((rng.normal(size=(N, 1, 3)) * 0.5).astype(f32)),
        incidents_rest=jnp.asarray((rng.normal(size=(N, 15, 3)) * 0.1).astype(f32)),
        visibility_dc=jnp.asarray(rng.normal(size=(N, 1, 1)).astype(f32)),
        visibility_rest=jnp.asarray(rng.normal(size=(N, 15, 1)).astype(f32)))
    root = tmp_path_factory.mktemp("viewer_model")
    jax_checkpoint.save_checkpoint(str(root / "chkpnt7.npz"), 7,
                                   params=params,
                                   aux=jax_gaussians.init_aux(N, N))
    (root / "cfg_args.json").write_text(json.dumps({"no_auto_plan": True}))
    return root


def frames(out_dir, mode: str = "render") -> np.ndarray:
    return np.stack([read_png(str(out_dir / f"{mode}_{i:04d}.png"))
                     for i in range(FRAMES)]).astype(np.int64)


@pytest.mark.parametrize("kind", ["render", "neilf"])
def test_headless_frames_match_the_jax_viewer(model_dir, tmp_path,
                                              monkeypatch, kind):
    """cli.gui.main --headless on the same checkpoint: every frame within
    1 u8 of the JAX viewer's at every pixel. For -t neilf the port's fresh
    env light takes the JAX viewer's values (jax.random's draw cannot be
    replayed in torch); each package traces its own visibility."""
    argv = ["-m", str(model_dir), "-c", str(model_dir / "chkpnt7.npz"),
            "-t", kind, "--headless", "--size", str(SIZE), "--frames",
            str(FRAMES), "--radius", "3.0", "--sample_num", "8"]
    jax_gui.main(argv + ["--out", str(tmp_path / "jax")])
    env = np.array(init_direct_light(16).env)
    monkeypatch.setattr(gui, "fresh_env", lambda res, device: (
        DirectLightMap.from_raw(torch.from_numpy(env)).to(device)))
    viewer = gui.main(argv + ["--out", str(tmp_path / "port")], device="cpu")
    got, want = frames(tmp_path / "port"), frames(tmp_path / "jax")
    assert got.shape == (FRAMES, SIZE, SIZE, 3)
    assert np.abs(got - want).max() <= 1
    assert want.std() > 10            # the frames show the model
    assert viewer.last_dt > 0


def test_render_once_reads_tensors_back():
    """A render_fn of tensors: [1, H, W] becomes grey RGB, clipped."""
    def render_fn(camera):
        h, w = camera.height, camera.width
        return {"render": torch.full((3, h, w), 1.5),
                "depth": torch.full((1, h, w), 0.25)}

    viewer = gui.GUI(20, 12, render_fn, mode="depth")
    img = viewer.render_once()
    assert img.shape == (12, 20, 3) and np.allclose(img, 0.25)
    viewer.mode = "render"
    assert np.allclose(viewer.render_once(), 1.0)


def tensor_render_fn(camera):
    h, w = camera.height, camera.width
    return {"render": torch.full((3, h, w), 0.25),
            "depth": torch.ones((1, h, w)),
            "normal": torch.zeros((3, h, w)),
            "radii": torch.zeros(7, dtype=torch.int32)}


def test_window_loop_with_a_stub_dearpygui(fake_dpg):  # noqa: F811
    """The window loop on a render_fn of tensors: a frame a step until the
    window closes, the texture, the mode menu of the image results, the
    mouse handlers."""
    viewer = gui.GUI(32, 24, tensor_render_fn, mode="render")
    viewer.run_window()
    assert fake_dpg.frames == 3
    tex = np.asarray(fake_dpg.values["_tex"])
    assert tex.shape == (24 * 32 * 3,) and np.allclose(tex, 0.25)
    assert fake_dpg.items["_mode"] == ["depth", "normal", "render"]
    assert "FPS" in fake_dpg.values["_fps"]
    assert ("destroy_context",) in fake_dpg.calls
    viewer = gui.GUI(32, 32, tensor_render_fn)
    viewer.setup_window()
    az, r = viewer.orbit.azimuth, viewer.orbit.radius
    drags = dict(fake_dpg.handlers["drag"][-2:])
    drags[FakeDPG.mvMouseButton_Left](None, (0, 30.0, -12.0))
    fake_dpg.handlers["wheel"][-1](None, 2.0)
    assert viewer.orbit.azimuth != az and viewer.orbit.radius < r
    fake_dpg._mode_cb(None, "depth")
    fake_dpg.running_frames += 1
    viewer.step()
    assert np.allclose(np.asarray(fake_dpg.values["_tex"]), 1.0)
    viewer.close_window()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("gui_scene")
    write_blender_dataset(root, n_frames=4, size=32)
    return root


def train_args(dataset, out, iterations: int) -> list[str]:
    return ["-s", str(dataset), "-m", str(out), "--iterations",
            str(iterations), "--max_init_points", "300", "--save_interval",
            str(iterations), "--checkpoint_interval", str(iterations),
            "--gui"]


def test_train_gui_takes_one_viewer_frame_a_step(dataset, tmp_path,
                                                 fake_dpg):  # noqa: F811
    """cli.train --gui with the stub: one window frame per step, showing
    the model as it trains, the window closed at the end; a window closed
    early stops the training as the JAX CLI does."""
    fake_dpg.running_frames = 100
    train_cli.main(train_args(dataset, tmp_path / "a", 5), device="cpu")
    assert fake_dpg.frames == 5
    assert ("destroy_context",) in fake_dpg.calls
    tex = np.asarray(fake_dpg.values["_tex"])
    assert tex.shape == (32 * 32 * 3,) and tex.std() > 0
    fake_dpg.frames, fake_dpg.running_frames = 0, 2
    with pytest.raises(KeyboardInterrupt, match="viewer window closed"):
        train_cli.main(train_args(dataset, tmp_path / "b", 5), device="cpu")
    assert fake_dpg.frames == 2


def test_train_gui_without_dearpygui_goes_on(dataset, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setitem(sys.modules, "dearpygui", None)
    train_cli.main(train_args(dataset, tmp_path, 3), device="cpu")
    assert ("--gui requested but dearpygui is not installed; continuing "
            "without the viewer") in capsys.readouterr().out
    assert (tmp_path / "chkpnt3.npz").exists()


def test_gui_main_defaults_to_the_card(model_dir, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises((RuntimeError, AssertionError)):
        gui.main(["-m", str(model_dir), "-c", str(model_dir / "chkpnt7.npz"),
                  "--headless", "--frames", "1", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
