"""Interactive and headless viewer, on the card.

Port of relightable3dgaussian_tpu/cli/gui.py (the reference's gui.py): an
OrbitCamera and a render loop that shows any image of the results dict as
a display mode. Where dearpygui is installed a live window is used (it is
imported only inside the window code); `--headless` renders an orbit
trajectory to PNG frames through the same render path. `-t render` renders
through models.render.render (kernel K1 a frame); `-t neilf` traces the
visibility once (kernel K3) and renders through
render_neilf(is_training=False), lit by a fresh DirectLightMap, as the JAX
viewer does (not by the checkpoint's env light).

Usage:
  python -m relightable3dgaussian_tpu_torch.cli.gui -m <model_dir> \
      [-c ckpt] [-t render|neilf] --headless --frames 24 --mode render

It runs on the card; `main(argv, device=...)` takes another device only
from a caller.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.lights import DirectLightMap
from ..models.render import render
from ..models.render_neilf import render_neilf, update_visibility
from ..ops.config import RasterConfig
from ..scene.cameras import Camera
from ..utils.graphics import focal2fov


class OrbitCamera:
    """Spherical orbit camera (reference gui.py:26-89)."""

    def __init__(self, width: int, height: int, fovy_deg: float = 50.0,
                 center=None, radius: float = 4.0):
        self.width = width
        self.height = height
        self.fovy = np.deg2rad(fovy_deg)
        self.center = np.zeros(3) if center is None else np.asarray(center)
        self.radius = radius
        self.azimuth = 0.0
        self.elevation = 0.0

    def orbit(self, d_azimuth: float, d_elevation: float) -> None:
        self.azimuth += d_azimuth
        self.elevation = np.clip(self.elevation + d_elevation,
                                 -np.pi / 2 + 1e-3, np.pi / 2 - 1e-3)

    def pan(self, dx: float, dy: float) -> None:
        cam = self.camera()
        right = cam.R[:, 0]
        up = cam.R[:, 1]
        self.center += (-dx * right + dy * up) * self.radius * 1e-3

    def zoom(self, delta: float) -> None:
        self.radius = max(0.05, self.radius * (0.95 ** delta))

    def camera(self) -> Camera:
        ca, sa = np.cos(self.azimuth), np.sin(self.azimuth)
        ce, se = np.cos(self.elevation), np.sin(self.elevation)
        eye = self.center + self.radius * np.array([sa * ce, se, ca * ce])
        fwd = self.center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        dn = np.cross(fwd, right)
        R = np.stack([right, dn, fwd], axis=1)
        T = -R.T @ eye
        fovx = focal2fov(
            self.height / (2 * np.tan(self.fovy / 2)), self.width)
        return Camera(uid=0, R=R, T=T, fovx=fovx, fovy=self.fovy,
                      width=self.width, height=self.height)


def _host_image(x) -> np.ndarray:
    """A [C, H, W] result → a float32 [H, W, 3] image in [0, 1]; a tensor
    is read back from its device (which waits for it)."""
    img = (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
           else np.asarray(x))
    if img.ndim == 3 and img.shape[0] in (1, 3):
        img = np.moveaxis(img, 0, -1)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    return np.clip(img, 0, 1)


class GUI:
    """Render-loop host. `render_fn(camera) -> results dict`."""

    def __init__(self, width: int, height: int, render_fn,
                 mode: str = "render", center=None, radius: float = 4.0):
        self.orbit = OrbitCamera(width, height, center=center, radius=radius)
        self.render_fn = render_fn
        self.mode = mode
        self.last_dt = 0.0

    def render_once(self) -> np.ndarray:
        t0 = time.perf_counter()
        results = self.render_fn(self.orbit.camera())
        img = _host_image(results[self.mode])
        self.last_dt = time.perf_counter() - t0
        return img

    def run_headless(self, out_dir: str, frames: int = 24) -> None:
        from ..scene.image_io import save_image_u8
        os.makedirs(out_dir, exist_ok=True)
        for i in range(frames):
            self.orbit.azimuth = 2 * np.pi * i / frames
            img = self.render_once()
            save_image_u8(os.path.join(out_dir, f"{self.mode}_{i:04d}.png"),
                          img)
            print(f"frame {i + 1}/{frames} ({1 / max(self.last_dt, 1e-9):.1f}"
                  " FPS)", flush=True)

    # ---- interactive window (reference gui.py:92-183) ----
    # Split into setup/step/close so the training loop can embed one GUI
    # frame per iteration (reference train.py:81-104 `--gui`).

    def setup_window(self) -> None:
        import dearpygui.dearpygui as dpg
        self._dpg = dpg
        w, h = self.orbit.width, self.orbit.height
        dpg.create_context()
        with dpg.texture_registry():
            dpg.add_raw_texture(w, h, np.zeros((h, w, 3), np.float32),
                                format=dpg.mvFormat_Float_rgb, tag="_tex")
        with dpg.window(tag="_win", width=w + 20, height=h + 80):
            dpg.add_image("_tex")
            with dpg.group(horizontal=True):
                dpg.add_text("mode:")
                dpg.add_combo([self.mode], default_value=self.mode,
                              tag="_mode", width=160,
                              callback=self._on_mode)
            dpg.add_text("", tag="_fps")

        # left-drag orbits, middle-drag pans, the wheel zooms (reference
        # gui.py:262-305)
        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(
                button=dpg.mvMouseButton_Left, callback=self._on_orbit)
            dpg.add_mouse_drag_handler(
                button=dpg.mvMouseButton_Middle, callback=self._on_pan)
            dpg.add_mouse_wheel_handler(callback=self._on_zoom)

        dpg.create_viewport(title="relightable3dgaussian_tpu_torch",
                            width=w + 40, height=h + 120)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        self._last_drag = (0.0, 0.0)
        self._last_pan = (0.0, 0.0)

    def _on_mode(self, sender, app_data):
        self.mode = app_data

    def _on_orbit(self, sender, app_data):
        _, dx, dy = app_data
        lx, ly = self._last_drag
        self.orbit.orbit(-(dx - lx) * 0.01, (dy - ly) * 0.01)
        self._last_drag = (dx, dy)

    def _on_pan(self, sender, app_data):
        # app_data is the drag's cumulative delta: pan by the increment
        _, dx, dy = app_data
        lx, ly = self._last_pan
        self.orbit.pan((dx - lx) * 0.2, (dy - ly) * 0.2)
        self._last_pan = (dx, dy)

    def _on_zoom(self, sender, app_data):
        self.orbit.zoom(app_data)

    def step(self) -> bool:
        """Render one frame into the window; False once the window closes."""
        dpg = self._dpg
        if not dpg.is_dearpygui_running():
            return False
        t0 = time.perf_counter()
        results = self.render_fn(self.orbit.camera())
        # the display modes: every [C, H, W] image of the results (reference
        # gui.py:179-181)
        modes = sorted(k for k, v in results.items()
                       if getattr(v, "ndim", 0) == 3 and v.shape[0] in (1, 3))
        if modes != getattr(self, "_modes", None):
            self._modes = modes
            dpg.configure_item("_mode", items=modes)
        img = _host_image(results.get(self.mode, results["render"]))
        self.last_dt = time.perf_counter() - t0
        dpg.set_value("_tex", np.ascontiguousarray(img, np.float32).ravel())
        dpg.set_value("_fps",
                      f"{1.0 / max(self.last_dt, 1e-9):.1f} FPS "
                      f"({self.last_dt * 1e3:.1f} ms)")
        if not self._last_drag == (0.0, 0.0) and \
                not dpg.is_mouse_button_down(dpg.mvMouseButton_Left):
            self._last_drag = (0.0, 0.0)
        if not self._last_pan == (0.0, 0.0) and \
                not dpg.is_mouse_button_down(dpg.mvMouseButton_Middle):
            self._last_pan = (0.0, 0.0)
        dpg.render_dearpygui_frame()
        return True

    def close_window(self) -> None:
        self._dpg.destroy_context()

    def run_window(self) -> None:
        self.setup_window()
        try:
            while self.step():
                pass
        finally:
            self.close_window()


def fresh_env(resolution: int, device) -> DirectLightMap:
    """The viewer's light for `-t neilf`: a new DirectLightMap, as the JAX
    viewer makes one (cli/gui.py:249-255), not the checkpoint's."""
    return DirectLightMap(resolution, device=device)


def build_parser():
    from .arguments import build_parser as base_parser
    parser = base_parser("viewer")
    parser.add_argument("-c", "--checkpoint", default=None)
    parser.add_argument("-t", "--type", choices=["render", "neilf"],
                        default="render")
    parser.add_argument("--headless", action="store_true")
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--mode", default="render")
    parser.add_argument("--size", type=int, default=400)
    parser.add_argument("--radius", type=float, default=4.0)
    parser.add_argument("--out", default="gui_frames")
    return parser


def main(argv=None, device: torch.device | str = "cuda") -> GUI:
    """Parse `argv` (sys.argv when None), load the model on `device` and
    run the viewer; returns it."""
    from ..train.config import ModelConfig, PipelineConfig
    from .arguments import extract, get_combined_args
    from .eval_nvs import load_model
    from .train import require_device

    device = torch.device(device)
    require_device(device)
    args = get_combined_args(build_parser(), argv)
    model_cfg = extract(ModelConfig, args)
    pipe = extract(PipelineConfig, args)

    is_pbr = args.type == "neilf"
    model, _ = load_model(args, model_cfg, is_pbr, device)
    bg = (torch.ones(3, device=device) if model_cfg.white_background
          else torch.zeros(3, device=device))
    center = model.xyz.detach().cpu().numpy().mean(0)
    cfg = RasterConfig(height=args.size, width=args.size, sh_degree=3)

    if is_pbr:
        vis = update_visibility(model, pipe.sample_num)
        env = fresh_env(model_cfg.env_resolution, device)

        @torch.no_grad()
        def render_fn(camera):
            return render_neilf(camera.view_inputs(device), model, cfg, bg,
                                env, vis, is_training=False)
    else:
        @torch.no_grad()
        def render_fn(camera):
            return render(camera.view_inputs(device), model, cfg, bg)

    gui = GUI(args.size, args.size, render_fn, mode=args.mode, center=center,
              radius=args.radius)
    if args.headless:
        gui.run_headless(args.out, args.frames)
    else:
        try:
            gui.run_window()
        except ImportError:
            print("dearpygui not available; falling back to --headless")
            gui.run_headless(args.out, args.frames)
    return gui


if __name__ == "__main__":
    main()
