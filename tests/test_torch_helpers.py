"""The port's `utils/timing.py` and four small public helpers
(`sh_to_rgb`, `unpack_symmetric`, `look_at_camera`, `find_checkpoint`)
against the JAX package's, on the CPU."""
import re

import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.scene import cameras as jax_cameras
from relightable3dgaussian_tpu.train import checkpoint as jax_checkpoint
from relightable3dgaussian_tpu.utils import quaternions as jax_quat
from relightable3dgaussian_tpu.utils import sh as jax_sh
from relightable3dgaussian_tpu_torch.scene import cameras
from relightable3dgaussian_tpu_torch.train import checkpoint
from relightable3dgaussian_tpu_torch.utils import quaternions, sh, timing
from test_torch_ops import share_cpu_threads  # noqa: F401  (torch threads)


def test_timing_prints_and_keeps_the_elapsed_ms(capsys, monkeypatch):
    clock = iter([10.0, 10.0123456])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(clock))
    with timing.Timing("render") as tm:
        pass
    assert tm.elapsed_ms == pytest.approx(12.3456)
    assert capsys.readouterr().out == "[timing] render: 12.346 ms\n"


def test_timing_without_a_name_or_disabled_prints_nothing(capsys):
    with timing.Timing() as a:
        sum(range(1000))
    with timing.Timing("x", enabled=False) as b:
        pass
    assert a.elapsed_ms >= 0 and b.elapsed_ms >= 0
    assert capsys.readouterr().out == ""


def test_time_fn_is_the_median_after_warmup(monkeypatch):
    calls = []
    # warmup call, then 5 timed calls of 3, 1, 9, 2, 7 ms
    clock = iter(np.cumsum([0, 0.003, 0, 0.001, 0, 0.009, 0, 0.002, 0,
                            0.007]).tolist())
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(clock))
    ms = timing.time_fn(lambda x, y=0: calls.append((x, y)), 4, y=5,
                        warmup=1, iters=5)
    assert ms == pytest.approx(3.0)
    assert calls == [(4, 5)] * 6


def test_timing_synchronizes_only_a_card(monkeypatch):
    """On the CPU nothing is waited for; a CUDA device is synchronized."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timing.synchronize("cpu")
    timing.synchronize(None)
    assert synced == []
    timing.synchronize("cuda:0")
    assert synced == [torch.device("cuda:0")]


def test_sh_to_rgb_matches_jax():
    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    np.testing.assert_allclose(sh.sh_to_rgb(torch.from_numpy(x)).numpy(),
                               jax_sh.sh_to_rgb(x), rtol=1e-6)
    np.testing.assert_allclose(sh.sh_to_rgb(sh.rgb_to_sh(
        torch.from_numpy(x))).numpy(), x, rtol=1e-5, atol=1e-6)


def test_unpack_symmetric_matches_jax():
    packed = np.random.default_rng(1).normal(size=(4, 5, 6)).astype(np.float32)
    got = quaternions.unpack_symmetric(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, jax_quat.unpack_symmetric(packed))
    np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))
    np.testing.assert_array_equal(quaternions.strip_symmetric(
        torch.from_numpy(got)).numpy(), packed)


@pytest.mark.parametrize("eye,up", [((0.0, 1, 3), (0.0, 1, 0)),
                                    ((2.0, -1, 4), (0.0, 0, 1))])
def test_look_at_camera_matches_jax(eye, up):
    args = (np.array(eye), np.zeros(3), np.array(up), 64, 48, 0.7)
    want = jax_cameras.look_at_camera(*args)
    got = cameras.look_at_camera(*args)
    np.testing.assert_allclose(got.R, want.R, atol=1e-12)
    np.testing.assert_allclose(got.T, want.T, atol=1e-12)
    assert (got.fovx, got.fovy, got.width, got.height) == pytest.approx(
        (want.fovx, want.fovy, want.width, want.height))
    # the target lies on the optical axis in front of the camera
    p = got.R.T @ np.zeros(3) + got.T
    assert p[2] > 0 and np.allclose(p[:2], 0.0, atol=1e-12)


def test_find_checkpoint_matches_jax(tmp_path):
    assert checkpoint.find_checkpoint(str(tmp_path / "none")) is None
    assert checkpoint.find_checkpoint(str(tmp_path)) is None
    for name in ("chkpnt500.npz", "chkpnt10000.npz", "chkpnt9000.npz",
                 "env_light_chkpnt20000.npz", "chkpnt12.txt",
                 "best_chkpnt.npz"):
        (tmp_path / name).write_bytes(b"")
    for prefix in ("chkpnt", "env_light_chkpnt"):
        got = checkpoint.find_checkpoint(str(tmp_path), prefix)
        assert got == jax_checkpoint.find_checkpoint(str(tmp_path), prefix)
        assert re.search(r"(^|/)" + prefix + r"(10000|20000)\.npz$", got)
