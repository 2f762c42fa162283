"""The port's command-line entry points on the CPU: cli.train stages 1 and 2
and cli.eval_nvs write the JAX CLI's artifact layout on a 32x32, 4-frame
Blender scene (tests/test_cli.py's), two steps match the JAX CLI's, a JAX
stage-1 checkpoint resumes in the port's stage 2, the collapse guard and the
refused flags; and every entry point of the port defaults to the card, so
on this CUDA-less torch it raises. The JAX CLI runs once in this file (its
compile is slow). Tolerances are stated at each comparison."""
import dataclasses
import glob
import json
import random

import numpy as np
import pytest
import torch

from relightable3dgaussian_tpu.cli import train as jax_train_cli
from relightable3dgaussian_tpu.train import config as jax_config
from relightable3dgaussian_tpu_torch.cli import (eval_nvs,
                                                 eval_relighting_syn4,
                                                 relighting)
from relightable3dgaussian_tpu_torch.cli import train as train_cli
from relightable3dgaussian_tpu_torch.models import lights
from relightable3dgaussian_tpu_torch.models.gaussians import GaussianModel
from relightable3dgaussian_tpu_torch.ops.camera import make_camera_params
from relightable3dgaussian_tpu_torch.scene import Scene
from relightable3dgaussian_tpu_torch.train import checkpoint, config
from relightable3dgaussian_tpu_torch.train.optim import (learning_rates,
                                                         make_env_optimizer)
from test_scene_io import write_blender_dataset

# The JAX CLI's budget flags (tests/test_cli.py), which the port accepts and
# ignores: both CLIs run on the same command line.
TPU_FLAGS = ["--capacity", "512", "--chunk", "32", "--max_chunks_per_tile",
             "16", "--max_tiles_per_gaussian", "4"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("blender_scene")
    write_blender_dataset(root, n_frames=4, size=32)
    with open(root / "transforms_train.json") as f:
        meta = json.load(f)
    with open(root / "transforms_test.json", "w") as f:
        json.dump(meta, f)
    return root


def stage1_args(dataset, out, iterations: int, *extra) -> list[str]:
    return ["-s", str(dataset), "-m", str(out), "--iterations",
            str(iterations), "--max_init_points", "300", *TPU_FLAGS,
            "--save_interval", str(iterations), "--checkpoint_interval",
            str(iterations), *extra]


@pytest.fixture(scope="module")
def stage1(dataset, tmp_path_factory):
    """12 port stage-1 steps with a densify at step 6."""
    out = tmp_path_factory.mktemp("stage1")
    train_cli.main(stage1_args(
        dataset, out, 12, "--densify_from_iter", "5",
        "--densification_interval", "6", "--densify_until_iter", "10",
        "--log_interval", "4", "--eval"), device="cpu")
    return out


@pytest.fixture(scope="module")
def stage2(dataset, stage1, tmp_path_factory):
    """The port's stage 2 from the stage-1 checkpoint to step 24: the
    visibility re-traced every 6 steps (at step 19), the env map upsampled
    at step 18."""
    out = tmp_path_factory.mktemp("stage2")
    train_cli.main([
        "-s", str(dataset), "-m", str(out), "-t", "neilf",
        "-c", str(stage1 / "chkpnt12.npz"), "--iterations", "24",
        "--sample_num", "8", *TPU_FLAGS, "--save_interval", "24",
        "--checkpoint_interval", "24", "--log_interval", "2",
        "--lambda_light", "0.01", "--env_upsample_iters", "18",
        "--vis_refresh_interval", "6", "--eval"], device="cpu")
    return out


def test_config_groups_are_the_jax_ones():
    for ours, theirs in ((config.ModelConfig, jax_config.ModelConfig),
                         (config.PipelineConfig, jax_config.PipelineConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
                == [(f.name, f.default) for f in dataclasses.fields(theirs)])


def test_train_flags_are_the_jax_clis(monkeypatch):
    """The same flag names with the same defaults: the JAX parser as its
    main builds it (training stubbed out)."""
    seen = {}
    monkeypatch.setattr(jax_train_cli, "training",
                        lambda args: seen.update(vars(args)))
    argv = ["-s", "data", "-m", "out"]
    jax_train_cli.main(argv)
    ours = vars(train_cli.build_train_parser().parse_args(argv))
    assert ours == seen


def test_stage1_writes_the_jax_artifact_layout(stage1):
    for rel in ("chkpnt12.npz", "point_cloud/iteration_12/point_cloud.ply",
                "cfg_args.json", "metric_test.txt", "metrics.jsonl",
                "input.ply", "cameras.json", "eval/test/000_render.png"):
        assert (stage1 / rel).exists(), rel
    text = (stage1 / "metric_test.txt").read_text()
    assert text.startswith("psnr: ") and "\nssim: " in text
    with open(stage1 / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert sorted(set(steps)) == list(range(1, 13))
    it, model = checkpoint.load_checkpoint(str(stage1 / "chkpnt12.npz"),
                                           device="cpu")
    assert it == 12 and model.num_points != 300      # the densify at step 6
    assert json.loads((stage1 / "cfg_args.json").read_text())["iterations"] == 12


def test_upsample_env_resizes_the_adam_moments_and_keeps_the_step():
    env = lights.DirectLightMap(4, 3.0, torch.Generator().manual_seed(2),
                                device="cpu")
    opt = make_env_optimizer(env, config.OptimizationConfig())
    for _ in range(3):
        env.env.grad = torch.randn(env.env.shape,
                                   generator=torch.Generator().manual_seed(3))
        opt.step()
    before = {k: v.clone() for k, v in opt.state[env.env].items()}
    new = train_cli.upsample_env(env, opt)
    assert new.env.shape == (8, 16, 3)
    assert opt.param_groups[0]["params"] == [new.env]
    assert env.env not in opt.state
    state = opt.state[new.env]
    assert float(state["step"]) == float(before["step"]) == 3
    for k in ("exp_avg", "exp_avg_sq"):
        torch.testing.assert_close(state[k],
                                   lights.bilinear_resize_2x(before[k]))
    torch.testing.assert_close(new.env.detach(),
                               lights.bilinear_resize_2x(env.env.detach()))


def test_stage2_upsamples_the_env_and_keeps_its_step(stage2):
    for rel in ("chkpnt24.npz", "env_light_chkpnt24.npz",
                "point_cloud/iteration_24/point_cloud.ply", "metric_test.txt",
                "eval/test/000_pbr.png"):
        assert (stage2 / rel).exists(), rel
    with np.load(stage2 / "env_light_chkpnt24.npz") as f:
        assert f["env.env"].shape == (32, 64, 3)
        assert f["env_state.mu"].shape == f["env_state.nu"].shape == (32, 64, 3)
        assert float(np.abs(f["env_state.mu"]).max()) > 0
        assert int(f["env_state.count"]) == 12      # steps 13 to 24
    with np.load(stage2 / "chkpnt24.npz") as f:
        # Adam continues the stage-1 count; every field has PBR rows
        assert int(f["opt_state.count"]) == 24
        assert f["params.base_color"].shape[0] == f["params.xyz"].shape[0]
    text = (stage2 / "metric_test.txt").read_text()
    assert "psnr_pbr: " in text and "ssim_pbr: " in text


def test_eval_nvs_writes_psnr_and_ssim(dataset, stage2):
    out = eval_nvs.main(["-s", str(dataset), "-m", str(stage2), "-t", "neilf",
                         "-c", str(stage2 / "chkpnt24.npz"), "--skip_train",
                         "--sample_num", "8"], device="cpu")
    text = (stage2 / "metric_test.txt").read_text()
    assert text.startswith("psnr: ") and "\nssim: " in text
    assert np.isfinite(out["test"]["psnr"]) and len(out["test"]["view_ms"]) == 4
    assert (stage2 / "test" / "renders" / "00000.png").exists()
    assert (stage2 / "test" / "gt" / "00003.png").exists()


def test_eval_nvs_reads_the_newest_ply(dataset, stage1):
    eval_nvs.main(["-s", str(dataset), "-m", str(stage1), "--skip_train"],
                  device="cpu")
    assert (stage1 / "metric_test.txt").read_text().startswith("psnr: ")


@pytest.fixture(scope="module")
def jax_cli_run(dataset, tmp_path_factory):
    """Two JAX CLI stage-1 steps, densify off, and the port's on the same
    command line, each after random.seed(0) (the scene shuffles its
    cameras with Python's random)."""
    argv = lambda out: stage1_args(dataset, out, 2, "--densify_from_iter",  # noqa: E731
                                   "100", "--log_interval", "1",
                                   "--no_auto_plan")
    out_j = tmp_path_factory.mktemp("jax_cli")
    random.seed(0)
    jax_train_cli.main(argv(out_j))
    out_t = tmp_path_factory.mktemp("port_cli")
    random.seed(0)
    train_cli.main(argv(out_t), device="cpu")
    return out_j, out_t


def read_metrics(out) -> dict:
    with open(out / "metrics.jsonl") as f:
        return {r["step"]: r for r in map(json.loads, f)}


def test_two_steps_match_the_jax_cli(jax_cli_run):
    """The same cameras, losses and Adam steps: the step losses within 1e-4
    relative (float32 sums in another order), the active rows of chkpnt2
    within 1% of each field's learning rate per step taken (as
    tests/test_torch_train.py holds one step), on all but 1e-3 of the
    entries of a field, and within the two steps' reach (2 lr) on every
    one: Adam's first step moves each entry by lr·g/|g|, so an entry whose
    gradient is rounding noise may step either way."""
    out_j, out_t = jax_cli_run
    mj, mt = read_metrics(out_j), read_metrics(out_t)
    assert mj[1]["overflow_pairs"] == mj[2]["overflow_pairs"] == 0
    for step in (1, 2):
        assert mt[step]["loss"] == pytest.approx(mj[step]["loss"], rel=1e-4)
    with np.load(out_j / "chkpnt2.npz") as fj, \
            np.load(out_t / "chkpnt2.npz") as ft:
        active = fj["aux.active"]
        assert int(fj["opt_state.count"]) == int(ft["opt_state.count"]) == 2
        for k in ("xyz", "normal", "shs_dc", "shs_rest", "scaling",
                  "rotation", "opacity"):
            want = fj[f"params.{k}"][active]
            got = ft[f"params.{k}"]
            assert got.shape == want.shape, k
            lr = step_lr(k)
            diff = np.abs(got - want)
            assert float((diff > 0.02 * lr).mean()) <= 1e-3, k
            assert float(diff.max()) <= 2 * lr * (1 + 1e-3), k


def step_lr(k: str) -> float:
    """The largest learning rate of a field over the two steps (xyz decays;
    its spatial scale is the scene's camera extent, 2.2)."""
    lrs = learning_rates(config.OptimizationConfig(), 1, 2.2)
    return lrs[k]


def test_jax_checkpoint_resumes_in_the_ports_stage2(dataset, jax_cli_run,
                                                    tmp_path):
    out_j, _ = jax_cli_run
    train_cli.main(["-s", str(dataset), "-m", str(tmp_path), "-t", "neilf",
                    "-c", str(out_j / "chkpnt2.npz"), "--iterations", "4",
                    "--sample_num", "8", "--save_interval", "4",
                    "--checkpoint_interval", "4"], device="cpu")
    with np.load(tmp_path / "chkpnt4.npz") as f:
        assert f["params.xyz"].shape == (300, 3)
        assert f["params.base_color"].shape == (300, 3)
        assert int(f["opt_state.count"]) == 4
    assert (tmp_path / "env_light_chkpnt4.npz").exists()


def test_collapse_guard_exits_3_and_quarantines(dataset, tmp_path):
    """An unreachable floor trips the guard at the first densify (step 6):
    exit code 3, and the checkpoint of step 3, newer than the best (none),
    is renamed collapsed_*."""
    with pytest.raises(SystemExit) as ex:
        train_cli.main(stage1_args(
            dataset, tmp_path, 12, "--densify_from_iter", "4",
            "--densification_interval", "6", "--densify_until_iter", "12",
            "--collapse_min_points", "100000", "--checkpoint_interval", "3"),
            device="cpu")
    assert ex.value.code == 3
    assert glob.glob(str(tmp_path / "collapsed_chkpnt3.npz"))
    assert not glob.glob(str(tmp_path / "chkpnt*.npz"))


def test_restore_refuses_a_collapsed_checkpoint(dataset, stage1, tmp_path):
    with pytest.raises(SystemExit, match="refusing to train a collapsed"):
        train_cli.main(["-s", str(dataset), "-m", str(tmp_path),
                        "-c", str(stage1 / "chkpnt12.npz"), "--iterations",
                        "16", "--collapse_min_points", "100000"],
                       device="cpu")


@pytest.mark.parametrize("flags,message", [
    (["--n_devices", "2"], "queue 1 item 4"), (["--gui"], "queue 1 item 4"),
    (["--max_capacity", "4096"], "no capacity")])
def test_unported_flags_are_refused(dataset, tmp_path, flags, message):
    with pytest.raises(SystemExit, match=message):
        train_cli.main(["-s", str(dataset), "-m", str(tmp_path), *flags],
                       device="cpu")


def test_cli_refuses_n_devices_in_eval(dataset, stage1):
    with pytest.raises(SystemExit, match="queue 1 item 4"):
        eval_nvs.main(["-s", str(dataset), "-m", str(stage1),
                       "--n_devices", "2"], device="cpu")


# ---------------------------------------------------------------------------
# every entry point defaults to the card
# ---------------------------------------------------------------------------

def entry_point_calls(dataset, stage1):
    path = str(stage1 / "chkpnt12.npz")
    d = {k: np.zeros((2,) + s, np.float32) for k, s in (
        ("xyz", (3,)), ("normal", (3,)), ("shs_dc", (1, 3)),
        ("shs_rest", (15, 3)), ("scaling", (3,)), ("rotation", (4,)),
        ("opacity", (1,)))}
    return {
        "load_checkpoint": lambda: checkpoint.load_checkpoint(path),
        "load_train_state": lambda: checkpoint.load_train_state(
            path, config.OptimizationConfig(), 1.0),
        "from_numpy": lambda: GaussianModel.from_numpy(d),
        "DirectLightMap": lambda: lights.DirectLightMap(4),
        "make_camera_params": lambda: make_camera_params(
            np.eye(3), np.zeros(3), 8, 8, fovx=0.9, fovy=0.9),
        "view_inputs": lambda: Scene(str(dataset), "", shuffle=False)
        .get_train_cameras()[0].view_inputs(),
        "cli.train": lambda: train_cli.main(["-s", str(dataset), "-m",
                                             str(stage1 / "never")]),
        "cli.eval_nvs": lambda: eval_nvs.main(["-s", str(dataset), "-m",
                                               str(stage1)]),
        "load_env_light": lambda: lights.load_env_light(
            str(dataset / "train" / "r_0.png")),
        "cli.relighting": lambda: relighting.main(["-co", str(stage1),
                                                   "--output",
                                                   str(stage1 / "never")]),
        "cli.eval_relighting_syn4": lambda: eval_relighting_syn4.main(
            ["-s", str(dataset), "-m", str(stage1)]),
    }


@pytest.mark.parametrize("name", ["load_checkpoint", "load_train_state",
                                  "from_numpy", "DirectLightMap",
                                  "make_camera_params", "view_inputs",
                                  "cli.train", "cli.eval_nvs",
                                  "load_env_light", "cli.relighting",
                                  "cli.eval_relighting_syn4"])
def test_entry_points_default_to_the_card(dataset, stage1, name):
    """Without a device argument every entry point asks for the card; this
    torch has none, so each raises and none carries on on the CPU."""
    assert not torch.cuda.is_available()
    call = entry_point_calls(dataset, stage1)[name]
    with pytest.raises((RuntimeError, AssertionError)):
        result = call()
        pytest.fail(f"{name} returned {type(result)} on the CPU")
    assert not (stage1 / "never").exists()


def test_env_checkpoint_defaults_to_the_card(stage2):
    with pytest.raises((RuntimeError, AssertionError)):
        checkpoint.load_env_checkpoint(str(stage2 / "env_light_chkpnt24.npz"),
                                       config.OptimizationConfig())
