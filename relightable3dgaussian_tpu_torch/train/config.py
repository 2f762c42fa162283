"""Training configuration (port of relightable3dgaussian_tpu/train/config.py).

The port keeps its own copy of the three flag groups the CLIs are built from
(`cli/arguments.py`): the port imports nothing of the JAX package. Field
names, order and defaults are the JAX package's (tests/test_torch_train.py
and tests/test_torch_cli.py check them). `PipelineConfig`'s
`compute_SHs_python`, `compute_cov3D_python` and `tracing` are flags of the
reference's CUDA rasterizer that the JAX package accepts and never reads;
the port accepts them likewise.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    global_shs_degree: int = 3
    env_resolution: int = 16     # rows of the learnable env map [H, 2H, 3]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    compute_SHs_python: bool = False
    compute_cov3D_python: bool = False
    tracing: bool = False
    sample_num: int = 64         # incident samples per point in stage 2
    debug: bool = False
    save_training_vis: bool = False
    save_training_vis_iteration: int = 1000


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 30_000
    finetune_visibility: bool = False

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    normal_lr: float = 0.01
    sh_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    env_lr: float = 0.1
    env_rest_lr: float = 0.001

    base_color_lr: float = 0.01
    roughness_lr: float = 0.01
    light_lr: float = 0.001
    light_rest_lr: float = 0.0001
    light_init: float = 3.0
    visibility_lr: float = 0.0025
    visibility_rest_lr: float = 0.0025

    percent_dense: float = 0.001
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 10_000

    densify_grad_threshold: float = 0.0002
    densify_grad_normal_threshold: float = 2e-9
    normal_densify_from_iter: int = 0

    lambda_depth: float = 0.0
    lambda_depth_smooth: float = 0.0
    lambda_mask_entropy: float = 0.0
    lambda_opacity: float = 0.0
    lambda_opacity_start_iteration: int = 5000
    lambda_surface: float = 0.0
    lambda_normal_render_depth: float = 0.0
    lambda_normal_mvs_depth: float = 0.0
    lambda_normal_smooth: float = 0.0
    lambda_point_entropy: float = 0.0
    lambda_orientation: float = 0.0
    lambda_orientation_from_iter: int = 5000
    lambda_depth_var: float = 0.0
    lambda_scaling: float = 0.0
    # The reference's depth-var ramp 10^(it/5000) assumes a 30k-iteration
    # schedule; compressed runs scale this down so the ramp reaches the same
    # strength at the same relative progress.
    depth_var_ramp_iters: int = 5000

    lambda_dssim: float = 0.2
    lambda_pbr: float = 1.0
    lambda_light: float = 0.0
    lambda_base_color: float = 0.0
    lambda_base_color_smooth: float = 0.0
    lambda_roughness_smooth: float = 0.0
    lambda_light_smooth: float = 0.0
    lambda_visibility_smooth: float = 0.0
    lambda_visibility: float = 0.0
    lambda_env_smooth: float = 0.0


# The NeRF-synthetic stage-1 recipe of the reference run scripts.
STAGE1_NERF_SYNTHETIC = dict(
    lambda_normal_render_depth=0.01,
    lambda_normal_smooth=0.01,
    lambda_mask_entropy=0.1,
    lambda_depth_var=1e-2,
)

# The NeRF-synthetic stage-2 recipe of the reference run scripts.
STAGE2_NERF_SYNTHETIC = dict(
    position_lr_init=0.000016,
    position_lr_final=0.00000016,
    normal_lr=0.001,
    sh_lr=0.00025,
    opacity_lr=0.005,
    scaling_lr=0.0005,
    rotation_lr=0.0001,
    iterations=40_000,
    lambda_base_color_smooth=0.0,
    lambda_roughness_smooth=0.0,
    lambda_light_smooth=0.0,
    lambda_light=0.01,
    lambda_env_smooth=0.01,
)
