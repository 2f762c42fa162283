"""relightable3dgaussian_tpu_torch — the PyTorch / CUDA port of relightable3dgaussian_tpu.

The JAX package beside this one is the reference: every module here names the
JAX function it ports, and `tests/test_torch_*.py` feed both the same numpy
inputs. The layout mirrors the JAX package (`ops/`, `models/`, `train/`,
`utils/`). Plain tensor code is PyTorch; the JAX package's Pallas kernels
become kernels written by hand for Hopper under `csrc/`, built with `nvcc` at
first use. On CPU tensors every kernel wrapper runs its plain PyTorch version.

This package imports torch and numpy, never jax.
"""
import torch

# TF32 would round the view/projection matmuls (ops/projection.py) to ~10
# mantissa bits, moving mean2d by ~1e-3 px at 800x800 — enough to change which
# tiles a gaussian touches and so the binned pair set. Keep float32 exact.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
