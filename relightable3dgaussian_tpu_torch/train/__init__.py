"""Training: configuration, per-field Adam, the stage-1 and stage-2 loops,
and checkpoint interchange with the JAX package."""
from .config import ModelConfig, OptimizationConfig, PipelineConfig  # noqa: F401
from .optim import learning_rates, make_optimizer  # noqa: F401
