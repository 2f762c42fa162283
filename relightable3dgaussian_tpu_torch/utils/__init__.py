"""Math helpers: spherical harmonics, quaternions, camera matrices, image
metrics, learning-rate schedules and step timing."""
from . import graphics, image, lr_schedule, quaternions, sh, timing  # noqa: F401
