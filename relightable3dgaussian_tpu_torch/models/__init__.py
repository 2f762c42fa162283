"""Scene model and the stage-1 render."""
from . import gaussians  # noqa: F401
from .gaussians import GaussianModel  # noqa: F401
# `models.render` stays the module: the render function is
# `models.render.render`.
from .render import ViewInputs, render_view  # noqa: F401
