from .cubic_spline import W, grad_W_over_r  # noqa: F401
from .gravity import softened_gphi_over_r, softened_phi  # noqa: F401
