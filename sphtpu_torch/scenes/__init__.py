from .setup import DEFAULTS, iniconds_setup  # noqa: F401
from . import generators  # noqa: F401
