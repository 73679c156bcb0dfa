from .sph import SphForces, evolve_K, sph_forces  # noqa: F401
from .density import density_at  # noqa: F401
from .gravity import (  # noqa: F401
    gravity_allpairs,
    gravity_newton_allpairs,
    gravity_sweep,
)
