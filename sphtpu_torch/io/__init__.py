from .snapshot import (  # noqa: F401
    read_snapshot,
    snapshot_path,
    write_snapshot,
)
from .stats import StatsFile, NSTEPS, NFIELDS  # noqa: F401
