"""Memory-mapped stats time series, bit-compatible with the reference.

The reference mmaps a 100000x10 Float64 Julia Matrix (SnapshotRW.jl:171-184).
Julia arrays are column-major, so on disk element (i, j) lives at byte
offset ((j-1)*nsteps + (i-1)) * 8 — we reproduce that with a Fortran-order
np.memmap so stats files written by either implementation read identically
in the other.

Row layout (polytrope_sim.jl:202): [t, T, V, U, Etot, com_x, com_y, com_z,
|p|, |L|], all CGS.
"""

from __future__ import annotations

import os

import numpy as np

NSTEPS = 100000
NFIELDS = 10


class StatsFile:
    """Open-or-create a stats mmap (SnapshotRW.jl:174-184)."""

    def __init__(self, path: str):
        self.path = path
        size = NSTEPS * NFIELDS * 8
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        is_new = not os.path.isfile(path)
        if is_new:
            with open(path, "wb") as f:
                f.write(b"\x00" * size)
        self.arr = np.memmap(
            path, dtype=np.float64, mode="r+", shape=(NSTEPS, NFIELDS), order="F"
        )

    def update_row(self, iter_id: int, stats) -> None:
        """1-based iter_id, like update_stats_row! (SnapshotRW.jl:191-195)."""
        if not (1 <= iter_id <= NSTEPS):
            raise IndexError(f"Iteration index out of bounds: {iter_id}")
        stats = np.asarray(stats, dtype=np.float64)
        if stats.shape != (NFIELDS,):
            raise ValueError(f"Mismatch in stats length: {stats.shape}")
        self.arr[iter_id - 1, :] = stats

    def up_to(self, iter_id: int) -> np.ndarray:
        """Copy of rows 1..iter_id (SnapshotRW.jl:203-205)."""
        return np.array(self.arr[:iter_id, :])

    def sync(self) -> None:
        self.arr.flush()

    def close(self) -> None:
        self.sync()
        del self.arr
