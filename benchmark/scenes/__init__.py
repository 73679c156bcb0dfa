"""Scene makers: `<kind>.py` here makes the start state of a configuration
whose `scene` is `<kind>`, from the run's seed (`make(config, seed, root)`).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np


class Scene(NamedTuple):
    """A start state in the run loop's code units (G = 1), float64 host
    arrays: positions, velocities, entropies, time, particle mass, the end
    time, and the smoothing lengths the run loop plans the first chunk
    from."""

    pos: np.ndarray
    vel: np.ndarray
    K: np.ndarray
    t: float
    m: float
    t_end: float
    h: np.ndarray


def rotations() -> list:
    """The 24 proper rotations of the cube as 3 x 3 integer matrices."""
    out = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            mat = np.zeros((3, 3), dtype=np.int64)
            for row, (col, sign) in enumerate(zip(perm, signs)):
                mat[row, col] = sign
            if round(np.linalg.det(mat)) == 1:
                out.append(mat)
    return out


def turned(scene: Scene, seed: int, rotate: bool = True) -> Scene:
    """`scene` with its particles permuted and, with `rotate`, rotated by
    one of the 24 rotations of the cube, both drawn from `seed` (a negative
    seed takes its absolute value). No particle moves relative to another
    and the rotation is exact in floating point, so the physics stays the
    same and the bits differ. The work stays the same where the planner's
    grid is as symmetric as the state: a uniform cloud plans the same tile
    grid in every orientation, while the block planner packs the collapsed
    state's buckets differently in different orientations (pair slots
    4.45e6-4.85e6 over 6 rotations, within 0.7 % over permutations)."""
    rng = np.random.default_rng(abs(int(seed)))
    rot = rotations()[int(rng.integers(24))].astype(np.float64) if rotate else np.eye(3)
    order = rng.permutation(scene.pos.shape[0])
    return scene._replace(
        pos=scene.pos[order] @ rot.T, vel=scene.vel[order] @ rot.T, K=scene.K[order],
        h=scene.h[order])
