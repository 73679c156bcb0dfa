"""A committed state (`.npz` in code units: pos, vel, K, h, t, m) as the
start state, turned by the run's seed (`scenes.turned`: a permutation of the
particles, and a rotation of the cube unless the configuration's `rotate` is
false). The stored h, the state's own SPH
smoothing lengths, is what the run loop plans the next chunk from.
"""

from __future__ import annotations

import os

import numpy as np

from . import Scene, turned


def make(config: dict, seed: int, root: str) -> Scene:
    """The state in `config["state"]` (a path under the checkout's root),
    turned by `seed`; its run ends at `config["t_end"]`."""
    d = np.load(os.path.join(root, config["state"]))
    scene = Scene(
        pos=d["pos"].astype(np.float64),
        vel=d["vel"].astype(np.float64),
        K=d["K"].astype(np.float64),
        t=float(d["t"]),
        m=float(d["m"]),
        t_end=float(config["t_end"]),
        h=d["h"].astype(np.float64),
    )
    return turned(scene, seed, rotate=bool(config.get("rotate", True)))
