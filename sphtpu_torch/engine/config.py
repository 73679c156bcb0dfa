"""Engine configuration and simulation state.

Static shape/EOS info lives in EngineConfig (hashable: run_simulation caches
one chunk runner per config); physics scalars live in Params as 0-d
tensors on the run's device. All Params/State values are in code units
(G = 1, see sphtpu_torch.units).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..physics.mesh_gravity import good_fft_size, tail_halfwidth


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n: int  # particle count
    kh: int  # hydro neighbor count (constants "Kh")
    eos: str  # "polytropic" | "isothermal"
    dtype: str = "float32"
    # masked cell-tile fast path: (grid, cap) or None for the gather
    # engine only. run_simulation re-chooses this per chunk from the evolving
    # smoothing lengths.
    tile: tuple = None
    # far-field gravity on the tile path: "exact" = Newtonian all-pairs
    # sweep + the tiles' near-field softening correction (O(N^2), matches
    # the softened all-pairs oracle); "p3m" = FFT particle-mesh + in-tile
    # pair correction. The gather fallback path is always exact.
    gravity: str = "exact"
    # P3M knobs: mesh cells per tile cell and Gaussian width in mesh
    # cells. The pair-correction stencil the Gaussian tail demands in
    # TILE cells is reach = 4.4 sigma = 4.4 * sigma_cells / mesh_factor
    # tile cells -> c_halfwidth. The default mesh_factor is 5 (a 5^3
    # stencil); mesh_factor >= ceil(4.4 * sigma_cells) (10 at the default
    # sigma_cells) shrinks the correction to a 3^3 stencil.
    mesh_factor: int = 5
    sigma_cells: float = 2.2
    # carried from the reference config for round-tripping; the port
    # dispatches kernels on the tensor's device, not on this flag
    pallas_a: bool = None
    # outlier-lane row budget of the mono-tile engine (physics/outliers.py):
    # at most this many large-h rows take the exact O(B*N) lane. 0 =
    # mono-level.
    outlier_budget: int = 0
    # occupancy-class query compaction for the tile path
    # (physics/ctiles.py): ((cap_k, n_cells_k), ...) plan-time class list
    # sizes, or None for the legacy full-cap sweep. Requires tile set,
    # outlier_budget == 0, and (for p3m) c_halfwidth == 1.
    tile_classes: tuple = None
    # multi-level tile engine spec (physics/mlevel.py)
    mlevel: tuple = None
    # block-compact engine spec (physics/blocks.py)
    blocks: tuple = None
    # certification-failure response. "gather": fall back to the exact
    # gather engine (the default — stale plans cost speed, never
    # correctness). "none": a failed certificate DISCARDS the step (state
    # returned unchanged, stats zeroed, n_fallbacks counts it) and the
    # caller must replan + re-dispatch.
    fallback: str = "gather"

    def __post_init__(self):
        if self.eos not in ("polytropic", "isothermal"):
            raise ValueError(f"unknown EOS {self.eos!r}")
        if self.fallback not in ("gather", "none"):
            raise ValueError(f"unknown fallback mode {self.fallback!r}")
        if self.gravity not in ("exact", "p3m"):
            raise ValueError(f"unknown gravity mode {self.gravity!r}")
        if (
            self.gravity == "p3m"
            and self.tile is None
            and self.mlevel is None
            and self.blocks is None
        ):
            raise ValueError("p3m gravity requires a tile/mlevel/blocks engine")
        if sum(x is not None for x in (self.tile, self.mlevel, self.blocks)) > 1:
            raise ValueError("tile, mlevel, and blocks are mutually exclusive")
        if self.tile_classes is not None:
            if self.tile is None:
                raise ValueError("tile_classes requires a tile config")
            if self.outlier_budget:
                raise ValueError("tile_classes excludes the outlier lane")
            if self.gravity == "p3m" and self.c_halfwidth != 1:
                raise ValueError(
                    "tile_classes + p3m requires c_halfwidth == 1 "
                    "(mesh_factor >= ceil(4.4 * sigma_cells))"
                )

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def mesh_gm(self) -> int:
        """Live mesh cells per edge (p3m mode)."""
        if self.tile is not None:
            g0 = self.tile[0]
        elif self.mlevel is not None:
            g0 = self.mlevel[0][0][0]
        else:
            g0 = self.blocks[3]  # the spec's mesh anchor grid
        return self.mesh_factor * g0

    @property
    def mesh_pad(self) -> int:
        """Padded FFT edge for isolated boundaries (p3m mode)."""
        return good_fft_size(2 * (self.mesh_gm + 2))

    @property
    def c_halfwidth(self) -> int:
        """P3M tail-correction stencil half-width in tile cells: the
        (2w+1)^3 block guarantees pair coverage to w tile cells = w *
        mesh_factor / sigma_cells Gaussian widths; w is the smallest
        half-width reaching TAIL_T = 4.4 sigma (complement ~1e-4)."""
        return tail_halfwidth(self.mesh_factor, self.sigma_cells)


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Params(NamedTuple):
    """Physics scalars as 0-d tensors, code units."""

    m: torch.Tensor  # particle mass
    gamma: torch.Tensor  # adiabatic index (unused for isothermal)
    cs0: torch.Tensor  # isothermal sound speed (unused for polytropic)
    alpha: torch.Tensor  # AV bulk viscosity
    beta: torch.Tensor  # AV interpenetration
    U0: torch.Tensor  # constant internal energy (isothermal diagnostics)
    t_end: torch.Tensor  # simulation end time


class State(NamedTuple):
    """Loop-carried simulation state, code units."""

    pos: torch.Tensor  # (N, 3)
    vel: torch.Tensor  # (N, 3)
    K: torch.Tensor  # (N,) per-particle entropy (zeros for isothermal)
    t: torch.Tensor  # scalar time


def _to_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Host float64 -> working dtype with one round-to-nearest, as
    ``jnp.asarray(x, dtype)`` does."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
        device=device, dtype=dtype
    )


def _dtype_of(dtype) -> torch.dtype:
    return _TORCH_DTYPES[dtype] if isinstance(dtype, str) else dtype


def state_from_numpy(pos, vel, K, t, *, dtype="float32", device=None) -> State:
    """State from host arrays (numpy / python scalars only)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    td = _dtype_of(dtype)
    return State(
        pos=_to_tensor(pos, td, dev).contiguous(),
        vel=_to_tensor(vel, td, dev).contiguous(),
        K=_to_tensor(K, td, dev).contiguous(),
        t=_to_tensor(t, td, dev),
    )


def params_from_numpy(
    m, gamma, cs0, alpha, beta, U0, t_end, *, dtype="float32", device=None
) -> Params:
    """Params from python/numpy scalars."""
    from ..device import resolve_device

    dev = resolve_device(device)
    td = _dtype_of(dtype)
    return Params(
        *(_to_tensor(float(x), td, dev) for x in (m, gamma, cs0, alpha, beta, U0, t_end))
    )


def _as_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_as_tuple(v) for v in x)
    return x


def config_from_reference(d: dict) -> EngineConfig:
    """EngineConfig from ``dataclasses.asdict`` of the reference package's
    EngineConfig (nested lists/tuples become tuples again)."""
    names = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown EngineConfig fields {sorted(unknown)}")
    return EngineConfig(**{k: _as_tuple(v) for k, v in d.items()})
