"""Code-unit rescaling: CGS <-> simulation units with G = 1.

The reference does every operation in Float64 CGS (positions ~1e17 cm,
densities ~1e-18 g/cm^3, kernel weights ~1/h^3 ~ 1e-48). On the GPU the
production type is float32, where 1e-48 is below the subnormal range — so the device
engine runs in rescaled units instead:

    unit_L = R   (characteristic radius from the snapshot constants)
    unit_M = M   (total gas mass)
    unit_T = sqrt(unit_L^3 / (G_cgs * unit_M))   =>   G_code = 1

Everything on device is O(1)..O(1e6) and float32-safe; host-side I/O
(snapshots, stats, IC generation) stays in CGS float64 exactly like the
reference, so snapshot files round-trip.

This module is host-side numpy; conversions happen at the device boundary.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    """Conversion factors between CGS and code units.

    ``x_code = x_cgs / unit`` for each quantity kind.
    """

    L: float  # length [cm]
    M: float  # mass [g]
    T: float  # time [s]

    @classmethod
    def from_constants(cls, G_cgs: float, M_cgs: float, R_cgs: float) -> "UnitSystem":
        """Build the G=1 unit system from snapshot constants M and R."""
        L = float(R_cgs)
        M = float(M_cgs)
        T = math.sqrt(L**3 / (G_cgs * M))
        return cls(L=L, M=M, T=T)

    # --- derived factors -------------------------------------------------
    @property
    def V(self) -> float:  # velocity [cm/s]
        return self.L / self.T

    @property
    def A(self) -> float:  # acceleration [cm/s^2]
        return self.L / self.T**2

    @property
    def RHO(self) -> float:  # density [g/cm^3]
        return self.M / self.L**3

    @property
    def P(self) -> float:  # pressure [erg/cm^3]
        return self.M / (self.L * self.T**2)

    @property
    def E(self) -> float:  # energy [erg]
        return self.M * self.V**2

    @property
    def G(self) -> float:  # gravitational constant in code units (== 1)
        return 1.0

    def K_entropy(self, gamma: float) -> float:
        """Unit of the polytropic entropy K = P / rho^gamma."""
        return self.P / self.RHO**gamma
