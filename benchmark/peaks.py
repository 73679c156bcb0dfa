"""The card's published peaks and the operation counts of the kernels whose
roofline share the benchmark reports.

Peaks: NVIDIA's data sheet for one H100 SXM at its full power limit of
700 W; float32 outside the tensor cores. The card's own power limit is
printed beside every run's numbers.
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12

# K3 (csrc/newton_sweep.cu): every ordered pair of the N particles takes the
# separation (3), r^2 (5), 1/r (rsqrt, 1), 1/r^3 (2), the three force sums
# (6), the potential sum (1) and the r = 0 test (2): 20 operations.
K3_OPS_PER_PAIR = 20


def k3_flops(n: int, evaluations: int) -> float:
    """Operations K3 needs for `evaluations` sweeps over N = n particles."""
    return float(evaluations) * float(n) * float(n) * K3_OPS_PER_PAIR


def k3_min_seconds(n: int, evaluations: int) -> float:
    """The least time the card could take for them: K3 is bound by its
    operations (its bytes, 16 N a sweep, are negligible)."""
    return k3_flops(n, evaluations) / PEAK_FLOPS_F32
