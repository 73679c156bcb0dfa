"""The numbers that decide `correct`: a request's outputs against the
reference's, each as a relative error.

*   pos_err, vel_err: the RMS over particles of the gap in the returned
    positions (velocities), over the RMS of their change across the chunk
    in the reference. A chunk that returns its state unchanged reads 1.
*   k_err, h_err, rho_err: the largest gap of a particle's entropy, last h
    and last density, over the reference's value.
*   dt_err: the gap in the time the chunk advanced, over the reference's.
*   stats_err: the largest gap in the diagnostics rows: time, the three
    energies, the total and |L| over their own magnitude; the centre of
    mass over the RMS radius; |p| over m sum |v|.
"""

from __future__ import annotations

import numpy as np
import torch

NAMES = ("pos_err", "vel_err", "k_err", "h_err", "rho_err", "dt_err", "stats_err")
OWN_SCALE = (0, 1, 2, 3, 4, 9)  # stats columns measured against themselves
COM = (5, 6, 7)
P_LIN = 8


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _rms(a: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum(a * a, axis=-1) if a.ndim > 1 else a * a)))


def numbers(out: dict, ref: dict, start: dict, m: float) -> dict:
    """out, ref: pos, vel, K, t, stats, h, rho (any array type); start: the
    start state's pos, vel, t."""
    o = {k: _f64(out[k]) for k in ("pos", "vel", "K", "t", "stats", "h", "rho")}
    r = {k: _f64(ref[k]) for k in ("pos", "vel", "K", "t", "stats", "h", "rho")}
    s = {k: _f64(start[k]) for k in ("pos", "vel", "t")}
    rows = r["stats"].shape[0]
    so, sr = o["stats"][:rows], r["stats"]
    gap = np.abs(so - sr)
    radius = _rms(s["pos"] - s["pos"].mean(axis=0))
    p_scale = m * float(np.sum(np.linalg.norm(s["vel"], axis=1)))
    stats = max(
        float(np.max(gap[:, OWN_SCALE] / np.maximum(np.abs(sr[:, OWN_SCALE]), 1e-300))),
        float(np.max(gap[:, COM])) / radius,
        float(np.max(gap[:, P_LIN])) / p_scale,
    )
    return {
        "pos_err": _rms(o["pos"] - r["pos"]) / _rms(r["pos"] - s["pos"]),
        "vel_err": _rms(o["vel"] - r["vel"]) / _rms(r["vel"] - s["vel"]),
        "k_err": float(np.max(np.abs(o["K"] - r["K"]) / np.abs(r["K"]))),
        "h_err": float(np.max(np.abs(o["h"] - r["h"]) / r["h"])),
        "rho_err": float(np.max(np.abs(o["rho"] - r["rho"]) / r["rho"])),
        "dt_err": float(abs(o["t"] - r["t"]) / abs(r["t"] - s["t"])),
        "stats_err": stats,
    }


def worst(readings: list) -> dict:
    """The largest reading of each number over several requests (NaN wins)."""
    out = {}
    for name in readings[0]:
        vals = [rd[name] for rd in readings]
        out[name] = float("nan") if any(v != v for v in vals) else max(vals)
    return out


def judge(reading: dict, limits: dict) -> bool:
    """True when every limited number is a number at or under its limit."""
    return all(reading[k] == reading[k] and reading[k] <= v for k, v in limits.items())
