"""Offline renderer replacing the reference's live GLMakie dashboards.

Produces the same two figures the reference saves per snapshot
(polytrope_sim.jl:128-148,253-299; SnapshotRW.jl:102-107):

  <ID>_star.png  — particle scatter colored by min((rho-3)/3, 1) with the
                   :autumn colormap, plus the radial density profile
  <ID>_stats.png — energy components, linear momentum, angular momentum
                   histories from the stats time series

Runs headless (matplotlib Agg) on compute hosts; can also re-render any
snapshot CSV after the fact via render_from_files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _graphs_dir(root: str, ic_type: str) -> str:
    d = os.path.join(root, "snapshots", ic_type, "graphs")
    os.makedirs(d, exist_ok=True)
    return d


def render_snapshot_figures(
    *,
    root: str,
    ic_type: str,
    snap_id: str,
    pos_cgs: np.ndarray,
    rho_cgs: Optional[np.ndarray],
    R: float,
    rlin_cgs: np.ndarray,
    rho_radial_cgs: np.ndarray,
    stats_cgs: np.ndarray,
    eos: str,
) -> tuple:
    d = _graphs_dir(root, ic_type)

    # --- figure 1: star scatter + radial density (polytrope_sim.jl:262-276)
    fig1, (ax1, ax2) = plt.subplots(2, 1, figsize=(5, 5))
    if rho_cgs is None:
        cval = np.zeros(len(pos_cgs))
    else:
        # density coloring, min((rho-3)/3, 1) on the :autumn map
        # (polytrope_sim.jl:265, isothermal_sim.jl:241). Documented
        # deviation: the reference applies the formula to raw CGS rho,
        # where astrophysical magnitudes (~1e-18 g/cm^3) pin every
        # particle to the same color; we apply it to rho normalized by
        # the mean so the intended 3x-6x-overdensity ramp actually
        # renders (tests/test_viz.py pins non-constant coloring).
        rho_rel = rho_cgs / max(float(np.mean(rho_cgs)), 1e-300)
        cval = np.minimum((rho_rel - 3.0) / 3.0, 1.0)
    ax1.scatter(
        pos_cgs[:, 0] / R,
        pos_cgs[:, 1] / R,
        c=cval,
        cmap="autumn",
        s=10,
        alpha=0.5,
        linewidths=0,
    )
    ax1.set_xlim(-1.4, 1.4)
    ax1.set_ylim(-1.4, 1.4)
    if eos == "isothermal":
        # analytic-profile overlay; the reference keeps this a gray
        # placeholder-zeros line (isothermal_sim.jl:125,250-251)
        ax2.plot(
            rlin_cgs,
            np.zeros_like(rho_radial_cgs),
            color="gray",
            linewidth=2,
            label="analytic",
        )
    ax2.plot(rlin_cgs, rho_radial_cgs, color="blue", linewidth=2,
             label="numerical")
    ax2.set_xlabel("radius")
    ax2.set_ylabel("density")
    star_path = os.path.join(d, f"{snap_id}_star.png")
    fig1.savefig(star_path, dpi=100)
    plt.close(fig1)

    # --- figure 2: conservation histories (polytrope_sim.jl:281-295)
    fig2, (nrg, pp, ll) = plt.subplots(3, 1, figsize=(5, 5))
    t_all = stats_cgs[:, 0]
    nrg.plot(t_all, stats_cgs[:, 1], color="red", label="T")
    nrg.plot(t_all, stats_cgs[:, 2], color="blue", label="V")
    if eos == "polytropic":
        nrg.plot(t_all, stats_cgs[:, 3], color="green", label="U")
    nrg.plot(t_all, stats_cgs[:, 4], color="black", label="E")
    nrg.set_xlabel("Time")
    nrg.set_ylabel("Energy")
    pp.plot(t_all, stats_cgs[:, 8], color="orange", label="Linear P")
    pp.set_xlabel("Time")
    pp.set_ylabel("L Mom")
    ll.plot(t_all, stats_cgs[:, 9], color="pink", label="Angular L")
    ll.set_xlabel("Time")
    ll.set_ylabel("Ang Mom")
    fig2.tight_layout()
    stats_path = os.path.join(d, f"{snap_id}_stats.png")
    fig2.savefig(stats_path, dpi=100)
    plt.close(fig2)
    return star_path, stats_path


def render_from_files(root: str, ic_type: str, snap_id: str, eos: str) -> tuple:
    """Re-render the figures for an existing snapshot CSV + stats file."""
    from ..io import StatsFile, read_snapshot, snapshot_path

    snap = read_snapshot(snapshot_path(root, ic_type, str(snap_id)))
    c = snap["constants"]
    stats = StatsFile(os.path.join(root, "snapshots", ic_type, "stats"))
    hist = stats.up_to(int(c.get("iterID", 1)))
    stats.close()
    return render_snapshot_figures(
        root=root,
        ic_type=ic_type,
        snap_id=str(snap_id),
        pos_cgs=snap["pos"],
        rho_cgs=None,
        R=float(c["R"]),
        rlin_cgs=snap["rlin"],
        rho_radial_cgs=snap["rho_radial"],
        stats_cgs=hist,
        eos=eos,
    )


def watch(
    root: str,
    ic_type: str,
    eos: str,
    *,
    interval_s: float = 5.0,
    max_iterations: int | None = None,
    _sleep=None,
) -> int:
    """Live-dashboard stand-in for the reference's GLMakie screens
    (polytrope_sim.jl:135-148): poll the snapshot directory and re-render
    the newest snapshot's figures whenever a new one appears, so a viewer
    watching <root>/snapshots/<ic>/graphs/latest_*.png follows the run.

    Runs until interrupted (or max_iterations polls, for tests). Returns
    the number of renders performed."""
    import shutil
    import time as _time

    sleep = _sleep or _time.sleep
    bin_dir = os.path.join(root, "snapshots", ic_type, "bin")
    gdir = _graphs_dir(root, ic_type)
    last = None
    renders = 0
    polls = 0
    while max_iterations is None or polls < max_iterations:
        polls += 1
        try:
            snaps = [
                int(f[: -len("snap.csv")])
                for f in os.listdir(bin_dir)
                if f.endswith("snap.csv")
            ]
        except FileNotFoundError:
            snaps = []
        newest = max(snaps) if snaps else None
        if newest is not None and newest != last:
            try:
                star, stats = render_from_files(
                    root, ic_type, str(newest), eos
                )
                shutil.copyfile(star, os.path.join(gdir, "latest_star.png"))
                shutil.copyfile(stats, os.path.join(gdir, "latest_stats.png"))
                last = newest
                renders += 1
            except Exception:
                pass  # snapshot mid-write: retry next poll
        if max_iterations is None or polls < max_iterations:
            sleep(interval_s)
    return renders
