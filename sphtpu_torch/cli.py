"""Command-line entry point with the reference flag grammar.

Mirrors sph_manager.jl:10-116:

    python -m sphtpu_torch.cli --generate --EOS polytropic --ic_type gaussian_sphere \
        --kwargs "N=5000,R=5.38552341e16,Omega_frac=0.25"
    python -m sphtpu_torch.cli --run --EOS polytropic --ic_type gaussian_sphere \
        --snapID 1 --snapInterval 5 --keepSnaps true --showPlots false

The kwargs string parses "key=val,key=val" with bool/int/float/str coercion
(sph_manager.jl:75-98). Extra flags beyond the reference: --root (snapshot
tree location), --dtype, --max-steps, --quiet, and --device: the run is on
the CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys


def parse_kwargs_string(s: str) -> dict:
    """bool -> int -> float -> str coercion, exactly sph_manager.jl:83-94."""
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=", 1)
        v_lower = v.lower()
        if v_lower == "true":
            parsed = True
        elif v_lower == "false":
            parsed = False
        else:
            try:
                parsed = int(v)
            except ValueError:
                try:
                    parsed = float(v)
                except ValueError:
                    parsed = v
        out[k] = parsed
    return out


def _bool_flag(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sphtpu_torch", description=__doc__)
    p.add_argument("--generate", action="store_true",
                   help="Generate initial conditions only")
    p.add_argument("--run", action="store_true", help="Run simulation")
    p.add_argument("--EOS", required=True,
                   help="Equation of State: isothermal or polytropic")
    p.add_argument("--ic_type", required=True,
                   help="Type of initial condition (see sphtpu_torch.scenes.IC_TYPES)")
    p.add_argument("--kwargs", default="",
                   help="Extra IC kwargs, format key1=val1,key2=val2")
    p.add_argument("--snapID", type=int, default=1,
                   help="Snapshot number to use for cold/warm start")
    p.add_argument("--snapInterval", type=int, default=10,
                   help="Interval between snapshots (in steps)")
    p.add_argument("--keepSnaps", type=_bool_flag, default=True,
                   help="Keep or not the snapshots")
    p.add_argument("--showPlots", type=_bool_flag, default=True,
                   help="Only useful when keepSnaps is active")
    # extensions beyond the reference grammar
    p.add_argument("--root", default=".", help="Snapshot tree root directory")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"),
                   help="Device compute precision")
    p.add_argument("--engine", default="auto", choices=("auto", "gather"),
                   help="auto: cell-tile fast path with certified fallback; "
                        "gather: neighbor-list engine only")
    p.add_argument("--gravity", default="auto",
                   choices=("auto", "exact", "p3m"),
                   help="tile-path far field: exact N^2 sweep or P3M FFT "
                        "mesh (auto: P3M from N = 150 000 on)")
    p.add_argument("--n-devices", type=int, default=1,
                   help="Shards of the sharded engines (z-slab tile engine, "
                        "work-sharded block and multi-level engines): the "
                        "first N CUDA devices, or N CPU shards with "
                        "--device cpu")
    p.add_argument("--device", default=None,
                   help="torch device of the run; default: cuda (an error "
                        "if there is none). 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    p.add_argument("--max-steps", type=int, default=None,
                   help="Stop after this many steps (debug/bench)")
    p.add_argument("--quiet", action="store_true", help="Suppress per-step prints")
    p.add_argument("--watch", action="store_true",
                   help="Follow a run from another process: re-render the "
                        "newest snapshot's figures to graphs/latest_*.png "
                        "whenever one appears (the live-dashboard stand-in "
                        "for the reference's GLMakie screens)")
    p.add_argument("--watch-interval", type=float, default=5.0,
                   help="Seconds between --watch polls")
    return p


# summary dict of the last --run made through main() in this process, for
# callers that drive the CLI programmatically
LAST_RUN = None


def main(argv=None) -> int:
    global LAST_RUN
    args = build_parser().parse_args(argv)

    if args.watch:
        from .viz import watch

        print(
            f"Watching snapshots of {args.ic_type} under {args.root} "
            "(ctrl-C to stop)"
        )
        watch(
            args.root, args.ic_type, args.EOS,
            interval_s=args.watch_interval,
        )
        return 0

    if args.generate:
        from .scenes import iniconds_setup

        print(
            f"Generating {args.EOS} initial conditions for the test case of : "
            f"{args.ic_type}"
        )
        iniconds_setup(
            args.EOS, args.ic_type, root=args.root, **parse_kwargs_string(args.kwargs)
        )

    if args.run:
        if args.EOS not in ("isothermal", "polytropic"):
            print(
                f"No EOS of type {args.EOS} exists. Available options are "
                "either: 'isothermal' or 'polytropic'"
            )
            return 1
        from .engine import run_simulation

        print(
            f"Running {args.EOS} simulation from snapshot {args.snapID} "
            f"with IC type: {args.ic_type}"
        )
        LAST_RUN = run_simulation(
            args.EOS,
            args.ic_type,
            snap_id=args.snapID,
            snap_interval=args.snapInterval,
            keep_snaps=args.keepSnaps,
            show_plots=args.showPlots,
            root=args.root,
            dtype=args.dtype,
            engine=args.engine,
            gravity=args.gravity,
            n_devices=args.n_devices,
            max_steps=args.max_steps,
            verbose=not args.quiet,
            device=args.device,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
