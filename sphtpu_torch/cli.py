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

A multi-process run (`--multihost`, shard/multihost.py) is one process a
rank, launched by hand or by torchrun, each with the same flags but its own
--process-id:

    python -m sphtpu_torch.cli --run ... --multihost --coordinator localhost:29500 \
        --num-processes 2 --process-id 0 --shards-per-process 2
    torchrun --nproc-per-node 2 -m sphtpu_torch.cli --run ... --multihost \
        --shards-per-process 2

Each rank runs --shards-per-process shards on cuda:<local rank mod visible
cards> (or on the CPU with --device cpu). --dist-backend gloo (the default)
shares a card between ranks and stages each exchange through host memory;
nccl needs one card a rank.
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
    p.add_argument("--multihost", action="store_true",
                   help="Join a multi-process run over torch.distributed: the "
                        "mesh spans every rank's shards, the work-sharded "
                        "engines carry the chunks, and only rank 0 writes "
                        "snapshots/stats/figures. Rendezvous from "
                        "--coordinator/--num-processes/--process-id, or from "
                        "the variables torchrun exports (MASTER_ADDR, "
                        "MASTER_PORT, WORLD_SIZE, RANK)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous for --multihost")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Number of ranks for --multihost")
    p.add_argument("--process-id", type=int, default=None,
                   help="This process's rank for --multihost")
    p.add_argument("--shards-per-process", type=int, default=1,
                   help="Shards this rank runs under --multihost, all on "
                        "cuda:<local rank mod visible cards> (on the CPU with "
                        "--device cpu); every rank must give the same number")
    p.add_argument("--dist-backend", default="gloo", choices=("gloo", "nccl"),
                   help="torch.distributed backend of --multihost: gloo shares "
                        "a card between ranks (exchanges staged through host "
                        "memory); nccl needs one card a rank")
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

        owned = False  # a process group this call formed, and leaves at the end
        if args.multihost:
            import torch.distributed

            from .shard import multihost as mh

            owned = not torch.distributed.is_initialized()
            if args.coordinator is not None:
                mh.initialize(args.coordinator, args.num_processes, args.process_id,
                              backend=args.dist_backend)
            elif not mh.maybe_initialize_from_env(backend=args.dist_backend):
                raise SystemExit(
                    "--multihost needs --coordinator, --num-processes and --process-id, "
                    "or the variables torchrun exports"
                )
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
            multihost=args.multihost,
            shards_per_process=args.shards_per_process,
            max_steps=args.max_steps,
            verbose=not args.quiet,
            device=args.device,
        )
        if owned:
            mh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
