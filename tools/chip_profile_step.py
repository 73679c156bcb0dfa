"""Where a step of the main path spends its time on the card.

    python3 tools/chip_profile_step.py [N | collapse | deep] [--shards P [--ranks R]]
                                       [--per-bucket]

Builds the headline scene (boss_bodenheimer, polytropic, Kh = 50, float32,
N = 100 000 unless given) — or, with `collapse` / `deep`, loads the
committed collapse state bench_data/bb_collapsed.npz (contrast 395) /
bb_collapsed_deep.npz (contrast 1001) with the same parameters — plans the
engine as run_simulation does (`plan_engine`; P3M gravity from N = 150 000
on; with the run loop's repairs, `driver.PLAN_REPAIRS` and
`CHUNK_REPAIRS`: ROADMAP D19-D21), warms up one chunk, then traces one
chunk with torch.profiler and prints: wall seconds per step, the device's busy and idle share (device
time of the traced steps over the wall of the same steps run untraced), and
device time by kernel name. A chunk is three steps, or ML_SUBCHUNK = 2 on
the block engine, whose host refit of the plan before each chunk
(`block_args_for_spec`) is timed apart and not in the step wall.
--per-bucket runs the block engine's phase B one capacity bucket a launch
(K6, `make_chunk_runner(cfg, grouped=False)`) instead of the grouped
launch (K5); it needs a scene the block engine plans, on one shard.

With --shards P the chunk runs over P shards of cuda:0 (the multi-device
layer in one process): a tile scene on the z-slab engine (`plan_slabs`
for the chunk's length; the pack into the slab layout and the unpack are
in the step wall, as in the run loop), a collapse state on the
work-sharded block engine (planned with shards=P). Every timed and traced
chunk starts from the same state.

With --ranks R as well, the P shards are split over R processes (gloo,
P / R shards of cuda:0 each; shard/multihost.py): each rank runs its own
shards (the slab rows its shards own, packed by shard/mh_slabs.mh_pack; or
the replicated state of the block engine), and prints its own wall and
device busy time. The card's idle share is 1 - (the ranks' busy times
summed) / rank 0's wall: kernels of two processes do not run at once on a
card without MPS, so their busy times add."""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from sphtpu_torch.engine import make_chunk_runner, params_from_numpy, state_from_numpy  # noqa: E402
from sphtpu_torch.engine.driver import (  # noqa: E402
    CHUNK_REPAIRS,
    EVAL_REPAIRS,
    ML_SUBCHUNK,
    P3M_MIN_N,
    PLAN_REPAIRS,
    plan_engine,
)
from sphtpu_torch.physics.blocks import block_args_for_spec  # noqa: E402


def load_fixture(path):
    """A committed collapse state in code units on the card: (cfg fields,
    state, params, pos, h0)."""
    d = np.load(path)
    pos, h0 = d["pos"].astype(np.float64), d["h"].astype(np.float64)
    state = state_from_numpy(pos, d["vel"], d["K"], float(d["t"]))
    params = params_from_numpy(m=float(d["m"]), gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0,
                               U0=0.0, t_end=1e30)
    base = dict(n=pos.shape[0], kh=chip_smoke.KH_COLLAPSE, eos="polytropic", dtype="float32")
    return base, state, params, pos, h0


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    argv = sys.argv[1:]
    shards = 1
    if "--shards" in argv:
        i = argv.index("--shards")
        shards = int(argv[i + 1])
        del argv[i : i + 2]
    ranks = 1
    if "--ranks" in argv:
        i = argv.index("--ranks")
        ranks = int(argv[i + 1])
        del argv[i : i + 2]
    grouped = "--per-bucket" not in argv
    if not grouped:
        argv.remove("--per-bucket")
    arg = argv[0] if argv else "100000"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    fixtures = {"collapse": chip_smoke.COLLAPSE, "deep": chip_smoke.COLLAPSE_DEEP}
    if arg in fixtures:
        base, state, params, pos, h0 = load_fixture(fixtures[arg])
    else:
        with tempfile.TemporaryDirectory() as tmp:
            base, state, params, pos, h0 = chip_smoke.load_scene(tmp, "boss_bodenheimer",
                                                                 int(arg))
    n = base["n"]
    cfg, _ = plan_engine(pos, h0, **base, gravity="p3m" if n >= P3M_MIN_N else "exact",
                         **PLAN_REPAIRS)
    steps = ML_SUBCHUNK if cfg.blocks is not None else 3
    refit_s = []
    if not grouped and (cfg.blocks is None or shards > 1):
        raise ValueError("--per-bucket needs a block-engine scene on one shard")
    if ranks > 1:
        return profile_ranks(card, arg, shards, ranks)
    if shards > 1:
        return profile_sharded(card, arg, base, state, params, pos, h0, cfg, steps, shards)
    chunk = make_chunk_runner(cfg, grouped=grouped, **CHUNK_REPAIRS)

    def run(state, h, n_steps):
        args = None
        if cfg.blocks is not None:
            t0 = time.perf_counter()
            args = block_args_for_spec(state.pos.double().cpu().numpy(),
                                       h.double().cpu().numpy(), cfg.blocks, gravity=cfg.gravity,
                                       **PLAN_REPAIRS)
            refit_s.append(time.perf_counter() - t0)
            if args is None:
                raise RuntimeError("the state no longer refits its block spec")
        return chunk(state, params, h, n_steps, args)

    h = chip_smoke.dev(h0, torch.float32)
    state, _, _, h, _, nfb = run(state, h, steps)  # warm-up, builds the kernels
    torch.cuda.synchronize()

    state_w, h_w = state, h
    t0 = time.perf_counter()
    refit0 = sum(refit_s)
    state, _, _, h, _, nfb1 = run(state, h, steps)
    torch.cuda.synchronize()
    # untraced (the profiler slows the host), the host refit excluded
    wall = (time.perf_counter() - t0 - (sum(refit_s) - refit0)) / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _, _, h, _, nfb2 = run(state_w, h_w, steps)
        torch.cuda.synchronize()
    # device-side events only: a host op's device time would count its kernels twice
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in kernels) / steps
    ours = sum(r[1] for r in kernels if "sph::" in r[0]) / steps
    out = {
        "card": card, "scene": arg, "n": n, "gravity": cfg.gravity,
        "phase_b": "grouped" if grouped else "per_bucket",
        "tile": list(cfg.tile) if cfg.tile else None,
        "tile_classes": [list(c) for c in cfg.tile_classes or ()],
        "blocks": [list(b) for b in cfg.blocks[0]] if cfg.blocks else None,
        "host_refit_ms_per_chunk": [1e3 * r for r in refit_s],
        "steps_timed": steps, "steps_traced": steps,
        "fallbacks": int(nfb.sum()) + int(nfb1.sum()) + int(nfb2.sum()),
        "wall_ms_per_step_untraced": wall * 1e3,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
        "hand_kernels_ms_per_step": ours,
        "torch_kernels_ms_per_step": busy_ms - ours,
        "device_kernel_launches_per_step": sum(r[2] for r in kernels) / steps,
        "top_by_device_ms_per_step": [
            {"name": k[:70], "ms": t / steps, "calls": c / steps} for k, t, c in kernels[:20]
        ],
    }
    print(json.dumps(out, indent=1))
    if not kernels:
        print("profiler reported no device time; time the wrappers with chip_smoke.py instead")
    return 0


def device_kernels(prof):
    """(name, device ms, calls) of the traced device events, largest first."""
    return sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )


def profile_sharded(card, arg, base, state, params, pos, h0, cfg, steps, shards, mesh=None):
    """The chunk over `shards` shards of cuda:0: the z-slab engine for a tile
    plan, the work-sharded block engine for a block plan. On a mesh across
    processes (`mesh`, shard/multihost.global_mesh) this rank's shards only;
    returns the report."""
    from sphtpu_torch.engine import EngineConfig
    from sphtpu_torch.physics.blocks import plan_blocks
    from sphtpu_torch.shard.blocks import make_blocks_chunk_runner
    from sphtpu_torch.shard.collectives import particle_mesh
    from sphtpu_torch.shard import tiles as shard_tiles

    multi = mesh is not None
    mesh = mesh if multi else particle_mesh(["cuda:0"] * shards)
    h = chip_smoke.dev(h0, torch.float32)
    info = {}
    if cfg.tile is not None:
        plan = shard_tiles.plan_slabs(pos, h0, base["kh"], shards, chunk_steps=steps)
        if plan is None:
            raise RuntimeError("no slab plan for this scene")
        cfg = EngineConfig(**base, tile=(plan.grid, plan.cap), gravity=cfg.gravity)
        chunk = shard_tiles.make_slab_chunk_runner(cfg, plan, mesh, **EVAL_REPAIRS)
        info = {"engine": "slabs", "grid": plan.grid, "cap": plan.cap, "halo": plan.halo,
                "hops": plan.hops, "budget": plan.budget, "n_loc": plan.n_loc}

        if multi:
            from sphtpu_torch.shard.mh_slabs import (
                LocalRows, _dev_of_rows, mh_local_rows, mh_pack,
            )

            mine = np.isin(_dev_of_rows(pos, plan), list(mesh.local))
            host = [f.double().cpu().numpy()[mine] for f in (state.pos, state.vel, state.K)]
            local = LocalRows(*host, h0[mine], np.flatnonzero(mine))

            def run():
                states, layout = mh_pack(local, plan, mesh, torch.float32)
                out = chunk(states, params, steps)
                mh_local_rows(out[0], out[4], layout)
                return out[3]
        else:
            def run():
                out = chunk(shard_tiles.pack_state(state, plan, mesh), params, steps)
                shard_tiles.unpack_state(out[0], plan, base["n"])
                return out[3]
    else:
        spec, bargs = plan_blocks(pos, h0, base["kh"], gravity=cfg.gravity, shards=shards,
                                  **PLAN_REPAIRS)
        cfg = EngineConfig(**base, blocks=spec, gravity=cfg.gravity)
        chunk = make_blocks_chunk_runner(cfg, mesh)
        info = {"engine": "blocks_sharded", "buckets": [list(b) for b in spec[0]]}

        def run():
            return chunk(state, params, h, bargs, steps)[3]

    run()  # warm-up, builds the kernels
    torch.cuda.synchronize()
    chip_smoke.reset_exchanges()
    t0 = time.perf_counter()
    cert = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    exchanges = chip_smoke.read_exchanges()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_ms = sum(r[1] for r in kernels) / steps
    ours = sum(r[1] for r in kernels if "sph::" in r[0]) / steps
    report = {
        "card": card, "scene": arg, "n": base["n"], "gravity": cfg.gravity, "shards": shards,
        "devices": [str(d) for d in mesh], **info, "steps_timed": steps,
        "certificate_failed": bool(cert.any()),
        "wall_ms_per_step_untraced": wall * 1e3,
        "exchange_ms_per_step": exchanges["seconds"] * 1e3 / steps,
        "exchange_requests_per_step": exchanges["requests"] / steps,
        "exchange_bytes_sent_per_step": exchanges["bytes_sent"] / steps,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
        "hand_kernels_ms_per_step": ours,
        "torch_kernels_ms_per_step": busy_ms - ours,
        "device_kernel_launches_per_step": sum(r[2] for r in kernels) / steps,
        "top_by_device_ms_per_step": [
            {"name": k[:70], "ms": t / steps, "calls": c / steps} for k, t, c in kernels[:20]
        ],
    }
    if multi:
        return report
    print(json.dumps(report, indent=1))
    return 0


def _rank_profile(rank, ranks, out, arg, shards):
    """A rank of profile_ranks: its shards' chunk profiled as profile_sharded
    does, the report saved to out/rank<r>.json."""
    from sphtpu_torch.shard import multihost as mh

    mh.initialize(init_method=f"file://{out}/rdv", num_processes=ranks, process_id=rank,
                  timeout_s=600)
    try:
        fixtures = {"collapse": chip_smoke.COLLAPSE, "deep": chip_smoke.COLLAPSE_DEEP}
        if arg in fixtures:
            base, state, params, pos, h0 = load_fixture(fixtures[arg])
        else:
            with tempfile.TemporaryDirectory() as tmp:
                base, state, params, pos, h0 = chip_smoke.load_scene(tmp, "boss_bodenheimer",
                                                                     int(arg))
        n = base["n"]
        cfg, _ = plan_engine(pos, h0, **base, gravity="p3m" if n >= P3M_MIN_N else "exact",
                             **PLAN_REPAIRS)
        steps = ML_SUBCHUNK if cfg.blocks is not None else 3
        mesh = mh.global_mesh(["cuda:0"] * (shards // ranks))
        report = profile_sharded("", arg, base, state, params, pos, h0, cfg, steps, shards,
                                 mesh=mesh)
    finally:
        mh.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def profile_ranks(card, arg, shards, ranks, limit_s=900.0):
    """profile_sharded over `ranks` processes of shards / ranks shards each
    (start method "spawn"; killed at limit_s)."""
    if shards % ranks:
        raise ValueError(f"--shards {shards} does not split over --ranks {ranks}")
    chip_smoke.build.load_kernels()  # once, before the ranks load it
    with tempfile.TemporaryDirectory() as out:
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_profile, args=(r, ranks, out, arg, shards))
                 for r in range(ranks)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + limit_s
        for proc in procs:
            proc.join(max(deadline - time.monotonic(), 0.1))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        if any(proc.exitcode != 0 for proc in procs):
            raise RuntimeError(f"rank exit codes {[proc.exitcode for proc in procs]}")
        reports = []
        for r in range(ranks):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    wall = reports[0]["wall_ms_per_step_untraced"]
    busy = sum(r["device_busy_ms_per_step"] for r in reports)
    print(json.dumps({
        "card": card, "scene": arg, "shards": shards, "ranks": ranks, "backend": "gloo",
        "wall_ms_per_step_untraced": [r["wall_ms_per_step_untraced"] for r in reports],
        "device_busy_ms_per_step": [r["device_busy_ms_per_step"] for r in reports],
        "device_busy_ms_per_step_summed": busy,
        "exchange_ms_per_step": [r["exchange_ms_per_step"] for r in reports],
        "exchange_requests_per_step": reports[0]["exchange_requests_per_step"],
        "exchange_bytes_sent_per_step": [r["exchange_bytes_sent_per_step"] for r in reports],
        "device_idle_share": 1.0 - busy / wall,
        "device_kernel_launches_per_step": [r["device_kernel_launches_per_step"]
                                            for r in reports],
        "rank_reports": reports,
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
