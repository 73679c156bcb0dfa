"""K1, K2, K3, K4, K5, K6 and the P3M tail on the main paths' inputs, timed
on one NVIDIA GPU for one source tree of the port, so that two trees can be
compared in one run.

    python3 tools/chip_k1k3.py capture FILE
    python3 tools/chip_k1k3.py time TREE FILE [--sweep] [--kernels k1,k2,k3,k4,k5,k6,tail,k3rc]
                                              [--outputs OUT]
    python3 tools/chip_k1k3.py same OUT_A OUT_B

`capture` builds the inputs of one force evaluation on each path and saves
them to FILE: K1's 12 launches and K5's launch on the collapse path
(bench_data/bb_collapsed.npz, contrast 395, block engine), K2's launch with
its outlier masks on the same state on the outlier rung (timed only for a
tree whose K2 takes them), K5's launch under
P3M on bench_data/bb_collapsed_deep.npz (contrast 1001), K1's and K2's
launches on the class path (boss_bodenheimer N = 100 000, Kh = 32: one
each a class), K4's and K2's launch on the exact path (the same scene at
Kh = 50, mono-tile engine) and on the P3M path (N = 200 000, mono-tile
engine with P3M gravity) with the tail's launch there, and K3's positions
(N = 100 000), all float32; K6's 12 per-bucket launches on the collapse
path (`grouped=False`); and K3's rows x columns launches of one z-slab
evaluation of the exact path's state over four shards of the card (the
ring of the sharded exact far field; timed only for a tree that has the
entry).

`time` imports `sphtpu_torch` from TREE (a checkout of the port, such as a
parent commit unpacked with `git archive`), builds its kernels there and
prints one JSON line: each kernel's CUDA-event median time on those inputs
(the sum over a path's launches; it holds the wrappers' host work, which a
short launch waits for) and its device time from torch.profiler (the
kernels alone, per evaluation; each launch's too), with the card's name
and power limit. Where TREE's K5 wrapper takes the plan's work units
(`units`), they are built once beforehand, as the block engine does.
K6's line `k6_collapse_launches` gives each of its 12 launches with its
(C_b, nb, n_u = work units a block; null for a tree whose K6 has none),
its wrapper time and its device time (a combine kernel counted with the
launch before it).
With --sweep it also times, where TREE's wrappers take the knob, K1 and
K4 at smaller list budgets (`list_cap`, with each budget's overflow
share), K5 at other work-unit sizes (`unit_table`'s `unit_slots`), K3
at other plans (rows a thread R, column slices S), K2 at other piece
sizes (`piece`) and the tail at other staging chunks (`chunk`).
--kernels limits the run to the kernels named (all by default).
K2's joint mode and the tail's skip mode (ROADMAP D21, the run loop's
launches on the P3M path: `k2_p3m_joint`, `tail_p3m_skip`) are timed for a
tree whose wrappers take them.
--outputs saves K2's, the tail's, K5's and K6's outputs on those inputs to
OUT; `same`
prints, for each launch list two such files share, whether every output
is bit-equal and otherwise the largest difference over its output's
largest magnitude.

Run the trees in turns within one call (parent, change, change, parent),
each in a fresh process (many profiler sessions in one process lose kernel
events): two calls may land on two cards.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def to_cpu(x):
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    return x.cpu() if hasattr(x, "cpu") else x


def capture(path: str) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from sphtpu_torch.engine import params_from_numpy, state_from_numpy
    from sphtpu_torch.engine.driver import plan_engine
    from sphtpu_torch.physics import blocks, ctiles, tiles

    def eval_calls(cfg, state, params, h, module, names, bargs=None, joint=False):
        res = {"state": state, "params": params, "h_last": h}
        calls = cs.capture_eval_inputs(res, cfg, module, names, mlargs=bargs,
                                       joint_gravity=joint)
        return [[(to_cpu(a), kw) for a, kw in calls[name]] for name in names]

    out = {}
    d = np.load(cs.COLLAPSE)
    pos, h0 = d["pos"].astype(np.float64), d["h"].astype(np.float64)
    state = state_from_numpy(pos, d["vel"], d["K"], float(d["t"]), device=cs.DEVICE)
    params = params_from_numpy(m=float(d["m"]), gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0,
                               U0=0.0, t_end=1e30, device=cs.DEVICE)
    base = dict(n=pos.shape[0], kh=cs.KH_COLLAPSE, eos="polytropic", dtype="float32")
    cfg, bargs = plan_engine(pos, h0, **base, gravity="exact")
    out["k1_collapse"], out["k5_collapse"] = eval_calls(
        cfg, state, params, cs.dev(h0, torch.float32), blocks,
        ("phase_a_cells", "phase_b_grouped"), bargs)
    # K6: the same evaluation with phase B per bucket
    calls6 = cs.capture_eval_inputs(
        {"state": state, "params": params, "h_last": cs.dev(h0, torch.float32)}, cfg, blocks,
        ("phase_b_blocks",), mlargs=bargs, grouped=False)
    out["k6_collapse"] = [(to_cpu(a), kw) for a, kw in calls6["phase_b_blocks"]]
    # K2 with its outlier masks: the same state on the outlier rung
    # (choose_tile_params_ml with the driver's arguments, k = 50 KD-tree h)
    pos_o, _, h_o, st_o, p_o, h_o_dev = cs.collapse_state(cs.COLLAPSE)
    grid, cap, budget, _ = cs.outlier_plan(pos_o, h_o)
    cfg_o = cs.EngineConfig(**base, tile=(grid, cap), outlier_budget=budget)
    out["k2_outlier"], = eval_calls(cfg_o, st_o, p_o, h_o_dev, tiles, ("phase_b_tiles",))
    # the plan's work units stay out of the file: a parent tree's wrapper
    # does not take them, and `time` builds them for a tree that does
    # K5 under P3M: the block engine on bb_collapsed_deep.npz (contrast
    # 1001), h from a k = 50 KD-tree as the smoke's deep-state phase takes it
    pos_d, h_d, st_d, p_d, h_dev = cs.deep_state()
    plan = blocks.plan_blocks(pos_d, h_d, cs.KH_COLLAPSE, gravity="p3m")
    cfg_d = cs.EngineConfig(n=pos_d.shape[0], kh=cs.KH_COLLAPSE, eos="polytropic",
                            dtype="float32", blocks=plan[0], gravity="p3m")
    res_d = {"state": st_d, "params": p_d, "h_last": h_dev}
    calls = cs.capture_eval_inputs(res_d, cfg_d, blocks, ("phase_b_grouped",), mlargs=plan[1])
    out["k5_deep_p3m"] = [(to_cpu(a), kw) for a, kw in calls["phase_b_grouped"]]
    for key in ("k5_collapse", "k5_deep_p3m"):
        out[key] = [(a, {k: v for k, v in kw.items() if k != "units"}) for a, kw in out[key]]
    with tempfile.TemporaryDirectory() as tmp:
        for n, kh, gravity, keys, module, names in (
                (cs.N_MAIN, cs.KH_CLASS, "exact", ("k1_class", "k2_class"), ctiles,
                 ("phase_a_cells", "phase_b_tiles")),
                (cs.N_P3M, 50, "p3m", ("k4_p3m", "k2_p3m", "tail_p3m"), tiles,
                 ("phase_a_tile", "phase_b_tiles", "p3m_tail")),
                (cs.N_MAIN, 50, "exact", ("k4_exact", "k2_exact"), tiles,
                 ("phase_a_tile", "phase_b_tiles"))):
            base, state, params, pos, h0 = cs.load_scene(
                os.path.join(tmp, keys[0]), "boss_bodenheimer", n, kh)
            cfg, _ = plan_engine(pos, h0, **base, gravity=gravity)
            if cfg.gravity != gravity or cfg.tile is None:
                raise RuntimeError(f"{keys[0]}: planned {cfg}")
            got = eval_calls(cfg, state, params, cs.dev(h0, torch.float32), module, names)
            out.update(zip(keys, got))
            del got
            if gravity == "p3m":
                # the run loop's launches: K2's joint mode, the tail's skip mode
                got = eval_calls(cfg, state, params, cs.dev(h0, torch.float32), module,
                                 ("phase_b_tiles", "p3m_tail"), joint=True)
                out["k2_p3m_joint"], out["tail_p3m_skip"] = got
                del got
            torch.cuda.empty_cache()
        out["k3rc_ring"] = ring_calls(cs, state, params, pos, h0)
    out["k3_pos"] = to_cpu(state.pos)
    torch.save(out, path)
    print(json.dumps({k: len(v) if isinstance(v, list) else list(v.shape)
                      for k, v in out.items()}))


def ring_calls(cs, state, params, pos, h0):
    """K3's rows x columns launches of one z-slab evaluation of the state
    over four shards of the card (the exact far field's ring)."""
    from sphtpu_torch.shard import tiles as shard_tiles
    from sphtpu_torch.shard.collectives import particle_mesh, run_spmd

    plan = shard_tiles.plan_slabs(pos, h0, 50, 4, chunk_steps=2)
    cfg = cs.EngineConfig(n=pos.shape[0], kh=50, eos="polytropic", tile=(plan.grid, plan.cap))
    mesh = particle_mesh([cs.DEVICE] * 4)
    ev = shard_tiles.make_slab_force_eval(cfg, plan)
    calls = []

    def rec(orig):
        def run(*a, **kw):
            calls.append((to_cpu(a), kw))
            return orig(*a, **kw)
        return run

    with cs.patched(shard_tiles, "newton_rows_cols", rec):
        run_spmd([ev(params, k, s.pos, s.vel, s.K, s.valid, None)
                  for k, s in enumerate(shard_tiles.pack_state(state, plan, mesh))])
    return calls


def time_tree(tree: str, path: str, sweep: bool,
              kernels=("k1", "k2", "k3", "k4", "k5", "k6", "tail", "k3rc"),
              outputs: str | None = None) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import inspect

    import torch

    from sphtpu_torch.kernels import (
        cuda_block_pairs,
        cuda_gravity,
        cuda_grouped_pairs,
        cuda_knn,
        cuda_p3m_tail,
        cuda_strip_knn,
        cuda_tile_pairs,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = "cuda"
    data = torch.load(path, weights_only=False)

    def to_dev(x):
        if isinstance(x, (tuple, list)):
            return type(x)(to_dev(v) for v in x)
        return x.to(dev) if hasattr(x, "to") else x

    def takes(fn, name):
        return name in inspect.signature(fn).parameters

    def median_ms(fn, iters=7):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def calls_ms(fn, calls, **extra):
        return sum(median_ms(lambda: fn(*a, **kw, **extra)) for a, kw in calls)

    def device_ms(fn, calls, iters=5):
        """Device time of the hand-written kernels over one pass of `calls`,
        and each of their kernels' (ms, the median over iters)."""
        from torch.profiler import ProfilerActivity, profile

        for a, kw in calls:
            fn(*a, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for a, kw in calls:
                    fn(*a, **kw)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and "sph::" in e.name),
                     key=lambda e: e.time_range.start)
        per = [e.time_range.elapsed_us() / 1e3 for e in evs]
        if not per:
            return None, None, None
        k = len(per) // iters
        launches = [statistics.median(per[i::k]) for i in range(k)]
        # by wrapper call: a combine kernel belongs to the call before it
        by_call = []
        for e, t in zip(evs, per):
            if "combine_kernel" in e.name and by_call:
                by_call[-1] += t
            else:
                by_call.append(t)
        n = len(by_call) // iters
        calls_dev = ([statistics.median(by_call[i::n]) for i in range(n)]
                     if n * iters == len(by_call) else None)
        return sum(per) / iters, launches, calls_dev

    def load(keys):
        # a keyword off at its default (K2's `outlier` and `joint`, the tail's
        # `skip_joint`) is dropped: a parent tree's wrapper may not take it
        off = ("outlier", "joint", "skip_joint")
        return {key: [(to_dev(a), {k: v for k, v in kw.items() if k not in off or v})
                      for a, kw in data[key]]
                for key in keys}

    pos = data["k3_pos"].to(dev)
    m = 1.0 / pos.shape[0]
    out = {"tree": tree, "card": card_line(), "n_k3": pos.shape[0], "kernels": list(kernels)}
    timed = []  # (key, wrapper, calls) whose wrapper and device ms are reported
    if "k1" in kernels:
        k1 = load(("k1_collapse", "k1_class"))
        timed += [(key, cuda_strip_knn.phase_a_cells, calls) for key, calls in k1.items()]
    if "k2" in kernels:
        k2 = load(("k2_class", "k2_exact", "k2_p3m"))
        if "k2_outlier" in data and takes(cuda_tile_pairs.phase_b_tiles, "outlier"):
            k2.update(load(("k2_outlier",)))
        if "k2_p3m_joint" in data and takes(cuda_tile_pairs.phase_b_tiles, "joint"):
            k2.update(load(("k2_p3m_joint",)))
        timed += [(key, cuda_tile_pairs.phase_b_tiles, calls) for key, calls in k2.items()]
    if "k4" in kernels:
        k4 = load(("k4_exact", "k4_p3m"))
        timed += [(key, cuda_knn.phase_a_tile, calls) for key, calls in k4.items()]
    if "tail" in kernels:
        tail = load(("tail_p3m",))["tail_p3m"]
        timed.append(("tail_p3m", cuda_p3m_tail.p3m_tail, tail))
        if "tail_p3m_skip" in data and takes(cuda_p3m_tail.p3m_tail, "skip_joint"):
            timed.append(("tail_p3m_skip", cuda_p3m_tail.p3m_tail,
                          load(("tail_p3m_skip",))["tail_p3m_skip"]))
    k5_units = takes(cuda_grouped_pairs.phase_b_grouped, "units")

    def with_units(calls, unit_slots=2048):
        if not k5_units:
            return calls
        return [(a, dict(kw, units=tuple(
            torch.as_tensor(u).to(dev) for u in cuda_grouped_pairs.unit_table(
                tuple(kw["qblk"]), tuple(kw["first"]), a[0][0].shape[0], unit_slots))))
            for a, kw in calls]

    if "k5" in kernels:
        k5 = with_units(load(("k5_collapse",))["k5_collapse"])
        out["k5_units"] = k5_units
        timed.append(("k5_collapse", cuda_grouped_pairs.phase_b_grouped, k5))
        if "k5_deep_p3m" in data:
            timed.append(("k5_deep_p3m", cuda_grouped_pairs.phase_b_grouped,
                          with_units(load(("k5_deep_p3m",))["k5_deep_p3m"])))
    if "k6" in kernels and "k6_collapse" in data:
        timed.append(("k6_collapse", cuda_block_pairs.phase_b_blocks,
                      load(("k6_collapse",))["k6_collapse"]))
    if "k3" in kernels:
        timed.append(("k3", cuda_gravity.newton_sweep, [((pos, m), {})]))
    rc = importlib.util.find_spec("sphtpu_torch.kernels.cuda_gravity_rc")
    if "k3rc" in kernels and "k3rc_ring" in data and rc is not None:
        from sphtpu_torch.kernels import cuda_gravity_rc

        timed.append(("k3rc_ring", cuda_gravity_rc.newton_rows_cols,
                      load(("k3rc_ring",))["k3rc_ring"]))
    for key, fn, calls in timed:
        out[f"{key}_ms"] = calls_ms(fn, calls)
    for key, fn, calls in timed:
        out[f"{key}_device_ms"], launches, calls_dev = device_ms(fn, calls)
        if key != "k3":
            out[f"{key}_device_ms_of_launches"] = launches
        if key == "k6_collapse":
            units = getattr(cuda_block_pairs, "block_units", None)
            out["k6_collapse_launches"] = [
                {"c_b": a[1][0].shape[1], "nb": a[1][0].shape[0],
                 "n_u": units(a[1][0].shape[1]) if units else None,
                 "ms": median_ms(lambda: fn(*a, **kw)),
                 "device_ms": calls_dev[i] if calls_dev else None}
                for i, (a, kw) in enumerate(calls)]
    if outputs:
        saved = {key: [to_cpu(fn(*a, **kw)) for a, kw in calls]
                 for key, fn, calls in timed if key.startswith(("k5_", "k6_", "k2_", "tail_"))}
        torch.cuda.synchronize()
        torch.save(saved, outputs)
    if sweep and "k2" in kernels and takes(cuda_tile_pairs.phase_b_tiles, "piece"):
        for key in ("k2_exact", "k2_p3m", "k2_class"):
            out[f"{key}_pieces"] = {
                piece: calls_ms(cuda_tile_pairs.phase_b_tiles, k2[key], piece=piece)
                for piece in (128, 256, 512, 1024, 2048)}
    if sweep and "tail" in kernels and takes(cuda_p3m_tail.p3m_tail, "chunk"):
        out["tail_p3m_chunks"] = {
            chunk: calls_ms(cuda_p3m_tail.p3m_tail, tail, chunk=chunk)
            for chunk in (1024, 2048, 4096)}
    if sweep and "k1" in kernels or sweep and "k4" in kernels:
        caps = (672, 448, 320, 224)
        for mod, fn, key_set in ((cuda_strip_knn, cuda_strip_knn.phase_a_cells, "k1"),
                                 (cuda_knn, cuda_knn.phase_a_tile, "k4")):
            if key_set not in kernels or not takes(fn, "list_cap"):
                continue
            groups = k1 if key_set == "k1" else k4
            for key, calls in groups.items():
                out[f"{key}_list_caps"] = {}
                for cap_l in caps:
                    valid = over = 0
                    for a, kw in calls:
                        fn(*a, **kw, list_cap=cap_l)
                        qm = a[0][3] if mod is cuda_strip_knn else a[0][3][
                            :, 13 * kw["cap"] : 14 * kw["cap"]]
                        valid += int((qm > 0).sum())
                        over += int(mod.last_overflow.item())
                    out[f"{key}_list_caps"][cap_l] = {
                        "ms": calls_ms(fn, calls, list_cap=cap_l),
                        "overflow_share": over / max(valid, 1)}
    if sweep and "k5" in kernels and k5_units:
        out["k5_unit_slots"] = {
            u: calls_ms(cuda_grouped_pairs.phase_b_grouped, with_units(k5, u))
            for u in (512, 1024, 2048, 4096, 8192)}
    if sweep and "k3" in kernels:
        n = pos.shape[0]
        plans = [(r, 256, s) for r in (1, 2, 4) for s in (1, 11, 22, 44, 88)] + [(4, 128, 44)]
        out["k3_plans"] = []
        for rows, threads, n_slices in plans:
            n_slices = -(-n // cuda_gravity.column_slices(n, n_slices, threads))
            plan = (rows, threads, n_slices)
            out["k3_plans"].append({
                "R": rows, "threads": threads, "S": n_slices,
                "ms": median_ms(lambda: cuda_gravity.newton_sweep(pos, m, plan=plan))})
        out["k3_default_plan"] = list(cuda_gravity.split_plan(
            n, torch.cuda.get_device_properties(0).multi_processor_count, pos.dtype))
    print(json.dumps(out), flush=True)


def same(path_a: str, path_b: str) -> None:
    """For each launch list saved by both `--outputs` files: whether every
    output tensor is bit-equal, and the largest |a - b| over the largest
    |b| of that output."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)

    def flat(x):
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in flat(v)]
        return [x]

    res = {}
    for key in sorted(set(a) & set(b)):
        xs, ys = flat(a[key]), flat(b[key])
        worst = 0.0
        for x, y in zip(xs, ys):
            live = y > -torch.finfo(y.dtype).max  # mu_max of a row with no pair is -max
            if bool(live.any()):
                scale = float(y[live].abs().max())
                err = float((x - y)[live].abs().max())
                worst = max(worst, err / scale if scale > 0 else err)
        res[key] = {"bit_equal": len(xs) == len(ys) and all(
            torch.equal(x, y) for x, y in zip(xs, ys)), "max_err_over_scale": worst}
    print(json.dumps(res), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "capture":
        capture(sys.argv[2])
    elif len(sys.argv) >= 4 and sys.argv[1] == "time":
        rest = sys.argv[4:]
        kernels = ("k1", "k2", "k3", "k4", "k5", "k6", "tail", "k3rc")
        if "--kernels" in rest:
            kernels = tuple(rest[rest.index("--kernels") + 1].split(","))
        outputs = rest[rest.index("--outputs") + 1] if "--outputs" in rest else None
        time_tree(sys.argv[2], sys.argv[3], "--sweep" in rest, kernels, outputs)
    elif len(sys.argv) >= 4 and sys.argv[1] == "same":
        same(sys.argv[2], sys.argv[3])
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
