"""The multi-device layer on four shards of one GPU.

    python3 tools/chip_shard.py [phase ...]

Phases (all, in this order, when none is named):

*   slabs: chip_smoke.phase_shard_slabs on the headline scene
    (boss_bodenheimer, N = 100 000, Kh = 50, exact gravity) through
    run_simulation over four shards of cuda:0, a 2-step slab chunk of its
    final state beside the single-device chunk, and one evaluation's K4
    and K2 launches (and the tail's, under P3M) against their plain
    versions at the slab's shapes; then K3's rows x columns
    entry against its plain version on the ring's inputs
    (chip_smoke.rc_entry; with `work` also on the row-sharded inputs);
*   p3m: the same on the P3M scene (N = 200 000, gravity "auto");
*   work: chip_smoke.phase_shard_work — bb_collapsed.npz on the
    work-sharded block engine, one evaluation against the single-device
    engine, and one bb_collapsed_deep.npz evaluation on the work-sharded
    multi-level engine.

With --cards the shards are four distinct cards (cuda:0..3, the default mesh
of run_simulation(n_devices=4); the machine must have four) in place of four
shards of cuda:0, every synchronisation covers all cards, and K3's rows x
columns entry is not timed (its launches lie on four cards).

Each phase prints chip_smoke's JSON lines; the card's name and power limit
come first."""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sphtpu_torch.kernels import build  # noqa: E402

PHASES = ("slabs", "p3m", "work")


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    cards = "--cards" in argv
    argv = [a for a in argv if a != "--cards"]
    phases = argv or PHASES
    if cards:
        n = torch.cuda.device_count()
        if n < chip_smoke.SHARDS:
            raise RuntimeError(f"--cards needs {chip_smoke.SHARDS} cards, {n} visible")
        chip_smoke.shard_mesh = lambda: [torch.device("cuda", i) for i in range(chip_smoke.SHARDS)]
        chip_smoke.sync = lambda: [torch.cuda.synchronize(i) for i in range(n)]
    lines = chip_smoke.run_text(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).splitlines()
    gpu_line = "; ".join(lines) if cards else lines[0]
    print(gpu_line, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    build.load_kernels()
    chip_smoke.say("build", seconds=time.time() - t0,
                   ptxas=[ln for lg in build.build_log.values() for ln in lg.splitlines()
                          if "registers" in ln or "spill" in ln and "0 bytes spill" not in ln])
    ring = counts = row_sharded = None
    with tempfile.TemporaryDirectory() as tmp:
        for phase in phases:
            t0 = time.time()
            if phase == "slabs":
                counts, ring, _, _ = chip_smoke.phase_shard_slabs(tmp, gpu_line, p3m=False)
            elif phase == "p3m":
                chip_smoke.phase_shard_slabs(tmp, gpu_line, p3m=True)
            elif phase == "work":
                _, row_sharded, _, _ = chip_smoke.phase_shard_work(tmp, gpu_line)
            else:
                raise ValueError(f"unknown phase {phase!r}")
            torch.cuda.empty_cache()
            chip_smoke.say("phase_seconds", name=phase, seconds=time.time() - t0)
        if ring is not None and not cards:
            if row_sharded is None:
                st = ring[0][0][1]
                row_sharded = (st, 1.0e-5)
            entry = chip_smoke.rc_entry(ring, row_sharded, counts)
            print(json.dumps({"newton_rows_cols": entry}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
