"""A longer run of the main path on the card, through the CLI.

    python3 tools/chip_long_run.py [STEPS] [N]

Generates boss_bodenheimer (polytropic, Kh = 50) at N particles (100 000
unless given), runs STEPS steps (40 unless given) in float32 with a
snapshot every 10, and prints one JSON object: steps, fallback
evaluations, the engine configs the planner used (tile and classes, or the
block buckets; gravity, P3M from N = 150 000 on), (steps, seconds,
fallback evaluations) and the engine of every chunk, the host planning
seconds before every chunk (plan or block refit), the steps and seconds per
engine, seconds a step after the first chunk without and with planning, the
relative energy drift, and the block plan's refits (`block_args_for_spec`
calls of the run loop: how many, how many declined, the first words of
each reason, `blocks.last_refit_fail`)."""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sphtpu_torch import cli  # noqa: E402
from sphtpu_torch.engine import driver  # noqa: E402
from sphtpu_torch.io import StatsFile  # noqa: E402
from sphtpu_torch.physics import blocks  # noqa: E402


def config_summary(c):
    if c.tile is not None:
        return {"tile": list(c.tile), "classes": [list(k) for k in c.tile_classes or ()],
                "gravity": c.gravity}
    if c.blocks is not None:
        return {"blocks": [list(b) for b in c.blocks[0]], "gravity": c.gravity}
    return "gather"


def by_engine(res):
    """(steps, seconds, fallback evaluations) summed per engine; a chunk
    whose certificate failed counts under its planned engine."""
    out = {}
    for eng, (steps, secs, fb) in zip(res["chunk_engines"], res["chunk_walls"]):
        acc = out.setdefault(eng, [0, 0.0, 0])
        acc[0] += steps
        acc[1] += secs
        acc[2] += fb
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    refits = []
    refit = driver.block_args_for_spec

    def counted(*a, **kw):
        out = refit(*a, **kw)
        refits.append(None if out is not None else (blocks.last_refit_fail() or "")[:40])
        return out

    driver.block_args_for_spec = counted
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--EOS", "polytropic", "--ic_type", "boss_bodenheimer", "--root", tmp]
        cli.main(["--generate", *common, "--kwargs", f"N={n}"])
        cli.main(["--run", *common, "--snapInterval", "10", "--showPlots", "false",
                  "--max-steps", str(steps)])
        res = cli.LAST_RUN
        sf = StatsFile(os.path.join(tmp, "snapshots", "boss_bodenheimer", "stats"))
        hist = sf.up_to(res["steps"])
        sf.close()
    driver.block_args_for_spec = refit
    walls = res["chunk_walls"][1:]
    plan_s = sum(res["pick_walls"][1:])
    e = hist[:, 4]
    print(json.dumps({
        "card": card, "n": n, "steps": res["steps"],
        "fallback_evals": res["fallback_evals"],
        "configs": [config_summary(c) for c in res["configs"]],
        "chunks_steps_seconds_fallbacks": res["chunk_walls"],
        "chunk_engines": res["chunk_engines"],
        "planning_s_by_chunk": res["pick_walls"],
        "steps_seconds_by_engine": by_engine(res),
        "s_per_step_after_first_chunk": sum(c[1] for c in walls) / sum(c[0] for c in walls),
        "particle_steps_per_s": n * sum(c[0] for c in walls) / sum(c[1] for c in walls),
        "s_per_step_end_to_end_after_first_chunk":
            (sum(c[1] for c in walls) + plan_s) / sum(c[0] for c in walls),
        "runtime_s_with_io": res["runtime_s"],
        "energy_drift": float(np.abs(e - e[0]).max() / abs(e[0])),
        "block_refits": len(refits),
        "block_refits_declined": [r for r in refits if r is not None],
        "t_cgs": res["t_cgs"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
