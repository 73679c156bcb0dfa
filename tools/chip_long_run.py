"""A longer run of the main path on the card, through the CLI.

    python3 tools/chip_long_run.py [STEPS] [N]

Generates boss_bodenheimer (polytropic, Kh = 50) at N particles (100 000
unless given), runs STEPS steps (40 unless given) in float32 with a
snapshot every 10, and prints one JSON object: steps, fallback
evaluations, the engine configs the planner used (tile, classes, gravity;
P3M from N = 150 000 on), (steps, seconds,
fallback evaluations) of every chunk, and the relative energy drift."""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sphtpu_torch import cli  # noqa: E402
from sphtpu_torch.io import StatsFile  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--EOS", "polytropic", "--ic_type", "boss_bodenheimer", "--root", tmp]
        cli.main(["--generate", *common, "--kwargs", f"N={n}"])
        cli.main(["--run", *common, "--snapInterval", "10", "--showPlots", "false",
                  "--max-steps", str(steps)])
        res = cli.LAST_RUN
        sf = StatsFile(os.path.join(tmp, "snapshots", "boss_bodenheimer", "stats"))
        hist = sf.up_to(res["steps"])
        sf.close()
    walls = res["chunk_walls"][1:]
    e = hist[:, 4]
    print(json.dumps({
        "card": card, "n": n, "steps": res["steps"],
        "fallback_evals": res["fallback_evals"],
        "configs": [[list(c.tile), [list(k) for k in c.tile_classes or ()], c.gravity]
                    if c.tile else "gather" for c in res["configs"]],
        "chunks_steps_seconds_fallbacks": res["chunk_walls"],
        "s_per_step_after_first_chunk": sum(c[1] for c in walls) / sum(c[0] for c in walls),
        "particle_steps_per_s": n * sum(c[0] for c in walls) / sum(c[1] for c in walls),
        "runtime_s_with_io": res["runtime_s"],
        "energy_drift": float(np.abs(e - e[0]).max() / abs(e[0])),
        "t_cgs": res["t_cgs"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
