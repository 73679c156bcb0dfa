"""The multi-level engine and the block kernels' float32 sums on one GPU.

    python3 tools/chip_mlevel.py [phase ...]

Phases (all, in this order, when none is named):

*   kernels_f7: K5 and K6 in float32 on ROADMAP F7's draw against their
    plain version in float64 (chip_smoke.kernels_f7), then chip_smoke's
    synthetic block cases (kernels_blocks);
*   mlevel: chip_smoke.phase_mlevel — bb_collapsed_deep.npz (N = 100 000,
    contrast 1001) on the multi-level engine in both gravity modes, each
    evaluation's seconds by stage beside the block engine's, K1 against its
    plain version on the path's launches, a 2-step chunk;
*   ladder: chip_smoke.phase_mlevel_ladder — four CLI steps with
    plan_blocks made to decline.

Each phase prints chip_smoke's JSON lines; the card's name and power limit
come first."""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sphtpu_torch.kernels import build  # noqa: E402

PHASES = ("kernels_f7", "mlevel", "ladder")


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    phases = argv or PHASES
    gpu_line = chip_smoke.run_text(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).splitlines()[0]
    print(gpu_line, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    build.load_kernels()
    chip_smoke.say("build", seconds=time.time() - t0,
                   ptxas=[ln for lg in build.build_log.values() for ln in lg.splitlines()
                          if "registers" in ln or "spill" in ln and "0 bytes spill" not in ln])
    for phase in phases:
        t0 = time.time()
        if phase == "kernels_f7":
            chip_smoke.say("kernels_f7", cases=chip_smoke.kernels_f7(1.0e-5)
                           + chip_smoke.kernels_blocks(np.random.default_rng(0), 1.0e-5))
        elif phase == "mlevel":
            k1, counts = chip_smoke.phase_mlevel(gpu_line)
            print(json.dumps({"k1_on_mlevel_path": k1, "launches": counts}), flush=True)
        elif phase == "ladder":
            with tempfile.TemporaryDirectory() as tmp:
                chip_smoke.phase_mlevel_ladder(tmp, gpu_line)
        else:
            raise ValueError(f"unknown phase {phase!r}")
        chip_smoke.say("phase_seconds", name=phase, seconds=time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
