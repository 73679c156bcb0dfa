"""The outlier lane and the off-path modules on one GPU.

    python3 tools/chip_outlier.py [phase ...]

Phases (all, in this order, when none is named):

*   k2: chip_smoke.kernels_k2_mono — K2 on synthetic mono rows (cap 160
    and 256, all EOS x P3M variants, float32 and float64), with the outlier
    masks on the exact variants (bit-identical to none where no slot holds
    mask 2);
*   outlier: chip_smoke.phase_outlier — bb_collapsed.npz (N = 100 000,
    contrast 395) on the mono-tile engine with its outlier lane in both
    gravity modes: the plan, one evaluation by stage beside the block
    engine's, K2 with its outlier masks against its plain version, a 2-step
    chunk;
*   ladder: chip_smoke.phase_outlier_ladder — four CLI steps with
    plan_blocks and plan_mlevel made to decline;
*   offpath: chip_smoke.phase_offpath — dense_forces and knn_celllist.

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

PHASES = ("k2", "outlier", "ladder", "offpath")


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
        if phase == "k2":
            chip_smoke.say("k2", cases=chip_smoke.kernels_k2_mono(np.random.default_rng(1),
                                                                   1.0e-5))
        elif phase == "outlier":
            k2, counts = chip_smoke.phase_outlier(gpu_line)
            print(json.dumps({"k2_on_outlier_path": k2, "launches": counts}), flush=True)
        elif phase == "ladder":
            with tempfile.TemporaryDirectory() as tmp:
                chip_smoke.phase_outlier_ladder(tmp, gpu_line)
        elif phase == "offpath":
            chip_smoke.phase_offpath(gpu_line)
        else:
            raise ValueError(f"unknown phase {phase!r}")
        chip_smoke.say("phase_seconds", name=phase, seconds=time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
