"""Exact against P3M gravity on the mono-tile engine, across N.

    python3 tools/chip_p3m_crossover.py [N ...]

For each N (50 000, 100 000, 150 000, 200 000, 300 000 unless given):
boss_bodenheimer, polytropic, Kh = 50, float32, the mono-tile plan of
run_simulation's planner (`choose_tile_params`, headroom 1.5), one chunk
runner with exact gravity (K3 sweep) and one with P3M (FFT mesh + tail
kernel) on the same plan. One warm-up step each, then chunks of STEPS steps
timed on the host clock around work that ends in a device-to-host read, in
turns exact, p3m, p3m, exact. Prints one JSON object per N, the card's name
and power limit in each."""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sphtpu_torch.engine import EngineConfig, make_chunk_runner  # noqa: E402
from sphtpu_torch.engine.driver import CHUNK_REPAIRS  # noqa: E402
from sphtpu_torch.physics.tiles import choose_tile_params  # noqa: E402

STEPS = 3


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    ns = [int(a) for a in sys.argv[1:]] or [50_000, 100_000, 150_000, 200_000, 300_000]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for n in ns:
        with tempfile.TemporaryDirectory() as tmp:
            base, state, params, pos, h0 = chip_smoke.load_scene(tmp, "boss_bodenheimer", n)
        tile = choose_tile_params(pos, h0, base["kh"], headroom=1.5)
        if tile is None:
            print(json.dumps({"card": card, "n": n, "tile": None}), flush=True)
            continue
        runners = {
            g: make_chunk_runner(EngineConfig(**base, tile=tile, gravity=g), **CHUNK_REPAIRS)
            for g in ("exact", "p3m")
        }
        h = chip_smoke.dev(h0, torch.float32)
        starts, fallbacks = {}, {}
        for g, run in runners.items():
            st, _, _, hg, _, nfb = run(state, params, h, 1)
            starts[g] = (st, hg)
            fallbacks[g] = int(nfb.sum())
        walls = {g: [] for g in runners}
        for g in ("exact", "p3m", "p3m", "exact"):
            st, hg = starts[g]
            t0 = time.perf_counter()
            _, _, _, h_out, _, nfb = runners[g](st, params, hg, STEPS)
            h_out.cpu()  # the chunk has finished
            walls[g].append((time.perf_counter() - t0) / STEPS * 1e3)
            fallbacks[g] += int(nfb.sum())
        print(json.dumps({
            "card": card, "n": n, "tile": list(tile), "ms_per_step": walls,
            "ms_per_step_mean": {g: sum(v) / len(v) for g, v in walls.items()},
            "fallback_evals": fallbacks,
        }), flush=True)
        del runners, starts, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
