"""Class-compacted vs mono-tile engine on an exact-gravity scene.

    python3 tools/chip_d1_engines.py [N [KH]]

boss_bodenheimer, polytropic, float32, exact gravity, N = 100 000 and
Kh = 50 (the headline scene) unless given. The class engine as
`choose_tile_classes` plans it with a capacity ceiling of 256 (Kh = 50:
cap 160 at N = 1e5, five classes; Kh = 32: cap 128, which the port's
planner gives the class engine) and the mono-tile engine at the same
(grid, cap). Protocol of chip_smoke.py's main
path: one warm-up step per engine, then chunks of STEPS steps timed on the
host clock around work that ends in a device-to-host read, in turns
class, mono, mono, class (twice). Also the hydro pass alone (the tile
engine's call, CUDA events, median of 5) on the same state. Prints one JSON
object; the card's name and power limit are in it."""

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
from sphtpu_torch.physics.ctiles import choose_tile_classes, ctile_sph_forces  # noqa: E402
from sphtpu_torch.physics.tiles import tile_sph_forces  # noqa: E402

STEPS = 5


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    kh = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        base, state, params, pos, h0 = chip_smoke.load_scene(tmp, "boss_bodenheimer", n, kh)
    grid, cap, classes = choose_tile_classes(pos, h0, base["kh"], headroom=1.5, cap_max=256)
    cfgs = {
        "class": EngineConfig(**base, tile=(grid, cap), tile_classes=classes),
        "mono": EngineConfig(**base, tile=(grid, cap)),
    }
    runners = {k: make_chunk_runner(c) for k, c in cfgs.items()}
    h = chip_smoke.dev(h0, torch.float32)
    starts = {}
    fallbacks = {k: 0 for k in cfgs}
    for k, run in runners.items():  # warm-up: builds the kernels, first allocations
        st, _, _, hk, _, nfb = run(state, params, h, 1)
        starts[k] = (st, hk)
        fallbacks[k] += int(nfb.sum())
    walls = {k: [] for k in cfgs}
    for k in ("class", "mono", "mono", "class") * 2:
        st, hk = starts[k]
        t0 = time.perf_counter()
        _, _, _, h_out, _, nfb = runners[k](st, params, hk, STEPS)
        h_out.cpu()  # the chunk has finished
        walls[k].append((time.perf_counter() - t0) / STEPS * 1e3)
        fallbacks[k] += int(nfb.sum())

    st, hk = starts["class"]
    kw = dict(eos="polytropic", gamma=params.gamma, cs0=params.cs0, alpha=params.alpha,
              beta=params.beta, kh=base["kh"], grid=grid, cap=cap)
    hydro_ms = {
        "class": chip_smoke.time_ms(lambda: ctile_sph_forces(
            st.pos, st.vel, params.m, st.K, hk, classes=classes, **kw)),
        "mono": chip_smoke.time_ms(lambda: tile_sph_forces(
            st.pos, st.vel, params.m, st.K, hk, **kw)),
    }
    out = {
        "card": card, "n": n, "kh": base["kh"], "tile": [grid, cap],
        "tile_classes": [list(c) for c in classes],
        "steps_per_chunk": STEPS, "ms_per_step": walls,
        "ms_per_step_median": {k: sorted(v)[len(v) // 2] for k, v in walls.items()},
        "hydro_ms_per_eval": hydro_ms, "fallback_evals": fallbacks,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
