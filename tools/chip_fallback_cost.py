"""Cost of one gather-engine (fallback) force evaluation on the card.

    python3 tools/chip_fallback_cost.py [N]

Times, at the headline scene (boss_bodenheimer, polytropic, Kh = 50,
float32, N = 100 000 unless given), the two halves of a fallback
evaluation — `sph_forces` (blocked kNN + pair sums) and `gravity_allpairs`
(blocked softened sweep) — at the default block sizes and at larger ones,
and checks that the block size changes the result only by roundoff."""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sphtpu_torch.neighbors import knn  # noqa: E402
from sphtpu_torch.physics import gravity_allpairs, sph_forces  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        base, state, params, pos, h0 = chip_smoke.load_scene(tmp, "boss_bodenheimer", n)
    h = chip_smoke.dev(h0, torch.float32)
    kw = dict(eos="polytropic", gamma=params.gamma, cs0=params.cs0, alpha=params.alpha,
              beta=params.beta, kh=base["kh"])
    out = {"card": card, "n": n}
    knn(state.pos[:1024], state.pos, base["kh"])  # warm-up
    _, out["sph_forces_s"] = timed(
        lambda: sph_forces(state.pos, state.vel, params.m, state.K, **kw))
    for bq, bc in ((512, 2048), (2048, 8192), (4096, 16384)):
        (_, d2), t = timed(lambda: knn(state.pos, state.pos, base["kh"], block_q=bq, block_c=bc))
        out[f"knn_{bq}x{bc}_s"] = t
    ref = None
    for bq, bc in ((256, 2048), (1024, 8192), (2048, 16384)):
        (g, phi), t = timed(
            lambda: gravity_allpairs(state.pos, h, params.m, block_q=bq, block_c=bc))
        out[f"gravity_allpairs_{bq}x{bc}_s"] = t
        if ref is None:
            ref = (g, phi)
        else:
            out[f"gravity_allpairs_{bq}x{bc}_max_rel_diff"] = float(
                ((g - ref[0]).abs().max() / ref[0].abs().max()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
