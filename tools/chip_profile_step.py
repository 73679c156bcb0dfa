"""Where a step of the main path spends its time on the card.

    python3 tools/chip_profile_step.py [N]

Builds the headline scene (boss_bodenheimer, polytropic, Kh = 50, float32,
N = 100 000 unless given), plans the engine as run_simulation does
(`plan_engine`; P3M gravity from N = 150 000 on), warms up one step, then traces three steps with
torch.profiler and prints: wall seconds per step, the device's busy and
idle share (device time of the traced steps over the wall of the same
steps run untraced), and device time by kernel name."""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from sphtpu_torch.engine import make_chunk_runner  # noqa: E402
from sphtpu_torch.engine.driver import P3M_MIN_N, plan_engine  # noqa: E402


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
    cfg = plan_engine(pos, h0, **base, gravity="p3m" if n >= P3M_MIN_N else "exact")
    chunk = make_chunk_runner(cfg)
    h = chip_smoke.dev(h0, torch.float32)
    state, _, _, h, _, nfb = chunk(state, params, h, 1)  # warm-up, builds the kernels
    torch.cuda.synchronize()

    steps = 3
    t0 = time.perf_counter()
    state, _, _, h, _, nfb1 = chunk(state, params, h, steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps  # untraced: the profiler slows the host

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _, _, h, _, nfb2 = chunk(state, params, h, steps)
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
        "card": card, "n": n, "tile": list(cfg.tile), "gravity": cfg.gravity,
        "tile_classes": [list(c) for c in cfg.tile_classes or ()],
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


if __name__ == "__main__":
    sys.exit(main())
