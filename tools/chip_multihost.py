"""The multi-process layer on one GPU: two gloo ranks, two shards each.

    python3 tools/chip_multihost.py [phase ...]

Phases (all, in this order, when none is named):

*   work: bb_collapsed.npz through run_simulation over four shards of
    cuda:0 in one process (chip_smoke.drive_sharded), then
    chip_smoke.phase_multihost_work: the same four steps through
    run_simulation(multihost=True) over two ranks x two shards, held
    against the one-process run;
*   nccl: phase_multihost_work with backend "nccl", one card a rank (needs
    two visible cards; the one-process run of `work` is made first if
    `work` was not named);
*   slabs: the headline scene (N = 100 000, Kh = 50) four steps through
    run_simulation over four shards of cuda:0 in one process
    (chip_smoke.drive_sharded), then chip_smoke.phase_multihost_slabs on its
    final state: state-sharded with shard/mh_slabs.py over two ranks x two
    shards, one 2-step slab chunk against the one-process chunk.

Each phase prints chip_smoke's JSON lines; the card's name and power limit
come first."""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sphtpu_torch.kernels import build  # noqa: E402

PHASES = ("work", "nccl", "slabs")


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    phases = argv or PHASES
    gpu_line = "; ".join(chip_smoke.run_text(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines())
    print(gpu_line, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    build.load_kernels()
    chip_smoke.say("build", seconds=time.time() - t0)
    one = None
    with tempfile.TemporaryDirectory() as tmp:
        for phase in phases:
            t0 = time.time()
            if phase in ("work", "nccl") and one is None:
                root = os.path.join(tmp, "shard_work")
                chip_smoke.write_collapse_snapshot(root, chip_smoke.COLLAPSE)
                one, counts, checks, _ = chip_smoke.drive_sharded(
                    root, chip_smoke.N_MAIN, generate=False)
                chip_smoke.say("one_process_x4", launches=counts,
                               failed=[k for k, v in checks.items() if not v],
                               chunk_engines=one["chunk_engines"],
                               **chip_smoke.walls_summary(one, chip_smoke.N_MAIN))
            if phase == "work":
                chip_smoke.phase_multihost_work(tmp, gpu_line, one)
            elif phase == "nccl":
                if torch.cuda.device_count() < chip_smoke.MH_RANKS:
                    chip_smoke.say("multihost_work_nccl", ran=False,
                                   visible_cards=torch.cuda.device_count())
                    continue
                chip_smoke.phase_multihost_work(tmp, gpu_line, one, "nccl")
            elif phase == "slabs":
                res, _, _, _ = chip_smoke.drive_sharded(os.path.join(tmp, "slab_exact"),
                                                        chip_smoke.N_MAIN)
                scene = chip_smoke.final_scene(res)
                del res
                chip_smoke.phase_multihost_slabs(tmp, gpu_line, scene)
            else:
                raise ValueError(f"unknown phase {phase!r}")
            torch.cuda.empty_cache()
            chip_smoke.say("phase_seconds", name=phase, seconds=time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
