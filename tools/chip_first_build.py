"""Build the CUDA kernels and check each once against its plain version.

    python3 tools/chip_first_build.py

A short first run for a machine with one NVIDIA GPU: prints what ptxas
says about every kernel (registers, shared memory, spills), then runs
chip_smoke's kernels phase (kernel vs plain PyTorch version, f32 and f64)
at a reduced number of rows."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sphtpu_torch.kernels import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    build.load_kernels()
    for name, log in build.build_log.items():
        print(f"== {name}\n{log}")
    chip_smoke.ROWS_F32, chip_smoke.ROWS_F64 = 64, 16
    chip_smoke.phase_kernels()
    return 0


if __name__ == "__main__":
    sys.exit(main())
