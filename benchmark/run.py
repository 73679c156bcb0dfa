"""The benchmark of sphtpu_torch: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device` and, with `--trace 1`,
`breakdown`; `checks`, each number compared with its limit, comes last. The
same numbers end standard error. Exits non-zero with no result when there is
no CUDA device, or when a module of the JAX package (or JAX) was loaded.
See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# caches at fixed paths inside the checkout, so only a cell's first run there
# builds (the program's own kernels go to <checkout>/build, by its build.py)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark_cache", sub)
os.environ["USE_FLAX"] = "0"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmark import harness, manifest

    cell = manifest.Cell(ROOT, args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.execute(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda", t_start=T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"modules loaded that the benchmark must not load: {foreign}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card_line()
    result["checks"] = checks
    print(f"card: {result['card']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
