"""Readings that the limits of `correct` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]

For each seed, in one process: the cell's set-up, one warm-up request and
one request of the program (the window's own entry, at the cell's size),
then the reference in float64, and the program's numbers against it; for
each control seed also the control, the reference computed in bfloat16 (the
precision below the configuration's float32) and held against the float64
reference the same way. One JSON line a seed on standard output. The
benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    runners = {}
    for seed in seeds + sorted(control - set(seeds)):
        p = harness.prepare(ROOT, args.workload, seed, "cuda", runners)
        line = {"cell": args.workload, "seed": seed, "plan": harness.describe(p.cfg)}
        if seed in seeds:
            p.req()
            o = p.req()
            line["failure"] = o.failure
            out = harness.outputs(o) if o.failure is None else None
            del o
        p = p._replace(req=None)
        gc.collect()
        if p.dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = harness.reference(p)
        line["reference_s"] = time.perf_counter() - t0
        if seed in seeds and out is not None:
            line["program"] = harness.readings(p, out, ref)
        if seed in control:
            t0 = time.perf_counter()
            ctl = harness.reference(p, dtype=torch.bfloat16)
            line["control_s"] = time.perf_counter() - t0
            line["control"] = harness.readings(p, ctl, ref)
            del ctl
        del ref
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
