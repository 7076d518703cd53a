#!/usr/bin/env python3
"""Readings that the benchmark's limits are set from; the benchmark's own
runs never run this.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control program|tf32|tf32_native] [--seconds 2]

For each seed, in one process, it runs one window of the cell, with the
program (``program``) or with the plain reference in its place at a
precision below the configuration's fp32 (``tf32``: every product's
operands rounded to TF32; ``tf32_native``: the card's TF32 tensor cores;
``systems/control.py``), and prints one JSON line: the seed, the numbers
compared, the end-to-end metrics and the latencies.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", default="program",
                        choices=("program", "tf32", "tf32_native"))
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "bench" / ".cache" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "bench" / ".cache" / "nv")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import manifest
    from bench.harness.runner import run_cell

    system = None
    if args.control != "program":
        def system(cfg, mix, weights, device):
            return manifest.load("systems", "control").build(
                cfg, mix, weights, device, precision=args.control)

    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False,
                     t_start=time.perf_counter(), device=args.device,
                     system=system)
        line = {"workload": args.workload, "control": args.control,
                "seed": seed, "correct": r["correct"], "checks": r["checks"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "info": r["info"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
