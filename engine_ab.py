#!/usr/bin/env python3
"""Time ``InferenceEngine.run`` of two source trees of the port on one
CUDA card, in alternated processes, so that a change in the latency per
image can be told apart from the host's noise.

    python3 engine_ab.py TREE_A TREE_B [--rounds 3] [--runs 200]

Each tree is a checkout holding ``src/repro_torch`` (the kernels build
into it at first use). Each round runs one process per tree in the order
A, B, B, A. A process times, for each CNN path of ``PATHS`` (224², fp32,
batch 1, random weights from seed 0, numpy-seeded images), ``--runs``
calls of ``engine.run`` after 5 warm-up calls, each ending in a
synchronize: the host-clock ms of a call (median, 10th and 90th
percentile, mean) and the process's CPU ms a call over all of them (its
CPU clock ticks too coarsely to read one call; a wall time well above it
is time the process waited for the card or for a core). It
also times one eager call of ``pointwise_conv`` at each of ResNet-18's
three stride-2 shortcuts, ending in a synchronize (median of 200, µs):
the wrapper's host cost with its launch. One JSON line a process, the
card's name and power limit first, a summary line a tree last: for each
path the median over its processes of the median ms and of the CPU ms,
and of each shortcut's µs.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# (path, config, per-layer): the tuned plan, or the tuned plan without
# its fused blocks
PATHS = (("resnet18", "resnet18", False),
         ("resnet18/per_layer", "resnet18", True),
         ("mobilenet_v2", "mobilenet_v2", False),
         ("mobilenet_v2/per_layer", "mobilenet_v2", True))
# ResNet-18's stride-2 1x1 shortcuts: (H, C, K)
SHORTCUTS = ((56, 64, 128), (28, 128, 256), (14, 256, 512))
WARMUP = 5


def _quantiles(xs):
    q = statistics.quantiles(xs, n=10)
    return {"median": statistics.median(xs), "p10": q[0], "p90": q[-1]}


def time_tree(tree: Path, runs: int) -> dict:
    """The timings of one process on ``tree``'s port."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.core import InferenceEngine
    from repro_torch.kernels import pointwise_conv

    if not torch.cuda.is_available():
        raise SystemExit("engine_ab: no CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = np.random.default_rng(0).standard_normal(
        (4, 224, 224, 3)).astype(np.float32)
    out = {"tree": str(tree), "paths": {}}
    tuned = {}
    for path, config, per_layer in PATHS:
        if per_layer:
            plan = copy.deepcopy(tuned[config].plan)
            plan.block_choices.clear()
            plan.block_specs.clear()
            engine = InferenceEngine(get(config), params=tuned[config].model,
                                     plan=plan)
        else:
            engine = tuned[config] = InferenceEngine(get(config), seed=0)
        for i in range(WARMUP):
            engine.run(images[i % len(images)])
        wall = []
        torch.cuda.synchronize()
        c0 = time.process_time()
        for i in range(runs):
            t0 = time.perf_counter()
            engine.run(images[i % len(images)])
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        cpu = (time.process_time() - c0) * 1e3 / runs
        out["paths"][path] = {"ms": {**_quantiles(wall),
                                     "mean": statistics.mean(wall)},
                              "cpu_ms": cpu}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out["shortcut_call_us"] = {}
    for H, C, K in SHORTCUTS:
        x = torch.randn(1, H, H, C, device="cuda", generator=gen)
        w = torch.randn(1, 1, C, K, device="cuda", generator=gen) * C ** -0.5
        scale = torch.rand(K, device="cuda", generator=gen) + 0.5
        bias = torch.randn(K, device="cuda", generator=gen) * 0.1
        times = []
        for i in range(WARMUP + 200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pointwise_conv.pointwise_conv(x, w, stride=2, scale=scale,
                                          bias=bias)
            torch.cuda.synchronize()
            if i >= WARMUP:
                times.append((time.perf_counter() - t0) * 1e6)
        out["shortcut_call_us"][f"{H}x{C}->{K}"] = statistics.median(times)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.one.resolve(), args.runs)),
              flush=True)
        return
    if len(args.trees) != 2:
        raise SystemExit("engine_ab: give two trees")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    a, b = (t.resolve() for t in args.trees)
    lines = {a: [], b: []}
    for r in range(args.rounds):
        for tree in (a, b, b, a):
            proc = subprocess.run(
                [sys.executable, __file__, "--one", str(tree),
                 "--runs", str(args.runs)], capture_output=True, text=True)
            if proc.returncode:
                sys.stderr.write(proc.stderr)
                raise SystemExit(f"engine_ab: {tree} exited "
                                 f"{proc.returncode}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            line["round"] = r
            lines[tree].append(line)
            print(json.dumps(line), flush=True)
    for tree, got in lines.items():
        print(json.dumps({"summary": str(tree), "processes": len(got), **{
            path: {"ms": statistics.median(g["paths"][path]["ms"]["median"]
                                           for g in got),
                   "cpu_ms": statistics.median(g["paths"][path]["cpu_ms"]
                                               for g in got)}
            for path, _, _ in PATHS},
            **{k: statistics.median(g["shortcut_call_us"][k] for g in got)
               for k in got[0]["shortcut_call_us"]}}), flush=True)


if __name__ == "__main__":
    main()
