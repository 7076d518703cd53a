#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json`` (see
``bench/README.md``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison read, beside its limit. The same checks are the last lines of
standard error.

It exits with another code than 0, and prints no result, without a card
(or with fewer than the cell asks for), when the program cannot be
imported from ``src/`` of this checkout, and when, once the window has
closed, ``jax``, ``jaxlib``, ``flax``, the JAX package ``repro`` or the
old ``benchmarks`` are loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the caches of what builds or compiles, at fixed paths inside the
# checkout (the program's own kernel library builds under src/repro_torch)
CACHES = {"TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(modules):
    """Top-level names among ``modules`` (compared whole: ``repro_torch``
    is not ``repro``) that the benchmark's process must not hold."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "bench" / ".cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    marks = {"import_torch": time.perf_counter()}

    from bench.harness.manifest import Manifest

    mf = Manifest(ROOT / "BENCHMARK.json")
    cell = mf.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"repro_torch comes from {repro_torch.__file__}, not from "
              f"{ROOT / 'src'}", file=sys.stderr)
        return 2
    torch.cuda.init()
    marks["cuda_init"] = time.perf_counter()

    from bench.harness.runner import run_cell

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START, mf=mf, marks=marks)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"the process holds {bad} after the window", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
