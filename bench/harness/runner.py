"""One run of one cell: set-up, the measured window, the comparison, and
the result line.

The order is fixed. Set-up (imports, the card, the kernel library, the
weights, the system's build and the warm-up of every shape the cell's
traffic uses) ends at the first timed request, and ``setup_s`` runs from
process start to there. The window follows, traced or not. Then the peak
memory is read, the system's state is freed, and only then does the
reference run and the comparison decide ``correct``.

Nothing here knows a network, a mix or a metric: the configuration's
reference module, the mix's driver and system, and each metric's reader
are found by name (``manifest.py``).
"""
from __future__ import annotations

import gc
import subprocess
import time
from dataclasses import dataclass, field

import torch

from bench.harness import counts, manifest
from bench.harness.drive import Record
from bench.harness.stats import percentile
from bench.harness.trace import Tracer

TRACE_SECONDS = 3.0  # a traced window is at most this long


@dataclass
class Run:
    """What a metric's ``read(run)`` sees of one run. ``record`` is the
    untraced window: the whole window of a ``--trace 0`` run, and the
    first of a ``--trace 1`` run's two, which host-clock metrics and
    program counters read (the profiler slows the host). ``traced`` is
    the window the profiler watched and ``trace`` its summary, which the
    device metrics read. ``ref`` is the configuration's reference module,
    ``peaks`` the chip's (``counts.PEAKS``), or None off a known chip."""
    cell: dict
    config: dict
    mix: dict
    ref: object
    setup_s: float
    record: Record
    counters: dict = field(default_factory=dict)
    traced: Record | None = None
    trace: object = None  # TraceSummary, or None
    peaks: dict | None = None


def _device_name(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def power_limit_w():
    """The card's power limit by ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _metrics(mf, cell, kind, run):
    out = {}
    for m in mf.metrics(cell, kind):
        value = manifest.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload, seed, seconds, trace, *, t_start, device="cuda",
             mf=None, overrides=None, system=None, marks=None):
    """The result line of one run (a dict). A ``--trace 1`` run measures
    two windows of ``min(seconds, TRACE_SECONDS)``: the first untraced,
    the second under the profiler. ``overrides`` changes the
    configuration's and the mix's numbers (the CPU tests' small images);
    ``system(cfg, mix, weights, device)`` builds another system than the
    mix's (the control, and the tests' planted faults); ``marks`` holds
    ``perf_counter`` stamps of set-up steps taken before the call."""
    marks = dict(marks or {})
    mf = mf if mf is not None else manifest.Manifest()
    overrides = overrides or {}
    cell = mf.cell(workload)
    cfg = {**mf.config(cell), **overrides.get("config", {})}
    mix = {**manifest.traffic(cell["traffic"]), **overrides.get("mix", {})}
    ref = manifest.reference(cfg)
    drive = manifest.driver(mix).drive
    weights = ref.draw(cfg, seed, device)
    inputs = ref.inputs(cfg, mix["pool"], seed)
    marks["weights"] = time.perf_counter()
    build = system or manifest.system(mix).build
    sut = build(cfg, mix, weights, device)
    marks["program"] = time.perf_counter()
    sut.warm(inputs)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    marks["warm"] = time.perf_counter()
    setup_s = marks["warm"] - t_start

    window = min(seconds, TRACE_SECONDS) if trace else seconds
    record = drive(sut, inputs, mix, window, seed, Tracer(False))
    counters = sut.counters()
    traced, tracer = None, Tracer(trace)
    if trace:
        tracer.start()
        traced = drive(sut, inputs, mix, window, seed, tracer)
        tracer.stop()

    kind = _device_name(device)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": 0}
    if on_card:
        torch.cuda.synchronize(device)
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    sut.close()
    del sut
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_trace = time.perf_counter()
    summary = tracer.summary()
    t_trace = time.perf_counter() - t_trace

    records = [record] + ([traced] if traced else [])
    over, checks = ref.judge(weights, cfg, inputs,
                             [a for r in records for a in r.answers], device)
    failed = over + sum(len(r.errors) + r.missing for r in records)
    checks["failed_answers"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    run = Run(cell=cell, config=cfg, mix=mix, ref=ref, setup_s=setup_s,
              record=record, counters=counters, traced=traced,
              trace=summary, peaks=counts.PEAKS.get(kind))
    metrics = _metrics(mf, cell, "per_layer" if trace else "end_to_end",
                       run)
    result = {"correct": correct,
              "attempted": sum(r.attempted for r in records),
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops,
                               "idle_gaps": summary.idle_gaps}

    def ms(values, q):
        v = percentile(values, q)
        return None if v is None else v * 1e3

    lat = record.latencies_s
    steps = sorted(marks.items(), key=lambda kv: kv[1])
    result["info"] = {
        "seed": seed, "window_s": record.window_s,
        "completed": record.completed, "errors": record.errors[:3],
        "missing": record.missing, "setup_s": setup_s,
        "setup_split_s": {name: t - prev for (name, t), prev in zip(
            steps, [t_start] + [t for _, t in steps[:-1]])},
        "trace_read_s": t_trace if trace else None,
        "latency_p50_ms": ms(lat, 50), "latency_p95_ms": ms(lat, 95),
        "latency_max_ms": ms(lat, 100),
        "counters": {k: {str(b): n for b, n in v.items()}
                     if isinstance(v, dict) else v
                     for k, v in counters.items()},
        "power_limit_w": power_limit_w() if on_card else None,
    }
    result["checks"] = checks
    return result
