#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``src/repro_torch/_build/``), then, printing one JSON object per line:

1. environment: the card's name and power limit, torch, nvcc, build time;
2. kernel phase: each kernel at every shape class the tuned ResNet-18 plan
   launches (plus the 1x1 fused block ResNet-50 uses), in fp32 and bf16,
   held against its plain PyTorch version on the same inputs within
   ``tolerance(dtype)``, with CUDA-event times of the kernel, the plain
   version and one PyTorch library call, and the least time the card
   could take for the same work;
3. engine phase: ``InferenceEngine(get("resnet18"))`` at full width
   (224x224, fp32, tuned, random weights from seed 0) on 4 images through
   ``run`` and ``run_batch``: logits against the same engine on the CPU,
   ``run_batch`` bitwise equal to ``run``, and the kernel launches per
   image (ilpm_conv 9, pointwise_conv 3, fused_residual_conv 8);
4. a ``kernels`` line summing each kernel over one image's launches;
5. the card's name and power limit as ``nvidia-smi`` gives them, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises: the script exits non-zero and never prints the
last line. There is no CPU path.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# Data-sheet peaks (NVIDIA, dense, at the full power limit), by a
# substring of torch.cuda.get_device_name(): fp32 outside the tensor
# cores, bf16 on the tensor cores, device-memory bandwidth.
CARD_PEAKS = {
    "H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                       "mem_bw": 3.35e12},  # H100 SXM
}

KERNEL_INFO = {
    "ilpm_conv": ("src/repro_torch/csrc/ilpm_conv.cu",
                  "src/repro/kernels/ilpm_conv.py:59"),
    "pointwise_conv": ("src/repro_torch/csrc/pointwise_conv.cu",
                       "src/repro/kernels/pointwise_conv.py:51"),
    "fused_residual_conv": ("src/repro_torch/csrc/fused_residual_conv.cu",
                            "src/repro/kernels/fused_block.py:234"),
}

ENGINE_IMAGES = 4
ENGINE_REL_BOUND = 1e-4  # 20 convolutions sum in other orders on the card
EXPECTED_PER_IMAGE = {"ilpm_conv": 9, "pointwise_conv": 3,
                      "fused_residual_conv": 8}


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _median_event_ms(step, samples, inner):
    """Median over samples of one ``step()``'s CUDA-event time / inner."""
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / inner)
    return statistics.median(out)


def time_ms(fn, samples=15, inner=10):
    """Device time of one ``fn()``: ``inner`` calls captured in a CUDA
    graph after a warm-up, the graph replayed and timed with CUDA events,
    the median over samples. The graph removes the host's launch cost,
    which at these sizes is as large as the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    return _median_event_ms(graph.replay, samples, inner)


def call_ms(fn, samples=15, inner=10):
    """Time of one eager ``fn()`` call back to back with the next: the
    host's launch cost and the device time, whichever is longer."""
    fn()

    def step():
        for _ in range(inner):
            fn()
    return _median_event_ms(step, samples, inner)


def shape_classes(plan):
    """Counter of (kernel, H, C, K, R, stride) -> launches per image, from
    the tuned plan's sites (a fused block's last conv runs in its block)."""
    classes = Counter()
    fused_tails = {name[:-len(".block")] + ".c2"
                   for name in plan.block_choices}
    kernel_of = {"ilpm": "ilpm_conv", "pointwise": "pointwise_conv"}
    for name, spec in plan.specs.items():
        if name in fused_tails:
            continue
        algo = plan.choices[name].algorithm
        require(algo in kernel_of, f"site {name} tuned to {algo}, which "
                                   "this slice does not port")
        classes[(kernel_of[algo], spec.h, spec.c, spec.k, spec.r,
                 spec.stride)] += 1
    for name, bspec in plan.block_specs.items():
        require(plan.block_choices[name].algorithm == "fused_residual_conv",
                f"block {name} fused as {plan.block_choices[name]}")
        classes[("fused_residual_conv", bspec.h, bspec.cin, bspec.cout,
                 bspec.r, 1)] += 1
    return classes


def kernel_case(mods, kernel, H, C, K, R, stride, dtype, gen, peaks):
    """Run one shape class of one kernel; return its result line."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import ref

    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(
            dtype)

    x = randn(1, H, H, C)
    w = randn(R, R, C, K, scale=(R * R * C) ** -0.5)
    scale = torch.rand(K, device=dev, generator=gen) + 0.5
    bias = torch.randn(K, device=dev, generator=gen) * 0.1
    if kernel == "pointwise_conv":
        mod = mods["pointwise_conv"]
        args, kw = (x, w), dict(stride=stride, scale=scale, bias=bias)
        w_mat = w[0, 0]
        x_read = x[:, ::stride, ::stride, :]

        def library():
            return torch.matmul(x[:, ::stride, ::stride, :], w_mat)
        inputs = [x_read, w, scale, bias]
    else:
        xp = ref.pad_same(x, R, R, stride)
        x_lib = xp.permute(0, 3, 1, 2)  # a channels-last NCHW view
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        if kernel == "ilpm_conv":
            mod = mods["ilpm_conv"]
            args = (xp, w)
            kw = dict(stride=stride, scale=scale, bias=bias, act="relu")

            def library():
                return F.conv2d(x_lib, w_lib, stride=stride)
            inputs = [xp, w, scale, bias]
        else:
            mod = mods["fused_residual_conv"]
            res = randn(1, H, H, K)
            res_lib = res.permute(0, 3, 1, 2)
            args = (xp, {"w": w, "scale": scale, "bias": bias})
            kw = dict(res=res, act="relu")

            def library():
                return torch.relu(F.conv2d(x_lib, w_lib) + res_lib)
            inputs = [xp, w, scale, bias, res]
    fn = getattr(mod, kernel)
    y = fn(*args, **kw)
    torch.cuda.synchronize()
    p = mod.plain(*args, **kw)
    err = (y.float() - p.float()).abs().max().item()
    rel = err / p.float().abs().max().item()
    Ho = y.shape[1]
    flops = 2 * Ho * y.shape[2] * R * R * C * K
    nbytes = sum(t.numel() * t.element_size() for t in inputs) \
        + y.numel() * y.element_size()
    name = "float32" if dtype == torch.float32 else "bfloat16"
    t_ops = flops / peaks[name]
    t_bytes = nbytes / peaks["mem_bw"]
    kernel_ms = time_ms(lambda: fn(*args, **kw))
    line = {
        "phase": "kernel", "kernel": kernel, "dtype": name,
        "shape": {"H": H, "C": C, "K": K, "R": R, "stride": stride,
                  "out": list(y.shape)},
        "max_rel_err": rel, "tol": tolerance(name), "max_abs_err": err,
        "kernel_ms": kernel_ms,
        "call_ms": call_ms(lambda: fn(*args, **kw)),
        "plain_ms": time_ms(lambda: mod.plain(*args, **kw),
                            samples=5, inner=3),
        "library_ms": time_ms(library),
        "flops": flops, "bytes": nbytes,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    line["frac_of_bound"] = line["bound_ms"] / kernel_ms
    return line


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.core import InferenceEngine, autotune
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_block, ilpm_conv, pointwise_conv
    from repro_torch.models import resnet

    # fp32 means IEEE fp32 in every reference and library call
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in CARD_PEAKS.items() if k in card), None)
    require(peaks is not None, f"no data-sheet peaks for card {card!r}")
    nvcc_version = subprocess.run(
        [_build.nvcc(), "--version"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[-1]
    lib_path, build_s = _build.build()
    _build.library()
    emit({"phase": "environment", "nvidia_smi": smi, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_version, "build_s": build_s,
          "library": str(lib_path.relative_to(ROOT))})

    # ---- kernel phase -------------------------------------------------
    mods = {"ilpm_conv": ilpm_conv, "pointwise_conv": pointwise_conv,
            "fused_residual_conv": fused_block}
    cfg = get("resnet18")
    plan = autotune.build_plan(resnet.conv_specs(cfg), epilogue=True,
                               block_specs=resnet.block_specs(cfg))
    classes = shape_classes(plan)
    # the 1x1 fused block of a ResNet-50 stage-0 bottleneck (no launch on
    # the ResNet-18 path)
    classes[("fused_residual_conv", 56, 64, 256, 1, 1)] += 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for (kernel, H, C, K, R, stride), per_image in sorted(classes.items()):
        for dtype in (torch.float32, torch.bfloat16):
            line = kernel_case(mods, kernel, H, C, K, R, stride,
                               dtype, gen, peaks)
            line["launches_per_image"] = per_image
            emit(line)
            results.append(line)
    bad = [(r["kernel"], r["dtype"], r["shape"]) for r in results
           if not r["max_rel_err"] <= r["tol"]]
    require(not bad, f"kernels disagree with their plain versions: {bad}")

    # ---- engine phase: the port's main path ---------------------------
    engine = InferenceEngine(cfg, seed=0)
    require(engine.device.type == "cuda", f"engine on {engine.device}")
    images = np.random.default_rng(0).standard_normal(
        (ENGINE_IMAGES, 224, 224, 3)).astype(np.float32)
    counters = {name: getattr(mods[name], name) for name in KERNEL_INFO}
    for fn in counters.values():
        fn.launches = 0
    singles = torch.stack([engine.run(im) for im in images])
    batched = engine.run_batch(images)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    runs = 2 * ENGINE_IMAGES
    per_image = {name: n / runs for name, n in launches.items()}
    require(per_image == EXPECTED_PER_IMAGE,
            f"launches per image {per_image}, want {EXPECTED_PER_IMAGE}")
    require(tuple(singles.shape) == (ENGINE_IMAGES, cfg.vocab_size)
            and bool(torch.isfinite(singles).all()),
            f"bad logits: shape {tuple(singles.shape)}")
    bitwise = torch.equal(singles, batched)
    require(bitwise, "run_batch is not bitwise equal to run")
    cpu = InferenceEngine(cfg, params={k: v.cpu() for k, v in
                                       engine.model.state_dict().items()},
                          plan=plan, device="cpu")
    ref_logits = cpu.run_batch(images)
    engine_rel = ((singles.cpu() - ref_logits).abs().max()
                  / ref_logits.abs().max()).item()
    require(engine_rel <= ENGINE_REL_BOUND,
            f"cuda logits vs cpu: {engine_rel} > {ENGINE_REL_BOUND}")
    times = []
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(images[i % ENGINE_IMAGES])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "engine", "config": cfg.name, "img": 224,
          "dtype": cfg.dtype, "images": ENGINE_IMAGES,
          "plan": sorted(Counter(plan.algorithms().values()).items()),
          "fused_blocks": len(plan.block_choices),
          "launches": launches, "launches_per_image": per_image,
          "max_rel_err_vs_cpu": engine_rel, "bound": ENGINE_REL_BOUND,
          "run_batch_bitwise_equal_run": bitwise,
          "ms_per_image_median": statistics.median(times)})

    # ---- summary: each kernel over one image's launches (fp32) --------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = [r for r in results if r["kernel"] == name]
        fp32 = [r for r in rows if r["dtype"] == "float32"]

        def per_image_sum(key, rows=fp32):
            return sum(r[key] * r["launches_per_image"] for r in rows)
        t_ops = sum(r["flops"] * r["launches_per_image"]
                    for r in fp32) / peaks["float32"]
        t_bytes = sum(r["bytes"] * r["launches_per_image"]
                      for r in fp32) / peaks["mem_bw"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "parity": "ok", "max_abs_err": max(r["max_abs_err"]
                                               for r in rows),
            "ms": per_image_sum("kernel_ms"),
            "plain_ms": per_image_sum("plain_ms"),
            "bound_ms": per_image_sum("bound_ms"),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": per_image_sum("library_ms")})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
