#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``src/repro_torch/_build/``), then, printing one JSON object per line:

1. environment: the card's name and power limit, torch, nvcc, build time;
2. kernel phase: each kernel at every shape class that the three main
   paths below launch (plus the 1x1 fused block ResNet-50 uses and a
   depthwise conv with channel multiplier 2), in fp32 and bf16, with
   non-zero folded-BN scales and biases, held against its plain PyTorch
   version on the same inputs within ``tolerance(dtype)``, with CUDA-event
   times of the kernel, the plain version and one PyTorch library call,
   and the least time the card could take for the same work;
3. engine phases, each on 4 numpy-seeded images through ``run`` and
   ``run_batch``, with the launch counters set to 0 just before and read
   just after: logits against the same engine and plan on the CPU,
   ``run_batch`` bitwise equal to ``run``, and the kernel launches per
   image:
   - ``InferenceEngine(get("resnet18"))`` at full width (224x224, fp32,
     tuned, random weights from seed 0): ilpm_conv 9, pointwise_conv 3,
     fused_residual_conv 8;
   - ``InferenceEngine(get("mobilenet_v2"))`` at full width (224x224, fp32,
     random weights from seed 0, folded-BN scales from U(0.5, 1.5) and
     biases from N(0, 0.1)), tuned: ilpm_conv 1, fused_inverted_residual
     17, pointwise_conv 1;
   - the same network on the per-layer plan (the tuned plan with its
     blocks stripped): ilpm_conv 1, depthwise_conv 17, pointwise_conv 34;
     its logits against the tuned engine's on the card;
4. a ``kernels`` line with each kernel's launches, error and times summed
   over one image of each path it runs on;
5. the card's name and power limit as ``nvidia-smi`` gives them, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises: the script exits non-zero and never prints the
last line. There is no CPU path.
"""
from __future__ import annotations

import copy
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
    "depthwise_conv": ("src/repro_torch/csrc/depthwise_conv.cu",
                       "src/repro/kernels/depthwise_conv.py:61"),
    "fused_inverted_residual": (
        "src/repro_torch/csrc/fused_inverted_residual.cu",
        "src/repro/kernels/fused_block.py:133"),
}
# the plan algorithm each kernel serves
KERNEL_OF = {"ilpm": "ilpm_conv", "pointwise": "pointwise_conv",
             "depthwise": "depthwise_conv",
             "fused_residual_conv": "fused_residual_conv",
             "fused_inverted_residual": "fused_inverted_residual"}

ENGINE_IMAGES = 4
ENGINE_REL_BOUND = 1e-4  # the convolutions sum in other orders on the card
NO_LAUNCHES = dict.fromkeys(KERNEL_INFO, 0)
EXPECTED_PER_IMAGE = {
    "resnet18": {**NO_LAUNCHES, "ilpm_conv": 9, "pointwise_conv": 3,
                 "fused_residual_conv": 8},
    "mobilenet_v2": {**NO_LAUNCHES, "ilpm_conv": 1,
                     "fused_inverted_residual": 17, "pointwise_conv": 1},
    "mobilenet_v2/per_layer": {**NO_LAUNCHES, "ilpm_conv": 1,
                               "depthwise_conv": 17, "pointwise_conv": 34},
}


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


def strip_blocks(plan):
    """The per-layer plan: ``plan`` without its fused blocks."""
    plan = copy.deepcopy(plan)
    plan.block_choices.clear()
    plan.block_specs.clear()
    return plan


def shape_classes(plan):
    """Counter of (kernel, shape) -> launches per image, from a plan's
    sites; a fused block's sites run in its block. Shapes: (H, C, K, R,
    stride) for the dense and pointwise kernels, (H, C, M, R, stride) for
    depthwise, (H, Cin, mid, Cout, R, stride, residual) for the inverted
    residual; H is the input size."""
    classes = Counter()
    fused = set()
    for name, bspec in plan.block_specs.items():
        block = name[:-len(".block")]
        fused |= {f"{block}.{site}" for site, _ in bspec.conv_specs()}
        algo = plan.block_choices[name].algorithm
        require(algo in KERNEL_OF, f"block {name} fused as {algo}")
        if algo == "fused_residual_conv":
            shape = (bspec.h, bspec.cin, bspec.cout, bspec.r, 1)
        else:
            shape = (bspec.h, bspec.cin, bspec.mid, bspec.cout, bspec.r,
                     bspec.stride, bspec.residual)
        classes[(KERNEL_OF[algo], shape)] += 1
    for name, spec in plan.specs.items():
        if name in fused:
            continue
        algo = plan.choices[name].algorithm
        require(algo in KERNEL_OF, f"site {name} tuned to {algo}, which "
                                   "the port does not run yet")
        if algo == "depthwise":
            shape = (spec.h, spec.c, spec.channel_multiplier, spec.r,
                     spec.stride)
        else:
            shape = (spec.h, spec.c, spec.k, spec.r, spec.stride)
        classes[(KERNEL_OF[algo], shape)] += 1
    return classes


def _same_pads(h, r, stride):
    """SAME padding of one axis, low first: (lo, hi)."""
    pad = max((-(-h // stride) - 1) * stride + r - h, 0)
    return pad // 2, pad - pad // 2


def _cl(w):
    """HWIO filters as a channels-last OIHW tensor, as cuDNN takes them."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def kernel_setup(kernel, shape, dtype, gen):
    """The call of one shape class: the wrapper, its plain version, their
    arguments, a PyTorch library call computing the same function, the
    inputs the function must read, its operations and its shape line."""
    from repro_torch.kernels import (depthwise_conv, fused_block, ilpm_conv,
                                     pointwise_conv, ref)

    dev = "cuda"

    def randn(*dims, scale=1.0):
        return (torch.randn(*dims, device=dev, generator=gen) * scale).to(
            dtype)

    def bn(n):  # folded BN: non-zero scale and bias
        return (torch.rand(n, device=dev, generator=gen) + 0.5,
                torch.randn(n, device=dev, generator=gen) * 0.1)

    def vec(v):  # an epilogue vector broadcast over an NCHW view
        return v.to(dtype).view(1, -1, 1, 1)

    if kernel == "fused_inverted_residual":
        H, Cin, mid, Cout, R, stride, residual = shape
        x = randn(1, H, H, Cin)
        weights = {}
        if mid != Cin:
            weights["w1"] = randn(1, 1, Cin, mid, scale=Cin ** -0.5)
            weights["s1"], weights["b1"] = bn(mid)
        weights["wdw"] = randn(R, R, 1, mid, scale=1 / R)
        weights["sdw"], weights["bdw"] = bn(mid)
        weights["w2"] = randn(1, 1, mid, Cout, scale=mid ** -0.5)
        weights["s2"], weights["b2"] = bn(Cout)
        OH = -(-H // stride)
        lo, hi = _same_pads(H, R, stride)
        x_lib = x.permute(0, 3, 1, 2)
        lib = {k: _cl(v) if k[0] == "w" else vec(v)
               for k, v in weights.items()}

        def library():
            h = x_lib
            if "w1" in lib:
                h = torch.clamp(F.conv2d(h, lib["w1"]) * lib["s1"]
                                + lib["b1"], 0, 6)
            if lo == hi:
                h = F.conv2d(h, lib["wdw"], stride=stride, padding=lo,
                             groups=mid)
            else:
                h = F.conv2d(F.pad(h, (lo, hi, lo, hi)), lib["wdw"],
                             stride=stride, groups=mid)
            h = torch.clamp(h * lib["sdw"] + lib["bdw"], 0, 6)
            h = F.conv2d(h, lib["w2"]) * lib["s2"] + lib["b2"]
            return h + x_lib if residual else h
        flops = 2 * (H * H * Cin * mid * ("w1" in weights)
                     + OH * OH * mid * (R * R + Cout))
        return dict(
            fn=fused_block.fused_inverted_residual,
            plain=fused_block.plain_inverted_residual,
            args=(x, weights), kw=dict(stride=stride, residual=residual),
            library=library, inputs=[x, *weights.values()], flops=flops,
            shape={"H": H, "Cin": Cin, "mid": mid, "Cout": Cout, "R": R,
                   "stride": stride, "residual": residual})
    if kernel == "depthwise_conv":
        H, C, M, R, stride = shape
        x = randn(1, H, H, C)
        w = randn(R, R, 1, M * C, scale=1 / R)
        scale, bias = bn(M * C)
        xp = ref.pad_same(x, R, R, stride)
        x_lib, w_lib = xp.permute(0, 3, 1, 2), _cl(w)

        def library():
            return F.conv2d(x_lib, w_lib, stride=stride, groups=C)
        Ho = -(-H // stride)
        return dict(
            fn=depthwise_conv.depthwise_conv, plain=depthwise_conv.plain,
            args=(xp, w),
            kw=dict(stride=stride, scale=scale, bias=bias, act="relu6"),
            library=library, inputs=[xp, w, scale, bias],
            flops=2 * Ho * Ho * R * R * M * C,
            shape={"H": H, "C": C, "M": M, "R": R, "stride": stride})
    H, C, K, R, stride = shape
    x = randn(1, H, H, C)
    w = randn(R, R, C, K, scale=(R * R * C) ** -0.5)
    scale, bias = bn(K)
    Ho = -(-H // stride)
    line = dict(flops=2 * Ho * Ho * R * R * C * K,
                shape={"H": H, "C": C, "K": K, "R": R, "stride": stride})
    if kernel == "pointwise_conv":
        w_mat = w[0, 0]

        def library():
            return torch.matmul(x[:, ::stride, ::stride, :], w_mat)
        return dict(line, fn=pointwise_conv.pointwise_conv,
                    plain=pointwise_conv.plain, args=(x, w),
                    kw=dict(stride=stride, scale=scale, bias=bias),
                    library=library,
                    inputs=[x[:, ::stride, ::stride, :], w, scale, bias])
    xp = ref.pad_same(x, R, R, stride)
    x_lib, w_lib = xp.permute(0, 3, 1, 2), _cl(w)
    if kernel == "ilpm_conv":
        def library():
            return F.conv2d(x_lib, w_lib, stride=stride)
        return dict(line, fn=ilpm_conv.ilpm_conv, plain=ilpm_conv.plain,
                    args=(xp, w),
                    kw=dict(stride=stride, scale=scale, bias=bias,
                            act="relu"),
                    library=library, inputs=[xp, w, scale, bias])
    res = randn(1, H, H, K)
    res_lib = res.permute(0, 3, 1, 2)

    def library():
        return torch.relu(F.conv2d(x_lib, w_lib) + res_lib)
    return dict(line, fn=fused_block.fused_residual_conv,
                plain=fused_block.plain,
                args=(xp, {"w": w, "scale": scale, "bias": bias}),
                kw=dict(res=res, act="relu"), library=library,
                inputs=[xp, w, scale, bias, res])


def kernel_case(kernel, shape, dtype, gen, peaks):
    """Run one shape class of one kernel; return its result line."""
    from repro_torch.core.dtypes import tolerance

    case = kernel_setup(kernel, shape, dtype, gen)
    fn, plain, args, kw = case["fn"], case["plain"], case["args"], case["kw"]
    y = fn(*args, **kw)
    torch.cuda.synchronize()
    p = plain(*args, **kw)
    err = (y.float() - p.float()).abs().max().item()
    rel = err / p.float().abs().max().item()
    nbytes = sum(t.numel() * t.element_size() for t in case["inputs"]) \
        + y.numel() * y.element_size()
    name = "float32" if dtype == torch.float32 else "bfloat16"
    t_ops = case["flops"] / peaks[name]
    t_bytes = nbytes / peaks["mem_bw"]
    kernel_ms = time_ms(lambda: fn(*args, **kw))
    line = {
        "phase": "kernel", "kernel": kernel, "dtype": name,
        "shape": {**case["shape"], "out": list(y.shape)},
        "max_rel_err": rel, "tol": tolerance(name), "max_abs_err": err,
        "kernel_ms": kernel_ms,
        "call_ms": call_ms(lambda: fn(*args, **kw)),
        "plain_ms": time_ms(lambda: plain(*args, **kw), samples=5, inner=3),
        "library_ms": time_ms(case["library"]),
        "flops": case["flops"], "bytes": nbytes,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    line["frac_of_bound"] = line["bound_ms"] / kernel_ms
    return line


def perturb_bn(params, seed):
    """Folded-BN vectors drawn anew from a numpy seed, in sorted-key
    order: every ``scale`` from U(0.5, 1.5), every ``bias`` from
    N(0, 0.1); other leaves kept. With the default ones and zeros a kernel
    that padded before the activation instead of after it would go
    unseen."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def draw(tree):
        out = {}
        for key in sorted(tree):
            v = tree[key]
            if isinstance(v, dict):
                out[key] = draw(v)
            elif key in ("scale", "bias"):
                a = rng.uniform(0.5, 1.5, tuple(v.shape)) if key == "scale" \
                    else rng.normal(0.0, 0.1, tuple(v.shape))
                out[key] = torch.from_numpy(a.astype(np.float32))
            else:
                out[key] = v
        return out
    return draw(params)


def engine_phase(path, engine, images, counters):
    """Drive one engine on ``images`` through ``run`` and ``run_batch``
    with the launch counters set to 0 just before; check the launches
    per image, the logits against the same engine and plan on the CPU,
    and ``run_batch`` against ``run``. Returns (line, logits)."""
    from repro_torch.core import InferenceEngine

    cfg = engine.cfg
    require(engine.device.type == "cuda", f"{path}: engine on "
                                          f"{engine.device}")
    for fn in counters.values():
        fn.launches = 0
    singles = torch.stack([engine.run(im) for im in images])
    batched = engine.run_batch(images)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    runs = 2 * len(images)
    per_image = {name: n / runs for name, n in launches.items()}
    require(per_image == EXPECTED_PER_IMAGE[path],
            f"{path}: launches per image {per_image}, want "
            f"{EXPECTED_PER_IMAGE[path]}")
    require(tuple(singles.shape) == (len(images), cfg.vocab_size)
            and bool(torch.isfinite(singles).all()),
            f"{path}: bad logits: shape {tuple(singles.shape)}")
    bitwise = torch.equal(singles, batched)
    require(bitwise, f"{path}: run_batch is not bitwise equal to run")
    cpu = InferenceEngine(cfg, params={k: v.cpu() for k, v in
                                       engine.model.state_dict().items()},
                          plan=engine.plan, device="cpu")
    ref_logits = cpu.run_batch(images)
    engine_rel = ((singles.cpu() - ref_logits).abs().max()
                  / ref_logits.abs().max()).item()
    require(engine_rel <= ENGINE_REL_BOUND,
            f"{path}: cuda logits vs cpu: {engine_rel} > "
            f"{ENGINE_REL_BOUND}")
    times = []
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(images[i % len(images)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    plan = engine.plan
    return {"phase": "engine", "path": path, "config": cfg.name,
            "img": cfg.extra["img"], "dtype": cfg.dtype,
            "images": len(images),
            "plan": sorted(Counter(plan.algorithms().values()).items()),
            "fused_blocks": len(plan.block_choices),
            "launches": launches, "launches_per_image": per_image,
            "max_rel_err_vs_cpu": engine_rel, "bound": ENGINE_REL_BOUND,
            "run_batch_bitwise_equal_run": bitwise,
            "ms_per_image_median": statistics.median(times)}, singles


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.core import InferenceEngine, autotune
    from repro_torch.kernels import _build
    from repro_torch.kernels import (depthwise_conv, fused_block, ilpm_conv,
                                     pointwise_conv)
    from repro_torch.models import mobilenet, resnet
    from repro_torch.models.spec import init_params

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

    # ---- the three main paths' plans -----------------------------------
    rcfg, mcfg = get("resnet18"), get("mobilenet_v2")
    rplan = autotune.build_plan(resnet.conv_specs(rcfg), epilogue=True,
                                block_specs=resnet.block_specs(rcfg))
    mplan = autotune.build_plan(mobilenet.conv_specs(mcfg), epilogue=True,
                                block_specs=mobilenet.block_specs(mcfg))
    plans = {"resnet18": rplan, "mobilenet_v2": mplan,
             "mobilenet_v2/per_layer": strip_blocks(mplan)}

    # ---- kernel phase --------------------------------------------------
    per_path = {}  # (kernel, shape) -> {path: launches per image}
    for path, plan in plans.items():
        for key, n in shape_classes(plan).items():
            per_path.setdefault(key, {})[path] = n
    # no launch on the main paths: the 1x1 fused block of a ResNet-50
    # stage-0 bottleneck, and a depthwise conv with channel multiplier 2
    per_path.setdefault(("fused_residual_conv", (56, 64, 256, 1, 1)), {})
    per_path.setdefault(("depthwise_conv", (14, 32, 2, 3, 2)), {})
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for (kernel, shape), paths in sorted(per_path.items(),
                                         key=lambda kv: repr(kv[0])):
        for dtype in (torch.float32, torch.bfloat16):
            line = kernel_case(kernel, shape, dtype, gen, peaks)
            line["launches_per_image"] = dict(paths)
            emit(line)
            results.append(line)
    bad = [(r["kernel"], r["dtype"], r["shape"]) for r in results
           if not r["max_rel_err"] <= r["tol"]]
    require(not bad, f"kernels disagree with their plain versions: {bad}")

    # ---- engine phases: the port's main paths --------------------------
    counters = {"ilpm_conv": ilpm_conv.ilpm_conv,
                "pointwise_conv": pointwise_conv.pointwise_conv,
                "fused_residual_conv": fused_block.fused_residual_conv,
                "depthwise_conv": depthwise_conv.depthwise_conv,
                "fused_inverted_residual":
                    fused_block.fused_inverted_residual}
    images = np.random.default_rng(0).standard_normal(
        (ENGINE_IMAGES, 224, 224, 3)).astype(np.float32)
    launches = {}
    line, _ = engine_phase("resnet18", InferenceEngine(rcfg, seed=0),
                           images, counters)
    launches["resnet18"] = line["launches"]
    emit(line)
    mparams = perturb_bn(init_params(mobilenet.model_specs(mcfg), 0,
                                     mcfg.param_dtype), seed=0)
    tuned = InferenceEngine(mcfg, params=mparams)
    require(tuned.plan.to_json() == mplan.to_json(), "mobilenet_v2: plan")
    logits = {}
    for path, engine in (
            ("mobilenet_v2", tuned),
            ("mobilenet_v2/per_layer",
             InferenceEngine(mcfg, params=mparams,
                             plan=plans["mobilenet_v2/per_layer"]))):
        line, logits[path] = engine_phase(path, engine, images, counters)
        launches[path] = line["launches"]
        if path == "mobilenet_v2/per_layer":
            a, b = logits["mobilenet_v2"], logits[path]
            line["vs_tuned_max_rel_err"] = (
                (a - b).abs().max() / a.abs().max()).item()
            line["vs_tuned_bitwise_equal"] = torch.equal(a, b)
            require(line["vs_tuned_max_rel_err"] <= ENGINE_REL_BOUND,
                    f"tuned vs per-layer logits on the card: "
                    f"{line['vs_tuned_max_rel_err']}")
        emit(line)

    # ---- summary: each kernel over one image of each path (fp32) -------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = [r for r in results if r["kernel"] == name]
        fp32 = [r for r in rows if r["dtype"] == "float32"]

        def per_image_sum(key, rows=fp32):
            return sum(r[key] * n for r in rows
                       for n in r["launches_per_image"].values())
        t_ops = per_image_sum("flops") / peaks["float32"]
        t_bytes = per_image_sum("bytes") / peaks["mem_bw"]
        by_path = {path: n[name] for path, n in launches.items() if n[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_per_image": {
                path: n / (2 * ENGINE_IMAGES) for path, n in by_path.items()},
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
