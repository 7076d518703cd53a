#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``src/repro_torch/_build/``), then, printing one JSON object per line:

1. environment: the card's name and power limit, torch, nvcc, build time;
   then the ``launch_floor`` line: one one-CTA PyTorch op on 16 bytes
   timed as the kernels are (graph replay), a yardstick of the least a
   launch costs, on no path (``gemm_sweep.py unroll`` adds its profiler
   device time);
2. kernel phase: each kernel at every shape class that the engine paths
   below launch (plus the 1x1 fused block ResNet-50 uses and a depthwise
   conv with channel multiplier 2), in fp32 and bf16, with non-zero
   folded-BN scales and biases, held against its plain PyTorch version on
   the same inputs within ``tolerance(dtype)`` (the im2col unroll, a copy,
   the Winograd input transform, add/sub in the plain version's order and
   rounding, and the Winograd output transform, Aᵀ m A in fp32 with its
   epilogue rounded once, bitwise: ``bitwise_equal``, required), with
   CUDA-event times of
   the kernel, the plain version and
   one PyTorch library call, and the least time the card could take for
   the same work; Winograd's classes are its input transform, its 16
   products in one batched ``gemm`` (bf16 V against fp32 U, as the forced
   path has it) and its output transform at 56²×64, 28²×128, 14²×256;
   then ``gemm`` in fp16 at each of its classes (the tensor cores; at
   Winograd's, fp16 V against an fp16 plan's cached U) and at two ragged
   products no path launches (197×2305 @ 2305×129 in fp32, M, Kc and N
   multiples of no tile; 197×2304 @ 2304×256 in bf16, M ragged on the
   tensor cores); then ``pointwise_conv`` and ``libdnn_conv``, which run
   on ``gemm``'s split-K tile, ``ilpm_conv`` and ``fused_residual_conv``,
   which run on the halo-resident conv tile, ``direct_conv`` and
   ``fused_inverted_residual``, split kernels of their own, and
   ``depthwise_conv``, in fp16 at each of their classes and at one ragged
   class each that no path launches (a 15x17 image, C = 12, K = 20,
   stride 2; a 9x11 image, C = 6, K = 20, 3x3; a 13x10 image, C = 12, K =
   20, 3x3 stride 2, for ilpm and for direct; an 11x9 image, C = 12, K =
   20, 3x3; an 11x9 image, Cin 12, mid 36, Cout 12, stride 1 with the
   identity add; an 11x9 image, C = 12, 3x3 depthwise, stride 1) in fp32
   and bf16; each line of these eight carries its launch plan (path,
   tile, split, CTAs; the conv tile's also its chunk and filter-row
   split; direct's its chunk, contraction slices and pixel tiles; the
   inverted residual's its tile and parts of the mid width; depthwise's
   tile, channels, threads, shared memory and which kernel: 3x3 or
   generic); then the two gathers, ``im2col_unroll`` and
   ``winograd_input_transform``, and ``winograd_output_transform``, in
   fp16 at each of their classes and at one ragged class each in fp32 and
   bf16 (a 9x11 image, C = 6, 3x3; a 10x14 image, C = 12; a 10x14 image, K
   = 10), each im2col line with its launch plan (pixels a CTA, channels,
   shared memory, CTAs), each output-transform line with its (tiles a CTA,
   channels, unit bytes, threads, CTAs).
   Each fp32
   ``fused_inverted_residual`` line is also held, bitwise
   (``vs_per_layer_bitwise_equal``), against the per-layer chain of
   ported kernels on the same inputs: pointwise -> SAME pad -> depthwise
   -> pointwise (+ x);
3. a ``comparison`` line: the paper's algorithm comparison re-run on this
   card at its four ResNet layers (``PAPER_CONV_LAYERS``), fp32, with the
   folded-BN epilogue and ReLU: the device time of ilpm, direct and
   libdnn (one kernel each), im2col as its path runs it (unroll, gemm,
   epilogue pass), winograd as its path runs it with U cached (input
   transform, gemm, output transform; "n/a: odd H" at 7²) and cuDNN, and
   the ratios to ilpm beside the paper's figures, which are a mobile
   GPU's (Mali);
4. engine phases, each on 4 numpy-seeded images on the card through
   ``run`` and ``run_batch`` of an engine that replays CUDA graphs, with
   the launch counters set to 0 just before and read just after. The
   counters tick when a forward is traced (one warm-up, the batch-1
   graph, the batch-4 graph: ``images_traced``), never on a replay, so
   ``launches_at_capture`` (launches per traced image) must equal the
   counts below and a second pass, all replays, must launch nothing
   (``launches_on_replay`` 0) and repeat the logits bitwise; an eager
   engine of the same plan and weights runs beside it, its launches per
   image as below and its logits bitwise the replay's
   (``replay_bitwise_equal_eager``, required). Each line also holds the
   logits against the same engine and plan on the CPU, ``run_batch``
   bitwise equal to ``run``, the graphs captured, and the host-clock ms
   per image with and without replay (``ms_per_image_replay``,
   ``ms_per_image_eager``: 20 runs each in turns, each ending in a
   synchronize, device images). The kernel launches per image:
   - ``InferenceEngine(get("resnet18"))`` at full width (224x224, fp32,
     tuned, random weights from seed 0): ilpm_conv 9, pointwise_conv 3,
     fused_residual_conv 8;
   - the same weights on the per-layer plan (the tuned plan with its
     blocks stripped, ``resnet18/per_layer``): ilpm_conv 17,
     pointwise_conv 3; its logits bitwise equal to the tuned engine's on
     the card (``vs_tuned_bitwise_equal``, required: the reference's
     fused-vs-per-layer contract at fp32);
   - ``InferenceEngine(get("mobilenet_v2"))`` at full width (224x224, fp32,
     random weights from seed 0, folded-BN scales from U(0.5, 1.5) and
     biases from N(0, 0.1)), tuned: ilpm_conv 1, fused_inverted_residual
     17, pointwise_conv 1;
   - the same network on the per-layer plan (the tuned plan with its
     blocks stripped): ilpm_conv 1, depthwise_conv 17, pointwise_conv 34;
     its logits bitwise equal to the tuned engine's on the card
     (required, as for ResNet-18);
   - ``InferenceEngine(get("resnet18"), algorithm=X)``, the reference's
     forced-algorithm entry point, on the tuned engine's weights, for X
     in direct (direct_conv 20), im2col (im2col_unroll 13, gemm 13,
     ilpm_conv 7: the strided sites), libdnn (libdnn_conv 13, ilpm_conv
     7) and winograd (winograd_input_transform 10, gemm 10,
     winograd_output_transform 10, ilpm_conv 10: the strided sites and
     the odd 7² ones, U computed per call in fp32); each also against the
     tuned engine's logits;
   - ResNet-18 on the tuned plan with its blocks stripped and the 10
     sites Winograd can run pinned to it (``resnet18/winograd_plan``: the
     three Winograd kernels 10 each, ilpm_conv 7, pointwise_conv 3), with
     the engine's U cache (10 entries), against the forced Winograd
     engine's logits;
   - the tuned ResNet-18 on int8 weights (``quant.quantize_params`` of
     the tuned engine's, scales folded into the epilogue;
     ``resnet18/int8``: 9 / 3 / 8 as the tuned path), with its top-1
     agreement and max relative logit error against the fp32 engine;
   - two storage-only precision variants on the tuned engine's weights,
     launches as the matching fp32 path's, fp32 logits:
     ``resnet18/im2col/store_bf16`` (fp32 compute over bf16 weights,
     forced im2col) within 1e-4 of the CPU engine, and
     ``resnet18/bf16/store_fp32`` (bf16 compute over fp32 weights, tuned)
     within ``tolerance("bfloat16")``, with its top-1 agreement and max
     relative logit error against the fp32 engine;
     ``resnet18/winograd/bf16`` (bf16 compute over fp32 weights, forced
     Winograd, launches as ``resnet18/winograd``) within
     ``tolerance("bfloat16")`` of the CPU engine and of the fp32 forced
     Winograd engine's logits, with its top-1 agreement against them; and
     ``mobilenet_v2/bf16/store_fp32``, the same for tuned MobileNetV2
     (launches as ``mobilenet_v2``);
5. the measured tuner: ResNet-18 at full width tuned with
   ``tune(mode="measured", noise_floor=0)`` (each candidate one graph
   replay timed with CUDA events), its algorithm counts, the sites whose
   algorithm moved from the cost-model plan, its replayed ms per image
   beside the cost-model plan's, its logits within the engine bound of
   the CPU engine on the same plan (the ``tuner`` line);
6. the serving tier (``serving`` lines): a ``Server`` on the card
   holding full-width ResNet-18 and MobileNetV2 (fp32, tuned), fed
   ragged bursts of host images across both, twice (``requests``: buckets
   1, 2 and 4 all dispatch, every answer bitwise ``engine.run`` of the
   same image on the same cached engine, ``trace_count`` at most the
   buckets run; per round, the first capturing the batch graphs: p50/p95
   latency, images/s); one threaded 30 fps stream of 30
   frames on ResNet-18 beside MobileNetV2 requests (``stream``: every
   frame and request bitwise ``run``, fps achieved, deadline-miss and
   drop rates); scripted persistent dispatch faults on a second server
   (``degraded``: the breaker trips, the ``xla_fallback_plan`` engine
   answers within the engine bound of the tuned engine's);
7. the Mamba-2 LM path (``repro_torch.launch.serve.generate``: one
   prefill, then greedy decode steps) on ``mamba2-370m`` at full width (48
   layers, random weights from seed 0):
   - ``causal_conv1d``, the kernel of its prefill, at the model's shapes
     (the xBC slice of the in-projection, read in place: rows 4384
     elements apart, C = 2304, K = 4) of both paths below and at the edge
     lengths L = 1, 2, 3, 513, in fp32 and bf16, then in fp16 at each
     (no path runs it), against its plain version
     within ``tolerance(dtype)``, with the same times as the kernel phase
     and ``F.conv1d(groups=C)`` as the library call;
   - ``mamba2_370m``, serving at the published dtype (bf16): batch 4,
     prompt 1024 (4 SSD chunks), 32 new tokens; exactly 48
     ``causal_conv1d`` launches in the prefill and none in the decode
     steps; prefill ms, decode ms per token, tokens/s, a profile of one
     prefill and one decode step, and the prefill logits against the same
     model with the conv's plain version (``impl="torch"``) on the card;
   - ``mamba2_370m/fp32``: batch 1, prompt 300 (across a chunk boundary),
     8 greedy decode steps; the logits of the prefill and of every step
     against the port on the CPU fed the same tokens;
8. the ``host_split`` line, after every timed line (a profiler session
   slows later graph replays): where one eager tuned ResNet-18 run's host
   time goes, by ``torch.profiler`` (host time inside aten ops against the
   wall, device busy ms) and by ``cProfile`` (own time by module, top
   functions);
9. a ``kernels`` line with each kernel's launches, error and times summed
   over one image (one prefill for ``causal_conv1d``) of each path it runs
   on, each class in the path's compute dtype, and per path
   (``per_path``); one ``gemm`` launch is two device kernels where its
   plan splits the contraction; the launches are those of the engine
   phases' traced forwards;
10. the card's name and power limit as ``nvidia-smi`` gives them, then
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
                       "float16": 989e12, "mem_bw": 3.35e12},  # H100 SXM
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
    "direct_conv": ("src/repro_torch/csrc/direct_conv.cu",
                    "src/repro/kernels/direct_conv.py:51"),
    "im2col_unroll": ("src/repro_torch/csrc/im2col_unroll.cu",
                      "src/repro/kernels/im2col_conv.py:31"),
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:32"),
    "libdnn_conv": ("src/repro_torch/csrc/libdnn_conv.cu",
                    "src/repro/kernels/libdnn_conv.py:43"),
    "winograd_input_transform": (
        "src/repro_torch/csrc/winograd_input_transform.cu",
        "src/repro/kernels/winograd_conv.py:55"),
    "winograd_output_transform": (
        "src/repro_torch/csrc/winograd_output_transform.cu",
        "src/repro/kernels/winograd_conv.py:97"),
    "causal_conv1d": ("src/repro_torch/csrc/causal_conv1d.cu",
                      "src/repro/kernels/causal_conv1d.py:34"),
}
# the plan algorithm each kernel serves
KERNEL_OF = {"ilpm": "ilpm_conv", "pointwise": "pointwise_conv",
             "depthwise": "depthwise_conv",
             "fused_residual_conv": "fused_residual_conv",
             "fused_inverted_residual": "fused_inverted_residual"}
# the kernels a site forced onto an algorithm launches
FORCED_KERNELS = {"ilpm": ("ilpm_conv",), "direct": ("direct_conv",),
                  "im2col": ("im2col_unroll", "gemm"),
                  "libdnn": ("libdnn_conv",),
                  "winograd": ("winograd_input_transform", "gemm",
                               "winograd_output_transform")}
FORCED = ("direct", "im2col", "libdnn", "winograd")
# Winograd's shape classes: ("winograd", H, C, K) of a 3x3/1 site
WINOGRAD_CLASSES = {("winograd", 56, 64, 64), ("winograd", 28, 128, 128),
                    ("winograd", 14, 256, 256)}
# gemm products no path launches, (M, Kc, N) -> dtype: M, Kc and N
# multiples of no tile on the CUDA-core path, and M ragged on the
# tensor-core path
RAGGED_GEMM = {("ragged", 197, 2305, 129): torch.float32,
               ("ragged", 197, 2304, 256): torch.bfloat16}
# the kernels on gemm's split-K tile (csrc/gemm_tile.cuh), on the conv
# tile (csrc/conv_tile.cuh) and the two split kernels of their own
# (direct_conv.cu, fused_inverted_residual.cu), whose lines carry their
# launch plan and which run in fp16 at every class
CONV_TILE_KERNELS = ("ilpm_conv", "fused_residual_conv")
TILE_KERNELS = ("gemm", "pointwise_conv", "libdnn_conv", *CONV_TILE_KERNELS)
PLANNED_KERNELS = (*TILE_KERNELS, "direct_conv", "fused_inverted_residual",
                   "depthwise_conv")
# classes of those kernels no path launches, (kernel, shape), in fp32 and
# bf16: H != W, C a multiple of no 16-byte run (scalar loads; in bf16 the
# CUDA cores), K of no tile; libdnn's C = 6 puts 16-byte runs across taps.
# A conv's shape is ("ragged", H, W, C, K, R, stride); the inverted
# residual's ("ragged", H, W, Cin, mid, Cout, R, stride, residual); the
# depthwise conv's ("ragged", H, W, C, M, R, stride).
RAGGED_CONV = (("pointwise_conv", ("ragged", 15, 17, 12, 20, 1, 2)),
               ("libdnn_conv", ("ragged", 9, 11, 6, 20, 3, 1)),
               ("ilpm_conv", ("ragged", 13, 10, 12, 20, 3, 2)),
               ("fused_residual_conv", ("ragged", 11, 9, 12, 20, 3, 1)),
               ("direct_conv", ("ragged", 13, 10, 12, 20, 3, 2)),
               ("fused_inverted_residual",
                ("ragged", 11, 9, 12, 36, 12, 3, 1, True)),
               ("depthwise_conv", ("ragged", 11, 9, 12, 1, 3, 1)))
# the two gathers and the Winograd output transform, which run in fp16 at
# every class and at one ragged class each in fp32 and bf16 (im2col: a 9x11
# image, C = 6, so 24- and 12-byte channel runs; the input transform: a
# 10x14 image, C = 12; the output transform: a 10x14 image, K = 10, so 40-
# and 20-byte channel runs and no 16-byte unit); each is a copy, an add/sub
# chain or (the output transform) Aᵀ m A in fp32 with its epilogue rounded
# once, in its plain version's order and rounding, so each must equal it
# bitwise; im2col's and the output transform's lines carry their launch
# plans
BITWISE_KERNELS = ("im2col_unroll", "winograd_input_transform",
                   "winograd_output_transform")
RAGGED_BITWISE = (("im2col_unroll", ("ragged", 9, 11, 6, 20, 3, 1)),
                  ("winograd_input_transform", ("ragged", 10, 14, 12)),
                  ("winograd_output_transform", ("ragged", 10, 14, 10)))
# the paper's speedups of ILP-M, measured on a mobile GPU (Mali): context
# for the comparison line, not a target
PAPER_SPEEDUP = {"im2col": 14.6, "direct": 2.30}

ENGINE_IMAGES = 4
ENGINE_TIMED_RUNS = 20
ENGINE_REL_BOUND = 1e-4  # the convolutions sum in other orders on the card
NO_LAUNCHES = dict.fromkeys(KERNEL_INFO, 0)
EXPECTED_PER_IMAGE = {
    "resnet18": {**NO_LAUNCHES, "ilpm_conv": 9, "pointwise_conv": 3,
                 "fused_residual_conv": 8},
    "resnet18/per_layer": {**NO_LAUNCHES, "ilpm_conv": 17,
                           "pointwise_conv": 3},
    "mobilenet_v2": {**NO_LAUNCHES, "ilpm_conv": 1,
                     "fused_inverted_residual": 17, "pointwise_conv": 1},
    "mobilenet_v2/per_layer": {**NO_LAUNCHES, "ilpm_conv": 1,
                               "depthwise_conv": 17, "pointwise_conv": 34},
    "resnet18/direct": {**NO_LAUNCHES, "direct_conv": 20},
    "resnet18/im2col": {**NO_LAUNCHES, "im2col_unroll": 13, "gemm": 13,
                        "ilpm_conv": 7},
    "resnet18/libdnn": {**NO_LAUNCHES, "libdnn_conv": 13, "ilpm_conv": 7},
    "resnet18/winograd": {**NO_LAUNCHES, "winograd_input_transform": 10,
                          "gemm": 10, "winograd_output_transform": 10,
                          "ilpm_conv": 10},
    "resnet18/winograd_plan": {**NO_LAUNCHES, "winograd_input_transform": 10,
                               "gemm": 10, "winograd_output_transform": 10,
                               "ilpm_conv": 7, "pointwise_conv": 3},
    "resnet18/int8": {**NO_LAUNCHES, "ilpm_conv": 9, "pointwise_conv": 3,
                      "fused_residual_conv": 8},
}
# storage-only precision variants: launches as the matching path's
EXPECTED_PER_IMAGE["resnet18/im2col/store_bf16"] = \
    EXPECTED_PER_IMAGE["resnet18/im2col"]
EXPECTED_PER_IMAGE["resnet18/bf16/store_fp32"] = EXPECTED_PER_IMAGE["resnet18"]
EXPECTED_PER_IMAGE["resnet18/winograd/bf16"] = \
    EXPECTED_PER_IMAGE["resnet18/winograd"]
EXPECTED_PER_IMAGE["mobilenet_v2/bf16/store_fp32"] = \
    EXPECTED_PER_IMAGE["mobilenet_v2"]
# the compute dtype of a path, where it is not fp32
PATH_DTYPE = {"resnet18/bf16/store_fp32": "bfloat16",
              "resnet18/winograd/bf16": "bfloat16",
              "mobilenet_v2/bf16/store_fp32": "bfloat16"}


# the serving phase: ragged bursts across both networks (buckets 1, 2
# and 4 all dispatch at max_batch 4), then one threaded stream
SERVE_NETS = ("resnet18", "mobilenet_v2")
SERVE_BURSTS = (1, 2, 3, 4, 5, 2, 1, 4)
SERVE_ROUNDS = 2
SERVE_WAIT = 60
STREAM_FPS, STREAM_FRAMES = 30.0, 30

# The Mamba-2 LM paths and their compute dtypes; causal_conv1d launches
# once per layer in a prefill and never in a decode step.
LM_CONFIG = "mamba2-370m"
LM_PATHS = {"mamba2_370m": "bfloat16", "mamba2_370m/fp32": "float32"}
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32
PARITY_PROMPT, PARITY_STEPS = 300, 8
EDGE_LENGTHS = (1, 2, 3, 513)


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


def device_us(fn, name=None, calls=20):
    """Mean device time, µs, of the kernels ``fn()`` launches whose name
    holds ``name`` (every kernel where None), from ``torch.profiler`` over
    ``calls`` eager calls: the kernel's own duration, without the launch
    gaps a graph replay's time includes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (name is None or name in e.name)]
    return sum(times) / calls if times else "not measured"


def launch_floor(device=False):
    """The launch floor of the kernel timings: one one-CTA PyTorch op on
    16 bytes (``zero_`` of 4 fp32 on the card), timed as a kernel line's
    ``kernel_ms`` (graph replay); with ``device`` also by the profiler's
    device time. A yardstick only: no path runs it. The kernel phase asks
    for no device time: with a profiler session before them, the kernel
    lines of a run read slower (PERF.md §6)."""
    t = torch.empty(4, device="cuda")
    line = {"phase": "launch_floor", "op": "zero_ of 4 fp32 (16 bytes)",
            "graph_ms": time_ms(t.zero_)}
    if device:
        line["device_us"] = device_us(t.zero_)
    return line


def strip_blocks(plan):
    """The per-layer plan: ``plan`` without its fused blocks."""
    plan = copy.deepcopy(plan)
    plan.block_choices.clear()
    plan.block_specs.clear()
    return plan


def routed(algorithm, spec):
    """The algorithm the router runs at a site asked for ``algorithm``:
    im2col, libdnn and winograd have no strided kernel, and Winograd
    F(2,3) needs a 3x3 filter and an even output; those sites run ilpm."""
    if spec.stride != 1 and algorithm in ("im2col", "libdnn", "winograd"):
        return "ilpm"
    if algorithm == "winograd" and (spec.r != 3 or spec.s != 3
                                    or spec.h % 2 or spec.w % 2):
        return "ilpm"
    return algorithm


def site_classes(algorithm, spec):
    """(kernel, shape) of each launch at one site run by ``algorithm``."""
    if algorithm == "winograd":
        return [(kernel, ("winograd", spec.h, spec.c, spec.k))
                for kernel in FORCED_KERNELS["winograd"]]
    if algorithm == "depthwise":
        return [(KERNEL_OF[algorithm], (spec.h, spec.c,
                                        spec.channel_multiplier, spec.r,
                                        spec.stride))]
    shape = (spec.h, spec.c, spec.k, spec.r, spec.stride)
    kernels = FORCED_KERNELS.get(algorithm) or (KERNEL_OF[algorithm],)
    return [(kernel, shape) for kernel in kernels]


def pin_winograd(plan, specs):
    """``plan`` without its fused blocks, every site that Winograd can run
    pinned to it."""
    from repro_torch.core import Choice

    plan = strip_blocks(plan)
    for name, spec in specs:
        if routed("winograd", spec) == "winograd":
            ch = plan.choices[name]
            plan.choices[name] = Choice("winograd", (), ch.est_time,
                                        ch.est_bytes, ch.est_flops, ch.vmem)
    return plan


def shape_classes(plan):
    """Counter of (kernel, shape) -> launches per image, from a plan's
    sites; a fused block's sites run in its block. Shapes: (H, C, K, R,
    stride) for the dense and pointwise kernels, (H, C, M, R, stride) for
    depthwise, (H, Cin, mid, Cout, R, stride, residual) for the inverted
    residual, ("winograd", H, C, K) for Winograd's three kernels; H is the
    input size."""
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
        algo = routed(plan.choices[name].algorithm, spec)
        require(algo in KERNEL_OF or algo == "winograd",
                f"site {name} tuned to {algo}, which the smoke run does "
                "not expect")
        classes.update(site_classes(algo, spec))
    return classes


def forced_classes(specs, algorithm):
    """Counter of (kernel, shape) -> launches per image of a network whose
    every conv site is forced onto ``algorithm``, each site run where the
    router sends it (``routed``). Shapes as in ``shape_classes``."""
    classes = Counter()
    for _, spec in specs:
        classes.update(site_classes(routed(algorithm, spec), spec))
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
    from repro_torch.kernels import (causal_conv1d, depthwise_conv,
                                     direct_conv, fused_block, gemm,
                                     ilpm_conv, im2col_conv, libdnn_conv,
                                     pointwise_conv, ref, winograd_conv)

    dev = "cuda"

    def randn(*dims, scale=1.0):
        return (torch.randn(*dims, device=dev, generator=gen) * scale).to(
            dtype)

    if kernel == "causal_conv1d":
        B, L, C, K, row, lo = shape
        # the xBC slice of a wider in-projection output, as the model
        # passes it: rows `row` elements apart
        x = randn(B, L, row)[..., lo:lo + C]
        w = randn(K, C, scale=K ** -0.5)
        b = randn(C, scale=0.1)
        w_lib = w.t()[:, None]

        def library():
            return F.conv1d(x.transpose(1, 2), w_lib, b, padding=K - 1,
                            groups=C)[..., :L]
        # K multiplies and K adds (the bias's included) per output
        return dict(fn=causal_conv1d.causal_conv1d, plain=causal_conv1d.plain,
                    args=(x, w, b), kw={}, library=library,
                    inputs=[x, w, b], flops=2 * K * B * L * C,
                    shape={"B": B, "L": L, "C": C, "K": K, "row_stride": row})

    def bn(n):  # folded BN: non-zero scale and bias
        return (torch.rand(n, device=dev, generator=gen) + 0.5,
                torch.randn(n, device=dev, generator=gen) * 0.1)

    def vec(v):  # an epilogue vector broadcast over an NCHW view
        return v.to(dtype).view(1, -1, 1, 1)

    if kernel == "winograd_input_transform":
        if shape[0] == "ragged":  # ("ragged", H, W, C)
            _, H, W, C = shape
            desc = {"algorithm": "ragged", "H": H, "W": W, "C": C}
        else:
            _, H, C, K = shape
            W, desc = H, {"algorithm": "winograd", "H": H, "C": C, "K": K}
        th, tw = H // 2, W // 2
        nt = th * tw
        line = {"shape": {**desc, "tiles": nt}}
        xp = ref.pad_same(randn(1, H, W, C), 3, 3)
        bt = ref._BT.to(dev, dtype)
        Hp, Wp = H + 2, W + 2

        def library():  # the stride-2 4x4 windows, then Bᵀ d B
            d = torch.as_strided(xp, (1, th, tw, 4, 4, C),
                                 (Hp * Wp * C, 2 * Wp * C, 2 * C, Wp * C,
                                  C, 1))
            return torch.einsum("ar,bijrsc,es->baeijc", bt, d, bt)
        # add/sub: 4 x 4 on the rows, 4 x 4 on the columns
        return dict(line, fn=winograd_conv.winograd_input_transform,
                    plain=winograd_conv.plain_input_transform,
                    args=(xp, H, W), kw={}, library=library,
                    inputs=[xp], flops=32 * nt * C)
    if kernel == "winograd_output_transform":
        if shape[0] == "ragged":  # ("ragged", H, W, K)
            _, H, W, K = shape
            desc = {"algorithm": "ragged", "H": H, "W": W, "K": K}
        else:
            _, H, C, K = shape
            W, desc = H, {"algorithm": "winograd", "H": H, "C": C, "K": K}
        th, tw = H // 2, W // 2
        nt = th * tw
        m = randn(1, 4, 4, nt, K, scale=3.0)
        scale, bias = bn(K)
        at = ref._AT.to(dev, dtype)
        s_lib, b_lib = scale.to(dtype), bias.to(dtype)

        def library():  # Aᵀ m A, the 2x2 scatter, the epilogue
            y = torch.einsum("ar,brstk,es->btaek", at, m, at)
            y = y.reshape(1, th, tw, 2, 2, K).permute(0, 1, 3, 2, 4, 5)
            return torch.relu(y.reshape(1, H, W, K) * s_lib + b_lib)
        # 16 add/sub on the rows, 8 on the columns, a multiply-add and the
        # activation on each of the 4 outputs
        return dict(shape={**desc, "tiles": nt},
                    fn=winograd_conv.winograd_output_transform,
                    plain=winograd_conv.plain_output_transform,
                    args=(m, H, W),
                    kw=dict(scale=scale, bias=bias, act="relu"),
                    library=library, inputs=[m, scale, bias],
                    flops=36 * nt * K)
    if shape[0] == "winograd":
        _, H, C, K = shape
        nt = (H // 2) ** 2
        line = {"shape": {"algorithm": "winograd", "H": H, "C": C, "K": K,
                          "tiles": nt}}
        # the 16 products of one image: V (16, nt, C) against U, fp32 as
        # the forced path has it; in fp16 the cached U of an fp16 plan
        a = randn(16, nt, C)
        b = (torch.randn(16, C, K, device=dev, generator=gen)
             * C ** -0.5)
        b_lib = b.to(dtype)
        if dtype == torch.float16:
            b = b_lib
        line["shape"].update(M=nt, Kc=C, N=K, batch=16,
                             b_dtype=str(b.dtype).removeprefix("torch."))
        return dict(line, fn=gemm.gemm, plain=gemm.plain, args=(a, b),
                    kw={}, library=lambda: torch.bmm(a, b_lib),
                    inputs=[a, b], flops=2 * 16 * nt * C * K)

    if shape[0] == "ragged" and kernel == "gemm":  # a product no path runs
        _, M, Kc, N = shape
        a = randn(1, M, Kc)
        b = randn(Kc, N, scale=Kc ** -0.5)
        return dict(fn=gemm.gemm, plain=gemm.plain, args=(a, b), kw={},
                    library=lambda: torch.matmul(a, b), inputs=[a, b],
                    flops=2 * M * Kc * N,
                    shape={"algorithm": "ragged", "M": M, "Kc": Kc, "N": N})

    if kernel == "fused_inverted_residual":
        if shape[0] == "ragged":
            _, H, W, Cin, mid, Cout, R, stride, residual = shape
            ragged = {"algorithm": "ragged", "W": W}
        else:
            (H, Cin, mid, Cout, R, stride, residual), W, ragged = \
                shape, shape[0], {}
        x = randn(1, H, W, Cin)
        weights = {}
        if mid != Cin:
            weights["w1"] = randn(1, 1, Cin, mid, scale=Cin ** -0.5)
            weights["s1"], weights["b1"] = bn(mid)
        weights["wdw"] = randn(R, R, 1, mid, scale=1 / R)
        weights["sdw"], weights["bdw"] = bn(mid)
        weights["w2"] = randn(1, 1, mid, Cout, scale=mid ** -0.5)
        weights["s2"], weights["b2"] = bn(Cout)
        OH, OW = -(-H // stride), -(-W // stride)
        pads = (*_same_pads(W, R, stride), *_same_pads(H, R, stride))
        x_lib = x.permute(0, 3, 1, 2)
        lib = {k: _cl(v) if k[0] == "w" else vec(v)
               for k, v in weights.items()}

        def library():
            h = x_lib
            if "w1" in lib:
                h = torch.clamp(F.conv2d(h, lib["w1"]) * lib["s1"]
                                + lib["b1"], 0, 6)
            if pads[0] == pads[1] == pads[2] == pads[3]:
                h = F.conv2d(h, lib["wdw"], stride=stride, padding=pads[0],
                             groups=mid)
            else:
                h = F.conv2d(F.pad(h, pads), lib["wdw"], stride=stride,
                             groups=mid)
            h = torch.clamp(h * lib["sdw"] + lib["bdw"], 0, 6)
            h = F.conv2d(h, lib["w2"]) * lib["s2"] + lib["b2"]
            return h + x_lib if residual else h
        flops = 2 * (H * W * Cin * mid * ("w1" in weights)
                     + OH * OW * mid * (R * R + Cout))
        return dict(
            fn=fused_block.fused_inverted_residual,
            plain=fused_block.plain_inverted_residual,
            args=(x, weights), kw=dict(stride=stride, residual=residual),
            library=library, inputs=[x, *weights.values()], flops=flops,
            shape={**ragged, "H": H, "Cin": Cin, "mid": mid, "Cout": Cout,
                   "R": R, "stride": stride, "residual": residual})
    if kernel == "depthwise_conv":
        if shape[0] == "ragged":
            _, H, W, C, M, R, stride = shape
            ragged = {"algorithm": "ragged", "W": W}
        else:
            (H, C, M, R, stride), W, ragged = shape, shape[0], {}
        x = randn(1, H, W, C)
        w = randn(R, R, 1, M * C, scale=1 / R)
        scale, bias = bn(M * C)
        xp = ref.pad_same(x, R, R, stride)
        x_lib, w_lib = xp.permute(0, 3, 1, 2), _cl(w)

        def library():
            return F.conv2d(x_lib, w_lib, stride=stride, groups=C)
        Ho, Wo = -(-H // stride), -(-W // stride)
        return dict(
            fn=depthwise_conv.depthwise_conv, plain=depthwise_conv.plain,
            args=(xp, w),
            kw=dict(stride=stride, scale=scale, bias=bias, act="relu6"),
            library=library, inputs=[xp, w, scale, bias],
            flops=2 * Ho * Wo * R * R * M * C,
            shape={**ragged, "H": H, "C": C, "M": M, "R": R,
                   "stride": stride})
    if shape[0] == "ragged":  # a conv class no path launches: H != W
        _, H, W, C, K, R, stride = shape
        ragged = {"algorithm": "ragged", "W": W}
    else:
        (H, C, K, R, stride), W, ragged = shape, shape[0], {}
    x = randn(1, H, W, C)
    w = randn(R, R, C, K, scale=(R * R * C) ** -0.5)
    scale, bias = bn(K)
    Ho, Wo = -(-H // stride), -(-W // stride)
    line = dict(flops=2 * Ho * Wo * R * R * C * K,
                shape={**ragged, "H": H, "C": C, "K": K, "R": R,
                       "stride": stride})
    if kernel == "gemm":  # im2col's product: (H*W, R*S*C) @ (R*S*C, K)
        a = randn(1, H * H, R * R * C)
        b = w.reshape(R * R * C, K)
        return dict(line, fn=gemm.gemm, plain=gemm.plain, args=(a, b),
                    kw={}, library=lambda: torch.matmul(a, b),
                    inputs=[a, b],
                    shape={**line["shape"], "M": H * H, "Kc": R * R * C,
                           "N": K})
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
    # a strided 1x1 reads only the pixels x[::s, ::s]
    x_read = xp[:, ::stride, ::stride] if R == 1 else xp
    if kernel == "im2col_unroll":
        Hp, Wp = xp.shape[1], xp.shape[2]

        def library():  # the patch matrix in the same order, one copy
            return torch.as_strided(
                xp, (1, H, W, R, R, C),
                (Hp * Wp * C, Wp * C, C, Wp * C, C, 1)).contiguous()
        return dict(line, fn=im2col_conv.im2col_unroll,
                    plain=im2col_conv.plain, args=(xp, R, R), kw={},
                    library=library, inputs=[xp], flops=0)
    if kernel == "ilpm_conv":
        def library():
            return F.conv2d(x_lib, w_lib, stride=stride)
        return dict(line, fn=ilpm_conv.ilpm_conv, plain=ilpm_conv.plain,
                    args=(xp, w),
                    kw=dict(stride=stride, scale=scale, bias=bias,
                            act="relu"),
                    library=library, inputs=[x_read, w, scale, bias])
    if kernel in ("direct_conv", "libdnn_conv"):
        mod = direct_conv if kernel == "direct_conv" else libdnn_conv
        kw = dict(scale=scale, bias=bias, act="relu")
        if kernel == "direct_conv":
            kw["stride"] = stride
        s_lib, b_lib = vec(scale), vec(bias)

        def library():  # cuDNN with the epilogue
            return torch.relu(F.conv2d(x_lib, w_lib, stride=stride) * s_lib
                              + b_lib)
        return dict(line, fn=getattr(mod, kernel), plain=mod.plain,
                    args=(xp, w), kw=kw, library=library,
                    inputs=[x_read, w, scale, bias])
    res = randn(1, H, W, K)
    res_lib = res.permute(0, 3, 1, 2)

    def library():
        return torch.relu(F.conv2d(x_lib, w_lib) + res_lib)
    return dict(line, fn=fused_block.fused_residual_conv,
                plain=fused_block.plain,
                args=(xp, {"w": w, "scale": scale, "bias": bias}),
                kw=dict(res=res, act="relu"), library=library,
                inputs=[xp, w, scale, bias, res])


def tile_plan(kernel, args, kw, y):
    """The launch plan of one call of a planned kernel
    (``PLANNED_KERNELS``): its path, tile, split and CTAs (the conv
    tile's: tile rows, columns and channels, chunk, channel-chunk split,
    filter-row split and the parts the reduction adds; direct's: pixels
    and channels of a tile, chunk, contraction slices and pixel tiles,
    one a CTA; the inverted residual's: output tile side and parts of the
    mid width, its 32-channel slabs, one a CTA; the depthwise conv's:
    output tile rows and columns, channels, threads and which kernel, the
    3x3 one or the generic), of the im2col unroll (pixels a CTA,
    channels, shared memory and CTAs) and of the Winograd output transform
    (tiles a CTA, channels, unit bytes, threads and CTAs).
    ``y`` is the call's output: (batch, M, N) for gemm, (B, Ho, Wo, K) for
    a conv."""
    from repro_torch.kernels import depthwise_conv, direct_conv, \
        fused_block, gemm, ilpm_conv, im2col_conv, libdnn_conv, \
        pointwise_conv, winograd_conv

    if kernel == "winograd_output_transform":
        m, H, W = args
        p = winograd_conv.plan(m, H, W)
        return {**p._asdict(), "threads": winograd_conv.threads(p, m.dtype),
                "ctas": winograd_conv.ctas(p, H, W, m.shape[-1])
                * m.shape[0]}
    if kernel == "im2col_unroll":
        xp, r, s = args
        p = im2col_conv.plan(xp, r, s)
        H, W = xp.shape[1] - r + 1, xp.shape[2] - s + 1
        return {**p._asdict(), "ctas": im2col_conv.ctas(
                    p, H, W, xp.shape[3]) * xp.shape[0],
                "smem": im2col_conv.smem_bytes(p, r, s, xp.dtype)}
    a, b = args
    if kernel == "depthwise_conv":
        p = depthwise_conv.plan(a, b, kw["stride"])
        B, Ho, Wo, K = y.shape
        R, S, _, _ = b.shape
        return {"tile": [p.tile_h, p.tile_w], "channels": p.channels,
                "threads": depthwise_conv.threads(p, a.dtype),
                "smem": depthwise_conv.smem_bytes(p, R, S, kw["stride"],
                                                  a.dtype),
                "kernel": depthwise_conv.kernel_of(
                    a, b, kw["stride"], y, kw["scale"], kw["bias"]),
                "ctas": depthwise_conv.ctas(p, Ho, Wo, K) * B}
    if kernel == "direct_conv":
        p = direct_conv.plan(a, b, kw["stride"])
        B, Ho, Wo, K = y.shape
        tiles = -(-Ho * Wo // p.tile)
        return {"path": p.path, "tile": [p.tile, direct_conv.TILE_K],
                "chunk": p.chunk, "slices": p.slices, "tiles": tiles,
                "ctas": -(-K // direct_conv.TILE_K) * p.slices * tiles * B}
    if kernel == "fused_inverted_residual":
        B, H, W, Cin = a.shape
        R, S, _, mid = b["wdw"].shape
        p = fused_block.plan(H, W, Cin, mid, y.shape[3], R, S,
                             kw["stride"], "w1" in b, a.dtype)
        return {"path": p.path, "tile": p.tile, "parts": p.parts,
                "ctas": -(-y.shape[1] // p.tile) * -(-y.shape[2] // p.tile)
                * p.parts * B}
    if kernel in CONV_TILE_KERNELS:
        w = b["w"] if kernel == "fused_residual_conv" else b
        p = ilpm_conv.plan(a, w, kw.get("stride", 1))
        B, Ho, Wo, K = y.shape
        return {"path": p.path, "tile": [p.tile, p.tile, ilpm_conv.TILE_K],
                "chunk": p.chunk, "split": p.split, "rsplit": p.rsplit,
                "parts": p.parts,
                "ctas": -(-Ho // p.tile) * -(-Wo // p.tile)
                * -(-K // ilpm_conv.TILE_K) * B * p.parts}
    if kernel == "gemm":
        batch, M, Kc = a.shape if a.dim() == 3 else (1, *a.shape)
        N, batch_b = b.shape[-1], b.shape[0] if b.dim() == 3 else 1
        kind = gemm.path(a.dtype, b.dtype)
        tile, split = gemm.plan(M, N, Kc, batch_b, a.dtype, b.dtype)
    else:
        batch, M, N = y.shape[0], y.shape[1] * y.shape[2], y.shape[3]
        kind = gemm.conv_path(a, b)
        tile, split = pointwise_conv.plan(a, b, kw["stride"]) \
            if kernel == "pointwise_conv" else libdnn_conv.plan(a, b)
    return {"path": kind, "tile": [tile, tile], "split": split,
            "ctas": -(-M // tile) * -(-N // tile) * batch * split}


def per_layer_chain(x, weights, stride, residual):
    """The inverted residual as the per-layer MobileNetV2 runs it, on the
    ported kernels: ``pointwise_conv`` (the expand, absent for t = 1) ->
    SAME pad -> ``depthwise_conv`` -> ``pointwise_conv`` (the project) ->
    ``+ x`` where residual; ReLU6 after the first two, as
    ``kernel_setup``'s calls of the fused kernel have it."""
    from repro_torch.kernels import depthwise_conv, pointwise_conv, ref

    h = x
    if "w1" in weights:
        h = pointwise_conv.pointwise_conv(h, weights["w1"],
                                          scale=weights["s1"],
                                          bias=weights["b1"], act="relu6")
    wdw = weights["wdw"]
    h = depthwise_conv.depthwise_conv(
        ref.pad_same(h, wdw.shape[0], wdw.shape[1], stride), wdw,
        stride=stride, scale=weights["sdw"], bias=weights["bdw"],
        act="relu6")
    h = pointwise_conv.pointwise_conv(h, weights["w2"], scale=weights["s2"],
                                      bias=weights["b2"])
    return h + x if residual else h


def kernel_case(kernel, shape, dtype, gen, peaks):
    """Run one shape class of one kernel; return its result line. An fp32
    ``fused_inverted_residual`` line also holds the kernel against the
    per-layer chain of ported kernels on the same inputs
    (``per_layer_chain``), bitwise."""
    from repro_torch.core.dtypes import canonical, tolerance

    case = kernel_setup(kernel, shape, dtype, gen)
    fn, plain, args, kw = case["fn"], case["plain"], case["args"], case["kw"]
    y = fn(*args, **kw)
    torch.cuda.synchronize()
    p = plain(*args, **kw)
    err = (y.float() - p.float()).abs().max().item()
    rel = err / p.float().abs().max().item()
    nbytes = sum(t.numel() * t.element_size() for t in case["inputs"]) \
        + y.numel() * y.element_size()
    name = canonical(dtype)
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
    if kernel in (*PLANNED_KERNELS, "im2col_unroll",
                  "winograd_output_transform"):
        line["plan"] = tile_plan(kernel, args, kw, y)
    if kernel == "fused_inverted_residual" and dtype == torch.float32:
        x, weights = args
        chain = per_layer_chain(x, weights, kw["stride"], kw["residual"])
        line["vs_per_layer_bitwise_equal"] = torch.equal(y, chain)
        line["vs_per_layer_max_abs_err"] = (y - chain).abs().max().item()
        require(line["vs_per_layer_bitwise_equal"],
                f"fused_inverted_residual {case['shape']}: not bitwise "
                f"equal to the per-layer chain: {(y - chain).abs().max()}")
    if kernel in BITWISE_KERNELS:  # bitwise or wrong
        line["bitwise_equal"] = torch.equal(y, p)
        require(line["bitwise_equal"],
                f"{kernel} {name} {case['shape']}: not bitwise equal to "
                "its plain version")
    return line


ODD_H = "n/a: odd H"


def comparison(peaks):
    """The paper's algorithm comparison on this card: each
    ``PAPER_CONV_LAYERS`` shape in fp32 with the folded-BN epilogue and
    ReLU, the device time of every contender and its ratio to ilpm. Each
    contender's output is held against ilpm's within tolerance("float32"),
    as they sum in other orders. Winograd runs its three kernels with U
    cached (the paper's §5.2 setting) where H is even; the sums over the
    layers are taken over the three even layers for every contender
    (``sum_even_ms``) and over all four for the rest (``sum_ms``)."""
    from repro_torch.configs.resnet import PAPER_CONV_LAYERS
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import (direct_conv, ilpm_conv, im2col_conv,
                                     libdnn_conv, ref, winograd_conv)

    gen = torch.Generator(device="cuda").manual_seed(1)
    layers = []
    for layer in PAPER_CONV_LAYERS:
        C, K, H, R = layer.c_in, layer.c_out, layer.h, layer.r
        x = torch.randn(1, H, H, C, device="cuda", generator=gen)
        w = torch.randn(R, R, C, K, device="cuda", generator=gen) \
            * (R * R * C) ** -0.5
        scale = torch.rand(K, device="cuda", generator=gen) + 0.5
        bias = torch.randn(K, device="cuda", generator=gen) * 0.1
        xp = ref.pad_same(x, R, R)
        ep = dict(scale=scale, bias=bias, act="relu")
        x_lib, w_lib = xp.permute(0, 3, 1, 2), _cl(w)
        s_lib, b_lib = scale.view(1, -1, 1, 1), bias.view(1, -1, 1, 1)
        runs = {
            "ilpm": lambda: ilpm_conv.ilpm_conv(xp, w, **ep),
            "direct": lambda: direct_conv.direct_conv(xp, w, **ep),
            "libdnn": lambda: libdnn_conv.libdnn_conv(xp, w, **ep),
            "im2col": lambda: im2col_conv.im2col_conv(xp, w, **ep),
            "cudnn": lambda: torch.relu(F.conv2d(x_lib, w_lib) * s_lib
                                        + b_lib).permute(0, 2, 3, 1),
        }
        if H % 2 == 0:
            u = ref.winograd_filter_transform(w)
            runs["winograd"] = lambda: winograd_conv.winograd_conv(
                xp, w, u=u, **ep)
        base = runs["ilpm"]()
        errs = {}
        for algo, fn in runs.items():
            y = fn().float()
            errs[algo] = ((y - base).abs().max() / base.abs().max()).item()
        bad = {a: e for a, e in errs.items()
               if not e <= tolerance("float32")}
        require(not bad, f"comparison {layer.name}: outputs disagree with "
                         f"ilpm's: {bad}")
        ms = {algo: time_ms(fn) for algo, fn in runs.items()}
        flops = 2 * H * H * R * R * C * K
        nbytes = 4 * (xp.numel() + w.numel() + 2 * K + base.numel())
        over = {a: t / ms["ilpm"] for a, t in ms.items() if a != "ilpm"}
        if "winograd" not in runs:
            ms["winograd"] = over["winograd"] = errs["winograd"] = ODD_H
        layers.append({
            "layer": layer.name, "H": H, "C": C, "K": K, "R": R,
            "ms": ms, "max_rel_err_vs_ilpm": errs, "over_ilpm": over,
            "bound_ms": max(flops / peaks["float32"],
                            nbytes / peaks["mem_bw"]) * 1e3})
    algos = list(layers[0]["ms"])
    even = [r for r in layers if r["H"] % 2 == 0]
    total = {a: sum(r["ms"][a] for r in layers) for a in algos
             if a != "winograd"}
    total["winograd"] = ODD_H
    total_even = {a: sum(r["ms"][a] for r in even) for a in algos}
    return {"phase": "comparison", "dtype": "float32",
            "epilogue": "folded BN + relu", "layers": layers,
            "sum_ms": total,
            "sum_over_ilpm": {a: t / total["ilpm"] for a, t in total.items()
                              if a not in ("ilpm", "winograd")},
            "even_layers": [r["layer"] for r in even],
            "sum_even_ms": total_even,
            "sum_even_over_ilpm": {a: t / total_even["ilpm"]
                                   for a, t in total_even.items()
                                   if a != "ilpm"},
            "paper_speedup_of_ilpm_mobile_gpu_mali": PAPER_SPEEDUP}


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


def rel_err(y, ref):
    """max|y - ref| / max|ref|."""
    return ((y - ref).abs().max() / ref.abs().max()).item()


def path_dtype(path) -> str:
    return PATH_DTYPE.get(path, "float32")


def alternate_ms(engines, images, runs=ENGINE_TIMED_RUNS):
    """Median host-clock ms of one ``run`` that ends in a synchronize, per
    named engine, the engines in turns, on device images."""
    times = {name: [] for name in engines}
    for i in range(runs):
        for name, engine in engines.items():
            times[name].append(host_ms(
                lambda: engine.run(images[i % len(images)]))[0])
    return {name: statistics.median(t) for name, t in times.items()}


def engine_phase(path, engine, images, counters, results,
                 bound=ENGINE_REL_BOUND):
    """Drive one engine, which replays CUDA graphs, on ``images`` (device
    tensors) through ``run`` and ``run_batch`` with the launch counters
    set to 0 just before. The counters tick when a forward is traced (the
    warm-up and each capture, ``engine.forwards``), so the launches per
    traced image must equal ``EXPECTED_PER_IMAGE``; a second pass, all
    replays, must launch nothing and give the same logits bitwise. An
    eager engine of the same plan and weights runs beside it: its logits
    bitwise the replay's, its launches per image as expected. Then the
    logits against the same engine and plan on the CPU (within
    ``bound``), ``run_batch`` against ``run``, and the ms per image with
    and without replay. The line also carries the device time of one
    image's launches as the kernel phase measured them (the class times
    in the path's compute dtype, ``results``). Returns (line, logits)."""
    from repro_torch.core import InferenceEngine

    cfg = engine.cfg
    require(engine.device.type == "cuda" and engine.replay,
            f"{path}: engine on {engine.device}, replay {engine.replay}")
    eager = InferenceEngine(cfg, params=engine.model, plan=engine.plan,
                            algorithm=engine.algorithm, replay=False)
    zero_counts(counters)
    before = engine.forwards
    singles = torch.stack([engine.run(im) for im in images])
    batched = engine.run_batch(images)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    traced = engine.forwards - before
    per_image = {name: n / traced for name, n in launches.items()}
    require(per_image == EXPECTED_PER_IMAGE[path],
            f"{path}: launches per traced image {per_image}, want "
            f"{EXPECTED_PER_IMAGE[path]}")
    zero_counts(counters)
    before = engine.forwards
    replayed = torch.stack([engine.run(im) for im in images])
    rebatched = engine.run_batch(images)
    torch.cuda.synchronize()
    on_replay = sum(read_counts(counters).values())
    require(on_replay == 0 and engine.forwards == before
            and torch.equal(replayed, singles)
            and torch.equal(rebatched, batched),
            f"{path}: replays launched {on_replay} wrapper calls, traced "
            f"{engine.forwards - before} forwards or changed the logits")
    zero_counts(counters)
    eager_logits = torch.stack([eager.run(im) for im in images])
    torch.cuda.synchronize()
    eager_per_image = {name: n / len(images)
                       for name, n in read_counts(counters).items()}
    require(eager_per_image == EXPECTED_PER_IMAGE[path],
            f"{path}: eager launches per image {eager_per_image}")
    replay_eager = torch.equal(singles, eager_logits)
    require(replay_eager, f"{path}: replayed logits are not bitwise equal "
                          "to eager dispatch's")
    require(tuple(singles.shape) == (len(images), cfg.vocab_size)
            and bool(torch.isfinite(singles).all()),
            f"{path}: bad logits: shape {tuple(singles.shape)}")
    bitwise = torch.equal(singles, batched)
    require(bitwise, f"{path}: run_batch is not bitwise equal to run")
    cpu = InferenceEngine(cfg, params={k: v.cpu() for k, v in
                                       engine.model.state_dict().items()},
                          plan=engine.plan, algorithm=engine.algorithm,
                          device="cpu")
    ref_logits = cpu.run_batch(images.cpu())
    engine_rel = ((singles.cpu() - ref_logits).abs().max()
                  / ref_logits.abs().max()).item()
    require(engine_rel <= bound,
            f"{path}: cuda logits vs cpu: {engine_rel} > {bound}")
    ms = alternate_ms({"replay": engine, "eager": eager}, images)
    plan = engine.plan
    return {"phase": "engine", "path": path, "config": cfg.name,
            "img": cfg.extra["img"], "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "logits_dtype":
            str(singles.dtype).removeprefix("torch."),
            "images": len(images), "algorithm": engine.algorithm,
            "plan": sorted(Counter(plan.algorithms().values()).items())
            if plan else None,
            "fused_blocks": len(plan.block_choices) if plan else 0,
            "launches": launches, "images_traced": traced,
            "launches_at_capture": per_image,
            "launches_on_replay": on_replay, "graphs": engine.graphs,
            "max_rel_err_vs_cpu": engine_rel, "bound": bound,
            "run_batch_bitwise_equal_run": bitwise,
            "replay_bitwise_equal_eager": replay_eager,
            "ms_per_image_replay": ms["replay"],
            "ms_per_image_eager": ms["eager"],
            "kernel_ms_per_image_from_classes": sum(
                r["kernel_ms"] * r["launches_per_image"].get(path, 0)
                for r in results if r["dtype"] == path_dtype(path))}, singles


def measured_phase(tuned, images):
    """The measured tuner at full width: ResNet-18 tuned with
    ``tune(mode="measured", noise_floor=0)`` on the card (each candidate a
    graph replay timed with CUDA events); its algorithm counts, the sites
    whose algorithm moved from the cost-model plan, its replayed ms per
    image beside the cost-model plan's, and its logits against the CPU
    engine on the same plan."""
    from repro_torch.core import InferenceEngine

    cfg = tuned.cfg
    t0 = time.perf_counter()
    plan = tuned.tune(mode="measured", noise_floor=0)
    tune_s = time.perf_counter() - t0
    require(plan.mode == "measured" and plan.specs == tuned.plan.specs,
            "measured plan: sites differ from the cost-model plan's")
    moved = {name: [tuned.plan.choices[name].algorithm, ch.algorithm]
             for name, ch in plan.choices.items()
             if ch.algorithm != tuned.plan.choices[name].algorithm}
    engine = InferenceEngine(cfg, params=tuned.model, plan=plan)
    logits = torch.stack([engine.run(im) for im in images])
    cpu = InferenceEngine(cfg, params={k: v.cpu() for k, v in
                                       engine.model.state_dict().items()},
                          plan=plan, device="cpu")
    rel = rel_err(logits.cpu(), cpu.run_batch(images.cpu()))
    require(bool(torch.isfinite(logits).all()) and rel <= ENGINE_REL_BOUND,
            f"resnet18/measured: cuda logits vs cpu {rel}")
    ms = alternate_ms({"measured": engine, "cost_model": tuned}, images)
    return {"phase": "tuner", "path": "resnet18/measured",
            "config": cfg.name, "mode": "measured", "noise_floor": 0,
            "repeats": 3, "timer": "CUDA graph replay, CUDA events",
            "tune_s": tune_s,
            "plan": sorted(Counter(plan.algorithms().values()).items()),
            "cost_model_plan": sorted(
                Counter(tuned.plan.algorithms().values()).items()),
            "fused_blocks": len(plan.block_choices),
            "sites_moved": len(moved), "moved": moved,
            "measured_us_per_site": {
                name: ch.est_time * 1e6 for name, ch in plan.choices.items()},
            "ms_per_image_replay": ms["measured"],
            "cost_model_ms_per_image_replay": ms["cost_model"],
            "max_rel_err_vs_cpu": rel, "bound": ENGINE_REL_BOUND}


def serving_phase():
    """The serving tier on the card: a ``Server`` holding full-width
    ResNet-18 and MobileNetV2 (fp32, tuned, weights from seed 0), fed
    ragged bursts of host images across both networks (buckets 1, 2 and
    4 all dispatch), every answer bitwise ``engine.run`` of the same
    image on the same cached engine and ``trace_count`` bounded by the
    buckets run; then one threaded 30 fps stream on ResNet-18 beside
    MobileNetV2 requests, every frame bitwise ``run``; then, on a second
    server, scripted persistent dispatch faults that trip the breaker and
    swap in the ``xla_fallback_plan`` engine, whose answers must lie
    within the engine bound of the tuned engine's."""
    import threading

    import numpy as np

    from repro_torch.configs import get
    from repro_torch.serving import (FaultInjector, RetryPolicy, Server,
                                     ServingOptions)

    img = get(SERVE_NETS[0]).extra["img"]
    host = np.random.default_rng(3).standard_normal(
        (max(SERVE_BURSTS), img, img, 3)).astype(np.float32)
    lines = []
    with Server(options=ServingOptions(max_batch=4)) as server:
        require(server.engines.device.type == "cuda",
                f"serving on {server.engines.device}")
        engines = {}
        for net in SERVE_NETS:
            server.warm(net)
            engines[net] = server.engines.get(get(net))
        truth = {net: [engines[net].run(im) for im in host]
                 for net in SERVE_NETS}
        tickets, rounds = [], []
        for r in range(SERVE_ROUNDS):  # the first captures the batch graphs
            graphs = sum(e.graphs for e in engines.values())
            t0 = time.perf_counter()
            done = []
            for n in SERVE_BURSTS:
                burst = [(net, i, server.submit(net, host[i]))
                         for i in range(n) for net in SERVE_NETS]
                for _, _, ticket in burst:
                    ticket.result(timeout=SERVE_WAIT)
                done += burst
            wall = time.perf_counter() - t0
            lat = sorted(t.latency * 1e3 for _, _, t in done)
            rounds.append({
                "round": r, "requests": len(done), "wall_s": wall,
                "images_per_s": len(done) / wall,
                "graphs_captured": sum(e.graphs for e in engines.values())
                - graphs,
                "latency_p50_ms": lat[round(0.50 * (len(lat) - 1))],
                "latency_p95_ms": lat[round(0.95 * (len(lat) - 1))],
                "latency_max_ms": lat[-1]})
            tickets += done
        bitwise = all(torch.equal(t.result(), truth[net][i])
                      for net, i, t in tickets)
        require(bitwise, "serving: an answer is not bitwise engine.run")
        stats = server.stats()
        per_net = {}
        for net in SERVE_NETS:
            batcher = server._batchers[server.engines.key(get(net))]
            padded = sorted({d["padded"] for d in batcher.dispatches})
            batched = [p for p in padded if p > 1]
            traces = engines[net].trace_count()
            require(traces <= len(batched), f"serving {net}: "
                    f"trace_count {traces} > buckets {batched}")
            st = batcher.stats()
            per_net[net] = {
                "requests": st["requests"], "dispatches": st["dispatches"],
                "batch_histogram": st["batch_histogram"],
                "buckets": padded, "trace_count": traces,
                "graphs": engines[net].graphs}
        buckets = set().union(*(v["buckets"] for v in per_net.values()))
        require({1, 2, 4} <= buckets, f"serving: buckets {sorted(buckets)}")
        lines.append({"phase": "serving", "part": "requests",
                      "networks": list(SERVE_NETS), "dtype": "float32",
                      "img": img, "bursts": list(SERVE_BURSTS),
                      "max_batch": 4, "window_ms": server.window_ms,
                      "requests": len(tickets), "rounds": rounds,
                      "bitwise_equal_engine_run": bitwise,
                      "per_network": per_net,
                      "scheduler_jobs": stats["scheduler"]["jobs"]})

        # one 30 fps stream on ResNet-18, MobileNetV2 requests beside it
        side = []

        def classify():
            for k in range(STREAM_FRAMES):
                side.append((k, server.submit("mobilenet_v2",
                                              host[k % len(host)])))
                time.sleep(1 / STREAM_FPS)

        with server.open_stream("resnet18", fps=STREAM_FPS) as stream:
            client = threading.Thread(target=classify, daemon=True)
            client.start()
            frames, start = [], time.perf_counter()
            for k in range(STREAM_FRAMES):
                time.sleep(max(0.0, start + k / STREAM_FPS
                               - time.perf_counter()))
                frames.append(stream.submit_frame(host[k % len(host)]))
            stream.flush()
            client.join(SERVE_WAIT)
        require(not client.is_alive(), "serving: classify client hung")
        done = [f for f in frames if not f.dropped]
        frames_bitwise = all(
            torch.equal(f.future.result(timeout=SERVE_WAIT),
                        truth["resnet18"][f.seq % len(host)]) for f in done)
        side_bitwise = all(
            torch.equal(t.result(timeout=SERVE_WAIT),
                        truth["mobilenet_v2"][k % len(host)])
            for k, t in side)
        require(frames_bitwise and side_bitwise and done,
                "serving: a stream frame or a request beside it is not "
                "bitwise engine.run")
        st = stream.stats()
        lines.append({"phase": "serving", "part": "stream",
                      "network": "resnet18", "fps_target": STREAM_FPS,
                      "frames": st["frames"], "completed": st["completed"],
                      "fps_achieved": st["fps_achieved"],
                      "deadline_ms": st["deadline_ms"],
                      "deadline_miss_rate": st["deadline_miss_rate"],
                      "drop_rate": st["dropped"] / st["frames"],
                      "latency_p50_ms": st["latency_p50_s"] * 1e3,
                      "latency_p95_ms": st["latency_p95_s"] * 1e3,
                      "frames_bitwise_equal_run": frames_bitwise,
                      "requests_beside": len(side),
                      "requests_beside_bitwise": side_bitwise})

    # degraded mode: persistent dispatch faults on one network
    fi = FaultInjector().fail_from("dispatch", 0, error=RuntimeError,
                                   message="scripted persistent fault")
    with Server(options=ServingOptions(
            max_batch=1, faults=fi, breaker_threshold=2,
            retry=RetryPolicy(max_retries=0))) as server:
        server.warm("resnet18")
        tuned = server.engines.get(get("resnet18"))
        want = tuned.run(host[0])
        outs, failures = [], 0
        for _ in range(3):
            try:
                outs.append(server.run("resnet18", host[0],
                                       timeout=SERVE_WAIT))
            except RuntimeError:
                failures += 1
        stats = server.stats()
        (batcher,) = server._batchers.values()
        fallback = batcher.engine
        algos = set(fallback.plan.algorithms().values())
        rel = max(rel_err(o, want) for o in outs) if outs else None
        ms = alternate_ms({"xla": fallback, "tuned": tuned},
                          torch.as_tensor(host[:1], device=tuned.device))
    require(failures == 1 and len(outs) == 2 and stats["degraded"] == 1
            and algos == {"xla"} and fallback is not tuned,
            f"serving degraded: {failures} failures, {len(outs)} answers, "
            f"{stats['degraded']} degraded, plan {algos}")
    require(rel <= ENGINE_REL_BOUND, f"serving degraded: xla answers vs "
                                     f"tuned {rel} > {ENGINE_REL_BOUND}")
    lines.append({"phase": "serving", "part": "degraded",
                  "network": "resnet18", "breaker_threshold": 2,
                  "failures": failures, "answers": len(outs),
                  "degraded": stats["degraded"],
                  "fallback_plan": sorted(algos),
                  "injected": fi.stats()["injected"],
                  "max_rel_err_vs_tuned": rel, "bound": ENGINE_REL_BOUND,
                  "ms_per_image_replay_xla": ms["xla"],
                  "ms_per_image_replay_tuned": ms["tuned"]})
    return lines


def host_split(engine, replay, image, runs=5):
    """Where one eager tuned ResNet-18 run's host time goes.
    ``torch.profiler`` over one run: the host time inside aten ops (self
    CPU ms, top ops) against the wall, so the rest is Python and the
    kernels' ctypes launches; the device's busy ms. Then ``cProfile``
    over ``runs`` runs, its own time by module (the ctypes launch counts
    in the wrapper that calls it) and the top functions; cProfile slows
    Python calls, so its shares are upper bounds for Python. Then where a
    replayed run (``replay``, the same plan) spends its time: the CUDA
    events around one ``run`` (copy-in, replay, clone-out), and a profile
    of one (device busy ms, device kernels, the top ones)."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        engine.run(image)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = host_ms(lambda: engine.run(image))
    aten, calls = Counter(), Counter()
    for e in prof.key_averages():
        if e.self_cpu_time_total > 0:
            aten[e.key] += e.self_cpu_time_total / 1e3
            calls[e.key] += e.count
    device = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e3
    in_aten = sum(aten.values())

    profiler = cProfile.Profile()
    torch.cuda.synchronize()
    profiler.enable()
    for _ in range(runs):
        engine.run(image)
    torch.cuda.synchronize()
    profiler.disable()
    st = pstats.Stats(profiler)
    by_module, top = Counter(), []
    for (file, line, name), (_, ncalls, tottime, _, _) in st.stats.items():
        if "repro_torch/kernels/" in file:
            group = "kernel wrappers and plans (kernels/*.py, ctypes)"
        elif "repro_torch/" in file:
            group = "engine, routing and models (core/, models/)"
        elif file == "~":
            group = "torch and builtins (C functions)"
        elif "/torch/" in file:
            group = "torch Python (functional, tensor methods)"
        else:
            group = "Python standard library"
        by_module[group] += tottime * 1e3 / runs
        top.append((tottime * 1e3 / runs, ncalls / runs,
                    f"{Path(file).name}:{line} {name}"))
    top.sort(reverse=True)
    replay.run(image)
    replayed = {"event_ms": _median_event_ms(lambda: replay.run(image),
                                             ENGINE_TIMED_RUNS, 1),
                "host_ms": statistics.median(
                    host_ms(lambda: replay.run(image))[0]
                    for _ in range(ENGINE_TIMED_RUNS)),
                "profile": device_profile(lambda: replay.run(image), top=12)}
    return {"phase": "host_split", "path": "resnet18", "dispatch": "eager",
            "launches_per_image": sum(EXPECTED_PER_IMAGE["resnet18"]
                                      .values()),
            "wall_ms_profiled": wall, "device_busy_ms": device,
            "aten_self_cpu_ms": in_aten,
            "outside_aten_ms": wall - in_aten,
            "aten_top": [{"op": k, "ms": v, "calls": calls[k]}
                         for k, v in aten.most_common(12)],
            "cprofile_runs": runs,
            "cprofile_ms_per_run": sum(by_module.values()),
            "cprofile_ms_per_run_by_module": dict(by_module.most_common()),
            "cprofile_top": [{"fn": f, "ms_per_run": t, "calls_per_run": c}
                             for t, c, f in top[:15]],
            "replay": replayed}


def per_layer_vs_tuned(line, tuned, per_layer):
    """Hold an fp32 per-layer path's logits against the tuned plan's on
    the card: bitwise, as the reference's contract has it (its fused
    kernels sum in the order of the per-layer kernels they replace)."""
    line["vs_tuned_max_rel_err"] = rel_err(per_layer, tuned)
    line["vs_tuned_bitwise_equal"] = torch.equal(tuned, per_layer)
    require(line["vs_tuned_bitwise_equal"],
            f"{line['path']}: logits not bitwise equal to the tuned plan's on the "
            f"card ({line['vs_tuned_max_rel_err']} relative)")


def conv1d_classes(cfg):
    """causal_conv1d's shape classes, (B, L, C, K, row stride, channel
    offset) -> {path: launches per prefill}: the prefill of each LM path
    (one launch a layer, on the xBC slice of the in-projection) and the
    edge lengths at the same width, which no path launches."""
    from repro_torch.models import ssm

    d_inner, G, N, P, H, Hg, conv_ch = ssm._dims(cfg)
    row = 2 * d_inner + 2 * G * N + H  # the in-projection's width
    K, layers = cfg.ssm_conv_k, cfg.num_layers
    classes = {
        (SERVE_BATCH, SERVE_PROMPT, conv_ch, K, row, d_inner):
            {"mamba2_370m": layers},
        (1, PARITY_PROMPT, conv_ch, K, row, d_inner):
            {"mamba2_370m/fp32": layers}}
    for L in EDGE_LENGTHS:
        classes.setdefault((1, L, conv_ch, K, row, d_inner), {})
    return classes


def zero_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def vocab_logits(logits, cfg):
    """The logits of the real vocab in fp32 (the padding is masked)."""
    return logits[..., :cfg.vocab_size].float()


def host_ms(fn):
    """Host-clock ms of one ``fn()`` that ends in a synchronize; returns
    (ms, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def device_profile(fn, top=8):
    """One ``fn()`` under torch.profiler: its host-clock ms, the device's
    busy ms (the sum of its kernels' and copies' times), the idle share
    of the call (profiler on, so an upper bound) and the ``top`` kernels
    by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = host_ms(fn)
    ms, calls = Counter(), Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name] += e.time_range.elapsed_us() / 1e3
            calls[e.name] += 1
    busy = sum(ms.values())
    return {"wall_ms_profiled": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall if ms else "not measured",
            "device_launches": sum(calls.values()),
            "top": [{"name": name[:100], "ms": t, "launches": calls[name]}
                    for name, t in ms.most_common(top)]}


def serve_phase(cfg, params, counters):
    """``generate`` on mamba2-370m at bf16: batch 4, prompt 1024, 32 new
    tokens, greedy. The counters are set to 0 before a prefill-only run
    (max_new=1) and before the full run, and read after each: both must
    show one causal_conv1d launch per layer, so the 31 decode steps
    launch none. Then the timings, a profile, and the prefill logits
    against the conv's plain version on the card."""
    import numpy as np

    from repro_torch.core.dtypes import tolerance
    from repro_torch.launch import serve, steps

    path = "mamba2_370m"
    expected = {**NO_LAUNCHES, "causal_conv1d": cfg.num_layers}
    B, S, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S))).cuda()

    def run(max_new):
        return serve.generate(cfg, params, prompts, max_new=max_new,
                              cache_len=S + max_new)
    zero_counts(counters)
    first = run(1)
    torch.cuda.synchronize()
    prefill_launches = read_counts(counters)
    zero_counts(counters)
    tokens = run(new)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    require(prefill_launches == expected,
            f"{path}: prefill launches {prefill_launches}, want {expected}")
    require(launches == expected, f"{path}: launches over the prefill and "
            f"{new - 1} decode steps {launches}, want {expected}")
    require(tuple(tokens.shape) == (B, new) and tokens.dtype == torch.int32
            and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
            f"{path}: bad tokens {tuple(tokens.shape)} {tokens.dtype}")
    require(torch.equal(tokens[:, :1], first), f"{path}: first token "
            "differs between max_new=1 and max_new=32")
    generate_ms = [host_ms(lambda: run(new))[0] for _ in range(3)]
    with torch.inference_mode():
        prefill_ms = []
        for _ in range(3):
            t, (logits, caches) = host_ms(lambda: steps.prefill_step(
                params, cfg, prompts, cache_len=S + new))
            prefill_ms.append(t)
        tok = vocab_logits(logits[:, -1], cfg).argmax(-1)[:, None]
        decode_ms = []
        for i in range(new - 1):
            t, (step_logits, caches) = host_ms(
                lambda: steps.decode_step(params, cfg, tok, caches, S + i))
            decode_ms.append(t)
            tok = vocab_logits(step_logits[:, -1], cfg).argmax(-1)[:, None]
        profiles = {
            "prefill": device_profile(lambda: steps.prefill_step(
                params, cfg, prompts, cache_len=S + new)),
            "decode_step": device_profile(lambda: steps.decode_step(
                params, cfg, tok, caches, S + new - 1))}
        plain, _ = steps.prefill_step(params, cfg, prompts, impl="torch")
    kernel_logits = vocab_logits(logits, cfg)
    require(bool(torch.isfinite(kernel_logits).all()),
            f"{path}: non-finite prefill logits")
    rel = rel_err(kernel_logits, vocab_logits(plain, cfg))
    require(rel <= tolerance("bfloat16"), f"{path}: prefill logits with the "
            f"kernel vs the plain conv on the card: {rel}")
    total_ms = statistics.median(generate_ms)
    return {"phase": "lm", "path": path, "config": cfg.name,
            "entry": "repro_torch.launch.serve.generate", "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "batch": B, "prompt": S, "new_tokens": new,
            "greedy": True, "launches": launches,
            "launches_prefill": prefill_launches,
            "launches_per_decode_step": {
                k: (launches[k] - prefill_launches[k]) / (new - 1)
                for k in launches},
            "prefill_ms_median": statistics.median(prefill_ms),
            "prefill_ms": prefill_ms,
            "decode_ms_per_token_median": statistics.median(decode_ms),
            "decode_ms_per_token_mean": statistics.mean(decode_ms),
            "generate_ms_median": total_ms, "generate_ms": generate_ms,
            "tokens_per_s": B * new / total_ms * 1e3,
            "prefill_tokens_per_s": B * S / statistics.median(prefill_ms)
            * 1e3,
            "vs_plain_conv_max_rel_err": rel,
            "vs_plain_conv_bitwise_equal": torch.equal(
                kernel_logits, vocab_logits(plain, cfg)),
            "tol": tolerance("bfloat16"), "profile": profiles,
            "sample_tokens": tokens[0, :8].tolist()}


def parity_phase(cfg, params, counters):
    """mamba2-370m in fp32 at full width: batch 1, prompt 300, 8 greedy
    decode steps on the card, the counters set to 0 before and read after;
    the logits of the prefill and of every step against the port on the
    CPU fed the same tokens, within ENGINE_REL_BOUND; ``generate`` on the
    card gives the same tokens."""
    import numpy as np

    from repro_torch.launch import serve, steps
    from repro_torch.models.spec import flatten, unflatten

    path = "mamba2_370m/fp32"
    cfg = cfg.replace(dtype="float32")
    expected = {**NO_LAUNCHES, "causal_conv1d": cfg.num_layers}
    S = PARITY_PROMPT
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, S)))
    card, fed, step_ms = [], [], []
    zero_counts(counters)
    with torch.inference_mode():
        t, (logits, caches) = host_ms(lambda: steps.prefill_step(
            params, cfg, prompts.cuda(), cache_len=S + PARITY_STEPS))
        step_ms.append(t)
        card.append(logits)
        for i in range(PARITY_STEPS):
            fed.append(vocab_logits(logits[:, -1], cfg).argmax(-1)[:, None])
            t, (logits, caches) = host_ms(lambda: steps.decode_step(
                params, cfg, fed[-1], caches, S + i))
            step_ms.append(t)
            card.append(logits)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    require(launches == expected, f"{path}: launches {launches}, want "
            f"{expected}")
    greedy = torch.cat(
        fed + [vocab_logits(logits[:, -1], cfg).argmax(-1)[:, None]], dim=1)
    tokens = serve.generate(cfg, params, prompts.cuda(),
                            max_new=PARITY_STEPS + 1,
                            cache_len=S + PARITY_STEPS + 1)
    require(torch.equal(tokens.long(), greedy),
            f"{path}: generate's tokens differ from the steps' greedy ones")
    cpu_params = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, caches = steps.prefill_step(cpu_params, cfg, prompts,
                                            cache_len=S + PARITY_STEPS)
        cpu = [logits]
        for i, tok in enumerate(fed):
            logits, caches = steps.decode_step(cpu_params, cfg, tok.cpu(),
                                               caches, S + i)
            cpu.append(logits)
    cpu_s = time.perf_counter() - t0
    errs = [rel_err(vocab_logits(a.cpu(), cfg), vocab_logits(b, cfg))
            for a, b in zip(card, cpu)]
    require(all(bool(torch.isfinite(vocab_logits(a, cfg)).all())
                for a in card), f"{path}: non-finite logits")
    require(max(errs) <= ENGINE_REL_BOUND, f"{path}: card vs cpu logits "
            f"{errs} > {ENGINE_REL_BOUND}")
    return {"phase": "lm", "path": path, "config": cfg.name,
            "entry": "repro_torch.launch.steps prefill_step / decode_step, "
                     "and serve.generate", "dtype": cfg.dtype,
            "layers": cfg.num_layers, "batch": 1, "prompt": S,
            "decode_steps": PARITY_STEPS, "launches": launches,
            "max_rel_err_vs_cpu": max(errs),
            "rel_err_vs_cpu_per_step": errs, "bound": ENGINE_REL_BOUND,
            "prefill_ms": step_ms[0],
            "decode_ms_per_token_median": statistics.median(step_ms[1:]),
            "cpu_s": cpu_s, "tokens": greedy[0].tolist()}


def conv1d_summary(rows, launches, peaks):
    """The ``kernels`` entry of causal_conv1d: each LM path's class in the
    path's dtype times its launches per prefill, summed over the paths
    and per path; ``launches`` counts the paths' main-path runs."""
    source, replaces = KERNEL_INFO["causal_conv1d"]

    def per_prefill_sum(key, path=None):
        return sum(r[key] * n for r in rows
                   for p, n in r["launches_per_prefill"].items()
                   if r["dtype"] == LM_PATHS[p] and path in (None, p))
    t_ops = sum(r["flops"] * n / peaks[r["dtype"]] for r in rows
                for p, n in r["launches_per_prefill"].items()
                if r["dtype"] == LM_PATHS[p])
    t_bytes = per_prefill_sum("bytes") / peaks["mem_bw"]
    return {
        "name": "causal_conv1d", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(n["causal_conv1d"] for n in launches.values()),
        "launches_per_prefill": {
            path: n["causal_conv1d"] for path, n in launches.items()},
        "parity": "ok", "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_prefill_sum("kernel_ms"),
        "plain_ms": per_prefill_sum("plain_ms"),
        "bound_ms": per_prefill_sum("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": per_prefill_sum("library_ms"),
        "per_path": {path: {
            key: per_prefill_sum(key, path=path)
            for key in ("kernel_ms", "bound_ms", "plain_ms", "library_ms")}
            for path in launches}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.configs.resnet import PAPER_CONV_LAYERS
    from repro_torch.core import InferenceEngine, autotune
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import _build
    from repro_torch.kernels import (causal_conv1d, depthwise_conv,
                                     direct_conv, fused_block, gemm,
                                     ilpm_conv, im2col_conv, libdnn_conv,
                                     pointwise_conv, winograd_conv)
    from repro_torch.launch import steps
    from repro_torch.models import mobilenet, resnet
    from repro_torch.models.spec import init_params
    from repro_torch.quant import quantize_params

    # fp32 means IEEE fp32 in every reference and library call, and a
    # bf16 matrix product accumulates in fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

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

    # ---- the plans of the planned paths ---------------------------------
    rcfg, mcfg = get("resnet18"), get("mobilenet_v2")
    # the storage-only precision variants: fp32 compute over bf16 weights,
    # bf16 compute over fp32 weights
    scfg = rcfg.replace(param_dtype="bfloat16")
    bcfg = rcfg.replace(dtype="bfloat16")
    mbcfg = mcfg.replace(dtype="bfloat16")
    rplan = autotune.build_plan(resnet.conv_specs(rcfg), epilogue=True,
                                block_specs=resnet.block_specs(rcfg))
    mplan = autotune.build_plan(mobilenet.conv_specs(mcfg), epilogue=True,
                                block_specs=mobilenet.block_specs(mcfg))
    plans = {"resnet18": rplan, "resnet18/per_layer": strip_blocks(rplan),
             "mobilenet_v2": mplan,
             "mobilenet_v2/per_layer": strip_blocks(mplan),
             "resnet18/winograd_plan": pin_winograd(
                 rplan, resnet.conv_specs(rcfg)),
             "resnet18/int8": rplan,
             "resnet18/bf16/store_fp32": autotune.build_plan(
                 resnet.conv_specs(bcfg), epilogue=True,
                 block_specs=resnet.block_specs(bcfg)),
             "mobilenet_v2/bf16/store_fp32": autotune.build_plan(
                 mobilenet.conv_specs(mbcfg), epilogue=True,
                 block_specs=mobilenet.block_specs(mbcfg))}

    # ---- kernel phase --------------------------------------------------
    per_path = {}  # (kernel, shape) -> {path: launches per image}
    for path, plan in plans.items():
        for key, n in shape_classes(plan).items():
            per_path.setdefault(key, {})[path] = n
    for algorithm in FORCED:
        for key, n in forced_classes(resnet.conv_specs(rcfg),
                                     algorithm).items():
            per_path.setdefault(key, {})[f"resnet18/{algorithm}"] = n
    for key, n in forced_classes(resnet.conv_specs(scfg), "im2col").items():
        per_path.setdefault(key, {})["resnet18/im2col/store_bf16"] = n
    for key, n in forced_classes(resnet.conv_specs(bcfg), "winograd").items():
        per_path.setdefault(key, {})["resnet18/winograd/bf16"] = n
    paper = {(layer.h, layer.c_in, layer.c_out, layer.r, layer.stride)
             for layer in PAPER_CONV_LAYERS}
    for kernel in ("im2col_unroll", "gemm", "libdnn_conv"):
        shapes = {shape for k, shape in per_path
                  if k == kernel and shape[0] != "winograd"}
        require(shapes == paper, f"{kernel} classes {sorted(shapes)} are "
                                 "not the paper's four layers")
    for kernel in FORCED_KERNELS["winograd"]:
        shapes = {shape for k, shape in per_path
                  if k == kernel and shape[0] == "winograd"}
        require(shapes == WINOGRAD_CLASSES, f"{kernel} classes "
                f"{sorted(shapes)} are not ResNet-18's even 3x3/1 layers")
    # no launch on the main paths: the 1x1 fused block of a ResNet-50
    # stage-0 bottleneck, and a depthwise conv with channel multiplier 2
    per_path.setdefault(("fused_residual_conv", (56, 64, 256, 1, 1)), {})
    per_path.setdefault(("depthwise_conv", (14, 32, 2, 3, 2)), {})
    emit(launch_floor())
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    # Winograd's classes last, so the earlier classes draw the inputs
    # they drew before them
    ordered = sorted(per_path.items(),
                     key=lambda kv: (kv[0][1][0] == "winograd", repr(kv[0])))
    for (kernel, shape), paths in ordered:
        for dtype in (torch.float32, torch.bfloat16):
            line = kernel_case(kernel, shape, dtype, gen, peaks)
            line["launches_per_image"] = dict(paths)
            emit(line)
            results.append(line)
    # then gemm in fp16 at each of its classes (the tensor cores; at
    # Winograd's an fp16 plan's cached U) and its ragged products, then
    # the convs on its tile and on the conv tile in fp16 at each of their
    # classes and at their ragged classes in fp32 and bf16
    extra = [("gemm", shape, paths, torch.float16)
             for (kernel, shape), paths in ordered if kernel == "gemm"]
    extra += [("gemm", shape, {}, dtype)
              for shape, dtype in RAGGED_GEMM.items()]
    extra += [(kernel, shape, paths, torch.float16)
              for (kernel, shape), paths in ordered
              if kernel in PLANNED_KERNELS and kernel != "gemm"]
    extra += [(kernel, shape, {}, dtype) for kernel, shape in RAGGED_CONV
              for dtype in (torch.float32, torch.bfloat16)]
    # the bitwise kernels last, so the classes before draw the inputs they
    # drew before them: fp16 at every class, then their ragged classes
    extra += [(kernel, shape, paths, torch.float16)
              for (kernel, shape), paths in ordered
              if kernel in BITWISE_KERNELS]
    extra += [(kernel, shape, {}, dtype) for kernel, shape in RAGGED_BITWISE
              for dtype in (torch.float32, torch.bfloat16)]
    for kernel, shape, paths, dtype in extra:
        line = kernel_case(kernel, shape, dtype, gen, peaks)
        line["launches_per_image"] = dict(paths)
        emit(line)
        results.append(line)
    bad = [(r["kernel"], r["dtype"], r["shape"]) for r in results
           if not r["max_rel_err"] <= r["tol"]]
    require(not bad, f"kernels disagree with their plain versions: {bad}")
    emit(comparison(peaks))

    # ---- engine phases: the port's main paths --------------------------
    counters = {"ilpm_conv": ilpm_conv.ilpm_conv,
                "pointwise_conv": pointwise_conv.pointwise_conv,
                "fused_residual_conv": fused_block.fused_residual_conv,
                "depthwise_conv": depthwise_conv.depthwise_conv,
                "fused_inverted_residual":
                    fused_block.fused_inverted_residual,
                "direct_conv": direct_conv.direct_conv,
                "im2col_unroll": im2col_conv.im2col_unroll,
                "gemm": gemm.gemm, "libdnn_conv": libdnn_conv.libdnn_conv,
                "winograd_input_transform":
                    winograd_conv.winograd_input_transform,
                "winograd_output_transform":
                    winograd_conv.winograd_output_transform,
                "causal_conv1d": causal_conv1d.causal_conv1d}
    require(set(counters) == set(KERNEL_INFO), "a kernel has no counter")
    images = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (ENGINE_IMAGES, 224, 224, 3)).astype(np.float32), device="cuda")
    launches, traced = {}, {}  # per path: counts, images traced
    tuned_engine = InferenceEngine(rcfg, seed=0)
    require(tuned_engine.plan.to_json() == rplan.to_json(), "resnet18: plan")
    line, tuned_logits = engine_phase("resnet18", tuned_engine, images,
                                      counters, results)
    launches["resnet18"] = line["launches"]
    traced["resnet18"] = line["images_traced"]
    emit(line)
    # the per-layer plan on the same weights: bitwise the tuned logits
    path = "resnet18/per_layer"
    line, logits = engine_phase(
        path, InferenceEngine(rcfg, params=tuned_engine.model,
                              plan=plans[path]), images, counters, results)
    per_layer_vs_tuned(line, tuned_logits, logits)
    launches[path] = line["launches"]
    traced[path] = line["images_traced"]
    emit(line)
    # the reference's forced-algorithm entry point, on the same weights
    forced = {}
    for algorithm in FORCED:
        path = f"resnet18/{algorithm}"
        line, forced[algorithm] = engine_phase(
            path, InferenceEngine(rcfg, seed=0, algorithm=algorithm),
            images, counters, results)
        line["vs_tuned_max_rel_err"] = rel_err(forced[algorithm],
                                               tuned_logits)
        require(line["vs_tuned_max_rel_err"] <= ENGINE_REL_BOUND,
                f"{path} vs tuned logits on the card: "
                f"{line['vs_tuned_max_rel_err']}")
        launches[path] = line["launches"]
        traced[path] = line["images_traced"]
        emit(line)
    # Winograd on a plan: the engine's U cache, one U per pinned site
    path = "resnet18/winograd_plan"
    engine = InferenceEngine(rcfg, seed=0, plan=plans[path])
    require(len(engine.winograd_u) == 10, f"{path}: "
            f"{len(engine.winograd_u)} cached filter transforms, want 10")
    line, logits = engine_phase(path, engine, images, counters, results)
    line["winograd_u_sites"] = len(engine.winograd_u)
    line["vs_forced_winograd_max_rel_err"] = rel_err(logits,
                                                     forced["winograd"])
    require(line["vs_forced_winograd_max_rel_err"] <= ENGINE_REL_BOUND,
            f"{path} vs the forced Winograd engine on the card: "
            f"{line['vs_forced_winograd_max_rel_err']}")
    launches[path] = line["launches"]
    traced[path] = line["images_traced"]
    emit(line)
    # the tuned path on int8 weights, the scales folded into the epilogue
    path = "resnet18/int8"
    qparams, report = quantize_params(tuned_engine.params)
    require(len(report) == 20, f"{path}: {len(report)} quantized sites")
    line, logits = engine_phase(
        path, InferenceEngine(rcfg, params=qparams, plan=plans[path]),
        images, counters, results)
    line["quantized_sites"] = len(report)
    line["vs_fp32_max_rel_err"] = rel_err(logits, tuned_logits)
    line["vs_fp32_top1_agreement"] = (
        logits.argmax(-1) == tuned_logits.argmax(-1)).float().mean().item()
    launches[path] = line["launches"]
    traced[path] = line["images_traced"]
    emit(line)
    # storage-only precision variants on the tuned engine's weights: conv
    # filters cast to the compute dtype once at build, fp32 logits as the
    # reference's head promotes them
    path = "resnet18/im2col/store_bf16"
    stored = {k: v.to(torch.bfloat16)
              for k, v in tuned_engine.model.state_dict().items()}
    line, logits = engine_phase(
        path, InferenceEngine(scfg, params=stored, algorithm="im2col"),
        images, counters, results)
    line["vs_fp32_weights_max_rel_err"] = rel_err(logits, forced["im2col"])
    launches[path] = line["launches"]
    traced[path] = line["images_traced"]
    emit(line)
    require(line["logits_dtype"] == "float32", f"{path}: logits "
                                               f"{line['logits_dtype']}")
    path = "resnet18/bf16/store_fp32"
    engine = InferenceEngine(bcfg, params=tuned_engine.model)
    require(engine.plan.to_json() == plans[path].to_json(), f"{path}: plan")
    line, logits = engine_phase(path, engine, images, counters, results,
                                bound=tolerance("bfloat16"))
    line["vs_fp32_max_rel_err"] = rel_err(logits, tuned_logits)
    line["vs_fp32_top1_agreement"] = (
        logits.argmax(-1) == tuned_logits.argmax(-1)).float().mean().item()
    launches[path] = line["launches"]
    traced[path] = line["images_traced"]
    emit(line)
    require(line["logits_dtype"] == "float32", f"{path}: logits "
                                               f"{line['logits_dtype']}")
    # forced Winograd at bf16 over the same fp32 weights: V, M and the
    # output in bf16, U per call in fp32
    path = "resnet18/winograd/bf16"
    line, logits = engine_phase(
        path, InferenceEngine(bcfg, params=tuned_engine.model,
                              algorithm="winograd"),
        images, counters, results, bound=tolerance("bfloat16"))
    line["vs_fp32_max_rel_err"] = rel_err(logits, forced["winograd"])
    line["vs_fp32_top1_agreement"] = (
        logits.argmax(-1) == forced["winograd"].argmax(-1)).float().mean(
    ).item()
    launches[path] = line["launches"]
    traced[path] = line["images_traced"]
    emit(line)
    require(line["vs_fp32_max_rel_err"] <= tolerance("bfloat16"),
            f"{path} vs the fp32 forced Winograd logits: "
            f"{line['vs_fp32_max_rel_err']}")
    require(line["logits_dtype"] == "float32", f"{path}: logits "
                                               f"{line['logits_dtype']}")
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
        line, logits[path] = engine_phase(path, engine, images, counters,
                                          results)
        launches[path] = line["launches"]
        traced[path] = line["images_traced"]
        if path == "mobilenet_v2/per_layer":
            per_layer_vs_tuned(line, logits["mobilenet_v2"], logits[path])
        emit(line)
    # the tuned plan at bf16 over the same fp32 weights
    path = "mobilenet_v2/bf16/store_fp32"
    engine = InferenceEngine(mbcfg, params=tuned.model)
    require(engine.plan.to_json() == plans[path].to_json(), f"{path}: plan")
    line, blogits = engine_phase(path, engine, images, counters, results,
                                 bound=tolerance("bfloat16"))
    line["vs_fp32_max_rel_err"] = rel_err(blogits, logits["mobilenet_v2"])
    line["vs_fp32_top1_agreement"] = (
        blogits.argmax(-1) == logits["mobilenet_v2"].argmax(-1)
    ).float().mean().item()
    launches[path] = line["launches"]
    traced[path] = line["images_traced"]
    emit(line)
    require(line["logits_dtype"] == "float32", f"{path}: logits "
                                               f"{line['logits_dtype']}")

    # ---- the measured tuner and the serving tier on the card -----------
    emit(measured_phase(tuned_engine, images))
    for line in serving_phase():
        emit(line)

    # ---- the Mamba-2 LM path: its kernel, serving, fp32 parity ---------
    lcfg = get(LM_CONFIG)
    conv_gen = torch.Generator(device="cuda").manual_seed(2)
    conv_results = []
    # fp32 and bf16 at every class, then fp16 at every class (no path runs
    # it), so the classes before draw the inputs they drew before them
    classes = conv1d_classes(lcfg)
    for dtypes in ((torch.float32, torch.bfloat16), (torch.float16,)):
        for shape, paths in classes.items():
            for dtype in dtypes:
                line = kernel_case("causal_conv1d", shape, dtype, conv_gen,
                                   peaks)
                line["launches_per_prefill"] = dict(paths)
                emit(line)
                conv_results.append(line)
    bad = [(r["dtype"], r["shape"]) for r in conv_results
           if not r["max_rel_err"] <= r["tol"]]
    require(not bad, f"causal_conv1d disagrees with its plain version: {bad}")
    lparams = steps.init_state(lcfg, 0, "cuda")["params"]
    lm_launches = {}
    for line in (serve_phase(lcfg, lparams, counters),
                 parity_phase(lcfg, lparams, counters)):
        lm_launches[line["path"]] = line["launches"]
        emit(line)
    del lparams

    # ---- after every timed line (a profiler session slows later graph
    # replays): where an eager tuned ResNet-18 run's host time goes ------
    emit(host_split(InferenceEngine(rcfg, params=tuned_engine.model,
                                    plan=rplan, replay=False), tuned_engine,
                    images[0]))

    # ---- summary: each kernel over one image of each path (fp32), and
    # causal_conv1d over one prefill of each LM path in its dtype ---------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        if name == "causal_conv1d":
            kernels.append(conv1d_summary(conv_results, lm_launches, peaks))
            continue
        rows = [r for r in results if r["kernel"] == name]

        def per_image_sum(key, rows=rows, path=None):
            """Over one image of each path (or of ``path``), each class
            in the path's compute dtype."""
            return sum(r[key] * n for r in rows
                       for p, n in r["launches_per_image"].items()
                       if path in (None, p) and r["dtype"] == path_dtype(p))
        t_ops = sum(r["flops"] * n / peaks[r["dtype"]] for r in rows
                    for p, n in r["launches_per_image"].items()
                    if r["dtype"] == path_dtype(p))
        t_bytes = per_image_sum("bytes") / peaks["mem_bw"]
        by_path = {path: n[name] for path, n in launches.items() if n[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_per_image": {
                path: n / traced[path] for path, n in by_path.items()},
            "parity": "ok", "max_abs_err": max(r["max_abs_err"]
                                               for r in rows),
            "ms": per_image_sum("kernel_ms"),
            "plain_ms": per_image_sum("plain_ms"),
            "bound_ms": per_image_sum("bound_ms"),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": per_image_sum("library_ms"),
            "per_path": {path: {
                key: per_image_sum(key, path=path)
                for key in ("kernel_ms", "bound_ms", "plain_ms",
                            "library_ms")} for path in by_path}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
