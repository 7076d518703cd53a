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
   latency, images/s); the same server behind the wire (``wire``: a
   ``ServerEndpoint`` on 127.0.0.1 and one ``AsyncClient`` sending the
   same bursts in two rounds, every answer's float32 bytes equal to
   ``engine.run``'s, an unknown network answered as ``BadRequest``; per
   round the client's p50/p95 latency and images/s beside the in-process
   round 2); one threaded 30 fps stream of 30
   frames on ResNet-18 beside MobileNetV2 requests (``stream``: every
   frame and request bitwise ``run``, fps achieved, deadline-miss and
   drop rates); scripted persistent dispatch faults on a second server
   (``degraded``: the breaker trips, the ``xla_fallback_plan`` engine
   answers within the engine bound of the tuned engine's);
7. the LM paths (``repro_torch.launch.serve.generate``: one prefill,
   then greedy decode steps, replayed as CUDA graphs by
   ``steps.StepGraphs``, an eager run beside) at full width, random
   weights from seed 0: the hybrid, encoder-decoder and vision-language
   models first (each model's weights freed before the next is drawn;
   the earlier models' profiles, taken last, keep theirs), then
   ``mamba2-370m`` (48 layers), ``qwen2-0.5b`` (24 layers, d 896, 14
   heads with kv 2, head_dim 64, d_ff 4864, vocab 151936 padded to
   152064, tied embeddings, qkv bias) and the two MoE configs below:
   - ``causal_conv1d``, the kernel of its prefill, at the model's shapes
     (the xBC slice of the in-projection, read in place: rows 4384
     elements apart, C = 2304, K = 4) of both Mamba-2 paths below, at
     Jamba's (rows 33920 apart, C = 17408) of both of its paths, and at
     the edge lengths L = 1, 2, 3, 513 at Mamba-2's width, in fp32 and
     bf16, then in fp16 at each (no path runs it), then at a ragged class
     (``CONV1D_RAGGED``: L 333, K 3, a view at an odd channel offset, so
     one channel a thread) in fp32 and bf16, bitwise its plain version,
     with its plan (channels a thread, steps walked, threads, blocks,
     halo share), the same times as the kernel phase and
     ``F.conv1d(groups=C)`` as the library call; then its backward,
     ``causal_conv1d_bwd``, at the train class (4, 1024, 2304) in fp32,
     bf16 and fp16, at the ragged class in fp32 and bf16 and at Jamba's
     train class (4, 1024, 17408) in fp32, bf16 and fp16, dx, dw and db
     bitwise ``ref.causal_conv1d_bwd`` at the plan's tile, beside one
     ``aten.convolution_backward(groups=C)`` call;
   - ``mamba2_370m`` and ``qwen2_0_5b``, serving at the published dtype
     (bf16 over fp32 master weights): batch 4, prompt 1024 (4 SSD
     chunks), 32 new tokens, replayed and eager; the launches per traced
     prefill (``causal_conv1d`` 48 for Mamba-2, none of any kernel for
     qwen2: ``NO_LAUNCHES``) when the graphs are captured, none on a
     replayed run, one prefill's worth eager; replayed tokens equal to
     eager ones and every step's logits bitwise equal (teacher-forced);
     prefill ms and decode ms per token both ways, ``generate`` ms and
     tokens/s; Mamba-2's prefill logits against the same model with the
     conv's plain version (``impl="torch"``) on the card; qwen2's prefill
     and decode-step bounds;
   - ``mamba2_370m/fp32`` and ``qwen2_0_5b/fp32``: batch 1, prompt 300
     (across a chunk boundary), 8 greedy decode steps through the graphs
     and eagerly, bitwise equal; the logits of the prefill and of every
     step against the port on the CPU fed the same tokens;
   - ``chunked_attention``: one ``attention`` call at qwen2's head shape,
     fp32, Sq = Sk = 2304 (above ``_FULL_THRESH``), bitwise
     ``_attend_chunked`` and within ``tolerance(fp32)`` of
     ``_attend_full``;
   - the MoE LMs, which launch no port kernel either (the reference
     writes MLA and MoE in jnp): ``granite_moe_3b`` (granite-moe-3b-a800m
     at published width and depth: 32 layers, d 1536, 24 heads with kv 8,
     40 experts top-8 of d_ff 512, bf16 over fp32 master weights) and
     ``deepseek_v2_2l`` (deepseek-v2-236b at published widths, its 60
     layers cut to 2, the dense first layer and one MoE layer: MLA with
     128 heads, kv_lora_rank 512, q_lora_rank 1536, 192-wide queries
     against 128-wide values; 160 routed experts top-6 and 2 shared, of
     d_ff 1536; bf16 storage as the config has it; ``reduced`` names the
     cut), each served as qwen2 is, with its bounds and the entries the
     dense dispatch dropped over one eager prefill of the serving prompt
     (``moe_drops``), then ``/fp32`` at the same depth as qwen2's;
   - ``jamba_1_5_large_5l``: jamba-1.5-large-398b at published widths
     (d 8192, 64 heads with kv 8, Mamba-2 with d_inner 16384, 8 groups
     of state 64, 128 heads of 128; d_ff 24576; 16 experts top-2), its 72
     layers cut to the first 5 of its 8-layer period (``reduced``): Mamba
     + dense, Mamba + MoE, Mamba + dense, Mamba + MoE, GQA + dense, so
     every hybrid block kind runs, in its own bf16 storage (24.0 B
     parameters, 48.0 GB; one period is 45.2 B and does not fit a card),
     served as Mamba-2 is: ``causal_conv1d`` 4 per traced prefill, 0 on
     replay, the prefill logits against the conv's plain version, with
     its bounds and ``moe_drops``; ``jamba_1_5_large_2l/fp32``: its first
     two layers (the same weights, the other three freed, cast to fp32:
     12.2 B parameters, 48.7 GB) held against the port on the CPU;
   - ``internvl2_26b``: internvl2-26b's backbone at published widths and
     depth (48 layers, d 6144, 48 heads with kv 8, d_ff 16384) in bf16
     storage instead of the config's fp32 master weights (19.9 B
     parameters, 39.7 GB against 79.5 GB; ``reduced``), fed 256 seeded
     patch embeddings before a 768-token prompt (1024 positions) through
     ``StepGraphs`` (``prefill(tokens, prefix_embeds=...)``), 32 greedy
     tokens from position 1024; no port kernel; replay bitwise eager;
     its bounds; ``internvl2_26b/fp32``: its first 8 layers (4.3 B) in
     fp32 against the CPU;
   - ``whisper_base``: whisper-base at full size (88.4 M parameters, bf16
     over fp32 weights) on seeded frame embeddings (4, 1500, 512), a
     4-token decoder prompt and 32 greedy tokens with the published
     448-position decoder cache, through ``StepGraphs`` (the prefill runs
     the encoder and ``cross_kv``, each decode step reads ``cross``); no
     port kernel; replay bitwise eager; prefill ms (encoder included) and
     decode ms a token with their bounds; ``whisper_base/fp32`` against
     the CPU;
   - ``audio_stem``: ``frontends.audio_stem`` at the published shape, mel
     (1, 3000, 80) -> (1, 1500, 512), fp32, against the CPU and timed;
     ``vit_patch_embed``: (1, 448, 448, 3) with patch 14 -> (1, 1024,
     6144), fp32, against the CPU and timed;
   - ``moe_dispatch``: layer 0's MoE ffn of granite at full width in
     fp32, batch 4 x 256 tokens, capacity factor 8 (nothing drops): the
     sort-based dispatch within ``tolerance(fp32)`` of the dense one on
     the card, the only card run of the sort-based path (no serving size
     reaches T * N > ``_DENSE_MAX``); with the serving line's drops;
   - training, after the serving lines: ``causal_conv1d_grad``, the
     kernel's gradient at the train class (4, 1024, 2304), K 4, x the
     xBC view, in fp32 and bf16: the wrapper under autograd (the
     ``CausalConv1d`` Function: one forward and one ``causal_conv1d_bwd``
     launch) against the plain version's autograd, dx, dw and db within
     ``tolerance(dtype)``, dx bitwise the forward kernel on the reversed
     dy, forward plus backward timed by graph replay beside the plain
     path, ``F.conv1d(groups=C)`` with its autograd and the byte bound;
     ``optim``: ``adamw.update`` and ``adafactor.update`` on mamba2-370m's
     11 leaf shapes in fp32, three seeded steps, within 2e-5 of the CPU,
     one AdamW update of the whole tree timed against its byte bound
     (28 bytes a parameter); ``train/mamba2_370m_2l/fp32``: its first 2
     layers at full width in fp32, two train steps of 2 x 512 tokens on
     the card and on the CPU from one state (the second from the CPU's),
     the loss, the grad norm and every gradient within 1e-4, the
     parameters within 1e-4 where the CPU's first moment exceeds 1e-3 of
     its leaf's largest; ``train/resume``: the same 2 layers through
     ``launch.train.train``, 12 steps of 2 x 256 tokens with a checkpoint
     every 4, twice uninterrupted (bitwise equal: the step is
     deterministic) and once with a ``TransientFailure`` at step 9 (one
     restart, bitwise the uninterrupted state); ``train/mamba2_370m``,
     the main path: ``launch.train.train`` of mamba2-370m at full width
     and depth (368.8 M parameters, bf16 over fp32 masters, AdamW,
     remat="full") for 20 steps of 4 x 1024 tokens from a 16-token
     vocabulary, peak lr 1e-3, one checkpoint at step 20: every loss
     finite, the last 5 losses' mean at least 0.2 below the first 5's,
     ``causal_conv1d`` exactly 96 launches a step (48 layers: the
     forward and its rematerialized recompute) and ``causal_conv1d_bwd``
     exactly 48 (dx, dw and db; the 2-layer and resume lines by the same
     rule, ``train_launches``), the checkpoint
     restored with its digest checked bitwise the live state; the median
     step ms (steps 3-20), tokens/s, peak device memory, save and restore
     seconds, and the step's bound;
   - the ``mesh`` lines, after the training lines: an NCCL group of one
     rank (no fallback to gloo) and the (1, 1) ("data", "model") mesh of
     ``launch.mesh.make_local_mesh``, the state, the batch, the
     gradients and the optimizer DTensors placed by ``rules_for``.
     ``mesh/mamba2_370m_2l/fp32``: one sharded and one unsharded step of
     the first 2 layers in fp32 from one state and batch, the loss, the
     grad norm and every gradient within 2e-5 of each one's largest
     (and whether they are bitwise equal); ``mesh/mamba2_370m``: two
     sharded steps of mamba2-370m at full size (bf16 over fp32, AdamW,
     4 x 1024 tokens), each launching ``causal_conv1d`` 96 times and
     ``causal_conv1d_bwd`` 48 times (inside ``local_map`` on the rank's
     channel shard), finite losses, each step's ms beside an unsharded
     step's and the card's ``nvidia-smi`` name and power limit;
   - a ``profile`` line a serving path: one replayed and one eager decode
     step and one replayed prefill under ``torch.profiler`` (device busy
     ms, device operations, the kernels that take the most time), and one
     for the main train path: one step and its gradients alone (the
     optimizer's share), the top kernels, ``causal_conv1d``'s forward,
     recompute and backward;
   - every other LM family's training (``FAMILY_TRAIN``), after the
     profiles have freed the serving paths' graphs and weights: a
     ``train/<config>`` line each, at published widths in its own
     compute dtype, weights, optimizer and remat, 6 steps of 4 x 1024
     positions of a 16-token vocabulary (qwen2-0.5b, whole, and
     granite-moe-3b-a800m, 16 of 32 layers, AdamW; DeepSeek-V2, layer 0,
     and Jamba, layer 0, Adafactor over bf16 weights; the four through
     ``launch.train.train``, DeepSeek with a checkpoint of its last step
     restored bitwise; internvl2-26b, 2 of 48 layers, on 256 patch
     embeddings and 768 tokens, Adafactor, and whisper-base, whole, on
     1500 frames a row, AdamW, through ``steps.make_train_step``): every
     loss finite, the mean of the last 3 at least 0.2 below the first
     3's, launches exactly ``train_launches`` (Jamba's one Mamba layer,
     not rematerialized: 1 + 1 a step; the others none), the median step
     ms, tokens/s, ``train_bounds`` and its share, peak and state GB and
     ``reduced``; beside each its ``/fp32`` line, ``train_parity`` at the
     family's least full-width depth on one row of 128 tokens (qwen2 two
     rows through ``accum=2``);
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
   phases' traced forwards and of the LM and training runs
   (``causal_conv1d``'s ``train``: its launches a train step and its
   forward-plus-backward times; ``causal_conv1d_bwd`` per train step of
   mamba2-370m and of Jamba-1L, each path's class in its dtype times its
   launches, 48 and 1);
10. the card's name and power limit as ``nvidia-smi`` gives them, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises: the script exits non-zero and never prints the
last line. There is no CPU path.
"""
from __future__ import annotations

import copy
import json
import math
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
    "causal_conv1d_bwd": (
        "src/repro_torch/csrc/causal_conv1d.cu",
        "none: the reference defines no backward kernel (no custom_vjp in "
        "src/repro); JAX's autodiff differentiates "
        "src/repro/kernels/causal_conv1d.py:34"),
}
# the two kernels of causal_conv1d.cu, whose lines the LM section runs
CONV1D_KERNELS = ("causal_conv1d", "causal_conv1d_bwd")
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
                   "winograd_output_transform", *CONV1D_KERNELS)
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
# causal_conv1d's ragged class, forward and backward: L not a multiple of
# any walk, K 3, C 1030 at channel offset 3 of rows 1037 apart, so every
# dtype takes one channel a thread, (B, L, C, K, row stride, offset)
CONV1D_RAGGED = (2, 333, 1030, 3, 1037, 3)
# The GQA attention LM at published width: it launches none of the
# port's kernels (the reference computes attention and the FFN in jnp),
# so its lines require NO_LAUNCHES; one attention call at its head shape
# above the full-score threshold takes the chunked path
ATTN_CONFIG = "qwen2-0.5b"
CHUNKED_SEQ = 2304
# The MoE LMs: granite-moe-3b-a800m at published width and depth, and
# deepseek-v2-236b (235.7 B parameters) at published widths cut in depth
# to its dense first layer and one MoE layer (5.36 B); neither launches a
# port kernel. One MoE layer runs both dispatches at a capacity factor at
# which nothing drops, as the reference's test_moe_sorted_equals_dense.
MOE_CONFIG = "granite-moe-3b-a800m"
MLA_CONFIG, MLA_LAYERS = "deepseek-v2-236b", 2
DISPATCH_BATCH, DISPATCH_SEQ, DISPATCH_CF = 4, 256, 8.0
# The hybrid: jamba-1.5-large-398b (398 B parameters) at published widths
# cut to the first 5 layers of its period, in its bf16 storage, and its
# first 2 in fp32 for parity (the 5-layer cut would need 96 GB in fp32)
HYBRID_CONFIG, HYBRID_LAYERS, HYBRID_PARITY_LAYERS = \
    "jamba-1.5-large-398b", 5, 2
HYBRID_PATH = "jamba_1_5_large_5l"
HYBRID_PARITY_PATH = "jamba_1_5_large_2l/fp32"
LM_PATHS.update({HYBRID_PATH: "bfloat16", HYBRID_PARITY_PATH: "float32"})
# The vision-language backbone at published widths and depth in bf16
# storage, fed its 256 patch embeddings before a 768-token prompt; its
# parity line at 8 layers in fp32
VLM_CONFIG, VLM_PROMPT, VLM_PARITY_LAYERS = "internvl2-26b", 768, 8
# The encoder-decoder at full size on 1500 frame embeddings, a 4-token
# decoder prompt, the published 448-position decoder context
ENCDEC_CONFIG, ENCDEC_PROMPT, ENCDEC_CACHE = "whisper-base", 4, 448
# The frontends at the published shapes: 30 s of 80-bin mel frames, and
# one 448 x 448 image in 14 x 14 patches
MEL_FRAMES, MEL_BINS, IMAGE_SIDE, PATCH = 3000, 80, 448, 14
# The training lines (after the LM serving lines, before the profiles):
# mamba2-370m at full width and depth, bf16 over fp32 master weights with
# the config's AdamW and remat="full", through launch/train.py's run on a
# 16-token vocabulary so the loss can fall (as the reference's
# test_lm_loss_decreases), 20 steps of 4 x 1024 tokens, one checkpoint at
# the end; its first 2 layers in fp32 against the CPU, two steps of 2 x
# 512 (two SSD chunks); the crash-resume run of the reference's
# test_crash_resume_bitwise on the same 2 layers; both optimizers alone on
# mamba2-370m's 11 leaf shapes; causal_conv1d's gradient at the train
# class. Each Mamba layer's train step launches causal_conv1d's forward
# twice (the forward and its rematerialized recompute) and its backward
# once (dx, dw and db).
TRAIN_PATH, TRAIN_PARITY_PATH = "train/mamba2_370m", \
    "train/mamba2_370m_2l/fp32"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, TRAIN_VOCAB = \
    20, 4, 1024, 1e-3, 16
TRAIN_DROP, TRAIN_TIMED_FROM = 0.2, 2  # step ms: steps 3-20
CONV_FWD_PER_LAYER_STEP, CONV_BWD_PER_LAYER_STEP = 2, 1
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 2, 512
TRAIN_PARITY_STEPS, TRAIN_BOUND = 2, 1e-4
# the parameters after a step are held where the CPU's new first moment
# (the gradient at the first step) exceeds this share of its leaf's
# largest: Adam's m / (sqrt(v) + eps) makes a whole step of a near-zero
# entry's sign, and near zero it magnifies the gradients' rounding
# (tests/test_torch_train.py)
TRAIN_LIVE = 1e-3
# The mesh lines (after the training lines): the train step sharded by
# the rules over a (1, 1) ("data", "model") DeviceMesh on an NCCL group of
# one rank (no fallback to gloo). Its first 2 layers at full width in
# fp32: one sharded and one unsharded step from one state and batch, the
# loss, the grad norm and every gradient within MESH_BOUND of each one's
# largest; then mamba2-370m at full size (bf16 over fp32, AdamW), two
# sharded steps of 4 x 1024 tokens beside two unsharded ones, each
# sharded step launching causal_conv1d and causal_conv1d_bwd as the
# unsharded step does (inside local_map, on each rank's channel shard).
MESH_PATH, MESH_PARITY_PATH = "mesh/mamba2_370m", "mesh/mamba2_370m_2l/fp32"
MESH_STEPS, MESH_BOUND = 2, 2e-5
# Serving under the same mesh (inside the same NCCL group): the first 2
# layers in fp32 at batch 1 and PARITY_PROMPT, MESH_SERVE_STEPS decode
# steps, the sharded steps replayed through a sharded StepGraphs bitwise
# equal to the sharded eager steps and to the unsharded ones; then
# mamba2-370m at full size as the lm lines serve it (bf16, SERVE_BATCH x
# SERVE_PROMPT + SERVE_NEW greedy tokens), causal_conv1d launching once a
# Mamba layer per traced sharded prefill (inside local_map, on each
# rank's channel shard) and never on a replay.
MESH_SERVE_PATH = "mesh_serve/mamba2_370m"
MESH_SERVE_PARITY_PATH = "mesh_serve/mamba2_370m_2l/fp32"
MESH_SERVE_LAYERS, MESH_SERVE_STEPS = 2, 4
LM_PATHS.update({MESH_SERVE_PATH: "bfloat16",
                 MESH_SERVE_PARITY_PATH: "float32"})
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL_AT = 12, 4, 9
RESUME_BATCH, RESUME_SEQ = 2, 256
OPTIM_STEPS, OPTIM_BOUND = 3, 2e-5
# The training lines of every other LM family (after the mesh lines and
# the profiles, which free the serving paths' graphs and weights: before
# them an H100 80GB had ~29 GB left, and granite-moe-16L ran out of
# memory): each config at published widths, in its own
# compute dtype (bf16), weights, optimizer and remat, FAMILY_STEPS steps
# of TRAIN_BATCH x TRAIN_SEQ positions from TokenPipeline(TRAIN_VOCAB),
# peak lr FAMILY_LR; the loss's mean over the last FAMILY_MEAN steps below
# its first FAMILY_MEAN's by TRAIN_DROP. Depth is cut where two optimizer
# states and the gradients would not fit the card (``reduced`` says what
# the whole depth needs). The token-only families through
# launch.train.train (DeepSeek with one checkpoint at its last step, the
# others with none); the VLM (FAMILY_PREFIX patch embeddings before the
# rest of the positions' tokens) and the encoder-decoder (ENCDEC frames a
# row) through steps.make_train_step on the same pipeline's tokens. Only
# Jamba's Mamba layer launches port kernels (train_launches); the others
# launch none. path: (config, layers kept or None, entry)
FAMILY_TRAIN = {
    "train/qwen2_0_5b": ("qwen2-0.5b", None, "train"),
    "train/granite_moe_3b_16l": ("granite-moe-3b-a800m", 16, "train"),
    "train/deepseek_v2_1l": ("deepseek-v2-236b", 1, "train"),
    "train/jamba_1_5_large_1l": ("jamba-1.5-large-398b", 1, "train"),
    "train/internvl2_26b_2l": ("internvl2-26b", 2, "step"),
    "train/whisper_base": ("whisper-base", None, "step"),
}
# peak lr: TRAIN_LR, but 1e-4 for the three Adafactor lines (d_model
# 5120-8192): at 1e-3 DeepSeek-1L's and internvl2-2L's losses fell for two
# steps and climbed back past 11 (H100 80GB, 700 W), at 3e-4 internvl2-2L's
# did the same; Adafactor's update is clipped to an RMS of 1 a leaf, so
# every entry of a wide matrix moves by ~lr at once
FAMILY_LR = {"train/deepseek_v2_1l": 1e-4, "train/jamba_1_5_large_1l": 1e-4,
             "train/internvl2_26b_2l": 1e-4}
FAMILY_CKPT = "train/deepseek_v2_1l"
JAMBA_TRAIN_PATH = "train/jamba_1_5_large_1l"
FAMILY_STEPS, FAMILY_MEAN, FAMILY_PREFIX, ENCDEC_FRAMES = 6, 3, 256, 1500
# why a line's depth is cut, beside the state the whole depth needs
FAMILY_CUT = {
    "granite-moe-3b-a800m": "two copies of the optimizer state and the "
                            "gradients exceed 80 GB at full depth",
    "deepseek-v2-236b": "its second layer is the first MoE layer (160 "
                        "experts): two states, the gradients and "
                        "Adafactor's fp32 temporaries of the expert leaf "
                        "exceed 80 GB; layer 0 keeps MLA and the dense ffn",
    "jamba-1.5-large-398b": "its second layer's MoE (16 experts of d_ff "
                            "24576) alone brings the state and gradients "
                            "past 80 GB; layer 0 keeps the Mamba mixer and "
                            "the dense ffn",
    "internvl2-26b": "two copies of the optimizer state and the gradients "
                     "exceed 80 GB at full depth; 2 layers hold every "
                     "layer kind of the backbone",
}
# The fp32 parity lines of the same families (path + "/fp32"): full width,
# the least depth that holds every layer kind of the family (whisper 2
# encoder and 2 decoder layers), FAMILY_PARITY_SEQ tokens a row (128, not
# 256: at 256 the CPU's side of the six lines took 495 s on an H100's
# host; internvl2's FAMILY_PREFIX patch embeddings before them),
# ``train_parity``'s two steps on the card and on the port's CPU; qwen2
# with accum=2 (two rows, one a micro-batch), the others one row
FAMILY_PARITY = {"train/qwen2_0_5b": 2, "train/granite_moe_3b_16l": 2,
                 "train/deepseek_v2_1l": 1, "train/jamba_1_5_large_1l": 1,
                 "train/internvl2_26b_2l": 2, "train/whisper_base": 2}
FAMILY_PARITY_SEQ, FAMILY_PARITY_ACCUM = 128, {"train/qwen2_0_5b": 2}
# the train paths that launch causal_conv1d, with their steps, and those
# timed at a class of the kernel lines, with their compute dtypes
TIMED_TRAIN_STEPS = {TRAIN_PATH: TRAIN_STEPS, MESH_PATH: MESH_STEPS,
                     JAMBA_TRAIN_PATH: FAMILY_STEPS}
TRAIN_DTYPES = {TRAIN_PATH: "bfloat16", JAMBA_TRAIN_PATH: "bfloat16"}
# leaf names of an LM's parameters that no matrix product reads: norm
# scales and shifts, biases, the Mamba conv (counted on its own) and its
# per-head decay, skip and time-step bias
NOT_MATMUL = frozenset({"w", "b", "bq", "bk", "bv", "b1", "b2", "conv_w",
                        "conv_b", "A_log", "D", "dt_bias"})


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

    if kernel in CONV1D_KERNELS:
        B, L, C, K, row, lo = shape
        # the xBC slice of a wider in-projection output, as the model
        # passes it: rows `row` elements apart
        x = randn(B, L, row)[..., lo:lo + C]
        w = randn(K, C, scale=K ** -0.5)
        b = randn(C, scale=0.1)
        w_lib = w.t()[:, None]
        line = {"B": B, "L": L, "C": C, "K": K, "row_stride": row,
                "offset": lo}
        if kernel == "causal_conv1d":
            def library():
                return F.conv1d(x.transpose(1, 2), w_lib, b, padding=K - 1,
                                groups=C)[..., :L]
            # K multiplies and K adds (the bias's included) per output
            return dict(fn=causal_conv1d.causal_conv1d,
                        plain=causal_conv1d.plain, args=(x, w, b), kw={},
                        library=library, inputs=[x, w, b],
                        flops=2 * K * B * L * C, shape=line)
        dy = randn(B, L, C)
        tile = causal_conv1d.plan(B, L, C, K, dtype, causal_conv1d.align_bytes(
            dy, x, w), backward=True).steps
        # one cuDNN call: dy padded to the conv's L + K - 1 outputs, x
        # and the (C, 1, K) filter as F.conv1d takes them
        gy = F.pad(dy.transpose(1, 2), (0, K - 1)).contiguous()
        xt, wl = x.transpose(1, 2), w_lib.contiguous()

        def library():
            return torch.ops.aten.convolution_backward(
                gy, xt, wl, [C], [1], [K - 1], [1], False, [0], C,
                [True, True, True])

        def plain(dy, x, w, has_bias):
            return causal_conv1d.plain_bwd(dy, x, w, has_bias, tile)
        # dx: K multiplies and adds an element; dw: K; db: one add
        return dict(fn=causal_conv1d.causal_conv1d_bwd, plain=plain,
                    args=(dy, x, w, True), kw={}, library=library,
                    inputs=[dy, x, w], flops=(4 * K + 1) * B * L * C,
                    shape=line)

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
    (tiles a CTA, channels, unit bytes, threads and CTAs) and of the causal
    conv's forward and backward (channels a thread, steps a thread walks,
    threads a block, blocks, and the share of loads that re-read a halo).
    ``y`` is the call's output: (batch, M, N) for gemm, (B, Ho, Wo, K) for
    a conv."""
    from repro_torch.kernels import causal_conv1d, depthwise_conv, \
        direct_conv, fused_block, gemm, ilpm_conv, im2col_conv, libdnn_conv, \
        pointwise_conv, winograd_conv

    if kernel in CONV1D_KERNELS:
        x, w = args[:2] if kernel == "causal_conv1d" else args[1:3]
        B, L, C = x.shape
        p = causal_conv1d.plan(B, L, C, w.shape[0], x.dtype,
                               causal_conv1d.align_bytes(*args[:3]),
                               backward=kernel == "causal_conv1d_bwd")
        return {**p._asdict(),
                "halo_share": causal_conv1d.halo_share(p, L, w.shape[0])}
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
    # a backward returns (dx, dw, db): each held against the plain one's
    ys, ps = (y, p) if isinstance(y, tuple) else ((y,), (p,))
    err = max((a.float() - r.float()).abs().max().item()
              for a, r in zip(ys, ps))
    rel = max((a.float() - r.float()).abs().max().item()
              / r.float().abs().max().item() for a, r in zip(ys, ps))
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*case["inputs"], *ys))
    name = canonical(dtype)
    t_ops = case["flops"] / peaks[name]
    t_bytes = nbytes / peaks["mem_bw"]
    kernel_ms = time_ms(lambda: fn(*args, **kw))
    line = {
        "phase": "kernel", "kernel": kernel, "dtype": name,
        "shape": {**case["shape"], "out": [list(t.shape) for t in ys]
                  if len(ys) > 1 else list(y.shape)},
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
    if kernel in (*PLANNED_KERNELS, *CONV1D_KERNELS, "im2col_unroll",
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
        line["bitwise_equal"] = all(map(torch.equal, ys, ps))
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
        # the same server behind the wire, its graphs already captured
        lines.append(wire_part(server, host, truth, rounds[-1]))

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


def wire_part(server, host, truth, in_process):
    """The wire in front of the same ``Server``: a ``ServerEndpoint`` on
    127.0.0.1 and one ``AsyncClient`` sending the serving bursts across
    both networks in two rounds, every answer (float32 bytes off the
    socket) bitwise equal to ``engine.run`` of the same image on the same
    engine, then an unknown network, which must come back as
    ``BadRequest``. Per round, the client's latency (send to answer) and
    images/s, beside the in-process round ``in_process``."""
    import asyncio

    from repro_torch.serving import AsyncClient, BadRequest, ServerEndpoint

    want = {net: [t.cpu().numpy().tobytes() for t in truth[net]]
            for net in SERVE_NETS}

    async def drive(address):
        async with await AsyncClient.connect(*address) as client:
            async def one(net, i):
                t0 = time.perf_counter()
                out = await client.classify(net, host[i])
                return net, i, out, (time.perf_counter() - t0) * 1e3
            rounds = []
            for _ in range(SERVE_ROUNDS):
                t0, done = time.perf_counter(), []
                for n in SERVE_BURSTS:
                    done += await asyncio.wait_for(asyncio.gather(
                        *(one(net, i) for i in range(n)
                          for net in SERVE_NETS)), SERVE_WAIT)
                rounds.append((done, time.perf_counter() - t0))
            try:
                await asyncio.wait_for(
                    client.classify("not-a-network", host[0]), SERVE_WAIT)
                unknown = "answered"
            except BadRequest as e:
                unknown = type(e).__name__
            return rounds, unknown

    with ServerEndpoint(server, host="127.0.0.1") as endpoint:
        rounds, unknown = asyncio.run(drive(endpoint.address))
        served = endpoint.stats()["served"]
    bitwise = all(out.dtype.name == "float32"
                  and out.tobytes() == want[net][i]
                  for done, _ in rounds for net, i, out, _ in done)
    require(bitwise, "wire: an answer is not bitwise engine.run")
    require(unknown == "BadRequest",
            f"wire: an unknown network gave {unknown}, not BadRequest")
    per_round = []
    for r, (done, wall) in enumerate(rounds):
        lat = sorted(ms for *_, ms in done)
        per_round.append({
            "round": r, "requests": len(done), "wall_s": wall,
            "images_per_s": len(done) / wall,
            "latency_p50_ms": lat[round(0.50 * (len(lat) - 1))],
            "latency_p95_ms": lat[round(0.95 * (len(lat) - 1))],
            "latency_max_ms": lat[-1]})
    return {"phase": "serving", "part": "wire",
            "entry": "repro_torch.serving ServerEndpoint + AsyncClient",
            "host": "127.0.0.1", "networks": list(SERVE_NETS),
            "dtype": "float32", "bursts": list(SERVE_BURSTS),
            "max_batch": 4, "window_ms": server.window_ms,
            "rounds": per_round, "served": served,
            "bitwise_equal_engine_run": bitwise,
            "unknown_network": unknown,
            "in_process_round": {k: in_process[k] for k in (
                "round", "latency_p50_ms", "latency_p95_ms",
                "images_per_s")}}


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


def mamba_layers(cfg) -> int:
    """The Mamba mixers of a config's plan: causal_conv1d's launches in
    one prefill."""
    from repro_torch.models import lm

    return sum(mixer == "mamba" for mixer, _ in lm.layer_plan(cfg))


def conv1d_class(cfg, B, L):
    """causal_conv1d's shape class in a prefill of (B, L): (B, L, C, K,
    row stride, channel offset) of the xBC slice of the in-projection."""
    from repro_torch.models import ssm

    d_inner, G, N, P, H, Hg, conv_ch = ssm._dims(cfg)
    row = 2 * d_inner + 2 * G * N + H  # the in-projection's width
    return (B, L, conv_ch, cfg.ssm_conv_k, row, d_inner)


def conv1d_classes(cfg, hybrid, hybrid_parity):
    """causal_conv1d's shape classes -> {path: launches per prefill}: the
    prefill of each LM path (one launch a Mamba layer) of Mamba-2 and of
    the hybrid, and the edge lengths at Mamba-2's width, which no path
    launches."""
    classes = {conv1d_class(cfg, SERVE_BATCH, SERVE_PROMPT):
               {"mamba2_370m": mamba_layers(cfg),
                MESH_SERVE_PATH: mamba_layers(cfg)},
               conv1d_class(cfg, 1, PARITY_PROMPT):
               {"mamba2_370m/fp32": mamba_layers(cfg),
                MESH_SERVE_PARITY_PATH: MESH_SERVE_LAYERS}}
    for L in EDGE_LENGTHS:
        classes.setdefault(conv1d_class(cfg, 1, L), {})
    # after Mamba-2's, so those draw the inputs they drew before
    classes[conv1d_class(hybrid, SERVE_BATCH, SERVE_PROMPT)] = {
        HYBRID_PATH: mamba_layers(hybrid)}
    classes[conv1d_class(hybrid_parity, 1, PARITY_PROMPT)] = {
        HYBRID_PARITY_PATH: mamba_layers(hybrid_parity)}
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


def lm_prompts(cfg, batch, length, seed):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length))).cuda()


def _bounds(flops, nbytes, dtype, peaks):
    """{step: bound} from each step's operations and the bytes it must
    move: the larger of the two times."""
    out = {}
    for step, ops in flops.items():
        t_ops = ops / peaks[dtype]
        t_bytes = nbytes[step] / peaks["mem_bw"]
        out[step] = {"bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "flops": ops, "bytes": nbytes[step]}
    return out


def _nbytes(*trees):
    from repro_torch.models.spec import flatten

    return sum(v.numel() * v.element_size() for tree in trees
               for v in flatten(tree).values())


def active_matmul(cfg, params):
    """The weights of the segments' matrix products that a token visits:
    routed experts at ``top_k / num_experts`` of theirs (shared experts
    whole: ``count_params(active_only=True)``'s count)."""
    from repro_torch.models import lm
    from repro_torch.models.spec import flatten

    routed = {f"seg{si}.sub{j}.ffn.{w}"
              for si, (body, _) in enumerate(lm.segments(cfg))
              for j, (_, ffn) in enumerate(body) if ffn == "moe"
              for w in ("w1", "w2", "w3")}
    share = cfg.top_k / cfg.num_experts if cfg.num_experts else 1.0
    return sum(v.numel() * (share if k in routed else 1.0)
               for k, v in flatten(params).items() if k.startswith("seg")
               and k.rsplit(".", 1)[1] not in NOT_MATMUL)


def attention_pair_flops(cfg):
    """(operations a query-key pair costs every attention layer together
    at the widths the path computes: with the full scores, and in an
    absorbed MLA decode step). GQA: two products of ``head_dim`` a head;
    MLA: qk_nope + qk_rope for the scores and v_head_dim for the values,
    its absorbed decode kv_lora_rank + qk_rope and kv_lora_rank."""
    from repro_torch.models import lm

    H = cfg.num_heads
    pair = {"gqa": (4 * H * cfg.head_dim, 4 * H * cfg.head_dim),
            "mla": (2 * H * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                             + cfg.v_head_dim),
                    2 * H * (2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim))}
    plans = lm.layer_plan(cfg)
    return (sum(pair[m][0] for m, _ in plans if m in pair),
            sum(pair[m][1] for m, _ in plans if m in pair))


def ssd_flops(cfg, S):
    """(operations a position costs every Mamba layer together in a pass
    of S positions, and in a decode step): the SSD as the chunked scan
    computes it (the chunk's C Bᵀ scores, Q N a group, and their product
    with x, Q P a head, the chunk state and its readout, N P a head each;
    a decode step the state update and readout) and the K-tap conv."""
    from repro_torch.models import ssm

    if not mamba_layers(cfg):
        return 0, 0
    _, G, N, P, Hm, _, conv_ch = ssm._dims(cfg)
    Q, conv = min(cfg.ssd_chunk, S), 2 * cfg.ssm_conv_k * conv_ch
    return (mamba_layers(cfg) * (2 * (G * Q * N + Hm * Q * P + 2 * Hm * N * P)
                                 + conv),
            mamba_layers(cfg) * (4 * Hm * N * P + conv))


def lm_bounds(cfg, cparams, caches, B, S, Lc, peaks):
    """The least time of a decoder-only model's prefill of (B, S)
    positions and of one decode step against caches of ``Lc`` positions:
    the larger of the bytes (every weight in the compute dtype read once,
    the caches read or written once) over the card's memory rate, and the
    operations over the compute dtype's peak: the matrix products of the
    weights a token visits (routed experts at ``top_k / num_experts`` of
    theirs, shared experts whole: ``count_params(active_only=True)``'s
    count), the attention of every layer at the widths the path computes
    (GQA: two products of ``head_dim`` a head per query-key pair, the
    full scores in a prefill; MLA's prefill: qk_nope + qk_rope for the
    scores and v_head_dim for the values; its absorbed decode:
    kv_lora_rank + qk_rope and kv_lora_rank a cached position), every
    Mamba layer's SSD as the chunked scan computes it (per token the
    chunk's C Bᵀ scores, Q N a group, and their product with x, Q P a
    head, the chunk state and its readout, N P a head each; a decode
    step the state update and readout) and its K-tap conv, and the
    unembed of the positions the step scores. The dense MoE dispatch's
    two contractions with its (T, N, cap) tensor are the reference's way
    of routing, not work the function needs, and are not counted."""
    from repro_torch.models.layers import padded_vocab

    matmul = active_matmul(cfg, cparams)
    head = cfg.d_model * padded_vocab(cfg.vocab_size)
    attn_pre, attn_dec = attention_pair_flops(cfg)
    ssd_pre, ssd_dec = ssd_flops(cfg, S)
    flops = {"prefill": 2 * B * S * matmul + attn_pre * B * S * S
             + ssd_pre * B * S + 2 * B * head,
             "decode_step": 2 * B * (matmul + head) + attn_dec * B * Lc
             + ssd_dec * B}
    nbytes = _nbytes(cparams, caches)
    return _bounds(flops, {"prefill": nbytes, "decode_step": nbytes},
                   cfg.dtype, peaks)


def encdec_weights(params):
    """(the encoder's, the decoder's and the decoder's cross K and V
    projections') weights of matrix products: the cross K and V read the
    encoder's positions."""
    from repro_torch.models.spec import flatten

    leaves = {k: v for k, v in flatten(params).items()
              if k.rsplit(".", 1)[-1] not in NOT_MATMUL}
    cross = (".xattn.wk", ".xattn.wv")

    def total(prefix, keep):
        return sum(v.numel() for k, v in leaves.items()
                   if k.startswith(prefix) and keep(k.endswith(cross)))
    return (total("enc.", lambda _: True), total("dec.", lambda x: not x),
            total("dec.", lambda x: x))


def encdec_bounds(cfg, cparams, caches, frames, B, S, Lc, peaks):
    """The least time of an encoder-decoder's prefill (the encoder over
    the T frames, every decoder layer's cross K and V, the decoder over S
    tokens) and of one decode step (against ``Lc`` self positions and the
    T cross positions): the bytes (every weight in the compute dtype, the
    caches, the prefill's frames, each once) over the memory rate, or the
    operations of the matrix products (the weights a position visits,
    the attention's two products of ``head_dim`` a head per query-key
    pair, the unembed of the scored positions) over the compute dtype's
    peak."""
    from repro_torch.models.layers import padded_vocab

    enc, dec, xkv = encdec_weights(cparams)
    T = frames.shape[1]
    attn = 4 * cfg.num_heads * cfg.head_dim
    head = cfg.d_model * padded_vocab(cfg.vocab_size)
    L, Le = cfg.num_layers, cfg.num_encoder_layers
    flops = {"prefill": 2 * B * T * (enc + xkv) + Le * attn * B * T * T
             + 2 * B * S * dec + L * attn * B * (S * S + S * T)
             + 2 * B * head,
             "decode_step": 2 * B * (dec + head) + L * attn * B * (Lc + T)}
    nbytes = _nbytes(cparams, caches)
    return _bounds(flops, {"prefill": nbytes + _nbytes({"f": frames}),
                           "decode_step": nbytes}, cfg.dtype, peaks)


def moe_drops(cfg, cparams, prompts):
    """The (token, slot) entries the dense dispatch drops over one eager
    prefill of ``prompts``: ``layers.moe`` wrapped to count, in each MoE
    layer, the entries at or past their expert's capacity (the same
    router, top-k and slot count as the call it wraps)."""
    from repro_torch.launch import steps
    from repro_torch.models import layers as L

    B, S = prompts.shape
    require(cfg.moe_dispatch == "dense"
            or B * S * cfg.num_experts <= L._DENSE_MAX,
            f"{cfg.name}: a prefill of {B}x{S} takes the sorted dispatch")
    cap = L.capacity(cfg, B * S)
    dropped, moe = [], L.moe

    def counting(p, c, x):
        _, _, idx = L.route(p, c, x)
        _, inside = L.dense_slots(idx.reshape(B * S, -1), c.num_experts,
                                  cap)
        dropped.append(int((~inside).sum()))
        return moe(p, c, x)
    L.moe = counting
    try:
        with torch.inference_mode():
            steps.prefill_step(cparams, cfg, prompts)
    finally:
        L.moe = moe
    return {"capacity_factor": cfg.capacity_factor, "capacity": cap,
            "entries_per_layer": B * S * cfg.top_k,
            "dropped_per_layer": dropped, "dropped": sum(dropped),
            "dropped_share": sum(dropped) / (B * S * cfg.top_k
                                             * len(dropped))}


def prefix_len(inputs) -> int:
    """The positions before the tokens: a VLM's patch embeddings."""
    p = inputs.get("prefix_embeds")
    return 0 if p is None else p.shape[1]


def greedy_tokens(cfg, params, prompts, inputs, new, cache_len, **kw):
    """Greedy tokens (B, new), int32: ``serve.generate`` for a prompt of
    tokens alone (``kw`` its ``graphs`` or ``replay``); with an
    encoder-decoder's ``frames`` or a VLM's ``prefix_embeds``, which
    ``generate`` does not take, the same loop on ``kw["graphs"]`` (a
    ``StepGraphs``) or, with ``replay=False``, on the eager steps."""
    from repro_torch.launch import serve, steps

    if not inputs:
        return serve.generate(cfg, params, prompts, max_new=new,
                              cache_len=cache_len, **kw)
    graphs, start = kw.get("graphs"), prompts.shape[1] + prefix_len(inputs)
    require(graphs is not None or kw.get("replay") is False,
            "greedy_tokens: pass graphs= or replay=False")
    with torch.inference_mode():
        if graphs is not None:
            logits, caches = graphs.prefill(prompts, cache_len, **inputs)

            def step(tok, pos):
                return graphs.decode(tok, caches, pos)
        else:
            cparams = steps.compute_params(params, cfg)
            logits, caches = steps.prefill_step(cparams, cfg, prompts,
                                                cache_len=cache_len,
                                                **inputs)

            def step(tok, pos):
                nonlocal caches
                logits, caches = steps.decode_step(cparams, cfg, tok,
                                                   caches, pos)
                return logits
        outs = [vocab_logits(logits[:, -1], cfg).argmax(-1).to(torch.int32)]
        for i in range(new - 1):
            logits = step(outs[-1][:, None], start + i)
            outs.append(vocab_logits(logits[:, 0], cfg).argmax(-1).to(
                torch.int32))
    return torch.stack(outs, dim=1)


def lm_serve_phase(path, cfg, params, counters, peaks, inputs=None,
                   prompt=SERVE_PROMPT, cache_len=None):
    """Greedy serving at the config's published dtype: batch 4, a prompt
    of ``prompt`` tokens (after a VLM's patch embeddings, ``inputs``'
    ``prefix_embeds``; an encoder-decoder reads ``inputs``' ``frames``),
    32 greedy tokens, replayed as CUDA graphs (``steps.StepGraphs``) and
    eagerly (``replay=False``) beside it: through ``generate`` for tokens
    alone, else ``greedy_tokens``' loop on the same steps. Required: the
    kernel launches per traced prefill (``causal_conv1d`` one a Mamba
    layer, none for an attention-only model) at the capture run and none
    on a second, replayed run; the replayed tokens equal to the eager
    ones; the prefill's and each step's logits, teacher-forced on those
    tokens, bitwise equal between replay and eager. Timed: prefill ms and
    decode ms per token both ways, and whole greedy runs. Profiles of one
    replayed and one eager step and one replayed prefill come back as
    thunks, for the caller to run after every timed LM line (a profiler
    session slows later graph replays), or to drop. A model with Mamba
    layers has its prefill logits also held against the conv's plain
    version (``impl="torch"``) on the card; a model with attention layers
    carries its prefill and decode bounds."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.launch import steps

    torch.cuda.reset_peak_memory_stats()
    inputs = inputs or {}
    mamba = mamba_layers(cfg)
    per_prefill = {**NO_LAUNCHES, **({"causal_conv1d": mamba}
                                     if mamba else {})}
    B, S, new = SERVE_BATCH, prompt, SERVE_NEW
    prompts = lm_prompts(cfg, B, S, seed=1)
    start = S + prefix_len(inputs)  # the first decode position
    cache_len = cache_len or start + new
    graphs = steps.StepGraphs(cfg, params)

    def generate(**kw):
        return greedy_tokens(cfg, params, prompts, inputs, new, cache_len,
                             **kw)
    zero_counts(counters)
    tokens = generate(graphs=graphs)  # captures both graphs
    torch.cuda.synchronize()
    traced = read_counts(counters)
    require(traced == {k: v * graphs.prefills
                       for k, v in per_prefill.items()},
            f"{path}: launches at capture {traced} over {graphs.prefills} "
            f"traced prefills, want {per_prefill} each")
    zero_counts(counters)
    again = generate(graphs=graphs)
    torch.cuda.synchronize()
    on_replay = read_counts(counters)
    require(on_replay == NO_LAUNCHES, f"{path}: launches on replay "
                                      f"{on_replay}")
    require(torch.equal(again, tokens), f"{path}: a second replayed "
                                        "generate gave other tokens")
    zero_counts(counters)
    eager_tokens = generate(replay=False)
    torch.cuda.synchronize()
    eager_launches = read_counts(counters)
    require(eager_launches == per_prefill, f"{path}: eager launches over a "
            f"prefill and {new - 1} steps {eager_launches}, want "
            f"{per_prefill}")
    require(tuple(tokens.shape) == (B, new) and tokens.dtype == torch.int32
            and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
            f"{path}: bad tokens {tuple(tokens.shape)} {tokens.dtype}")
    require(torch.equal(tokens, eager_tokens),
            f"{path}: replayed tokens differ from eager ones")

    # teacher-forced on the replayed tokens: each step both ways, bitwise;
    # the eager steps read the graphs' weights (compute_params' values)
    cparams = graphs.params
    prefill_ms = {"replay": [], "eager": []}
    decode_ms = {"replay": [], "eager": []}
    with torch.inference_mode():
        for _ in range(3):
            t, (rlog, rcaches) = host_ms(lambda: graphs.prefill(
                prompts, cache_len, **inputs))
            prefill_ms["replay"].append(t)
            first = rlog.clone()
            t, (elog, ecaches) = host_ms(lambda: steps.prefill_step(
                cparams, cfg, prompts, cache_len=cache_len, **inputs))
            prefill_ms["eager"].append(t)
        bitwise = [torch.equal(first, elog)]
        for i in range(new - 1):
            tok = tokens[:, i:i + 1]
            t, rlog = host_ms(lambda: graphs.decode(tok, rcaches, start + i))
            decode_ms["replay"].append(t)
            t, (elog, ecaches) = host_ms(lambda: steps.decode_step(
                cparams, cfg, tok, ecaches, start + i))
            decode_ms["eager"].append(t)
            bitwise.append(torch.equal(rlog, elog))
        require(all(bitwise), f"{path}: replayed logits not bitwise eager "
                f"at steps {[i for i, b in enumerate(bitwise) if not b]}")
        require(bool(torch.isfinite(vocab_logits(first, cfg)).all()),
                f"{path}: non-finite prefill logits")
        if mamba:
            plain, _ = steps.prefill_step(cparams, cfg, prompts,
                                          impl="torch", **inputs)
    generate_ms = {"replay": [host_ms(lambda: generate(graphs=graphs))[0]
                              for _ in range(3)],
                   "eager": [host_ms(lambda: generate(replay=False))[0]
                             for _ in range(3)]}
    tok, pos = tokens[:, -2:-1], start + new - 2

    def profiled(fn):
        def run():
            with torch.inference_mode():
                return device_profile(fn)
        return run
    profiles = {"decode_step_replay": profiled(
                    lambda: graphs.decode(tok, rcaches, pos)),
                "decode_step_eager": profiled(lambda: steps.decode_step(
                    cparams, cfg, tok, ecaches, pos)),
                "prefill_replay": profiled(
                    lambda: graphs.prefill(prompts, cache_len, **inputs))}
    line = {"phase": "lm", "path": path, "config": cfg.name,
            "entry": "repro_torch.launch.steps.StepGraphs prefill / decode"
                     if inputs else "repro_torch.launch.serve.generate",
            "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "batch": B, "prompt": S,
            **{f"{k}_shape": list(v.shape) for k, v in inputs.items()},
            "first_decode_position": start, "cache_len": cache_len,
            "new_tokens": new, "greedy": True, "graphs": graphs.graphs,
            "prefills_traced": graphs.prefills,
            "steps_traced": graphs.steps, "launches_at_capture": traced,
            "launches_per_traced_prefill": {
                k: v / graphs.prefills for k, v in traced.items()},
            "launches_on_replay": on_replay,
            "launches_eager": eager_launches,
            "tokens_replay_equal_eager": True,
            "logits_replay_bitwise_equal_eager": all(bitwise),
            "steps_compared": len(bitwise)}
    for how in ("replay", "eager"):
        line[f"prefill_ms_{how}"] = statistics.median(prefill_ms[how])
        line[f"decode_ms_per_token_{how}"] = statistics.median(
            decode_ms[how])
        line[f"generate_ms_{how}"] = statistics.median(generate_ms[how])
        line[f"tokens_per_s_{how}"] = \
            B * new / line[f"generate_ms_{how}"] * 1e3
    line.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
                generate_ms=generate_ms)
    if mamba:
        rel = rel_err(vocab_logits(first, cfg), vocab_logits(plain, cfg))
        require(rel <= tolerance(cfg.dtype), f"{path}: prefill logits with "
                f"the kernel vs the plain conv on the card: {rel}")
        line.update(vs_plain_conv_max_rel_err=rel,
                    vs_plain_conv_bitwise_equal=torch.equal(
                        vocab_logits(first, cfg), vocab_logits(plain, cfg)),
                    tol=tolerance(cfg.dtype))
    if cfg.is_encoder_decoder:
        line["bounds"] = encdec_bounds(cfg, cparams, rcaches,
                                       inputs["frames"], B, S, cache_len,
                                       peaks)
    elif mamba < cfg.num_layers:
        line["bounds"] = lm_bounds(cfg, cparams, rcaches, B, start,
                                   cache_len, peaks)
    if cfg.num_experts:
        line["moe_drops"] = moe_drops(cfg, cparams, prompts)
    line["sample_tokens"] = tokens[0, :8].tolist()
    line["device_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return line, profiles


def parity_phase(path, cfg, params, counters, inputs=None):
    """The model in fp32 at full width: batch 1, prompt 300 (after a
    VLM's patch embeddings; an encoder-decoder reads its frames), 8
    greedy decode steps on the card through the graphs, an eager step
    beside each (the logits bitwise equal), the counters set to 0 before
    and read after; the logits of the prefill and of every step against
    the port on the CPU fed the same tokens, within ENGINE_REL_BOUND;
    greedy serving on the card (``generate``, or ``greedy_tokens``' loop
    with ``inputs``), replayed through the same graphs and eager, gives
    the same tokens."""
    from repro_torch.launch import steps
    from repro_torch.models.spec import flatten, unflatten

    torch.cuda.reset_peak_memory_stats()
    cfg = cfg.replace(dtype="float32")
    inputs = inputs or {}
    per_prefill = {**NO_LAUNCHES, **({"causal_conv1d": mamba_layers(cfg)}
                                     if mamba_layers(cfg) else {})}
    S = PARITY_PROMPT
    start = S + prefix_len(inputs)
    prompts = lm_prompts(cfg, 1, S, seed=2)
    cache_len = start + PARITY_STEPS
    graphs = steps.StepGraphs(cfg, params)
    card, fed, step_ms, bitwise = [], [], [], []
    zero_counts(counters)
    with torch.inference_mode():
        t, (logits, caches) = host_ms(lambda: graphs.prefill(
            prompts, cache_len, **inputs))
        step_ms.append(t)
        elog, ecaches = steps.prefill_step(graphs.params, cfg, prompts,
                                           cache_len=cache_len, **inputs)
        bitwise.append(torch.equal(logits, elog))
        card.append(logits.clone())
        for i in range(PARITY_STEPS):
            fed.append(vocab_logits(card[-1][:, -1], cfg).argmax(-1)[:, None])
            t, logits = host_ms(lambda: graphs.decode(fed[-1], caches,
                                                      start + i))
            step_ms.append(t)
            elog, ecaches = steps.decode_step(graphs.params, cfg, fed[-1],
                                              ecaches, start + i)
            bitwise.append(torch.equal(logits, elog))
            card.append(logits.clone())
    torch.cuda.synchronize()
    launches = read_counts(counters)
    want = {k: v * (graphs.prefills + 1) for k, v in per_prefill.items()}
    require(launches == want, f"{path}: launches {launches} over "
            f"{graphs.prefills} traced prefills and one eager, want {want}")
    require(all(bitwise), f"{path}: replayed logits not bitwise eager at "
            f"steps {[i for i, b in enumerate(bitwise) if not b]}")
    greedy = torch.cat(
        fed + [vocab_logits(card[-1][:, -1], cfg).argmax(-1)[:, None]], dim=1)
    traced = graphs.prefills  # those the counts above cover
    tokens = greedy_tokens(cfg, params, prompts, inputs, PARITY_STEPS + 1,
                           cache_len + 1, graphs=graphs)
    require(torch.equal(tokens.long(), greedy), f"{path}: generate's "
            "tokens (replayed) differ from the steps' greedy ones")
    # eager once the graphs are gone: at fp32 over bf16 storage each holds
    # a cast copy of the weights
    del graphs, ecaches, caches, logits, elog
    tokens = greedy_tokens(cfg, params, prompts, inputs, PARITY_STEPS + 1,
                           cache_len + 1, replay=False)
    require(torch.equal(tokens.long(), greedy), f"{path}: generate's "
            "tokens (eager) differ from the steps' greedy ones")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cpu_params = steps.compute_params(
        unflatten({k: v.cpu() for k, v in flatten(params).items()}), cfg)
    cpu_inputs = {k: v.cpu() for k, v in inputs.items()}
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, caches = steps.prefill_step(cpu_params, cfg, prompts.cpu(),
                                            cache_len=cache_len,
                                            **cpu_inputs)
        cpu = [logits]
        for i, tok in enumerate(fed):
            logits, caches = steps.decode_step(cpu_params, cfg, tok.cpu(),
                                               caches, start + i)
            cpu.append(logits)
    cpu_s = time.perf_counter() - t0
    errs = [rel_err(vocab_logits(a.cpu(), cfg), vocab_logits(b, cfg))
            for a, b in zip(card, cpu)]
    require(all(bool(torch.isfinite(vocab_logits(a, cfg)).all())
                for a in card), f"{path}: non-finite logits")
    require(max(errs) <= ENGINE_REL_BOUND, f"{path}: card vs cpu logits "
            f"{errs} > {ENGINE_REL_BOUND}")
    return {"phase": "lm", "path": path, "config": cfg.name,
            "entry": "repro_torch.launch.steps.StepGraphs prefill / decode "
                     "beside prefill_step / decode_step, and serve.generate"
                     if not inputs else "repro_torch.launch.steps.StepGraphs"
                     " prefill / decode beside prefill_step / decode_step",
            "dtype": cfg.dtype, "layers": cfg.num_layers, "batch": 1,
            "prompt": S, **{f"{k}_shape": list(v.shape)
                            for k, v in inputs.items()},
            "decode_steps": PARITY_STEPS, "launches": launches,
            "prefills_traced": traced,
            "logits_replay_bitwise_equal_eager": all(bitwise),
            "max_rel_err_vs_cpu": max(errs),
            "rel_err_vs_cpu_per_step": errs, "bound": ENGINE_REL_BOUND,
            "prefill_ms_replay": step_ms[0],
            "decode_ms_per_token_replay": statistics.median(step_ms[1:]),
            "cpu_s": cpu_s, "device_peak_gb": peak_gb,
            "tokens": greedy[0].tolist()}


def chunked_attention_phase(cfg):
    """One ``layers.attention`` call at the model's head shape (fp32,
    batch 1, causal) with Sq = Sk = CHUNKED_SEQ, above ``_FULL_THRESH``,
    so it takes the online softmax over KV chunks of ``cfg.attn_chunk``:
    required bitwise equal to ``_attend_chunked`` and within
    ``tolerance(fp32)`` of ``_attend_full`` on the same inputs. No model
    path on the card reaches the chunked path otherwise."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.models import layers as L

    S, H, KV, D = CHUNKED_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    require(S * S > L._FULL_THRESH, "chunked attention: below the threshold")
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((1, S, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((1, S, KV, D), generator=gen, device="cuda")
            for _ in range(2))
    pos = torch.arange(S, device="cuda")[None]
    kw = dict(causal=True, q_pos=pos, kv_pos=pos, scale=D ** -0.5)
    with torch.inference_mode():
        ms, out = host_ms(lambda: L.attention(q, k, v, causal=True,
                                              q_pos=pos, kv_pos=pos,
                                              chunk=cfg.attn_chunk))
        ke, ve = (torch.repeat_interleave(t, H // KV, dim=2) for t in (k, v))
        chunked = L._attend_chunked(q, ke, ve, chunk=cfg.attn_chunk, **kw)
        full_ms, full = host_ms(lambda: L._attend_full(q, ke, ve, **kw))
    rel = rel_err(out, full)
    require(torch.equal(out, chunked), "chunked attention: attention() did "
                                       "not take the chunked path")
    require(bool(torch.isfinite(out).all()) and rel <= tolerance("float32"),
            f"chunked attention vs full on the card: {rel}")
    return {"phase": "lm", "part": "chunked_attention", "config": cfg.name,
            "dtype": "float32", "shape": [1, S, H, KV, D],
            "chunk": cfg.attn_chunk, "chunks": -(-S // cfg.attn_chunk),
            "full_thresh": L._FULL_THRESH, "max_rel_err_vs_full": rel,
            "tol": tolerance("float32"), "ms_chunked": ms,
            "ms_full": full_ms}


def moe_dispatch_phase(cfg, params, drops):
    """The first MoE layer of ``cfg`` at full width in fp32 (its stored
    weights cast), on DISPATCH_BATCH x DISPATCH_SEQ tokens drawn from a
    seeded generator, with capacity factor DISPATCH_CF so that neither
    dispatch drops an entry: ``_moe_scatter_dispatch`` on the router's
    top-k against ``moe``'s dense dispatch, within tolerance("float32"),
    on the card. ``drops`` is the serving line's count of the entries the
    dense dispatch dropped at the config's own capacity factor. Also the
    slot count's time at the serving prompt's entries (graph replay):
    ``dense_slots``' scan along the innermost axis against the reference's
    op order, a scan along an outer axis, the same integers."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.spec import flatten, unflatten

    (si, j, n), = [(si, j, n) for si, (body, n) in enumerate(lm.segments(cfg))
                   for j, (_, ffn) in enumerate(body) if ffn == "moe"][:1]
    tree = params[f"seg{si}"][f"sub{j}"]["ffn"]
    p = unflatten({k: (v[0] if n > 1 else v).float()
                   for k, v in flatten(tree).items()})
    c = cfg.replace(dtype="float32", capacity_factor=DISPATCH_CF,
                    num_shared_experts=0)
    B, S, E, N = DISPATCH_BATCH, DISPATCH_SEQ, cfg.d_model, cfg.num_experts
    require(B * S * N <= L._DENSE_MAX, "moe_dispatch: moe() would not take "
                                       "the dense dispatch")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((B, S, E), generator=gen, device="cuda") * 0.3
    with torch.inference_mode():
        dense_ms, (y_dense, aux) = host_ms(lambda: L.moe(p, c, x))
        _, gate, idx = L.route(p, c, x)
        sorted_ms, y_sorted = host_ms(
            lambda: L._moe_scatter_dispatch(p, c, x, idx, gate))
        cap = L.capacity(c, B * S)
        _, inside = L.dense_slots(idx.reshape(B * S, -1), N, cap)
        row_cap = L.capacity(c, S)
        row_load = (idx.reshape(B, -1)[..., None]
                    == torch.arange(N, device="cuda")).sum(1)
    # the slot count at the serving prompt (T = 4 x 1024): the port's scan
    # along the innermost axis against the reference's op order, a scan
    # along the entries of a (T * k, N) one-hot
    T, k = SERVE_BATCH * SERVE_PROMPT, c.top_k
    sidx = torch.argsort(torch.rand((T, N), generator=gen, device="cuda"),
                         dim=-1)[:, :k]

    def outer_scan():
        onehot = (sidx[..., None] == torch.arange(N, device="cuda")).to(
            torch.int32)
        run = torch.cumsum(onehot.reshape(T * k, N), dim=0).reshape(
            T, k, N) - 1
        return (run * onehot).sum(-1)
    require(torch.equal(outer_scan(), L.dense_slots(sidx, N, cap)[0]),
            "moe_dispatch: the slots differ from the reference's op order")
    slots_ms = {"entries": [T * k, N],
                "innermost_scan": time_ms(lambda: L.dense_slots(sidx, N,
                                                                cap)),
                "outer_scan": time_ms(outer_scan)}
    rel = rel_err(y_sorted, y_dense)
    require(bool(inside.all()) and int(row_load.max()) <= row_cap,
            "moe_dispatch: an entry dropped at capacity factor "
            f"{DISPATCH_CF}")
    require(bool(torch.isfinite(y_dense).all()) and rel <= tolerance(
        "float32"), f"moe_dispatch: sorted vs dense dispatch {rel}")
    return {"phase": "lm", "part": "moe_dispatch", "config": cfg.name,
            "layer": f"seg{si}.sub{j}" + ("[0]" if n > 1 else ""),
            "dtype": "float32", "batch": B, "seq": S, "experts": N,
            "top_k": c.top_k, "capacity_factor": DISPATCH_CF,
            "dense_capacity": cap, "sorted_capacity_per_row": row_cap,
            "max_expert_load_per_row": int(row_load.max()),
            "sorted_vs_dense_max_rel_err": rel, "tol": tolerance("float32"),
            "aux": float(aux), "dense_ms_eager": dense_ms,
            "sorted_ms_eager": sorted_ms, "dense_slots_ms": slots_ms,
            "dense_drops_at_serving_prompt": drops}


def frontend_phase(part, fn, args, out_shape, peaks, flops):
    """One frontend at its published shape in fp32 on the card (its
    parameters and input drawn on the host from seeds, then moved):
    ``fn(*args)`` against the same call on the CPU within
    ENGINE_REL_BOUND (the products sum in another order on the card),
    its device time (graph replay) and the least time the card could
    take (the input, the parameters and the output moved once, or
    ``flops`` at the fp32 peak)."""
    from repro_torch.models.spec import flatten

    with torch.inference_mode():
        y = fn(*args)
        cpu = fn(*(({k: v.cpu() for k, v in a.items()}
                    if isinstance(a, dict) else a.cpu() if
                    isinstance(a, torch.Tensor) else a) for a in args))
        ms = time_ms(lambda: fn(*args))
    rel = rel_err(y.cpu(), cpu)
    require(tuple(y.shape) == out_shape and bool(torch.isfinite(y).all())
            and rel <= ENGINE_REL_BOUND, f"{part}: shape {tuple(y.shape)} "
            f"want {out_shape}, card vs cpu {rel}")
    nbytes = sum(v.numel() * v.element_size()
                 for a in args if isinstance(a, (dict, torch.Tensor))
                 for v in (flatten(a).values() if isinstance(a, dict)
                           else [a])) + y.numel() * y.element_size()
    t_ops, t_bytes = flops / peaks["float32"], nbytes / peaks["mem_bw"]
    return {"phase": "lm", "part": part, "dtype": "float32",
            "input_shape": [list(a.shape) for a in args
                            if isinstance(a, torch.Tensor)],
            "output_shape": list(y.shape), "max_rel_err_vs_cpu": rel,
            "bound": ENGINE_REL_BOUND, "ms": ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def conv1d_summary(rows, launches, peaks, grad_lines, train_launches):
    """The ``kernels`` entry of causal_conv1d: each LM path's class in the
    path's dtype times its launches per prefill, summed over the paths
    and per path; ``launches`` maps each path to its main-path run's
    counts and the prefills they cover (the traced ones, and the parity
    path's eager one). ``train`` adds the training paths: their forward
    launches (``train_launches``, one run each) and a step's, and the
    forward plus backward times of the gradient line (``grad_lines``) a
    dtype."""
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
        "launches": sum(n["causal_conv1d"] for n, _ in launches.values())
        + sum(n["causal_conv1d"] for n in train_launches.values()),
        "launches_per_prefill": {
            path: n["causal_conv1d"] / k for path, (n, k) in launches.items()},
        "parity": "ok", "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_prefill_sum("kernel_ms"),
        "plain_ms": per_prefill_sum("plain_ms"),
        "bound_ms": per_prefill_sum("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": per_prefill_sum("library_ms"),
        "per_path": {path: {
            key: per_prefill_sum(key, path=path)
            for key in ("kernel_ms", "bound_ms", "plain_ms", "library_ms")}
            for path in launches},
        "train": {
            "launches": {path: n["causal_conv1d"]
                         for path, n in train_launches.items()},
            "launches_per_step": {
                path: train_launches[path]["causal_conv1d"] / n
                for path, n in TIMED_TRAIN_STEPS.items()},
            "fwd_bwd_at": [TRAIN_BATCH, TRAIN_SEQ],
            "fwd_bwd": {r["dtype"]: {
                "ms": r["fwd_bwd_ms"], "plain_ms": r["plain_fwd_bwd_ms"],
                "library_ms": r["library_fwd_bwd_ms"],
                "bound_ms": r["bound_ms"], "max_abs_err": r["max_abs_err"]}
                for r in grad_lines}}}


def conv1d_bwd_summary(rows, train_launches, peaks):
    """The ``kernels`` entry of causal_conv1d_bwd: each train path's class
    (its line in the path's dtype, ``TRAIN_DTYPES``) times its launches a
    step (one a Mamba layer), summed over the paths and per path, with
    one call's times at each class and dtype; ``launches`` the training
    runs' counts (``train_launches``)."""
    source, replaces = KERNEL_INFO["causal_conv1d_bwd"]
    step_rows = [r for r in rows if r["launches_per_step"]]

    def per_step_sum(key, path=None):
        return sum(r[key] * n for r in step_rows
                   for p, n in r["launches_per_step"].items()
                   if r["dtype"] == TRAIN_DTYPES[p] and path in (None, p))
    t_ops = sum(r["flops"] * n / peaks[r["dtype"]] for r in step_rows
                for p, n in r["launches_per_step"].items()
                if r["dtype"] == TRAIN_DTYPES[p])
    t_bytes = per_step_sum("bytes") / peaks["mem_bw"]
    keys = ("kernel_ms", "bound_ms", "plain_ms", "library_ms")
    return {
        "name": "causal_conv1d_bwd", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(t["causal_conv1d_bwd"]
                        for t in train_launches.values()),
        "launches_per_step": {
            path: train_launches[path]["causal_conv1d_bwd"] / n
            for path, n in TIMED_TRAIN_STEPS.items()},
        "train": {path: t["causal_conv1d_bwd"]
                  for path, t in train_launches.items()},
        "parity": "ok", "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_step_sum("kernel_ms"), "plain_ms": per_step_sum("plain_ms"),
        "bound_ms": per_step_sum("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": per_step_sum("library_ms"),
        "per_path": {path: {key: per_step_sum(key, path) for key in keys}
                     for path in TRAIN_DTYPES},
        "per_call": {"{B}x{L}x{C} ".format(**r["shape"]) + r["dtype"]: {
            key: r[key] for key in (*keys, "frac_of_bound")}
            for r in step_rows}}


def hybrid_vlm_encdec(hcfg, h2cfg, counters, peaks, lm_launches, profiles):
    """The new LM lines, before Mamba-2's: jamba's 5-layer cut served and
    its first 2 layers in fp32, internvl2's backbone served and its first
    8 layers in fp32, whisper-base served and in fp32, then the audio
    stem and the ViT patch embed. Each model's weights are freed before
    the next is drawn, and no profile keeps jamba's 48 GB or internvl2's
    40 GB for the end (whisper's is kept, in ``profiles``); the hybrid's
    causal_conv1d counts go into ``lm_launches``."""
    from repro_torch.configs import get
    from repro_torch.launch import steps
    from repro_torch.models import frontends
    from repro_torch.models.spec import flatten, init_params, unflatten

    full = get(HYBRID_CONFIG).num_layers
    t0 = time.perf_counter()
    hparams = steps.init_params(hcfg, 0, "cuda")
    draw_s = time.perf_counter() - t0
    line, thunks = lm_serve_phase(HYBRID_PATH, hcfg, hparams, counters,
                                  peaks)
    lm_launches[HYBRID_PATH] = (line["launches_at_capture"],
                                line["prefills_traced"])
    emit({**line, "reduced": {"num_layers": f"{full} -> {HYBRID_LAYERS}"},
          "parameters": hcfg.num_params(), "draw_s": draw_s})
    del line, thunks
    # its first two layers in fp32: the same weights (a leaf's draw is
    # seeded by its path), the other three layers freed, each leaf cast
    # as its bf16 copy goes
    flat = flatten({"embed": hparams["embed"], "ln_f": hparams["ln_f"],
                    "seg0": {f"sub{j}": hparams["seg0"][f"sub{j}"]
                             for j in range(HYBRID_PARITY_LAYERS)}})
    del hparams
    for key in flat:
        flat[key] = flat[key].float()
    torch.cuda.empty_cache()
    h2params = unflatten(flat)
    del flat
    line = parity_phase(HYBRID_PARITY_PATH, h2cfg, h2params, counters)
    lm_launches[HYBRID_PARITY_PATH] = (line["launches"],
                                       line["prefills_traced"] + 1)
    emit({**line, "reduced": {
        "num_layers": f"{full} -> {HYBRID_PARITY_LAYERS}",
        "param_dtype": "bfloat16 -> float32 (the serving line's weights)"},
        "parameters": h2cfg.num_params()})
    del h2params
    torch.cuda.empty_cache()
    # the VLM backbone at published widths and depth in bf16 storage, fed
    # patch embeddings at the token embeddings' scale
    vcfg = get(VLM_CONFIG).replace(param_dtype="bfloat16")
    t0 = time.perf_counter()
    vparams = steps.init_params(vcfg, 0, "cuda")
    draw_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(6)
    prefix = torch.randn((SERVE_BATCH, vcfg.frontend_tokens, vcfg.d_model),
                         generator=gen, device="cuda") * 0.02
    line, thunks = lm_serve_phase(
        "internvl2_26b", vcfg, vparams, counters, peaks,
        inputs={"prefix_embeds": prefix}, prompt=VLM_PROMPT)
    emit({**line, "reduced": {"param_dtype": "float32 -> bfloat16"},
          "parameters": vcfg.num_params(), "draw_s": draw_s})
    del line, thunks
    v8cfg = vcfg.replace(num_layers=VLM_PARITY_LAYERS, param_dtype="float32")
    flat = {k: (v[:VLM_PARITY_LAYERS] if k.startswith("seg") else v).float()
            for k, v in flatten(vparams).items()}
    del vparams
    torch.cuda.empty_cache()
    v8params = unflatten(flat)
    del flat
    emit({**parity_phase("internvl2_26b/fp32", v8cfg, v8params, counters,
                         inputs={"prefix_embeds": prefix[:1]}),
          "reduced": {"num_layers": f"{vcfg.num_layers} -> "
                                    f"{VLM_PARITY_LAYERS}",
                      "param_dtype": "bfloat16 -> float32 (the serving "
                                     "line's first layers)"},
          "parameters": v8cfg.num_params()})
    del v8params, prefix
    torch.cuda.empty_cache()
    # the encoder-decoder at full size, then both frontends
    wcfg = get(ENCDEC_CONFIG)
    wparams = steps.init_params(wcfg, 0, "cuda")
    frames = torch.randn((SERVE_BATCH, wcfg.encoder_seq, wcfg.d_model),
                         generator=gen, device="cuda")
    line, thunks = lm_serve_phase(
        "whisper_base", wcfg, wparams, counters, peaks,
        inputs={"frames": frames}, prompt=ENCDEC_PROMPT,
        cache_len=ENCDEC_CACHE)
    profiles.append((line["path"], thunks))
    emit({**line, "parameters": wcfg.num_params()})
    emit(parity_phase("whisper_base/fp32", wcfg, wparams, counters,
                      inputs={"frames": frames[:1]}))
    stem = init_params(frontends.audio_stem_specs(wcfg, n_mels=MEL_BINS), 0,
                       "float32", device="cuda")
    mel = torch.randn((1, MEL_FRAMES, MEL_BINS), generator=gen,
                      device="cuda")
    D, T2 = wcfg.d_model, MEL_FRAMES // 2
    emit(frontend_phase(
        "audio_stem", lambda p, m: frontends.audio_stem(p, wcfg, m),
        (stem, mel), (1, T2, D), peaks,
        flops=2 * 3 * (MEL_FRAMES * MEL_BINS * D + T2 * D * D)))
    patch = init_params(frontends.vit_patch_specs(vcfg, patch=PATCH), 0,
                        "float32", device="cuda")
    image = torch.randn((1, IMAGE_SIDE, IMAGE_SIDE, 3), generator=gen,
                        device="cuda")
    n = (IMAGE_SIDE // PATCH) ** 2
    emit(frontend_phase(
        "vit_patch_embed",
        lambda p, x: frontends.vit_patch_embed(p, vcfg, x, patch=PATCH),
        (patch, image), (1, n, vcfg.d_model), peaks,
        flops=2 * n * PATCH * PATCH * 3 * vcfg.d_model))


# ----------------------------------------------------------------------
# training


def opt_bytes(params, opt):
    """Bytes an optimizer step must move: each weight read and written,
    its gradient (in the weight's dtype) read, each leaf of the optimizer
    state read and written, in their own dtypes (AdamW over fp32 weights:
    28 a parameter; Adafactor over bf16 weights and an fp32 momentum: 14,
    and its factored statistics)."""
    from repro_torch.models.spec import flatten

    state = {k: v for k, v in flatten(opt).items() if k != "step"}
    return 3 * _nbytes(params) + 2 * _nbytes(state)


def train_bounds(cfg, state, B, S, peaks, frames=0):
    """The least time of one train step of (B, S) positions (an
    encoder-decoder's ``frames`` encoder positions a row besides) in the
    compute dtype: the larger of the operations over its peak and the
    optimizer's bytes (``opt_bytes`` of the state) over the memory rate.
    The operations count the forward as ``lm_bounds`` and
    ``encdec_bounds`` count a prefill of every position (the matrix
    products of the weights a position visits, routed experts at
    ``top_k / num_experts`` of theirs; the attention's score and value
    products of every layer at its widths over the full scores the path
    computes; every Mamba layer's SSD and conv), four times for the layers
    (the forward, its rematerialized recompute and the two products of
    the backward) and three for the unembed of every position (it is not
    rematerialized); ``8 N T`` is the count of every parameter's products
    alone. Left out: the elementwise work (norms, the softmax of the
    loss, the optimizer's arithmetic), bytes that the optimizer's bound
    covers."""
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.spec import flatten

    params = state["params"]
    n = sum(v.numel() for v in flatten(params).values())
    head = cfg.d_model * padded_vocab(cfg.vocab_size)
    T = B * S
    if cfg.is_encoder_decoder:
        enc, dec, xkv = encdec_weights(params)
        pair = 4 * cfg.num_heads * cfg.head_dim
        matmul = B * frames * (enc + xkv) + T * dec
        attn = pair * B * (cfg.num_encoder_layers * frames * frames
                           + cfg.num_layers * (S * S + S * frames))
        ssd = 0
    else:
        matmul = T * active_matmul(cfg, params)
        attn = attention_pair_flops(cfg)[0] * B * S * S
        ssd = ssd_flops(cfg, S)[0] * T
    flops = 4 * (2 * matmul + attn + ssd) + 3 * 2 * T * head
    nbytes = opt_bytes(params, state["opt"])
    line = _bounds({"train_step": flops}, {"train_step": nbytes},
                   cfg.dtype, peaks)["train_step"]
    return {**line, "parameters": n, "ssd_flops": 4 * ssd,
            "attention_flops": 4 * attn,
            "bound_ms_8NT": max(8 * n * T / peaks[cfg.dtype],
                                nbytes / peaks["mem_bw"]) * 1e3}


def conv_grad_phase(cfg, peaks):
    """causal_conv1d's gradient at the train class of Mamba-2, (4, 1024,
    2304), K 4, x the xBC view of an in-projection-shaped buffer, in
    fp32 and bf16: the wrapper under autograd (the ``CausalConv1d``
    Function: one forward launch and one ``causal_conv1d_bwd`` call for
    dx, dw and db) against the plain version's autograd, dx, dw and db
    within ``tolerance(dtype)``, and dx bitwise the forward kernel run on
    the reversed dy (how the backward computed dx before it had a kernel);
    forward plus backward timed by graph replay for the kernel path, the
    plain path and ``F.conv1d(groups=C)`` with its autograd, beside the
    byte bound (x, dy, y and dx moved once)."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import causal_conv1d as cc
    from repro_torch.kernels import ref

    B, L, C, K, row, off = conv1d_class(cfg, TRAIN_BATCH, TRAIN_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn((B, L, row), generator=gen, device="cuda").to(
            dtype).requires_grad_()
        w = (torch.randn((K, C), generator=gen, device="cuda")
             * K ** -0.5).to(dtype).requires_grad_()
        b = (torch.randn((C,), generator=gen, device="cuda")
             * 0.1).to(dtype).requires_grad_()
        dy = torch.randn((B, L, C), generator=gen, device="cuda").to(dtype)

        def library(x, w, b):
            y = F.conv1d(x.transpose(1, 2), w.t()[:, None, :], b,
                         padding=K - 1, groups=C)
            return y[..., :L].transpose(1, 2)

        def fwd_bwd(f):
            def run():
                x = buf[..., off:off + C]
                return torch.autograd.grad(f(x, w, b), (x, w, b), dy)
            return run

        cc.causal_conv1d.launches = cc.causal_conv1d_bwd.launches = 0
        got = fwd_bwd(cc.causal_conv1d)()
        launches = {k: getattr(cc, k).launches for k in CONV1D_KERNELS}
        want = fwd_bwd(ref.causal_conv1d)()
        flip = torch.flip(cc.causal_conv1d(
            torch.flip(dy, (1,)).contiguous(), w.detach()), (1,))
        errs = {name: rel_err(a.float(), r.float())
                for name, a, r in zip(("dx", "dw", "db"), got, want)}
        tol = tolerance(dtype)
        name = str(dtype).replace("torch.", "")
        require(launches == dict.fromkeys(CONV1D_KERNELS, 1),
                f"causal_conv1d_grad {name}: launches {launches} for a "
                "forward and a backward, want one of each")
        require(all(e <= tol for e in errs.values()),
                f"causal_conv1d_grad {name}: {errs} > {tol}")
        require(torch.equal(got[0], flip), f"causal_conv1d_grad {name}: dx "
                "not bitwise the forward kernel on the reversed dy")
        nbytes = 4 * B * L * C * buf.element_size() \
            + 2 * (K + 1) * C * w.element_size()
        flops = 2 * K * B * L * C * 3 + B * L * C
        bound = _bounds({"fwd_bwd": flops}, {"fwd_bwd": nbytes}, name,
                        peaks)["fwd_bwd"]
        lines.append({
            "phase": "causal_conv1d_grad", "dtype": name,
            "shape": [B, L, C], "taps": K, "x_row_stride": row,
            "entry": "repro_torch.kernels.causal_conv1d.causal_conv1d "
                     "under autograd (CausalConv1d)",
            "launches_fwd_bwd": launches, "tol": tol,
            "dx_bitwise_equal_flip_path": True,
            **{f"{k}_max_rel_err": v for k, v in errs.items()},
            "max_abs_err": max((a.float() - r.float()).abs().max().item()
                               for a, r in zip(got, want)),
            "fwd_bwd_ms": time_ms(fwd_bwd(cc.causal_conv1d)),
            "plain_fwd_bwd_ms": time_ms(fwd_bwd(ref.causal_conv1d)),
            "library_fwd_bwd_ms": time_ms(fwd_bwd(library)),
            "library": "F.conv1d(groups=C, padding=K-1)[..., :L] with "
                       "its autograd", **bound})
        del buf, w, b, dy, got, want, flip
    return lines


def optim_phase(cfg, peaks):
    """``adamw.update`` and ``adafactor.update`` on the card against the
    CPU on the config's leaf shapes in fp32 (params N(0, 0.02²), three
    seeded gradients N(0, 1e-3²), zero fp32 states, lr 1e-3), three steps:
    every parameter and state leaf within ``OPTIM_BOUND``; one AdamW
    update of the whole tree timed (CUDA events, eager) against its byte
    bound, and one Adafactor update."""
    from repro_torch import optim
    from repro_torch.models import registry
    from repro_torch.models.spec import flatten, unflatten
    from repro_torch.optim import schedule

    shapes = {k: s.shape for k, s in
              flatten(registry.model_specs(cfg)).items()}
    gen = torch.Generator(device="cuda").manual_seed(8)

    def draw(scale):
        return unflatten({k: torch.randn(s, generator=gen, device="cuda")
                          * scale for k, s in shapes.items()})

    def cpu(tree):
        return unflatten({k: v.cpu() for k, v in flatten(tree).items()})
    params = draw(0.02)
    grads = [draw(1e-3) for _ in range(OPTIM_STEPS)]
    cpu_params, cpu_grads = cpu(params), [cpu(g) for g in grads]
    n = sum(v.numel() for v in flatten(params).values())
    line = {"phase": "optim", "config": cfg.name, "leaves": len(shapes),
            "parameters": n, "steps": OPTIM_STEPS, "bound": OPTIM_BOUND}
    for name in ("adamw", "adafactor"):
        mod = optim.get(name)
        card = (params, mod.init(params, "float32"))
        host = (cpu_params, mod.init(cpu_params, "float32"))
        lr, cpu_lr = schedule.const(1e-3, params["ln_f"]["w"]), \
            schedule.const(1e-3, cpu_params["ln_f"]["w"])
        t0 = time.perf_counter()
        for g in cpu_grads:
            host = mod.update(g, host[1], host[0], lr=cpu_lr)
        cpu_s = time.perf_counter() - t0
        for g in grads:
            card = mod.update(g, card[1], card[0], lr=lr)
        got = flatten({"params": card[0], "opt": card[1]})
        want = flatten({"params": host[0], "opt": host[1]})
        errs = {k: rel_err(v.cpu().float(), want[k].float())
                for k, v in got.items()
                if v.numel() and v.is_floating_point()}
        worst = max(errs, key=errs.get)
        require(all(e <= OPTIM_BOUND for e in errs.values()),
                f"optim {name}: {worst} {errs[worst]} > {OPTIM_BOUND} of "
                "the CPU")
        require(int(card[1]["step"]) == OPTIM_STEPS, f"optim {name}: step")
        ms = call_ms(lambda mod=mod, card=card: mod.update(
            grads[0], card[1], card[0], lr=lr), samples=5, inner=1)
        line[name] = {"max_rel_err_vs_cpu": errs[worst], "worst_leaf": worst,
                      "update_ms": ms, "cpu_s_3_steps": cpu_s,
                      "bytes": opt_bytes(*card)}
        del card, host, got, want
    line["adamw"].update(_bounds({"update": 0},
                                 {"update": line["adamw"]["bytes"]},
                                 "float32", peaks)["update"])
    return line


def _to(tree, device):
    from repro_torch.models.spec import tree_map

    return tree_map(lambda v: v.to(device), tree)


def train_launches(cfg, steps) -> dict:
    """causal_conv1d's forward and backward launches in ``steps`` train
    steps of ``cfg``: per Mamba layer a step, the forward, its
    rematerialized recompute where the layer's segment is stacked (a
    segment of one layer is not rematerialized, as in the reference's
    ``_run_segment``), and one backward."""
    from repro_torch.models import lm

    fwd = bwd = 0
    for body, n in lm.segments(cfg):
        layers = n * sum(mixer == "mamba" for mixer, _ in body)
        remat = n > 1 and cfg.remat == "full"
        fwd += (CONV_FWD_PER_LAYER_STEP if remat else 1) * layers
        bwd += CONV_BWD_PER_LAYER_STEP * layers
    return {"causal_conv1d": fwd * steps, "causal_conv1d_bwd": bwd * steps}


def train_parity_phase(cfg, counters):
    """The first ``TRAIN_PARITY_LAYERS`` layers of the full-width model
    (a leaf is seeded by its path, so these are the full draw's first
    layers) in fp32, ``train_parity``'s two steps of 2 x 512 tokens."""
    from repro_torch.data import TokenPipeline

    cfg2 = cfg.replace(num_layers=TRAIN_PARITY_LAYERS, dtype="float32")
    pipe = TokenPipeline(cfg2.vocab_size, TRAIN_PARITY_SEQ,
                         TRAIN_PARITY_BATCH, seed=1)
    return {"phase": "train", "path": TRAIN_PARITY_PATH, "config": cfg.name,
            "entry": "repro_torch.launch.steps.make_train_step and "
                     "batch_grads, card against CPU",
            "dtype": "float32", "layers": cfg2.num_layers,
            "batch": TRAIN_PARITY_BATCH, "seq": TRAIN_PARITY_SEQ,
            "optimizer": cfg2.optimizer, "remat": cfg2.remat,
            **train_parity(TRAIN_PARITY_PATH, cfg2, pipe, counters,
                           lr=TRAIN_LR),
            "reduced": {"num_layers": f"{cfg.num_layers} -> "
                                      f"{TRAIN_PARITY_LAYERS}",
                        "dtype": "bfloat16 -> float32"}}


def train_parity(path, cfg, pipe, counters, *, lr, accum=1):
    """Two train steps of ``cfg`` (fp32) on ``pipe``'s batches (with the
    family's other input, ``family_batch``) on the card and on the port's
    CPU from one state and batch, the second from the CPU's state after
    the first: the loss, the step's loss, the grad norm and every
    gradient leaf (``steps.batch_grads``, with ``accum`` micro-batches)
    within TRAIN_BOUND, and the parameters after the step within it on
    the live entries: AdamW's where the CPU's new first moment exceeds
    TRAIN_LIVE of its leaf's largest (an entry nearer zero may take its
    sign from rounding, and Adam moves it by a whole step), Adafactor's
    where the CPU's gradient does. The CPU takes each gradient once and
    its step by ``train_step.apply``; the card's batch_grads and train
    step launch exactly ``train_launches``. -> the line's fields."""
    from repro_torch.launch import steps
    from repro_torch.models.spec import flatten

    step_fn = steps.make_train_step(cfg, peak_lr=lr, warmup=1,
                                    total_steps=TRAIN_STEPS, accum=accum)
    host = steps.init_state(cfg, 0, "cpu")  # drawn on the CPU either way
    state = _to(host, "cuda")
    per_step, card_ms, cpu_s = [], [], 0.0
    zero_counts(counters)
    for i in range(TRAIN_PARITY_STEPS):
        batch = family_batch(cfg, pipe, i)
        t0 = time.perf_counter()
        cg, cm = steps.batch_grads(cfg, host["params"], _to(batch, "cpu"),
                                   accum)
        new_host, chm = step_fn.apply(host, cg, cm)
        cpu_s += time.perf_counter() - t0
        # compared on the card, each CPU leaf copied over in turn
        cg = flatten(cg)
        g, m = steps.batch_grads(cfg, state["params"], batch, accum)
        g = flatten(g)
        grad_err = max(_leaf_err(g[k], cg[k].cuda()) for k in cg)
        loss_err = _leaf_err(m["loss"], cm["loss"].cuda())
        del g, m
        t, (new, hm) = host_ms(lambda state=state: step_fn(state, batch))
        card_ms.append(t)
        del state
        newp = flatten(new["params"])
        live_of = flatten(new_host["opt"]["m"]) \
            if cfg.optimizer == "adamw" else cg
        param_err = 0.0
        for k, ref in flatten(new_host["params"]).items():
            ref, of = ref.cuda(), live_of[k].cuda()
            diff = (newp[k] - ref).abs()[of.abs() > TRAIN_LIVE
                                         * of.abs().max()]
            if diff.numel():
                param_err = max(param_err,
                                (diff.max() / ref.abs().max()).item())
        errs = {"loss": loss_err,
                "step_loss": _leaf_err(hm["loss"].cpu(), chm["loss"]),
                "grad_norm": _leaf_err(hm["grad_norm"].cpu(),
                                       chm["grad_norm"]),
                "grads": grad_err, "params": param_err}
        require(all(e <= TRAIN_BOUND for e in errs.values()),
                f"{path} step {i + 1}: {errs} > {TRAIN_BOUND}")
        per_step.append({"step": i + 1, "loss": float(chm["loss"]),
                         "grad_norm": float(chm["grad_norm"]),
                         **{f"{k}_max_rel_err": v for k, v in errs.items()}})
        del new, newp, cg, batch
        host = new_host
        # the next step starts on both sides from the CPU's state
        state = _to(host, "cuda") if i + 1 < TRAIN_PARITY_STEPS else None
    launches = read_counts(counters)
    # each step: the card's batch_grads and its train step, each taking
    # ``accum`` loss_and_grads
    want = {**NO_LAUNCHES,
            **train_launches(cfg, 2 * accum * TRAIN_PARITY_STEPS)}
    require(launches == want, f"{path}: launches {launches}, want {want}")
    return {"launches": launches, "bound": TRAIN_BOUND,
            "live_entries": "AdamW m" if cfg.optimizer == "adamw"
            else "CPU gradient", "steps": per_step, "card_step_ms": card_ms,
            "cpu_s": cpu_s, "parameters": sum(
                v.numel() for v in flatten(host["params"]).values())}


def resume_phase(cfg, counters):
    """The reference's test_crash_resume_bitwise on the card: the 2-layer
    full-width cut in fp32, ``train.train`` for 12 steps of 2 x 256
    tokens with a checkpoint every 4, twice uninterrupted (the step is
    deterministic: the two states bitwise equal) and once with a
    ``TransientFailure`` injected at step 9 (one restart, from step 8's
    checkpoint): every leaf of the state bitwise the uninterrupted
    run's; causal_conv1d's launches by ``train_launches`` over the 37
    steps the three runs take."""
    import tempfile

    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models.spec import flatten
    from repro_torch.runtime import TransientFailure

    cfg2 = cfg.replace(num_layers=TRAIN_PARITY_LAYERS, dtype="float32")
    pipe = TokenPipeline(cfg2.vocab_size, RESUME_SEQ, RESUME_BATCH, seed=5)

    def run(tmp, injector=None, max_failures=0):
        return train.train(cfg2, steps_total=RESUME_STEPS, lr=TRAIN_LR,
                           ckpt_dir=tmp, ckpt_every=RESUME_EVERY, seed=1,
                           device="cuda", pipeline=pipe,
                           fail_injector=injector,
                           max_failures=max_failures)

    hits = {RESUME_FAIL_AT: True}

    def injector(step):
        if hits.pop(step, None):
            raise TransientFailure("injected")

    zero_counts(counters)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref_a = run(f"{tmp}/a")
        ref_b = run(f"{tmp}/b")
        ft = run(f"{tmp}/ft", injector, max_failures=2)
    wall_s = time.perf_counter() - t0
    launches = read_counts(counters)
    # the two uninterrupted runs, then the resumed one: its steps up to the
    # failure, then again from the last checkpoint before it
    ran = 2 * RESUME_STEPS + RESUME_FAIL_AT + RESUME_STEPS \
        - RESUME_FAIL_AT // RESUME_EVERY * RESUME_EVERY
    want = {**NO_LAUNCHES, **train_launches(cfg2, ran)}
    require(launches == want, f"train/resume: launches {launches} over "
            f"{ran} steps, want {want}")
    a, b, f = (flatten(r.state) for r in (ref_a, ref_b, ft))
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    require(not differ, f"train/resume: two uninterrupted runs differ at "
            f"{differ[:5]}: the step is not deterministic")
    off = sorted(k for k in a if not torch.equal(a[k], f[k]))
    require(ft.restarts == 1 and ft.step == RESUME_STEPS,
            f"train/resume: {ft.restarts} restarts, step {ft.step}")
    require(not off, f"train/resume: the resumed state differs at {off[:5]}")
    return {"phase": "train", "path": "train/resume", "config": cfg.name,
            "entry": "repro_torch.launch.train.train with a fail injector",
            "dtype": "float32", "layers": cfg2.num_layers,
            "batch": RESUME_BATCH, "seq": RESUME_SEQ, "steps": RESUME_STEPS,
            "ckpt_every": RESUME_EVERY, "failure_at": RESUME_FAIL_AT,
            "restarts": ft.restarts, "uninterrupted_runs_bitwise_equal": True,
            "resumed_bitwise_equal": True, "leaves": len(a),
            "steps_run": ran,
            "launches": {k: launches[k] for k in CONV1D_KERNELS},
            "wall_s": wall_s,
            "reduced": {"num_layers": f"{cfg.num_layers} -> "
                                      f"{TRAIN_PARITY_LAYERS}",
                        "dtype": "bfloat16 -> float32"}}


def train_phase(cfg, counters, peaks):
    """The main training path: ``launch.train.train`` of mamba2-370m at
    full width and depth, bf16 over fp32 masters, AdamW, remat="full",
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens from
    ``TokenPipeline(TRAIN_VOCAB, ...)``, peak lr ``TRAIN_LR``, one
    checkpoint at the last step into a temporary directory; the counters
    set to 0 before and read after: causal_conv1d's forward exactly
    ``CONV_FWD_PER_LAYER_STEP`` and its backward exactly
    ``CONV_BWD_PER_LAYER_STEP`` a Mamba layer a step, nothing else. Every
    loss finite, the last 5 losses' mean below the first 5's by
    ``TRAIN_DROP``; the checkpoint restored with its digest checked,
    bitwise the live state. Returns (line, the profile thunks: one step
    and its loss_and_grads under the profiler, run with the profiles)."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps, train
    from repro_torch.models.spec import flatten

    pipe = TokenPipeline(TRAIN_VOCAB, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts(counters)
        t0 = time.perf_counter()
        run = train.train(cfg, steps_total=TRAIN_STEPS, lr=TRAIN_LR,
                          ckpt_dir=tmp, ckpt_every=TRAIN_STEPS, seed=0,
                          device="cuda", pipeline=pipe)
        wall_s = time.perf_counter() - t0
        launches = read_counts(counters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        step, host = CheckpointManager(tmp).restore(TRAIN_STEPS)
        restore_s = time.perf_counter() - t0
        live, got = flatten(run.state), flatten(host)
        restored = step == TRAIN_STEPS and set(got) == set(live) and all(
            torch.equal(got[k], v.cpu()) for k, v in live.items())
        del host, got
        t0 = time.perf_counter()
        CheckpointManager(Path(tmp) / "again", async_save=False).save(
            TRAIN_STEPS, run.state)
        save_s = time.perf_counter() - t0
    want = {**NO_LAUNCHES, **train_launches(cfg, TRAIN_STEPS)}
    require(launches == want, f"{TRAIN_PATH}: launches {launches}, want "
            f"{want}")
    losses = [run.metrics[i]["loss"] for i in range(TRAIN_STEPS)]
    drop = statistics.mean(losses[:5]) - statistics.mean(losses[-5:])
    require(all(map(math.isfinite, losses)), f"{TRAIN_PATH}: losses "
            f"{losses}")
    require(drop >= TRAIN_DROP, f"{TRAIN_PATH}: the loss fell by {drop}, "
            f"want {TRAIN_DROP}: {losses}")
    require(run.restarts == 0 and run.step == TRAIN_STEPS,
            f"{TRAIN_PATH}: {run.restarts} restarts, step {run.step}")
    require(restored, f"{TRAIN_PATH}: the checkpoint of step {TRAIN_STEPS} "
            "is not bitwise the live state")
    step_ms = [run.metrics[i]["seconds"] * 1e3
               for i in range(TRAIN_TIMED_FROM, TRAIN_STEPS)]
    median_ms = statistics.median(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound = train_bounds(cfg, run.state, TRAIN_BATCH, TRAIN_SEQ, peaks)
    line = {"phase": "train", "path": TRAIN_PATH, "config": cfg.name,
            "entry": "repro_torch.launch.train.train",
            "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
            "optimizer": cfg.optimizer, "remat": cfg.remat,
            "layers": cfg.num_layers, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "vocab_fed": TRAIN_VOCAB,
            "steps": TRAIN_STEPS, "peak_lr": TRAIN_LR,
            "warmup": train.warmup_steps(TRAIN_STEPS),
            "launches": launches,
            "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                  for k in CONV1D_KERNELS},
            "losses": losses, "loss_drop": drop,
            "grad_norms": [run.metrics[i]["grad_norm"]
                           for i in range(TRAIN_STEPS)],
            "step_ms": [run.metrics[i]["seconds"] * 1e3
                        for i in range(TRAIN_STEPS)],
            "step_ms_median": median_ms,
            "tokens_per_s": tokens / median_ms * 1e3,
            "bound": bound, "bound_share": bound["bound_ms"] / median_ms,
            "checkpoint_restored_bitwise": restored,
            "save_s": save_s, "restore_s": restore_s, "wall_s": wall_s,
            "device_allocated_before_gb": base_gb,
            "device_peak_gb": peak_gb}
    state = run.state
    step_fn = steps.make_train_step(cfg, peak_lr=TRAIN_LR,
                                    warmup=train.warmup_steps(TRAIN_STEPS),
                                    total_steps=TRAIN_STEPS)
    batch = pipe.batch(TRAIN_STEPS, "cuda")
    thunks = {"train_step": lambda: train_profile(
        lambda: step_fn(state, batch),
        lambda: steps.loss_and_grads(cfg, state["params"], batch),
        mamba_layers(cfg))}
    return line, thunks


def family_cfg(path, parity=False):
    """The config of a FAMILY_TRAIN line: its depth cut, or (``parity``)
    its parity line's depth in fp32."""
    from repro_torch.configs import get

    name, layers, _ = FAMILY_TRAIN[path]
    cfg = get(name)
    if parity:
        n = FAMILY_PARITY[path]
        kw = {"num_encoder_layers": n} if cfg.is_encoder_decoder else {}
        return cfg.replace(num_layers=n, dtype="float32",
                           param_dtype="float32", **kw)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def family_inputs(cfg):
    """(patch embeddings, frames) a row of the config's family."""
    return (FAMILY_PREFIX if cfg.frontend == "vit_stub" else 0,
            ENCDEC_FRAMES if cfg.is_encoder_decoder else 0)


def family_batch(cfg, pipe, step):
    """``pipe``'s batch of ``step`` on the card with the family's other
    input, laid out as the CPU tests' ``_batch``: a VLM's patch
    embeddings (N(0, 0.02²)) before its tokens, the labels of their
    positions masked; an encoder-decoder's frame embeddings (N(0, 1));
    drawn from a generator seeded by the step."""
    batch = pipe.batch(step, "cuda")
    prefix, frames = family_inputs(cfg)
    B = batch["tokens"].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(1000 + step)
    if prefix:
        batch["patch_embeds"] = torch.randn(
            (B, prefix, cfg.d_model), generator=gen, device="cuda") * 0.02
        batch["labels"] = torch.cat([torch.full_like(
            batch["labels"][:, :1], -1).expand(B, prefix), batch["labels"]],
            dim=1)
    if frames:
        batch["frames"] = torch.randn((B, frames, cfg.d_model),
                                      generator=gen, device="cuda")
    return batch


def spec_gb(cfg):
    """GB of the weights, the optimizer state and the gradients of
    ``cfg`` (counted from its spec trees; nothing is drawn)."""
    from repro_torch.core.dtypes import torch_dtype
    from repro_torch.launch import steps
    from repro_torch.models.spec import flatten

    def nbytes(tree):
        return sum(math.prod(s.shape) * torch.empty(
            (), dtype=torch_dtype(s.dtype or cfg.param_dtype)).element_size()
            for s in flatten(tree).values())
    specs = steps.state_specs(cfg)
    return (2 * nbytes(specs["params"]) + nbytes(specs["opt"])) / 1e9


def free_device():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def family_train_phase(path, counters, peaks):
    """One FAMILY_TRAIN line: ``launch.train.train`` or a loop of
    ``steps.make_train_step`` over FAMILY_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ positions (an encoder-decoder's decoder tokens, besides
    ENCDEC_FRAMES frames a row); the counters set to 0 before and read
    after, exactly ``train_launches`` (Jamba's Mamba layer) and nothing
    else; every loss finite and the mean of the last FAMILY_MEAN below
    the first FAMILY_MEAN's by TRAIN_DROP; DeepSeek's checkpoint of its
    last step restored with its digest checked, bitwise the live state
    (bf16 weights, fp32 momentum and factored statistics); the median
    step ms (steps 3 on), tokens a second, ``train_bounds`` and its
    share, the device's peak GB and the state's GB."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps, train
    from repro_torch.models.spec import flatten

    name, layers, entry = FAMILY_TRAIN[path]
    cfg = family_cfg(path)
    lr = FAMILY_LR.get(path, TRAIN_LR)
    prefix, frames = family_inputs(cfg)
    pipe = TokenPipeline(TRAIN_VOCAB, TRAIN_SEQ - prefix, TRAIN_BATCH,
                         seed=0)
    free_device()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    restored = None
    zero_counts(counters)
    t0 = time.perf_counter()
    if entry == "train":
        with tempfile.TemporaryDirectory() as tmp:
            run = train.train(
                cfg, steps_total=FAMILY_STEPS, lr=lr,
                ckpt_dir=tmp if path == FAMILY_CKPT else None,
                ckpt_every=FAMILY_STEPS, seed=0, device="cuda",
                pipeline=pipe)
            wall_s = time.perf_counter() - t0
            launches = read_counts(counters)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if path == FAMILY_CKPT:
                step, host = CheckpointManager(tmp).restore(FAMILY_STEPS)
                live, got = flatten(run.state), flatten(host)
                restored = step == FAMILY_STEPS and set(got) == set(live) \
                    and all(torch.equal(got[k], v.cpu())
                            for k, v in live.items())
                del host, got
        require(run.restarts == 0 and run.step == FAMILY_STEPS,
                f"{path}: {run.restarts} restarts, step {run.step}")
        state, metrics = run.state, [run.metrics[i]
                                     for i in range(FAMILY_STEPS)]
        del run
    else:
        state = steps.init_state(cfg, 0, "cuda")
        step_fn = steps.make_train_step(
            cfg, peak_lr=lr, warmup=train.warmup_steps(FAMILY_STEPS),
            total_steps=FAMILY_STEPS)
        metrics = []
        for i in range(FAMILY_STEPS):
            ms, (state, m) = host_ms(
                lambda i=i, state=state: step_fn(
                    state, family_batch(cfg, pipe, i)))
            metrics.append({**{k: float(v) for k, v in m.items()},
                            "seconds": ms / 1e3})
        wall_s = time.perf_counter() - t0
        launches = read_counts(counters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {**NO_LAUNCHES, **train_launches(cfg, FAMILY_STEPS)}
    require(launches == want, f"{path}: launches {launches}, want {want}")
    losses = [m["loss"] for m in metrics]
    drop = statistics.mean(losses[:FAMILY_MEAN]) \
        - statistics.mean(losses[-FAMILY_MEAN:])
    require(all(map(math.isfinite, losses)), f"{path}: losses {losses}")
    require(drop >= TRAIN_DROP, f"{path}: the loss fell by {drop}, want "
            f"{TRAIN_DROP}: {losses}")
    if path == FAMILY_CKPT:
        require(restored, f"{path}: the checkpoint of step {FAMILY_STEPS} "
                "is not bitwise the live state")
    step_ms = [m["seconds"] * 1e3 for m in metrics]
    median_ms = statistics.median(step_ms[TRAIN_TIMED_FROM:])
    bound = train_bounds(cfg, state, TRAIN_BATCH, TRAIN_SEQ, peaks, frames)
    line = {"phase": "train", "path": path, "config": name,
            "entry": "repro_torch.launch.train.train" if entry == "train"
            else "repro_torch.launch.steps.make_train_step",
            "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
            "optimizer": cfg.optimizer,
            "opt_state_dtype": cfg.opt_state_dtype, "remat": cfg.remat,
            "layers": cfg.num_layers, "batch": TRAIN_BATCH,
            "positions": TRAIN_SEQ, "patch_embeds": prefix,
            "frames": frames, "vocab_fed": TRAIN_VOCAB,
            "steps": FAMILY_STEPS, "peak_lr": lr,
            "warmup": train.warmup_steps(FAMILY_STEPS),
            "launches": launches, "losses": losses, "loss_drop": drop,
            "grad_norms": [m["grad_norm"] for m in metrics],
            "step_ms": step_ms, "step_ms_median": median_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3,
            "bound": bound, "bound_share": bound["bound_ms"] / median_ms,
            "wall_s": wall_s, "device_allocated_before_gb": base_gb,
            "device_peak_gb": peak_gb,
            "state_gb": _nbytes(state) / 1e9}
    if path == FAMILY_CKPT:
        line["checkpoint_restored_bitwise"] = restored
    if layers is not None:
        full = get(name)
        line["reduced"] = {
            "num_layers": f"{full.num_layers} -> {layers}",
            "why": FAMILY_CUT[name],
            "full_depth_weights_state_grads_gb": spec_gb(full)}
    return line


def _leaf_err(y, ref):
    """max|y - ref| / max|ref| (max|y| where ``ref`` is all zeros)."""
    den = ref.abs().max().item()
    return (y - ref).abs().max().item() / den if den else \
        y.abs().max().item()


def family_parity_phase(path, counters):
    """The fp32 parity line of a FAMILY_TRAIN path (``path`` + "/fp32"):
    FAMILY_PARITY layers at full width, FAMILY_PARITY_SEQ tokens a row
    (FAMILY_PARITY_ACCUM rows through as many micro-batches where given),
    ``train_parity``'s two steps."""
    from repro_torch.configs import get
    from repro_torch.data import TokenPipeline

    cfg = family_cfg(path, parity=True)
    prefix, frames = family_inputs(cfg)
    accum = FAMILY_PARITY_ACCUM.get(path, 1)
    pipe = TokenPipeline(cfg.vocab_size, FAMILY_PARITY_SEQ, accum, seed=1)
    full = get(FAMILY_TRAIN[path][0])
    return {"phase": "train", "path": f"{path}/fp32", "config": full.name,
            "entry": "repro_torch.launch.steps.make_train_step and "
                     "batch_grads, card against CPU",
            "dtype": "float32", "layers": cfg.num_layers,
            "encoder_layers": cfg.num_encoder_layers,
            "batch": accum, "positions": FAMILY_PARITY_SEQ + prefix,
            "patch_embeds": prefix, "frames": frames, "accum": accum,
            "optimizer": cfg.optimizer, "remat": cfg.remat,
            **train_parity(f"{path}/fp32", cfg, pipe, counters,
                           lr=FAMILY_LR.get(path, TRAIN_LR), accum=accum),
            "reduced": {"num_layers": f"{full.num_layers} -> "
                                      f"{cfg.num_layers}",
                        **({"num_encoder_layers":
                            f"{full.num_encoder_layers} -> "
                            f"{cfg.num_encoder_layers}"}
                           if cfg.is_encoder_decoder else {}),
                        "dtype": f"{full.dtype} -> float32",
                        "param_dtype": f"{full.param_dtype} -> float32"}}


def family_lines(path, counters, peaks):
    """The train line of a FAMILY_TRAIN path, then its fp32 parity line,
    the card's memory freed after each."""
    yield family_train_phase(path, counters, peaks)
    free_device()
    yield family_parity_phase(path, counters)
    free_device()


def mesh_phase(cfg, params, counters, smi):
    """The train step across a mesh on the card (``MESH_PATH``): an NCCL
    group of one rank from a ``HashStore``, the (1, 1) mesh of
    ``launch.mesh.make_local_mesh``, the rules of ``rules_for``; then
    serving on the same mesh (``mesh_serve_phase``; ``params`` are the
    unsharded full-size weights it is held against). Returns (the 2-layer
    fp32 parity line, the full-size line, the two serving lines); the
    group is destroyed before it returns."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.spec import flatten
    from repro_torch.sharding.rules import rules_for

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        require(dist.get_backend() == "nccl",
                f"mesh: the group's backend is {dist.get_backend()}")
        mesh = make_local_mesh("cuda")
        require(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
                f"mesh: {mesh}")

        # the first 2 layers in fp32: sharded against unsharded
        cfg2 = cfg.replace(num_layers=TRAIN_PARITY_LAYERS, dtype="float32")
        rules = rules_for(cfg2, mesh)
        pipe = TokenPipeline(cfg2.vocab_size, TRAIN_PARITY_SEQ,
                             TRAIN_PARITY_BATCH, seed=1)
        kw = dict(peak_lr=TRAIN_LR, warmup=1, total_steps=TRAIN_STEPS)
        sstate = steps.init_state(cfg2, 0, mesh=mesh, rules=rules)
        state = steps.init_state(cfg2, 0, "cuda")
        sbatch = pipe.batch(0, mesh=mesh, rules=rules)
        batch = pipe.batch(0, "cuda")
        sg, sm = steps.loss_and_grads(cfg2, sstate["params"], sbatch, mesh,
                                      rules)
        g, m = steps.loss_and_grads(cfg2, state["params"], batch)
        _, sstep = steps.make_train_step(cfg2, mesh, rules, **kw)(sstate,
                                                                   sbatch)
        _, step = steps.make_train_step(cfg2, **kw)(state, batch)
        sg, g = flatten(sg), flatten(g)
        pairs = {"loss": (whole(sm["loss"]), m["loss"]),
                 "grad_norm": (whole(sstep["grad_norm"]), step["grad_norm"]),
                 **{f"grad:{k}": (whole(v), g[k]) for k, v in sg.items()}}
        errs = {k: rel_err(a.float(), b.float()) for k, (a, b)
                in pairs.items()}
        bitwise = {k: torch.equal(a, b) for k, (a, b) in pairs.items()}
        worst = max(errs, key=errs.get)
        require(errs[worst] <= MESH_BOUND,
                f"{MESH_PARITY_PATH}: {worst} {errs[worst]} > {MESH_BOUND}")
        parity = {
            "phase": "mesh", "path": MESH_PARITY_PATH, "config": cfg.name,
            "entry": "repro_torch.launch.steps.make_train_step(cfg, mesh, "
                     "rules) and loss_and_grads, sharded against unsharded",
            "mesh": {"shape": list(mesh.shape),
                     "names": list(mesh.mesh_dim_names),
                     "backend": dist.get_backend()},
            "dtype": "float32", "layers": cfg2.num_layers,
            "batch": TRAIN_PARITY_BATCH, "seq": TRAIN_PARITY_SEQ,
            "bound": MESH_BOUND,
            "loss_max_rel_err": errs["loss"],
            "grad_norm_max_rel_err": errs["grad_norm"],
            "grads_max_rel_err": max(v for k, v in errs.items()
                                     if k.startswith("grad:")),
            "worst": worst, "bitwise_equal": all(bitwise.values()),
            "not_bitwise": sorted(k for k, v in bitwise.items() if not v),
            "reduced": {"num_layers": f"{cfg.num_layers} -> "
                                      f"{TRAIN_PARITY_LAYERS}",
                        "dtype": "bfloat16 -> float32"}}
        del sstate, state, sg, g, sbatch, batch

        # mamba2-370m at full size: sharded steps beside unsharded ones
        rules = rules_for(cfg, mesh)
        pipe = TokenPipeline(TRAIN_VOCAB, TRAIN_SEQ, TRAIN_BATCH, seed=0)
        kw = dict(peak_lr=TRAIN_LR, warmup=2, total_steps=TRAIN_STEPS)
        state = steps.init_state(cfg, 0, "cuda")
        step_fn = steps.make_train_step(cfg, **kw)
        plain_ms = []
        for i in range(MESH_STEPS):
            t, (state, _) = host_ms(lambda: step_fn(state, pipe.batch(
                i, "cuda")))
            plain_ms.append(t)
        del state
        sstate = steps.init_state(cfg, 0, mesh=mesh, rules=rules)
        sstep_fn = steps.make_train_step(cfg, mesh, rules, **kw)
        sharded_ms, losses, per_step = [], [], []
        for i in range(MESH_STEPS):
            zero_counts(counters)
            t, (sstate, sm) = host_ms(lambda: sstep_fn(sstate, pipe.batch(
                i, mesh=mesh, rules=rules)))
            per_step.append(read_counts(counters))
            sharded_ms.append(t)
            losses.append(float(whole(sm["loss"])))
        want = {**NO_LAUNCHES, **train_launches(cfg, 1)}
        require(all(n == want for n in per_step),
                f"{MESH_PATH}: launches a step {per_step}, want {want}")
        require(all(map(math.isfinite, losses)),
                f"{MESH_PATH}: losses {losses}")
        placements = {str(tuple(v.placements)) for v in
                      flatten(sstate).values()}
        line = {
            "phase": "mesh", "path": MESH_PATH, "config": cfg.name,
            "entry": "repro_torch.launch.steps.make_train_step(cfg, mesh, "
                     "rules) on launch.mesh.make_local_mesh",
            "card": smi,
            "mesh": {"shape": list(mesh.shape),
                     "names": list(mesh.mesh_dim_names),
                     "backend": dist.get_backend()},
            "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
            "optimizer": cfg.optimizer, "remat": cfg.remat,
            "layers": cfg.num_layers, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "vocab_fed": TRAIN_VOCAB,
            "steps": MESH_STEPS, "losses": losses,
            "launches": {k: sum(n[k] for n in per_step) for k in want},
            "launches_per_step": per_step,
            "sharded_step_ms": sharded_ms, "unsharded_step_ms": plain_ms,
            "sharded_over_unsharded": [a / b for a, b in
                                       zip(sharded_ms, plain_ms)],
            "state_placements": sorted(placements)}
        del sstate
        serve_lines = mesh_serve_phase(cfg, params, counters, mesh, smi)
    finally:
        dist.destroy_process_group()
    return parity, line, serve_lines


def mesh_serve_phase(cfg, params, counters, mesh, smi):
    """Serving on ``mesh`` (``MESH_SERVE_PARITY_PATH``, then
    ``MESH_SERVE_PATH``): the sharded prefill and decode steps of
    ``steps`` replayed through a sharded ``StepGraphs`` beside the same
    steps eager, sharded and unsharded. Returns the two lines."""
    from repro_torch.launch import serve, steps
    from repro_torch.sharding.rules import rules_for

    def local(t):  # a (1, 1) mesh: every block is the whole tensor
        return t.to_local() if hasattr(t, "to_local") else t

    def run(cfg, graphs, cparams, prompts, cache_len, tokens, mesh=None):
        """Prefill then one decode step a column of ``tokens`` (B, n):
        ``graphs`` replayed, or the eager steps of ``cfg`` on ``cparams``
        -> (each step's logits, host ms of each step)."""
        out, ms = [], []
        with torch.no_grad():
            if graphs is not None:
                t, (logits, caches) = host_ms(lambda: graphs.prefill(
                    prompts, cache_len))
            else:
                t, (logits, caches) = host_ms(lambda: steps.prefill_step(
                    cparams, cfg, prompts, cache_len=cache_len, mesh=mesh))
            out.append(local(logits).clone())
            ms.append(t)
            for i in range(tokens.shape[1]):
                tok, pos = tokens[:, i:i + 1], prompts.shape[1] + i
                if graphs is not None:
                    t, logits = host_ms(lambda: graphs.decode(tok, caches,
                                                              pos))
                else:
                    t, (logits, caches) = host_ms(lambda: steps.decode_step(
                        cparams, cfg, tok, caches, pos, mesh=mesh))
                out.append(local(logits).clone())
                ms.append(t)
        return out, ms

    lines = []
    # ---- the first 2 layers in fp32: replay = sharded eager = unsharded
    cfg2 = cfg.replace(num_layers=MESH_SERVE_LAYERS, dtype="float32")
    rules = rules_for(cfg2, mesh)
    sparams = steps.init_params(cfg2, 0, mesh=mesh, rules=rules)
    uparams = steps.init_params(cfg2, 0, "cuda")
    prompts = lm_prompts(cfg2, 1, PARITY_PROMPT, seed=2)
    cache_len = PARITY_PROMPT + MESH_SERVE_STEPS
    graphs = steps.StepGraphs(cfg2, sparams, mesh, rules)
    zero_counts(counters)
    with torch.no_grad():
        logits, _ = graphs.prefill(prompts, cache_len)
    torch.cuda.synchronize()
    traced = read_counts(counters)
    tokens = vocab_logits(local(logits)[:, -1], cfg2).argmax(-1)[:, None]
    tokens = tokens.expand(1, MESH_SERVE_STEPS).contiguous()
    replay, _ = run(cfg2, graphs, None, prompts, cache_len, tokens)
    eager, _ = run(cfg2, None, graphs.params, prompts, cache_len, tokens,
                   mesh)
    plain, _ = run(cfg2, None, steps.compute_params(uparams, cfg2), prompts,
                   cache_len, tokens)
    vs_eager = [torch.equal(a, b) for a, b in zip(replay, eager)]
    vs_plain = [torch.equal(a, b) for a, b in zip(replay, plain)]
    want = {**NO_LAUNCHES, "causal_conv1d": MESH_SERVE_LAYERS}
    require(traced == {k: v * graphs.prefills for k, v in want.items()},
            f"{MESH_SERVE_PARITY_PATH}: launches {traced} over "
            f"{graphs.prefills} traced prefills, want {want} each")
    require(all(vs_eager), f"{MESH_SERVE_PARITY_PATH}: replay not bitwise "
            f"sharded eager at steps {vs_eager}")
    require(all(vs_plain), f"{MESH_SERVE_PARITY_PATH}: sharded not bitwise "
            f"unsharded at steps {vs_plain}")
    lines.append({
        "phase": "mesh", "path": MESH_SERVE_PARITY_PATH, "config": cfg.name,
        "entry": "repro_torch.launch.steps.StepGraphs(cfg, params, mesh, "
                 "rules) beside prefill_step / decode_step(..., mesh=), "
                 "sharded and unsharded",
        "mesh": {"shape": list(mesh.shape),
                 "names": list(mesh.mesh_dim_names)},
        "dtype": "float32", "layers": MESH_SERVE_LAYERS, "batch": 1,
        "prompt": PARITY_PROMPT, "decode_steps": MESH_SERVE_STEPS,
        "launches_at_capture": traced, "prefills_traced": graphs.prefills,
        "replay_bitwise_equal_sharded_eager": all(vs_eager),
        "sharded_bitwise_equal_unsharded": all(vs_plain),
        "max_rel_err_vs_unsharded": max(
            rel_err(a.float(), b.float()) for a, b in zip(replay, plain)),
        "reduced": {"num_layers": f"{cfg.num_layers} -> "
                                  f"{MESH_SERVE_LAYERS}",
                    "dtype": "bfloat16 -> float32"}})
    del graphs, sparams, uparams, replay, eager, plain

    # ---- full size, bf16: generate through the sharded graphs --------
    rules = rules_for(cfg, mesh)
    B, S, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    cache_len = S + new
    prompts = lm_prompts(cfg, B, S, seed=1)
    sparams = steps.init_params(cfg, 0, mesh=mesh, rules=rules)
    graphs = steps.StepGraphs(cfg, sparams, mesh, rules)
    kw = dict(max_new=new, cache_len=cache_len, mesh=mesh)
    zero_counts(counters)
    tokens = serve.generate(cfg, sparams, prompts, graphs=graphs, **kw)
    torch.cuda.synchronize()
    traced = read_counts(counters)
    zero_counts(counters)
    again = serve.generate(cfg, sparams, prompts, graphs=graphs, **kw)
    torch.cuda.synchronize()
    on_replay = read_counts(counters)
    eager_tokens = serve.generate(cfg, sparams, prompts, replay=False, **kw)
    plain_tokens = serve.generate(cfg, params, prompts, max_new=new,
                                  cache_len=cache_len)
    per_prefill = {**NO_LAUNCHES, "causal_conv1d": mamba_layers(cfg)}
    require(traced == {k: v * graphs.prefills
                       for k, v in per_prefill.items()},
            f"{MESH_SERVE_PATH}: launches at capture {traced} over "
            f"{graphs.prefills} traced prefills, want {per_prefill} each")
    require(on_replay == NO_LAUNCHES,
            f"{MESH_SERVE_PATH}: launches on replay {on_replay}")
    require(torch.equal(again, tokens) and torch.equal(eager_tokens, tokens),
            f"{MESH_SERVE_PATH}: replayed, replayed again and eager sharded "
            "tokens differ")
    require(tuple(tokens.shape) == (B, new) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size,
            f"{MESH_SERVE_PATH}: bad tokens {tuple(tokens.shape)}")
    # teacher-forced on the sharded tokens: prefill ms and decode ms a
    # token, sharded replayed and eager beside unsharded replayed and eager
    ugraphs = steps.StepGraphs(cfg, params)
    cases = {"sharded_replay": (graphs, None, mesh),
             "sharded_eager": (None, graphs.params, mesh),
             "unsharded_replay": (ugraphs, None, None),
             "unsharded_eager": (None, ugraphs.params, None)}
    forced = tokens[:, :new - 1]
    prefill_ms, decode_ms, logits = {}, {}, {}
    for name, (g, cp, m) in cases.items():
        prefill_ms[name], decode_ms[name] = [], []
        for _ in range(3):
            out, ms = run(cfg, g, cp, prompts, cache_len, forced, m)
            prefill_ms[name].append(ms[0])
            decode_ms[name].extend(ms[1:])
        logits[name] = out
    bitwise = {name: all(torch.equal(a, b) for a, b in
                         zip(logits["sharded_replay"], out))
               for name, out in logits.items()}
    require(bitwise["sharded_eager"], f"{MESH_SERVE_PATH}: replayed logits "
            "not bitwise the sharded eager ones")
    require(torch.equal(plain_tokens, tokens) and bitwise["unsharded_replay"]
            and bitwise["unsharded_eager"],
            f"{MESH_SERVE_PATH}: sharded tokens or replayed logits not "
            f"bitwise the unsharded ones ({bitwise})")
    line = {
        "phase": "mesh", "path": MESH_SERVE_PATH, "config": cfg.name,
        "entry": "repro_torch.launch.serve.generate(cfg, params, prompts, "
                 "mesh=, graphs=steps.StepGraphs(cfg, params, mesh, rules))",
        "card": smi,
        "mesh": {"shape": list(mesh.shape),
                 "names": list(mesh.mesh_dim_names)},
        "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
        "layers": cfg.num_layers, "batch": B, "prompt": S,
        "new_tokens": new, "cache_len": cache_len,
        "graphs": graphs.graphs, "prefills_traced": graphs.prefills,
        "launches_at_capture": traced,
        "launches_per_traced_prefill": {
            k: v / graphs.prefills for k, v in traced.items()},
        "launches_on_replay": on_replay,
        "tokens_replay_equal_eager": True,
        "tokens_equal_unsharded": True,
        "logits_bitwise_equal_sharded_replay": bitwise,
        "sample_tokens": tokens[0, :8].tolist()}
    for name in cases:
        line[f"prefill_ms_{name}"] = statistics.median(prefill_ms[name])
        line[f"decode_ms_per_token_{name}"] = statistics.median(
            decode_ms[name])
    line.update(prefill_ms=prefill_ms, decode_ms=decode_ms)
    lines.append(line)
    del graphs, ugraphs, sparams, logits
    return lines


def train_profile(step, grads, layers, top=10):
    """One train step under torch.profiler, then its ``loss_and_grads``
    alone: the device busy ms of each, the optimizer's and the clip's
    share (1 - the gradients' busy ms over the step's), the top kernels
    of the step, and causal_conv1d's device kernels: the forward's split
    by their order (a step's first ``layers`` are the forward, the rest
    the backward's recomputes), and the backward's (the pass and the
    ordered sum of its partials, two a layer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def events(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = host_ms(fn)
        return wall, sorted(
            ((e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3)
             for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e[0])
    wall, ev = events(step)
    gwall, gev = events(grads)
    busy, gbusy = sum(e[2] for e in ev), sum(e[2] for e in gev)
    ms, calls = Counter(), Counter()
    for _, name, t in ev:
        ms[name] += t
        calls[name] += 1
    fwd = [t for _, name, t in ev if "causal_conv1d_fwd" in name]
    bwd = [t for _, name, t in ev if "causal_conv1d_bwd" in name]
    return {"wall_ms_profiled": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall,
            "device_launches": len(ev),
            "loss_and_grads_busy_ms": gbusy,
            "optimizer_and_clip_share": 1 - gbusy / busy,
            "causal_conv1d": {
                "device_kernels": len(fwd) + len(bwd),
                "ms": sum(fwd) + sum(bwd),
                "share": (sum(fwd) + sum(bwd)) / busy,
                "forward_ms": sum(fwd[:layers]),
                "recompute_ms": sum(fwd[layers:]),
                "backward_ms": sum(bwd), "backward_kernels": len(bwd)},
            "top": [{"name": name[:100], "ms": t, "launches": calls[name]}
                    for name, t in ms.most_common(top)]}


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
                "causal_conv1d": causal_conv1d.causal_conv1d,
                "causal_conv1d_bwd": causal_conv1d.causal_conv1d_bwd}
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

    # ---- the LM paths: causal_conv1d at their classes -------------------
    lcfg = get(LM_CONFIG)
    hcfg = get(HYBRID_CONFIG).replace(num_layers=HYBRID_LAYERS)
    h2cfg = hcfg.replace(num_layers=HYBRID_PARITY_LAYERS,
                         param_dtype="float32")
    jcfg = family_cfg(JAMBA_TRAIN_PATH)
    conv_gen = torch.Generator(device="cuda").manual_seed(2)
    conv_results = []
    # fp32 and bf16 at every class, then fp16 at every class (no path runs
    # it), so the classes before draw the inputs they drew before them
    classes = conv1d_classes(lcfg, hcfg, h2cfg)
    for dtypes in ((torch.float32, torch.bfloat16), (torch.float16,)):
        for shape, paths in classes.items():
            for dtype in dtypes:
                line = kernel_case("causal_conv1d", shape, dtype, conv_gen,
                                   peaks)
                line["launches_per_prefill"] = dict(paths)
                if shape == conv1d_class(jcfg, TRAIN_BATCH, TRAIN_SEQ):
                    line["launches_per_train_step"] = {JAMBA_TRAIN_PATH: (
                        train_launches(jcfg, 1)["causal_conv1d"])}
                emit(line)
                conv_results.append(line)
    # then the forward's ragged class, and the backward at the train class
    # in fp32, bf16 and fp16, at the ragged class, and at Jamba's train
    # class in the three dtypes
    train_classes = {conv1d_class(lcfg, TRAIN_BATCH, TRAIN_SEQ): {
        TRAIN_PATH: mamba_layers(lcfg)}}
    train_classes[conv1d_class(jcfg, TRAIN_BATCH, TRAIN_SEQ)] = {
        JAMBA_TRAIN_PATH: mamba_layers(jcfg)}
    train_class, jamba_class = train_classes
    extra = [("causal_conv1d", CONV1D_RAGGED, dtype)
             for dtype in (torch.float32, torch.bfloat16)]
    extra += [("causal_conv1d_bwd", train_class, dtype)
              for dtype in (torch.float32, torch.bfloat16, torch.float16)]
    extra += [("causal_conv1d_bwd", CONV1D_RAGGED, dtype)
              for dtype in (torch.float32, torch.bfloat16)]
    extra += [("causal_conv1d_bwd", jamba_class, dtype)
              for dtype in (torch.float32, torch.bfloat16, torch.float16)]
    for kernel, shape, dtype in extra:
        line = kernel_case(kernel, shape, dtype, conv_gen, peaks)
        if kernel == "causal_conv1d":
            line["launches_per_prefill"] = {}
        else:
            line["launches_per_step"] = {
                path: CONV_BWD_PER_LAYER_STEP * n
                for path, n in train_classes.get(shape, {}).items()}
        emit(line)
        conv_results.append(line)
    bad = [(r["kernel"], r["dtype"], r["shape"]) for r in conv_results
           if not (r["max_rel_err"] <= r["tol"] and r["bitwise_equal"])]
    require(not bad, f"causal_conv1d disagrees with its plain version: {bad}")
    lm_launches, profiles = {}, []

    # ---- the hybrid, the VLM and the encoder-decoder, first ------------
    hybrid_vlm_encdec(hcfg, h2cfg, counters, peaks, lm_launches, profiles)

    # ---- Mamba-2, qwen2 and the MoE LMs --------------------------------
    lparams = steps.init_params(lcfg, 0, "cuda")
    line, thunks = lm_serve_phase("mamba2_370m", lcfg, lparams, counters,
                                  peaks)
    lm_launches[line["path"]] = (line["launches_at_capture"],
                                 line["prefills_traced"])
    profiles.append((line["path"], thunks))
    emit(line)
    line = parity_phase("mamba2_370m/fp32", lcfg, lparams, counters)
    lm_launches[line["path"]] = (line["launches"],
                                 line["prefills_traced"] + 1)
    emit(line)
    # the GQA attention LM at published width, then the chunked path
    acfg = get(ATTN_CONFIG)
    aparams = steps.init_params(acfg, 0, "cuda")
    line, thunks = lm_serve_phase("qwen2_0_5b", acfg, aparams, counters,
                                  peaks)
    profiles.append((line["path"], thunks))
    emit(line)
    emit(parity_phase("qwen2_0_5b/fp32", acfg, aparams, counters))
    emit(chunked_attention_phase(acfg))
    del aparams
    # the MoE LMs: granite-moe at published width and depth, bf16 over
    # fp32 master weights, and one of its MoE layers through both
    # dispatches; then DeepSeek-V2 at published widths, 2 of its 60
    # layers, in its own bf16 storage
    gcfg = get(MOE_CONFIG)
    gparams = steps.init_params(gcfg, 0, "cuda")
    line, thunks = lm_serve_phase("granite_moe_3b", gcfg, gparams, counters,
                                  peaks)
    profiles.append((line["path"], thunks))
    emit(line)
    emit(moe_dispatch_phase(gcfg, gparams, line["moe_drops"]))
    emit(parity_phase("granite_moe_3b/fp32", gcfg, gparams, counters))
    del gparams
    dcfg = get(MLA_CONFIG).replace(num_layers=MLA_LAYERS)
    reduced = {"num_layers": f"{get(MLA_CONFIG).num_layers} -> {MLA_LAYERS}"}
    dparams = steps.init_params(dcfg, 0, "cuda")
    line, thunks = lm_serve_phase("deepseek_v2_2l", dcfg, dparams, counters,
                                  peaks)
    profiles.append((line["path"], thunks))
    emit({**line, "reduced": reduced})
    emit({**parity_phase("deepseek_v2_2l/fp32", dcfg, dparams, counters),
          "reduced": reduced})
    del dparams
    # ---- training: causal_conv1d's gradient, the optimizers, the 2-layer
    # parity and crash-resume lines, then mamba2-370m at full size --------
    grad_lines = conv_grad_phase(lcfg, peaks)
    for line in grad_lines:
        emit(line)
    emit(optim_phase(lcfg, peaks))
    line = train_parity_phase(lcfg, counters)
    train_counts = {TRAIN_PARITY_PATH: {k: line["launches"][k]
                                        for k in CONV1D_KERNELS}}
    emit(line)
    emit(resume_phase(lcfg, counters))
    line, thunks = train_phase(lcfg, counters, peaks)
    train_counts[TRAIN_PATH] = {k: line["launches"][k]
                                for k in CONV1D_KERNELS}
    profiles.append((line["path"], thunks))
    emit(line)
    # ---- the train step across a mesh (NCCL, one rank) -----------------
    parity, line, serve_lines = mesh_phase(lcfg, lparams, counters, smi)
    emit(parity)
    train_counts[MESH_PATH] = {k: line["launches"][k]
                               for k in CONV1D_KERNELS}
    emit(line)
    for line in serve_lines:
        lm_launches[line["path"]] = (line["launches_at_capture"],
                                     line["prefills_traced"])
        emit(line)
    # after every timed LM line: one replayed and one eager decode step
    # of each serving path under the profiler, and one train step
    for path, thunks in profiles:
        emit({"phase": "lm", "part": "profile", "path": path,
              **{name: fn() for name, fn in thunks.items()}})
    del lparams, profiles, thunks
    # ---- every other LM family's train step, each beside its fp32
    # parity line: after the profiles, whose serving graphs, weights and
    # caches (~50 GB) stay on the card until they have run ----------------
    free_device()
    for path in FAMILY_TRAIN:
        for line in family_lines(path, counters, peaks):
            if mamba_layers(family_cfg(path)):
                train_counts[line["path"]] = {
                    k: line["launches"][k] for k in CONV1D_KERNELS}
            emit(line)

    # ---- after every timed line (a profiler session slows later graph
    # replays): where an eager tuned ResNet-18 run's host time goes ------
    emit(host_split(InferenceEngine(rcfg, params=tuned_engine.model,
                                    plan=rplan, replay=False), tuned_engine,
                    images[0]))

    # ---- summary: each kernel over one image of each path (fp32), and
    # causal_conv1d over one prefill of each LM path in its dtype ---------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        if name in CONV1D_KERNELS:
            rows = [r for r in conv_results if r["kernel"] == name]
            kernels.append(
                conv1d_summary(rows, lm_launches, peaks, grad_lines,
                               train_counts)
                if name == "causal_conv1d" else
                conv1d_bwd_summary(rows, train_counts, peaks))
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
