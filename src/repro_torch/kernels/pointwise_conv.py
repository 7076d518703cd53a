"""Pointwise (1x1) convolution as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``pointwise_conv`` in ``src/repro/kernels/
pointwise_conv.py``; the source is ``csrc/pointwise_conv.cu``, on the
split-K tile of ``csrc/gemm_tile.cuh`` that ``gemm`` and ``libdnn_conv``
share.

What bounds it on the H100: MobileNetV2's and ResNet-18's 1x1 layers do
0.002-0.1 GFLOP over 0.1-5 MB, so in IEEE fp32 (CUDA cores) the deep 7²
and 14² layers are bound by their operations and the wide ones by their
bytes; in bf16 the bytes bound them all. A 1x1 conv is one (Ho·Wo, C) @
(C, K) product per image whose row q is the pixel ``x[(q // Wo)·s,
(q % Wo)·s]``, so a strided 1x1 reads only the pixels it uses, in the
load itself. The first kernel gave the deep layers 3-8 CTAs, each walking
all of C; now ``plan`` splits C (never by the number of images), the
splits' fp32 partial tiles go to a workspace the wrapper allocates, and a
second kernel of the same launch sums them in split order and applies
the epilogue ``act(acc*scale + bias)`` once, with one cast. fp32 stays
IEEE on the CUDA cores and splits at its 32-channel slabs, the fused
inverted residual's order; bf16 and fp16 split by ``gemm.conv_plan``
(the product's shape and dtype) and run on the tensor cores where C and
K are multiples of 8 (``gemm.conv_path``), else on the CUDA cores.

``pointwise_conv`` runs the kernel for a CUDA tensor and the plain
version (``ref.pointwise_conv``) for a CPU tensor;
``pointwise_conv.launches`` counts the wrapper's launches (one launch is
two device kernels where the plan splits C).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, gemm, ref

plain = ref.pointwise_conv


def plan(x, w, stride=1) -> tuple[int, int]:
    """(tile, split) of a launch on ``x`` (B, H, W, C) and ``w`` (1, 1, C,
    K). An fp32 ``x`` is split into its ``gemm.SLAB``-channel slabs, one a
    split (``gemm.split_bounds(C, chunk, split, gemm.SLAB)``): the order
    in which ``fused_inverted_residual`` sums its expand and its project,
    so the per-layer MobileNetV2 chain gives the fused block's bits. Any
    other dtype: ``gemm.conv_plan`` of one image's product (Ho·Wo, C) @
    (C, K) on the path the kernel takes."""
    _, H, W, C = x.shape
    if x.dtype == torch.float32:
        return gemm.TILE, -(-C // gemm.SLAB)
    M = -(-H // stride) * -(-W // stride)
    return gemm.conv_plan(M, w.shape[-1], C, x.dtype, gemm.conv_path(x, w))


def pointwise_conv(x, w, *, stride=1, scale=None, bias=None, act=None):
    """x: (B, H, W, C) unpadded; w: (1, 1, C, K)
    -> (B, ceil(H/stride), ceil(W/stride), K) in ``x.dtype``."""
    if x.device.type == "cpu":
        return plain(x, w, stride=stride, scale=scale, bias=bias, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"pointwise_conv: no kernel for {x.device}")
    B, H, W, C = x.shape
    R, S, Cw, K = w.shape
    if (R, S) != (1, 1) or Cw != C or stride < 1:
        raise ValueError(f"pointwise_conv: bad geometry x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} stride {stride}")
    dev, dt = x.device, x.dtype
    code = _build.kernel_dtype("pointwise_conv", x)
    _build.check_operand("pointwise_conv", "x", x, dev, dt)
    _build.check_operand("pointwise_conv", "w", w, dev, dt)
    sc, bi = _build.epilogue_vectors(scale, bias, K, dev)
    Ho, Wo = -(-H // stride), -(-W // stride)
    tile, split = plan(x, w, stride)
    out = torch.empty((B, Ho, Wo, K), dtype=dt, device=dev)
    ws = gemm.workspace(split, B, Ho * Wo, K, dev)
    err = _build.library().pointwise_conv_launch(
        code, x.data_ptr(), w.data_ptr(), sc.data_ptr(), bi.data_ptr(),
        out.data_ptr(), B, H, W, C, K, stride, _build.act_code(act), tile,
        split, ws.data_ptr() if ws is not None else None, _build.stream(dev))
    _build.check(err, "pointwise_conv")
    pointwise_conv.launches += 1
    return out


pointwise_conv.launches = 0
