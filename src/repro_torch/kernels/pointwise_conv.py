"""Pointwise (1x1) convolution as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``pointwise_conv`` in ``src/repro/kernels/
pointwise_conv.py``; the source is ``csrc/pointwise_conv.cu``.

What bounds it on the H100: each ResNet-18 projection shortcut does
0.013 GFLOP and must move about 0.65 MB in fp32, so in fp32 (CUDA cores)
the arithmetic and the bytes take about the same time and in bf16 the
bytes bound it. A 1x1 conv has no halo, so the kernel tiles
output pixels as a flat run (64 pixels x 64 channels a block) and stages
32-channel chunks of pixel rows and filter rows in shared memory. A
strided 1x1 reads only the pixels ``x[::s, ::s]`` it uses, in the load
itself, with no gather pass. The epilogue ``act(acc*scale + bias)`` runs
on the fp32 accumulator and the store converts once.

``pointwise_conv`` runs the kernel for a CUDA tensor and the plain
version (``ref.pointwise_conv``) for a CPU tensor;
``pointwise_conv.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.pointwise_conv


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
    out = torch.empty((B, -(-H // stride), -(-W // stride), K), dtype=dt,
                      device=dev)
    err = _build.library().pointwise_conv_launch(
        code, x.data_ptr(), w.data_ptr(), sc.data_ptr(), bi.data_ptr(),
        out.data_ptr(), B, H, W, C, K, stride, _build.act_code(act),
        _build.stream(dev))
    _build.check(err, "pointwise_conv")
    pointwise_conv.launches += 1
    return out


pointwise_conv.launches = 0
