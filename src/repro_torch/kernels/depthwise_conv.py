"""Depthwise convolution as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``depthwise_conv`` in ``src/repro/kernels/
depthwise_conv.py``; the source is ``csrc/depthwise_conv.cu``.

What bounds it on the H100: a depthwise conv has no contraction (R·S
FMAs per output), so at every MobileNetV2 shape the bytes bound it. The
TPU kernel pins a channel slab of the padded image in VMEM and puts the
channels on lanes; here the 32 lanes of a warp take 32 neighbouring
channels of one output pixel, so every load and the store coalesce, and
the grid is (pixel groups, channel groups, batch) so that even the 7x7x960
layer fills the card. Each thread runs the R×S tap loop at stride 1 or 2,
reading input channel ``k // M`` for output channel ``k``; the epilogue
``act(acc*scale + bias)`` runs on the fp32 accumulator and the store
converts once.

``depthwise_conv`` runs the kernel for a CUDA tensor and the plain version
(``ref.depthwise_conv``) for a CPU tensor; ``depthwise_conv.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.depthwise_conv


def depthwise_conv(x_padded, w, *, stride=1, scale=None, bias=None,
                   act=None):
    """x_padded: (B, (H-1)*stride+R, (W-1)*stride+S, C) pre-padded;
    w: (R, S, 1, M*C) -> (B, H, W, M*C) in ``x_padded.dtype``."""
    if x_padded.device.type == "cpu":
        return plain(x_padded, w, stride=stride, scale=scale, bias=bias,
                     act=act)
    if x_padded.device.type != "cuda":
        raise ValueError(f"depthwise_conv: no kernel for {x_padded.device}")
    B, Hp, Wp, C = x_padded.shape
    R, S, one, K = w.shape
    H = (Hp - R) // stride + 1
    W = (Wp - S) // stride + 1
    if stride < 1 or one != 1 or K % C or H < 1 or W < 1:
        raise ValueError(f"depthwise_conv: bad geometry x "
                         f"{tuple(x_padded.shape)} w {tuple(w.shape)} "
                         f"stride {stride}")
    dev, dt = x_padded.device, x_padded.dtype
    name = "depthwise_conv"
    code = _build.kernel_dtype(name, x_padded)
    _build.check_operand(name, "x_padded", x_padded, dev, dt)
    _build.check_operand(name, "w", w, dev, dt)
    sc, bi = _build.epilogue_vectors(scale, bias, K, dev)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    err = _build.library().depthwise_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S, K, H, W, stride,
        _build.act_code(act), _build.stream(dev))
    _build.check(err, name)
    depthwise_conv.launches += 1
    return out


depthwise_conv.launches = 0
