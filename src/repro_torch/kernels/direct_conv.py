"""Direct convolution, the paper's strongest existing baseline, as a CUDA
kernel for Hopper.

Replaces the Pallas kernel ``direct_conv`` in ``src/repro/kernels/
direct_conv.py``; the source is ``csrc/direct_conv.cu``.

What bounds it on the H100: at ResNet-18's layers a launch does 0.12-0.23
GFLOP and must move 1-10 MB, so in fp32 (IEEE, on CUDA cores) the
arithmetic bounds it. Direct keeps its own structure: output pixels in row
bands (whole rows, at most 64 pixels; a wider row is cut into equal
segments) with the filter bank as the operand held on chip. The TPU kernel
keeps the whole bank resident, which does not fit a block's shared memory
(3x3x512x512 fp32 is 9.4 MB), so each block stages its 64-channel slab of
the bank 32 contraction rows at a time and reuses each chunk over every
pixel of its band; the image is never staged, each thread reads its taps
through L1. Stride 1 or 2; the epilogue ``act(acc*scale + bias)`` runs on
the fp32 accumulator and the store converts once.

``direct_conv`` runs the kernel for a CUDA tensor and the plain version
(``ref.direct_conv``) for a CPU tensor; ``direct_conv.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.direct_conv


def direct_conv(x_padded, w, *, stride=1, scale=None, bias=None, act=None):
    """x_padded: (B, (H-1)*stride+R, (W-1)*stride+S, C) pre-padded;
    w: (R, S, C, K) -> (B, H, W, K) in ``x_padded.dtype``."""
    if x_padded.device.type == "cpu":
        return plain(x_padded, w, stride=stride, scale=scale, bias=bias,
                     act=act)
    if x_padded.device.type != "cuda":
        raise ValueError(f"direct_conv: no kernel for {x_padded.device}")
    B, Hp, Wp, C = x_padded.shape
    R, S, Cw, K = w.shape
    H = (Hp - R) // stride + 1
    W = (Wp - S) // stride + 1
    if stride < 1 or Cw != C or H < 1 or W < 1:
        raise ValueError(f"direct_conv: bad geometry x "
                         f"{tuple(x_padded.shape)} w {tuple(w.shape)} "
                         f"stride {stride}")
    dev, dt = x_padded.device, x_padded.dtype
    name = "direct_conv"
    code = _build.kernel_dtype(name, x_padded)
    _build.check_operand(name, "x_padded", x_padded, dev, dt)
    _build.check_operand(name, "w", w, dev, dt)
    sc, bi = _build.epilogue_vectors(scale, bias, K, dev)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    err = _build.library().direct_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S, K, H, W, stride,
        _build.act_code(act), _build.stream(dev))
    _build.check(err, name)
    direct_conv.launches += 1
    return out


direct_conv.launches = 0
