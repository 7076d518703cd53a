"""ILP-M convolution: the paper's algorithm, as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``ilpm_conv`` in ``src/repro/kernels/
ilpm_conv.py``; the source is ``csrc/ilpm_conv.cu`` over the halo'd-tile
body in ``csrc/conv_tile.cuh``.

What bounds it on the H100: at the ResNet-18 shapes a launch does 0.12-
0.24 GFLOP and must move 1-10 MB, so in fp32 (IEEE, on CUDA cores) the
arithmetic bounds it; in bf16 the bytes do. The TPU kernel keeps the whole
padded image resident across the K grid, which does not fit a Hopper
block's shared memory (a padded 58x58x64 fp32 activation is 861 KB of the
227 KB), so each block stages an 8x8-output halo'd tile, chunk by chunk of
C, and reuses it over a 64-channel filter slab and all R·S taps: one
filter slab per image tile, the paper's ratio, cut to fit. Stride 2 is
strided taps into the same staged tile. The epilogue ``act(acc*scale +
bias)`` runs on the fp32 accumulator and the store converts once.

``ilpm_conv`` runs the kernel for a CUDA tensor and the plain version
(``ref.ilpm_conv``) for a CPU tensor; ``ilpm_conv.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.ilpm_conv


def ilpm_conv(x_padded, w, *, stride=1, scale=None, bias=None, act=None):
    """x_padded: (B, (H-1)*stride+R, (W-1)*stride+S, C) pre-padded;
    w: (R, S, C, K) -> (B, H, W, K) in ``x_padded.dtype``."""
    if x_padded.device.type == "cpu":
        return plain(x_padded, w, stride=stride, scale=scale, bias=bias,
                     act=act)
    if x_padded.device.type != "cuda":
        raise ValueError(f"ilpm_conv: no kernel for {x_padded.device}")
    B, Hp, Wp, C = x_padded.shape
    R, S, Cw, K = w.shape
    H = (Hp - R) // stride + 1
    W = (Wp - S) // stride + 1
    if stride < 1 or Cw != C or H < 1 or W < 1:
        raise ValueError(f"ilpm_conv: bad geometry x {tuple(x_padded.shape)}"
                         f" w {tuple(w.shape)} stride {stride}")
    dev, dt = x_padded.device, x_padded.dtype
    code = _build.kernel_dtype("ilpm_conv", x_padded)
    _build.check_operand("ilpm_conv", "x_padded", x_padded, dev, dt)
    _build.check_operand("ilpm_conv", "w", w, dev, dt)
    sc, bi = _build.epilogue_vectors(scale, bias, K, dev)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    err = _build.library().ilpm_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S, K, H, W, stride,
        _build.act_code(act), _build.stream(dev))
    _build.check(err, "ilpm_conv")
    ilpm_conv.launches += 1
    return out


ilpm_conv.launches = 0
