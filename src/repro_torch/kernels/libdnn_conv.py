"""libdnn-style fused im2col convolution as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``libdnn_conv`` in ``src/repro/kernels/
libdnn_conv.py``; the source is ``csrc/libdnn_conv.cu``.

What bounds it on the H100: at the paper's four layers a launch does 0.23
GFLOP and must move 1-10 MB, so in fp32 (IEEE, on CUDA cores) the
arithmetic bounds it. im2col and the product run in one kernel: a block
owns 64 output pixels by 64 output channels and walks the R·S·C
contraction 32 columns at a time, building the patch tile in shared
memory from the padded image (the ``(r, s, c)``-from-column index math)
beside the filter chunk, then contracting it. The patch never reaches
device memory, but every K tile rebuilds it: the paper's critique of
libdnn, kept. Stride 1 only (the router sends strided sites to ilpm); the
epilogue ``act(acc*scale + bias)`` runs on the fp32 accumulator and the
store converts once.

``libdnn_conv`` runs the kernel for a CUDA tensor and the plain version
(``ref.libdnn_conv``) for a CPU tensor; ``libdnn_conv.launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.libdnn_conv


def libdnn_conv(x_padded, w, *, scale=None, bias=None, act=None):
    """x_padded: (B, H+R-1, W+S-1, C) pre-padded; w: (R, S, C, K)
    -> (B, H, W, K) in ``x_padded.dtype``."""
    if x_padded.device.type == "cpu":
        return plain(x_padded, w, scale=scale, bias=bias, act=act)
    if x_padded.device.type != "cuda":
        raise ValueError(f"libdnn_conv: no kernel for {x_padded.device}")
    B, Hp, Wp, C = x_padded.shape
    R, S, Cw, K = w.shape
    H, W = Hp - R + 1, Wp - S + 1
    if Cw != C or H < 1 or W < 1:
        raise ValueError(f"libdnn_conv: bad geometry x "
                         f"{tuple(x_padded.shape)} w {tuple(w.shape)}")
    dev, dt = x_padded.device, x_padded.dtype
    name = "libdnn_conv"
    code = _build.kernel_dtype(name, x_padded)
    _build.check_operand(name, "x_padded", x_padded, dev, dt)
    _build.check_operand(name, "w", w, dev, dt)
    sc, bi = _build.epilogue_vectors(scale, bias, K, dev)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    err = _build.library().libdnn_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S, K, H, W,
        _build.act_code(act), _build.stream(dev))
    _build.check(err, name)
    libdnn_conv.launches += 1
    return out


libdnn_conv.launches = 0
