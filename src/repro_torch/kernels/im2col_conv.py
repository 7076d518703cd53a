"""im2col convolution, the paper's most popular baseline: an unroll
kernel for Hopper, then the ``gemm`` kernel, then the epilogue pass.

Replaces the Pallas kernel ``im2col_unroll`` and its composition
``im2col_conv`` in ``src/repro/kernels/im2col_conv.py``; the source is
``csrc/im2col_unroll.cu``.

What bounds it on the H100: the unroll is a pure copy, bound by bytes; it
writes the whole (H·W, R·S·C) patch matrix, R·S times the image, to device
memory, and ``gemm`` reads it back. That round trip is the algorithm's
cost in the paper (Table 3), so the two phases stay separate kernels; the
fused form is ``libdnn_conv``. The unroll's lanes run along C, so reads
and writes coalesce, 16 bytes a lane where the channel run allows; it
moves bits, so it equals its plain version bitwise. The folded-BN
epilogue is a third pass of PyTorch ops (``ref.apply_epilogue``), as the
JAX package computes it outside any kernel: the GEMM writes the compute
dtype and the epilogue rounds again.

``im2col_unroll`` runs the kernel for a CUDA tensor and the plain version
(``ref.im2col_unroll``) for a CPU tensor; ``im2col_unroll.launches`` counts
the kernel's launches. ``im2col_conv`` launches the unroll and the GEMM
once each.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gemm import gemm

plain = ref.im2col_unroll


def im2col_unroll(x_padded, r, s):
    """x_padded: (B, H+r-1, W+s-1, C) -> (B, H*W, r*s*C) in
    ``x_padded.dtype``, columns ordered ``(r*S + s)*C + c``."""
    if x_padded.device.type == "cpu":
        return plain(x_padded, r, s)
    if x_padded.device.type != "cuda":
        raise ValueError(f"im2col_unroll: no kernel for {x_padded.device}")
    B, Hp, Wp, C = x_padded.shape
    H, W = Hp - r + 1, Wp - s + 1
    if H < 1 or W < 1 or r < 1 or s < 1:
        raise ValueError(f"im2col_unroll: bad geometry x "
                         f"{tuple(x_padded.shape)} filter {r}x{s}")
    dev, dt = x_padded.device, x_padded.dtype
    code = _build.kernel_dtype("im2col_unroll", x_padded)
    _build.check_operand("im2col_unroll", "x_padded", x_padded, dev, dt)
    out = torch.empty((B, H * W, r * s * C), dtype=dt, device=dev)
    err = _build.library().im2col_unroll_launch(
        code, x_padded.data_ptr(), out.data_ptr(), B, Hp, Wp, C, r, s, H, W,
        _build.stream(dev))
    _build.check(err, "im2col_unroll")
    im2col_unroll.launches += 1
    return out


im2col_unroll.launches = 0


def im2col_conv(x_padded, w, *, scale=None, bias=None, act=None):
    """Stride-1 im2col: x_padded (B, H+R-1, W+S-1, C), w (R,S,C,K)
    -> (B,H,W,K). The patch matrix goes through device memory between the
    unroll and the GEMM; the epilogue is a separate pass."""
    R, S, C, K = w.shape
    B, Hp, Wp, _ = x_padded.shape
    patches = im2col_unroll(x_padded, R, S)
    out = gemm(patches, w.reshape(R * S * C, K))
    return ref.apply_epilogue(out.reshape(B, Hp - R + 1, Wp - S + 1, K),
                              scale, bias, act)
