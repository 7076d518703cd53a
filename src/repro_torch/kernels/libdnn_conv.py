"""libdnn-style fused im2col convolution as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``libdnn_conv`` in ``src/repro/kernels/
libdnn_conv.py``; the source is ``csrc/libdnn_conv.cu``, on the split-K
tile of ``csrc/gemm_tile.cuh`` that ``gemm`` and ``pointwise_conv`` share.

What bounds it on the H100: at the paper's four layers a launch does 0.23
GFLOP and must move 1-10 MB, so in IEEE fp32 (CUDA cores) the arithmetic
bounds it and in bf16 (tensor cores) the bytes do. im2col and the product
run in one kernel: a (H·W, R·S·C) @ (R·S·C, K) product per image whose
row q is the patch of pixel (q // W, q % W), gathered from the padded
image chunk by chunk into shared memory (column k is tap k // C, channel
k % C). The patch never reaches device memory, but every K tile rebuilds
it: the paper's critique of libdnn, kept. The first kernel gave the 7² and
14² layers 8-16 CTAs, each walking the whole contraction; now
``gemm.conv_plan`` splits it by the product's shape and dtype (never by
the number of images), the splits' fp32 partial tiles go to a workspace
the wrapper allocates, and a second kernel of the same launch sums them
in split order and applies the epilogue ``act(acc*scale + bias)`` once,
with one cast. fp32 stays IEEE on the CUDA cores; bf16 and fp16 run on
the tensor cores where C and K are multiples of 8 (``gemm.conv_path``),
else on the CUDA cores. Stride 1 only (the router sends strided sites to
ilpm).

``libdnn_conv`` runs the kernel for a CUDA tensor and the plain version
(``ref.libdnn_conv``) for a CPU tensor; ``libdnn_conv.launches`` counts
the wrapper's launches (one launch is two device kernels where the plan
splits the contraction).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, gemm, ref

plain = ref.libdnn_conv


def plan(x_padded, w) -> tuple[int, int]:
    """(tile, split) of a launch on ``x_padded`` (B, H+R-1, W+S-1, C) and
    ``w`` (R, S, C, K): ``gemm.conv_plan`` of one image's product (H·W,
    R·S·C) @ (R·S·C, K) on the path the kernel takes."""
    _, Hp, Wp, C = x_padded.shape
    R, S, _, K = w.shape
    M = (Hp - R + 1) * (Wp - S + 1)
    return gemm.conv_plan(M, K, R * S * C, x_padded.dtype,
                          gemm.conv_path(x_padded, w))


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
    tile, split = plan(x_padded, w)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    ws = gemm.workspace(split, B, H * W, K, dev)
    err = _build.library().libdnn_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S, K, H, W,
        _build.act_code(act), tile, split,
        ws.data_ptr() if ws is not None else None, _build.stream(dev))
    _build.check(err, name)
    libdnn_conv.launches += 1
    return out


libdnn_conv.launches = 0
