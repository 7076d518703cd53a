"""Direct convolution, the paper's strongest existing baseline, as a CUDA
kernel for Hopper.

Replaces the Pallas kernel ``direct_conv`` in ``src/repro/kernels/
direct_conv.py``; the source is ``csrc/direct_conv.cu``, which uses the
copies, ``ldmatrix``, ``mma.sync`` and split reduction of
``csrc/gemm_tile.cuh`` under a main loop of its own.

What bounds it on the H100: at ResNet-18's layers a launch does 0.12-0.23
GFLOP and must move 1-10 MB, so in IEEE fp32 (CUDA cores, 67 TFLOP/s) the
arithmetic bounds it (forced direct's 20 launches: 0.0541 ms per image)
and in bf16 or fp16 (tensor cores) the bytes do. Direct keeps the TPU
kernel's structure, the paper's CONV_CACHE_FILTER: the filter bank is held
on chip and the pixels stream past it. A bank does not fit a block's
shared memory (3x3x512x512 fp32 is 9.4 MB), so a CTA stages one slice of
it, a 64-wide K tile over a contiguous range of the flattened R·S·C
contraction, before anything else, and streams one 64-pixel tile of one
image past it, gathering the tile's patch rows chunk by chunk
(double-buffered ``cp.async``). Each pixel tile's CTA stages its slice
anew (from L2): walking several tiles past one staged slice left fewer
CTAs and was slower at every ResNet-18 class (``gemm_sweep.py``). The
first kernel walked the whole contraction in 8-28 CTAs with a scalar
global load per 4 FMAs; now ``plan`` cuts the contraction into slices
from the shape and dtype only (never the number of images), the slices' fp32
partials go to a workspace that a second kernel of the same launch sums in
slice order and passes through the epilogue ``act(acc*scale + bias)``
once, with one cast. fp32 stays IEEE ``fmaf`` on the CUDA cores (4 pixels
x 4 channels a thread); bf16 and fp16 run ``mma.sync`` where C and K are
multiples of 8 and x and w are 16-byte aligned (``gemm.conv_path``), any
other 16-bit shape (the C = 3 stem, ragged C or K) on the CUDA cores of the
same kernel. Stride 1 or 2.

``direct_conv`` runs the kernel for a CUDA tensor and the plain version
(``ref.direct_conv``) for a CPU tensor; ``direct_conv.launches`` counts the
wrapper's launches (one launch is two device kernels where the plan cuts
the contraction into slices).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, gemm, ref

plain = ref.direct_conv

TILE = 64    # output pixels of a tile
TILE_K = 64  # output channels of a CTA
CHUNK = gemm.CHUNK  # contraction rows a gathered chunk holds, by path
TC_PAD = 8   # tensor cores: elements padding a staged row
# Where the pixel tiles x K tiles of one image fall below the card's SMS,
# the contraction is cut into slices until the grid reaches MIN_CTAS, at
# most MAX_SLICES and one chunk a slice; a grid that fills the card
# unsplit (the 7x7 stem, 196 tiles) is not split. Read from gemm_sweep.py
# (``direct``, a ladder of slice counts at forced direct's classes, one
# H100): the pick is within 10% of the fastest at all 22 class x dtype
# lines, 9.8% off at the fp32 56² 3x3 (6 slices against 8).
MIN_CTAS = 256
MAX_SLICES = 32
MAX_SMEM = 232448  # a block's shared-memory limit on sm_90


class DirectPlan(NamedTuple):
    """A launch plan of ``direct_conv``: its path (``"fp32"``: CUDA cores,
    ``"tensor"``: mma.sync), pixels per tile (one tile a CTA), contraction
    rows per chunk and contraction slices."""
    path: str
    tile: int
    chunk: int
    slices: int


def smem_bytes(path, itemsize, chunk, depth):
    """Shared memory of one CTA, as ``csrc/direct_conv.cu`` sizes it: two
    stages of the gathered patch tile (rows padded by 16 bytes) and the
    resident filter slice of ``depth`` rows (padded on the tensor
    cores)."""
    if path == "tensor":
        return itemsize * (2 * TILE * (chunk + TC_PAD)
                           + depth * (TILE_K + TC_PAD))
    return itemsize * (2 * TILE * (chunk + 16 // itemsize) + depth * TILE_K)


def slice_depth(chunks, chunk, slices):
    """Filter rows a CTA stages: the most chunks a slice takes, in rows."""
    return -(-chunks // slices) * chunk


def plan(x_padded, w, stride) -> DirectPlan:
    """The launch plan of a direct conv of ``x_padded`` (B, Hp, Wp, C)
    with ``w`` (R, S, C, K) at ``stride``: the path ``gemm.conv_path``
    gives; the fewest slices of the R·S·C contraction whose deepest slice
    fits shared memory, raised while one image's grid (slices x K tiles x
    pixel tiles) has fewer than ``MIN_CTAS`` CTAs, where the unsplit grid
    has fewer than ``gemm.SMS``, up to ``MAX_SLICES`` and the number of
    chunks. Never sees the number of images."""
    _, Hp, Wp, C = x_padded.shape
    R, S, _, K = w.shape
    H, W = (Hp - R) // stride + 1, (Wp - S) // stride + 1
    path = gemm.conv_path(x_padded, w)
    size = x_padded.element_size()
    chunk = CHUNK[path]
    chunks = -(-R * S * C // chunk)
    grid = -(-K // TILE_K) * -(-H * W // TILE)
    slices = 1
    while smem_bytes(path, size, chunk,
                     slice_depth(chunks, chunk, slices)) > MAX_SMEM:
        slices += 1
        if slices > chunks:
            raise ValueError(f"direct_conv: no slice fits shared memory "
                             f"for w {tuple(w.shape)}")
    if grid < gemm.SMS:
        while grid * slices < MIN_CTAS and slices < min(MAX_SLICES, chunks):
            slices += 1
    return DirectPlan(path, TILE, chunk, slices)


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
    p = plan(x_padded, w, stride)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    ws = gemm.workspace(p.slices, B, H * W, K, dev)
    err = _build.library().direct_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S, K, H, W, stride,
        _build.act_code(act), p.tile, p.slices,
        ws.data_ptr() if ws is not None else None, _build.stream(dev))
    _build.check(err, name)
    direct_conv.launches += 1
    return out


direct_conv.launches = 0
