"""ILP-M convolution: the paper's algorithm, as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``ilpm_conv`` in ``src/repro/kernels/
ilpm_conv.py``; the source is ``csrc/ilpm_conv.cu`` over the halo-resident,
split conv tile of ``csrc/conv_tile.cuh``, which ``fused_residual_conv``
shares. This module plans both (``plan``).

What bounds it on the H100: at ResNet-18's shapes a launch does 0.12-0.24
GFLOP and must move 1-10 MB, so in IEEE fp32 (CUDA cores, 67 TFLOP/s) the
arithmetic bounds it (the tuned path's 9 launches: 0.0260 ms per image)
and in bf16 or fp16 (tensor cores) the bytes do. The TPU kernel keeps the
whole padded image resident across the K grid, which does not fit a Hopper
block's shared memory, so a CTA owns an 8x8 output tile, 64 output
channels and one image: it stages the halo'd input tile once per channel
chunk with ``cp.async`` (double-buffered, in the input's dtype) and reads
every R·S tap of the chunk from shared memory as a shifted, at stride 2
strided, window of it, against a 64-channel filter slab. The first tile
walked the whole C·R·S contraction alone in each CTA (8 CTAs at 7²) with
scalar staging and no tensor cores; now ``plan`` splits the contraction
over channel chunks, and over filter rows where chunks alone cannot fill
the card, from the shape and dtype only (never the number of images). The
parts' fp32 partial tiles go to a workspace that a second kernel of the
same launch sums in part order and passes through the epilogue
``act(acc*scale + bias)`` once, with one cast; unsplit, the epilogue runs
in registers. fp32 stays IEEE ``fmaf`` on the CUDA cores (8 pixels x 4
channels a thread); bf16 and fp16 run ``mma.sync`` fed by ``ldmatrix``
from the staged tile where C and K are multiples of 8 and x and w are
16-byte aligned (``gemm.conv_path``), any other 16-bit shape (the C = 3
stems, ragged C or K) on the CUDA cores of the same kernel.

``ilpm_conv`` runs the kernel for a CUDA tensor and the plain version
(``ref.ilpm_conv``) for a CPU tensor; ``ilpm_conv.launches`` counts the
wrapper's launches (one launch is two device kernels where the plan splits
the contraction).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, gemm, ref

plain = ref.ilpm_conv

TILE = 8     # output pixels per CTA: TILE x TILE
TILE_K = 64  # output channels per CTA
# channels per chunk, at most and at least, by path; a chunk is halved
# while two stages of it overflow a block's shared memory
CHUNK = {"fp32": 16, "tensor": 32}
MIN_CHUNK = {"fp32": 4, "tensor": 16}
TC_PAD = 8   # tensor cores: elements padding a staged pixel and filter row
# CTAs one image's grid should reach by splitting the channel chunks (4
# warps a CTA on both paths). Below ROW_SPLIT_BELOW CTAs every filter row
# becomes a part of its own; below MIN_CTAS the rows are halved where a
# filter row of a chunk holds at least MIN_ROW_DEPTH products (S x chunk:
# the 7x7 stem's 28 and the 56² 3x3s' 48, not MobileNetV2's 3x3 stem's
# 12, whose workspace round trip costs more than its taps). Measured with
# gemm_sweep.py: the fastest split at every class of the two kernels in
# fp32 and bf16 but one, within 10% there.
MIN_CTAS = {"fp32": 256, "tensor": 128}
ROW_SPLIT_BELOW = 132
MIN_ROW_DEPTH = 16
MAX_SPLIT = 16
MAX_SMEM = 232448  # a block's shared-memory limit on sm_90


class ConvPlan(NamedTuple):
    """A launch plan of the conv tile: its path (``"fp32"``: CUDA cores,
    ``"tensor"``: mma.sync), output tile side, channels per chunk,
    channel-chunk splits and filter-row splits."""
    path: str
    tile: int
    chunk: int
    split: int
    rsplit: int

    @property
    def parts(self) -> int:
        """Partial sums the reduction adds: split x rsplit."""
        return self.split * self.rsplit


def smem_bytes(path, itemsize, chunk, R, S, stride, rsplit, stages=2):
    """Shared memory of one CTA, as ``csrc/conv_tile.cuh`` sizes it: per
    stage the halo'd tile (rows for the most filter rows a part takes,
    columns rounded up to whole stride phases) and the filter rows of its
    taps, each row padded on the tensor cores."""
    pad = TC_PAD if path == "tensor" else 0
    nr = -(-R // rsplit)
    iw = (TILE - 1) * stride + S
    halo = ((TILE - 1) * stride + nr) * -(-iw // stride) * stride \
        * (chunk + pad)
    run = 16 // itemsize
    halo = -(-halo // run) * run
    return stages * (halo + nr * S * chunk * (TILE_K + pad)) * itemsize


def plan(x_padded, w, stride) -> ConvPlan:
    """The launch plan of a conv of ``x_padded`` (B, Hp, Wp, C) with ``w``
    (R, S, C, K) at ``stride``: the path ``gemm.conv_path`` gives; the
    smallest power of two of channels at least C, within the path's chunk
    (halved while two stages overflow shared memory); the smallest
    power-of-two split of the chunks that gives one image's grid (output
    tiles x channel slabs) ``MIN_CTAS``, at most ``MAX_SPLIT`` and the
    number of chunks; every filter row a part of its own while the grid
    stays below ``ROW_SPLIT_BELOW`` CTAs, or where a chunk of the least
    width does not fit otherwise; the rows halved while it stays below
    ``MIN_CTAS`` and a filter row of a chunk holds ``MIN_ROW_DEPTH``
    products. Never sees the number of images."""
    _, Hp, Wp, C = x_padded.shape
    R, S, _, K = w.shape
    H, W = (Hp - R) // stride + 1, (Wp - S) // stride + 1
    path = gemm.conv_path(x_padded, w)
    size = x_padded.element_size()
    chunk = MIN_CHUNK[path]
    while chunk < min(C, CHUNK[path]):
        chunk *= 2
    while chunk > MIN_CHUNK[path] and smem_bytes(
            path, size, chunk, R, S, stride, 1) > MAX_SMEM:
        chunk //= 2
    chunks = -(-C // chunk)
    ctas = -(-H // TILE) * -(-W // TILE) * -(-K // TILE_K)
    split = 1
    while ctas * split < MIN_CTAS[path] and 2 * split <= min(MAX_SPLIT,
                                                             chunks):
        split *= 2
    rsplit = 1
    if R > 1 and ctas * split < ROW_SPLIT_BELOW:
        rsplit = R
    elif R > 1 and ctas * split < MIN_CTAS[path] \
            and S * chunk >= MIN_ROW_DEPTH:
        rsplit = 2
    if smem_bytes(path, size, chunk, R, S, stride, rsplit) > MAX_SMEM:
        rsplit = R
    if smem_bytes(path, size, chunk, R, S, stride, rsplit) > MAX_SMEM:
        raise ValueError(f"conv tile: no chunk fits shared memory for w "
                         f"{tuple(w.shape)} at stride {stride}")
    return ConvPlan(path, TILE, chunk, split, rsplit)


def launch_args(p, ws, device) -> tuple:
    """The trailing arguments of a conv tile entry point: tile, chunk,
    split, rsplit, the workspace and the stream."""
    return (p.tile, p.chunk, p.split, p.rsplit,
            ws.data_ptr() if ws is not None else None, _build.stream(device))


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
    p = plan(x_padded, w, stride)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    ws = gemm.workspace(p.parts, B, H * W, K, dev)
    err = _build.library().ilpm_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S, K, H, W, stride,
        _build.act_code(act), *launch_args(p, ws, dev))
    _build.check(err, "ilpm_conv")
    ilpm_conv.launches += 1
    return out


ilpm_conv.launches = 0
