"""Depthwise convolution as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``depthwise_conv`` in ``src/repro/kernels/
depthwise_conv.py``; the source is ``csrc/depthwise_conv.cu``.

What bounds it on the H100: a depthwise conv has no contraction (R·S
FMAs per output), so at every MobileNetV2 shape the bytes bound it. The
TPU kernel pins a channel slab of the padded image in VMEM and puts the
channels on lanes. The first kernel here gave a thread one output element
and read every tap through L1 (1.4-2.6x cuDNN). Now a CTA owns a
``tile_h`` x ``tile_w`` patch of output pixels x ``channels`` output
channels of one image, stages the patch's input halo once in shared memory
with ``cp.async`` in 16-byte runs, and each thread computes two
neighbouring pixels of one row x a 16-byte vector of channels (4 fp32, 8
bf16/fp16). A 3x3 filter at stride 1 or 2 with M = 1 and C a multiple of
the vector (every MobileNetV2 site) takes a kernel with the taps unrolled
over weights held in registers and the window slid in registers; every
other shape (another filter or stride, a channel multiplier M > 1, a
ragged C) takes a generic kernel on the same tiles. ``plan`` picks the
tile from the shape and dtype alone (never the number of images). Each
output is the chain of the fused inverted residual's depthwise stage (taps
r-major, s-inner from 0, then ``act(acc*scale + bias)``, one cast).

``depthwise_conv`` runs the kernel for a CUDA tensor and the plain version
(``ref.depthwise_conv``) for a CPU tensor; ``depthwise_conv.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, gemm, ref

plain = ref.depthwise_conv

# csrc/depthwise_conv.cu: output pixels a thread takes along a row
# (``PX``), threads a CTA at most, a block's shared-memory limit on sm_90
PIXELS = 2
MAX_THREADS = 256
MAX_TILES = 65535  # output tiles of an image: the grid's y
MAX_SMEM = 232448
# The plan's search (``options``, which gemm_sweep.py ``dw`` times):
# output tile rows and columns, and the fewest threads a CTA should have.
# A CTA takes PLAN_LANES channel vectors (128 bytes of each pixel), or the
# fewest powers of two of them that cover K. Among the tiles that give
# one image a CTA a SM (or the most CTAs any gives), the plan takes the
# least bytes on the busiest SM: ceil(CTAs / SMs) x a CTA's halo and
# outputs. gemm_sweep.py ``dw`` times every tile of ``options`` beside
# the pick at MobileNetV2's 10 depthwise classes, fp32 and bf16.
DW_TILE_H = (1, 2, 4, 8, 16)
DW_TILE_W = (2, 4, 8, 16)
MIN_THREADS = 32
PLAN_LANES = 8


class DwPlan(NamedTuple):
    """A launch plan of ``depthwise_conv``: a CTA's output tile rows and
    columns (a multiple of ``PIXELS``) and its output channels (a
    multiple of 16 bytes' worth)."""
    tile_h: int
    tile_w: int
    channels: int


def vector(dtype) -> int:
    """Channels in 16 bytes of ``dtype``: a thread's channel vector."""
    return 16 // torch.empty(0, dtype=dtype).element_size()


def threads(p: DwPlan, dtype) -> int:
    """Threads of one CTA: channel vectors x rows x pixel pairs."""
    return p.channels // vector(dtype) * p.tile_h * p.tile_w // PIXELS


def smem_bytes(p: DwPlan, r, s, stride, dtype) -> int:
    """Shared memory of one CTA: its input halo, ((tile_h-1)·stride + R)
    x ((tile_w-1)·stride + S) pixels x ``channels``, in ``dtype``."""
    size = torch.empty(0, dtype=dtype).element_size()
    return ((p.tile_h - 1) * stride + r) * ((p.tile_w - 1) * stride + s) \
        * p.channels * size


def ctas(p: DwPlan, h, w, k) -> int:
    """CTAs of one image: output tiles x channel groups."""
    return -(-h // p.tile_h) * -(-w // p.tile_w) * -(-k // p.channels)


def channels(k, dtype) -> int:
    """A CTA's output channels: ``PLAN_LANES`` vectors, or the fewest
    powers of two of vectors that cover ``k``."""
    lanes = 1
    while lanes < PLAN_LANES and lanes * vector(dtype) < k:
        lanes *= 2
    return lanes * vector(dtype)


def options(h, w, k, r, s, stride, dtype) -> list[DwPlan]:
    """The tiles ``plan`` chooses from, each on ``channels(k, dtype)``:
    every (tile_h, tile_w) of the search with at most ``MAX_TILES`` tiles
    an image, whose CTA has at most ``MAX_THREADS`` threads, fits shared
    memory and is not wider than the output needs (a row and a thread's
    pixels the least); at least ``MIN_THREADS`` threads a CTA where any
    option has them."""
    group = channels(k, dtype)
    out = []
    for th in DW_TILE_H:
        for tw in DW_TILE_W:
            p = DwPlan(th, tw, group)
            if (-(-h // th) * -(-w // tw) > MAX_TILES
                    or threads(p, dtype) > MAX_THREADS
                    or smem_bytes(p, r, s, stride, dtype) > MAX_SMEM
                    or (th > 1 and th // 2 >= h)
                    or (tw > PIXELS and tw // 2 >= w)):
                continue
            out.append(p)
    wide = [p for p in out if threads(p, dtype) >= MIN_THREADS]
    return wide or out


def sm_bytes(p: DwPlan, h, w, k, r, s, stride, dtype) -> int:
    """Bytes the busiest SM moves in one image's launch: ceil(CTAs / SMs)
    CTAs, each its halo and its outputs."""
    size = torch.empty(0, dtype=dtype).element_size()
    cta = smem_bytes(p, r, s, stride, dtype) \
        + p.tile_h * p.tile_w * p.channels * size
    return -(-ctas(p, h, w, k) // gemm.SMS) * cta


def min_ctas(h, w, k, r, s, stride, dtype) -> int:
    """The CTAs ``plan`` promises one image: one a SM (``gemm.SMS``), or
    the most any of its ``options`` gives."""
    return min(gemm.SMS, max(ctas(p, h, w, k) for p in
                             options(h, w, k, r, s, stride, dtype)))


@functools.lru_cache(maxsize=1024)
def _plan(h, w, c, k, r, s, stride, dtype) -> DwPlan:
    least = min_ctas(h, w, k, r, s, stride, dtype)
    fill = [p for p in options(h, w, k, r, s, stride, dtype)
            if ctas(p, h, w, k) >= least]
    if not fill:
        raise ValueError(f"depthwise_conv: no tile fits shared memory for "
                         f"a {r}x{s} filter at stride {stride}")
    return min(fill, key=lambda p: sm_bytes(p, h, w, k, r, s, stride, dtype))


def plan(x_padded, w, stride=1) -> DwPlan:
    """The launch plan of ``depthwise_conv`` on ``x_padded`` (B, Hp, Wp,
    C) and ``w`` (R, S, 1, K): among its ``options`` that give at least
    ``min_ctas``, the least ``sm_bytes``, the first of a tie (smaller
    tiles first). A pure function of shape and dtype: never sees the
    number of images or the device. Memoised: an engine plans every
    depthwise site of every image."""
    _, Hp, Wp, C = x_padded.shape
    R, S, _, K = w.shape
    H = (Hp - R) // stride + 1
    W = (Wp - S) // stride + 1
    return _plan(H, W, C, K, R, S, stride, x_padded.dtype)


def kernel_of(x_padded, w, stride, *aligned) -> str:
    """Which kernel of ``csrc/depthwise_conv.cu`` a launch takes, as its
    launcher decides: ``"3x3"`` (M = 1, stride 1 or 2, C a multiple of a
    vector, x, w and the other tensors of ``aligned`` 16-byte aligned) or
    ``"generic"`` (every other shape)."""
    R, S, _, K = w.shape
    C = x_padded.shape[-1]
    vec = C % vector(x_padded.dtype) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x_padded, w, *aligned))
    return "3x3" if (R, S) == (3, 3) and K == C and stride in (1, 2) \
        and vec else "generic"


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
    p = plan(x_padded, w, stride)
    if threads(p, dt) > MAX_THREADS or p.tile_w % PIXELS \
            or p.channels % vector(dt) \
            or smem_bytes(p, R, S, stride, dt) > MAX_SMEM:
        raise ValueError(f"{name}: plan {p} does not fit a CTA")
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    err = _build.library().depthwise_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S, K, H, W, stride,
        _build.act_code(act), p.tile_h, p.tile_w, p.channels,
        _build.stream(dev))
    _build.check(err, name)
    depthwise_conv.launches += 1
    return out


depthwise_conv.launches = 0
