"""im2col convolution, the paper's most popular baseline: an unroll
kernel for Hopper, then the ``gemm`` kernel, then the epilogue pass.

Replaces the Pallas kernel ``im2col_unroll`` and its composition
``im2col_conv`` in ``src/repro/kernels/im2col_conv.py``; the source is
``csrc/im2col_unroll.cu``.

What bounds it on the H100: the unroll is a pure copy whose output, the
(H·W, R·S·C) patch matrix, is R·S times the image, so the bytes written
bound it; ``gemm`` reads the matrix back. That round trip is the
algorithm's cost in the paper (Table 3), so the two phases stay separate
kernels; the fused form is ``libdnn_conv``. The first kernel moved one
16-byte unit a thread over the whole output with 64-bit divisions per
unit and fetched each input R·S times through L1/L2 (2.6x its bound at
56²x64). Now a CTA owns one output row's run of ``pixels`` pixels x a
group of ``channels`` channels of one image, stages their input halo once
in shared memory with ``cp.async`` and writes its patch rows from there,
16 bytes a lane where the channel run allows (8, 4 or 2 else), the 3x3
taps unrolled. ``plan`` picks the run and group from the shape and dtype
alone (never the number of images). The copy moves bits, so it equals its plain
version bitwise. The folded-BN epilogue is a third pass of PyTorch ops
(``ref.apply_epilogue``), as the JAX package computes it outside any
kernel: the GEMM writes the compute dtype and the epilogue rounds again.

``im2col_unroll`` runs the kernel for a CUDA tensor and the plain version
(``ref.im2col_unroll``) for a CPU tensor; ``im2col_unroll.launches`` counts
the kernel's launches. ``im2col_conv`` launches the unroll and the GEMM
once each.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gemm import SMS, gemm

plain = ref.im2col_unroll

# csrc/im2col_unroll.cu: a block's shared-memory limit on sm_90, and the
# share of an SM's 228 KB (less 1 KB a CTA) that lets two CTAs sit on it
MAX_SMEM = 232448
CTA_SMEM = 233472 // 2 - 1024
# The plan's search (``options``, which gemm_sweep.py ``unroll`` times): a
# CTA's output pixels along a row, and its channel group in bytes where it
# does not take all of C. Among the options whose CTA writes at least
# ``MIN_ROW_BYTES`` of patch rows (all options where none does), and of those
# that give one image ``MIN_CTAS`` CTAs (or the most any gives), the plan
# takes the least bytes on the busiest SM: ceil(CTAs / SMs) x a CTA's
# halo and patch rows. In the sweep, CTAs of a few hundred bytes to 4 KB
# (1-2 pixels x 128 bytes, 400-800 CTAs) lost 0.2-0.5 µs at 28² and
# below; within its noise (0.1-0.3 µs) no floor of 2 x SMs CTAs helped.
UNROLL_PIXELS = (1, 2, 4, 8, 16, 32, 64)
GROUP_BYTES = (128, 256, 512, 1024)
MIN_ROW_BYTES = 8192
MIN_CTAS = SMS // 2


class UnrollPlan(NamedTuple):
    """A launch plan of ``im2col_unroll``: a CTA's run of output pixels
    and its channels (all of C, or a multiple of 16 bytes' worth)."""
    pixels: int
    channels: int


def unit_bytes(run: int) -> int:
    """The unit the kernel moves a pixel's ``run`` bytes of channels in,
    for aligned tensors: the widest of 16, 8, 4 and 2 bytes that divides
    it (``csrc/im2col_unroll.cu`` ``unit_bytes``, which also needs both
    addresses to be multiples of it)."""
    return next(u for u in (16, 8, 4, 2) if run % u == 0)


def smem_bytes(p: UnrollPlan, r, s, dtype) -> int:
    """Shared memory of one CTA: its halo, R rows x (pixels + S - 1)
    columns x ``channels``."""
    size = torch.empty(0, dtype=dtype).element_size()
    return r * (p.pixels + s - 1) * p.channels * size


def ctas(p: UnrollPlan, h, w, c) -> int:
    """CTAs of one image: output rows x pixel runs x channel groups."""
    return h * -(-w // p.pixels) * -(-c // p.channels)


def row_bytes(p: UnrollPlan, w, c, r, s, dtype) -> int:
    """Bytes of patch rows one full CTA writes."""
    size = torch.empty(0, dtype=dtype).element_size()
    return min(p.pixels, w) * r * s * min(p.channels, c) * size


def sm_bytes(p: UnrollPlan, h, w, c, r, s, dtype) -> int:
    """Bytes the busiest SM moves in one image's launch: ceil(CTAs / SMs)
    CTAs, each its halo and its patch rows."""
    size = torch.empty(0, dtype=dtype).element_size()
    cta = r * (p.pixels + s - 1) * p.channels * size \
        + p.pixels * r * s * p.channels * size
    return -(-ctas(p, h, w, c) // SMS) * cta


def options(h, w, c, r, s, dtype) -> list[UnrollPlan]:
    """The plans ``plan`` chooses from: every run of ``UNROLL_PIXELS`` not
    wider than the row needs, on all of C or a group of ``GROUP_BYTES``
    narrower than C, whose CTA fits ``CTA_SMEM``."""
    size = torch.empty(0, dtype=dtype).element_size()
    groups = [c] + [g // size for g in GROUP_BYTES if g // size < c]
    return [UnrollPlan(px, ch) for px in UNROLL_PIXELS
            if px == 1 or px // 2 < w for ch in groups
            if smem_bytes(UnrollPlan(px, ch), r, s, dtype) <= CTA_SMEM]


@functools.lru_cache(maxsize=1024)
def _plan(h, w, c, r, s, dtype) -> UnrollPlan:
    opts = options(h, w, c, r, s, dtype)
    if not opts:
        raise ValueError(f"im2col_unroll: no plan fits shared memory for "
                         f"a {r}x{s} filter over {c} channels")
    big = [p for p in opts
           if row_bytes(p, w, c, r, s, dtype) >= MIN_ROW_BYTES] or opts
    least = min(MIN_CTAS, max(ctas(p, h, w, c) for p in big))
    fill = [p for p in big if ctas(p, h, w, c) >= least]
    return min(fill, key=lambda p: sm_bytes(p, h, w, c, r, s, dtype))


def plan(x_padded, r, s) -> UnrollPlan:
    """The launch plan of ``im2col_unroll`` on ``x_padded`` (B, Hp, Wp, C)
    and an ``r`` x ``s`` filter: among its ``options`` whose CTA writes
    ``MIN_ROW_BYTES`` (all where none does) and that give ``MIN_CTAS``
    CTAs an image (or the most any of those gives), the least
    ``sm_bytes``, the first of a tie (narrower runs first). A pure function of shape and dtype: never sees the number of images or
    the device. Memoised: an engine plans every site of every image."""
    _, Hp, Wp, C = x_padded.shape
    return _plan(Hp - r + 1, Wp - s + 1, C, r, s, x_padded.dtype)


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
    p = plan(x_padded, r, s)
    if smem_bytes(p, r, s, dt) > MAX_SMEM:
        raise ValueError(f"im2col_unroll: plan {p} does not fit a CTA")
    out = torch.empty((B, H * W, r * s * C), dtype=dt, device=dev)
    err = _build.library().im2col_unroll_launch(
        code, x_padded.data_ptr(), out.data_ptr(), B, Hp, Wp, C, r, s, H, W,
        p.pixels, p.channels, _build.stream(dev))
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
