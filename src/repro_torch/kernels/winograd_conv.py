"""Winograd F(2x2, 3x3) convolution, the paper's last baseline (§3.2,
Lavin & Gray): an input-transform kernel for Hopper, the ``gemm`` kernel
for the 16 products, then an output-transform kernel with the fused
epilogue.

Replaces the Pallas kernels ``winograd_input_transform`` and
``winograd_output_transform`` and their composition ``winograd_conv`` in
``src/repro/kernels/winograd_conv.py``; the sources are
``csrc/winograd_input_transform.cu`` and
``csrc/winograd_output_transform.cu``.

What bounds it on the H100: the transforms do adds and subtracts only, so
bytes bound them: V, written in the input dtype, is 4x the image, and M,
written in the same dtype, 4x the output. The input transform gives one
thread one (image, tile, channel), lanes along C, so every load and store
coalesces; the TPU kernels' whole-image VMEM block does not fit a block's
227 KB, and a tile block's halo staged in shared memory with 16-byte
channel vectors measured slower on the H100 (L1 serves the windows'
overlap). It rounds each add or subtract to the input dtype, as the Pallas
kernel computes it, so the two agree bitwise in every dtype. The output
transform reads each M value once: a CTA takes a block of tiles x a
channel group of one image, a thread a unit of 16, 8, 4 or 2 bytes of
channels, from ``plan`` (shape and dtype alone, never the number of
images); it computes in fp32 and rounds its epilogue once, as the Pallas
kernel's compiles, so it too equals its plain version bitwise. The 16
products contract over C alone, where the direct
algorithms walk 9·C, so their CTAs' serial loops are 9x shorter. The
filter transform U = G g Gᵀ is an einsum outside any kernel, as in the
reference; the engine caches it per plan site (weights are frozen at
inference), and without a cache it is computed per call, in fp32.

``winograd_input_transform`` and ``winograd_output_transform`` run their
kernels for a CUDA tensor and their plain versions (``ref.*``) for a CPU
tensor; each counts its kernel's launches in ``.launches``.
``winograd_conv`` launches the input transform, ``gemm`` and the output
transform once each.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gemm import SMS, gemm

plain_input_transform = ref.winograd_input_transform
plain_output_transform = ref.winograd_output_transform

# The output transform's plan search (``options``, which gemm_sweep.py
# ``wout`` times): the bytes of channels a thread moves, a CTA's tiles, and
# its channel group in bytes where it does not take all of K (groups that
# divide K only, so no CTA is ragged), at most ``MAX_THREADS`` threads a
# CTA (csrc/winograd_output_transform.cu). Among the options whose CTA has
# ``MIN_THREADS`` (all where none has), the plan takes the widest unit
# whose grid gives one image ``MIN_CTAS`` CTAs (or the most any gives),
# then the least bytes on the busiest SM, then the fewest CTAs. In the
# sweep on the H100, one-warp CTAs and grids of half a CTA a SM (im2col's
# floor) lost 4-11% of device time against two or more warps on a CTA or
# more a SM; the unit's width moved it by less than its noise (2-3%).
UNITS = (16, 8, 4, 2)
TILES = (1, 2, 4, 8, 16, 32, 64)
GROUP_BYTES = (128, 256, 512)
MAX_THREADS = 256
MIN_THREADS = 64
MIN_CTAS = SMS


class OutputTransformPlan(NamedTuple):
    """A launch plan of ``winograd_output_transform``: a CTA's tiles, its
    channels (all of K or a group dividing it) and the bytes of channels
    a thread moves."""
    tiles: int
    channels: int
    unit: int


def _size(dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


def threads(p: OutputTransformPlan, dtype) -> int:
    """Threads of one CTA: its tiles x its channel units (at most
    ``MAX_THREADS``; a wider group loops)."""
    return p.tiles * min(p.channels * _size(dtype) // p.unit, MAX_THREADS)


def ctas(p: OutputTransformPlan, h, w, k) -> int:
    """CTAs of one image: tile blocks x channel groups."""
    return -(-(h // 2) * (w // 2) // p.tiles) * (k // p.channels)


def sm_bytes(p: OutputTransformPlan, h, w, k, dtype) -> int:
    """Bytes the busiest SM moves in one image's launch: ceil(CTAs / SMs)
    CTAs, each 16 M values and 4 outputs a (tile, channel)."""
    nt = (h // 2) * (w // 2)
    return -(-ctas(p, h, w, k) // SMS) * min(p.tiles, nt) * p.channels \
        * 20 * _size(dtype)


def options(h, w, k, dtype) -> list[OutputTransformPlan]:
    """The plans ``plan`` chooses from: every unit of ``UNITS`` no
    narrower than an element that divides K's bytes, on all of K or a
    group of ``GROUP_BYTES`` that divides it, at every block of ``TILES``
    not wider than the image needs whose CTA has at most ``MAX_THREADS``
    threads."""
    size, nt = _size(dtype), (h // 2) * (w // 2)
    out = []
    for unit in UNITS:
        if unit < size or k * size % unit:
            continue
        groups = [k] + [g // size for g in GROUP_BYTES
                        if g // size < k and k * size % g == 0]
        for ch in groups:
            out += [OutputTransformPlan(tl, ch, unit) for tl in TILES
                    if (tl == 1 or tl // 2 < nt)
                    and threads(OutputTransformPlan(tl, ch, unit), dtype)
                    <= MAX_THREADS]
    return out


@functools.lru_cache(maxsize=1024)
def _plan(h, w, k, dtype) -> OutputTransformPlan:
    opts = options(h, w, k, dtype)
    big = [p for p in opts if threads(p, dtype) >= MIN_THREADS] or opts
    least = min(MIN_CTAS, max(ctas(p, h, w, k) for p in big))
    fill = [p for p in big if ctas(p, h, w, k) >= least]
    unit = max(p.unit for p in fill)
    return min((p for p in fill if p.unit == unit),
               key=lambda p: (sm_bytes(p, h, w, k, dtype),
                              ctas(p, h, w, k)))


def plan(m, H, W) -> OutputTransformPlan:
    """The launch plan of ``winograd_output_transform`` on ``m`` (B, 4, 4,
    (H/2)(W/2), K): among its ``options`` of at least ``MIN_THREADS``
    threads a CTA (all where none has), the widest unit of those that give
    one image ``MIN_CTAS`` CTAs (or the most any gives), and of that
    unit's, the least ``sm_bytes``, then the fewest CTAs. A pure function
    of shape and dtype: never sees the number of images or the device.
    Memoised: an engine plans every site of every image."""
    return _plan(H, W, m.shape[-1], m.dtype)


def _even_dims(kernel, H, W):
    if H < 2 or W < 2 or H % 2 or W % 2:
        raise ValueError(f"{kernel}: winograd F(2,3) needs even output "
                         f"dims, got {H}x{W}")


def winograd_input_transform(x_padded, H, W):
    """x_padded: (B, H+2, W+2, C) -> V (B, 4, 4, (H/2)(W/2), C) in
    ``x_padded.dtype``, tiles row-major over (tile row, tile column)."""
    if x_padded.device.type == "cpu":
        return plain_input_transform(x_padded, H, W)
    if x_padded.device.type != "cuda":
        raise ValueError(f"winograd_input_transform: no kernel for "
                         f"{x_padded.device}")
    B, Hp, Wp, C = x_padded.shape
    _even_dims("winograd_input_transform", H, W)
    if (Hp, Wp) != (H + 2, W + 2) or B < 1 or C < 1:
        raise ValueError(f"winograd_input_transform: bad geometry x "
                         f"{tuple(x_padded.shape)} for {H}x{W}")
    dev, dt = x_padded.device, x_padded.dtype
    code = _build.kernel_dtype("winograd_input_transform", x_padded)
    _build.check_operand("winograd_input_transform", "x_padded", x_padded,
                         dev, dt)
    out = torch.empty((B, 4, 4, (H // 2) * (W // 2), C), dtype=dt,
                      device=dev)
    err = _build.library().winograd_input_transform_launch(
        code, x_padded.data_ptr(), out.data_ptr(), B, Hp, Wp, C,
        _build.stream(dev))
    _build.check(err, "winograd_input_transform")
    winograd_input_transform.launches += 1
    return out


winograd_input_transform.launches = 0


def winograd_output_transform(m, H, W, *, scale=None, bias=None, act=None):
    """m: (B, 4, 4, (H/2)(W/2), K) -> (B, H, W, K) in ``m.dtype``: Aᵀ m A
    per tile with ``act(y*scale + bias)`` fused into the write, the
    multiply-add rounded once."""
    if m.device.type == "cpu":
        return plain_output_transform(m, H, W, scale=scale, bias=bias,
                                      act=act)
    if m.device.type != "cuda":
        raise ValueError(f"winograd_output_transform: no kernel for "
                         f"{m.device}")
    _even_dims("winograd_output_transform", H, W)
    if m.dim() != 5 or tuple(m.shape[1:4]) != (4, 4, (H // 2) * (W // 2)) \
            or 0 in m.shape:
        raise ValueError(f"winograd_output_transform: bad shape m "
                         f"{tuple(m.shape)} for {H}x{W}")
    B, K = m.shape[0], m.shape[-1]
    dev, dt = m.device, m.dtype
    code = _build.kernel_dtype("winograd_output_transform", m)
    _build.check_operand("winograd_output_transform", "m", m, dev, dt)
    sc, bi = _build.epilogue_vectors(scale, bias, K, dev)
    p = plan(m, H, W)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    err = _build.library().winograd_output_transform_launch(
        code, m.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), B,
        H, W, K, _build.act_code(act), p.tiles, p.channels, p.unit,
        _build.stream(dev))
    _build.check(err, "winograd_output_transform")
    winograd_output_transform.launches += 1
    return out


winograd_output_transform.launches = 0


def winograd_conv(x_padded, w, *, u=None, scale=None, bias=None, act=None):
    """x_padded (B, H+2, W+2, C), w (3,3,C,K), even H and W -> (B,H,W,K).
    ``u`` is the cached filter transform (4,4,C,K), in ``w.dtype`` or
    fp32; without it U is computed here in fp32."""
    R, S, C, K = w.shape
    if (R, S) != (3, 3):
        raise ValueError(f"winograd F(2,3) is 3x3-only, got {R}x{S}")
    B, Hp, Wp, _ = x_padded.shape
    H, W = Hp - 2, Wp - 2
    _even_dims("winograd_conv", H, W)
    if u is None:
        u = ref.winograd_filter_transform(w)
    v = winograd_input_transform(x_padded, H, W)
    m = gemm(v.reshape(B * 16, -1, C), u.reshape(16, C, K).contiguous())
    return winograd_output_transform(m.reshape(B, 4, 4, -1, K), H, W,
                                     scale=scale, bias=bias, act=act)
