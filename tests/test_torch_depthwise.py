"""``depthwise_conv``'s Hopper kernel, on the CPU: its launch plan, a
Python mirror of the kernel's tiles, and the plain version against the
JAX package's Pallas kernel.

- **Plan.** ``depthwise_conv.plan`` is a function of shape and dtype
  alone (one image and four plan alike), its CTA fits the kernel's thread
  and shared-memory limits, it is one of its ``options`` (128 bytes of
  each pixel a CTA), and at every depthwise class of MobileNetV2 it gives
  one image at least the CTAs ``min_ctas`` promises (a CTA a SM where an
  option gives that many).
- **Tiles.** ``kernel_mirror`` walks the CTAs and threads of
  ``csrc/depthwise_conv.cu`` as the kernel does (the halo staged at
  ``(oh0·stride, ow0·stride)`` of the padded image, zeros past it; thread
  t's channel vector ``t % tc``, row and pair of pixels; output channel k
  reading halo channel ``k // M - k0 // M``; the taps r-major, s-inner),
  each output written once, and sums the taps as the plain version does,
  so in fp32 it must give the plain version's bits. Its plans at ragged
  shapes (H != W, C of no 16-byte run, M = 2, strides 1 and 2) are the
  ones ``plan`` picks, and every other option too.
- **Reference.** The plain version against ``repro``'s ``ops.depthwise``
  (the Pallas kernel in interpret mode and its jnp path) in fp32, bf16
  and fp16 within ``tolerance(dtype)``.

The CUDA kernel cannot run here; chip_smoke.py holds it against the plain
version on the card at every class in fp32, bf16 and fp16.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import _build, depthwise_conv, gemm
from repro_torch.kernels import ref as tref
from repro_torch.models import mobilenet

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _classes():
    """(H, C, M, R, stride) of every depthwise site of full-width
    MobileNetV2, each class once."""
    return sorted({(s.h, s.c, s.channel_multiplier, s.r, s.stride)
                   for _, s in mobilenet.conv_specs(get("mobilenet_v2"))
                   if s.groups != 1})


CLASSES = _classes()


def _data(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(y, ref):
    y = y.float().numpy()
    r = np.asarray(ref, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    return float(np.abs(y - r).max() / np.abs(r).max())


# ---- the plan -------------------------------------------------------------

def test_classes_are_mobilenets_ten():
    assert len(CLASSES) == 10
    assert {c[2] for c in CLASSES} == {1} and {c[3] for c in CLASSES} == {3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("H,C,M,R,stride", CLASSES + [(14, 32, 2, 3, 2)])
def test_plan_is_batch_blind_fits_a_cta_and_fills_the_card(H, C, M, R,
                                                           stride, dtype):
    w = torch.empty(R, R, 1, M * C, dtype=dtype)
    plans = {depthwise_conv.plan(
        tref.pad_same(torch.empty(b, H, H, C, dtype=dtype), R, R, stride),
        w, stride) for b in (1, 4)}
    assert len(plans) == 1
    p = plans.pop()
    Ho = -(-H // stride)
    assert p in depthwise_conv.options(Ho, Ho, M * C, R, R, stride, dtype)
    assert p.tile_w % depthwise_conv.PIXELS == 0
    assert p.channels % depthwise_conv.vector(dtype) == 0
    assert depthwise_conv.MIN_THREADS <= depthwise_conv.threads(p, dtype) \
        <= depthwise_conv.MAX_THREADS
    assert depthwise_conv.smem_bytes(p, R, R, stride, dtype) \
        <= depthwise_conv.MAX_SMEM
    least = depthwise_conv.min_ctas(Ho, Ho, M * C, R, R, stride, dtype)
    assert depthwise_conv.ctas(p, Ho, Ho, M * C) >= least
    opts = depthwise_conv.options(Ho, Ho, M * C, R, R, stride, dtype)
    assert least == min(gemm.SMS, max(
        depthwise_conv.ctas(o, Ho, Ho, M * C) for o in opts))
    v = depthwise_conv.vector(dtype)  # 128 bytes of a pixel, or all of K
    assert p.channels == min(depthwise_conv.PLAN_LANES * v,
                             -(-M * C // v) * v)
    assert {o.channels for o in opts} == {p.channels}


def test_plan_has_no_argument_for_the_number_of_images():
    _plan = depthwise_conv._plan.__wrapped__
    assert list(_plan.__code__.co_varnames[:8]) == [
        "h", "w", "c", "k", "r", "s", "stride", "dtype"]


# ---- a mirror of the kernel's tiles ----------------------------------------

def kernel_mirror(xp, w, stride, p, scale, bias, act):
    """The outputs of ``csrc/depthwise_conv.cu`` under plan ``p``, CTA by
    CTA and thread by thread, the taps summed as the plain version sums
    them (fp32 multiply, then add; the kernel fuses the two)."""
    B, Hp, Wp, C = xp.shape
    R, S, _, K = w.shape
    M = K // C
    H, W = (Hp - R) // stride + 1, (Wp - S) // stride + 1
    V, PX = depthwise_conv.vector(xp.dtype), depthwise_conv.PIXELS
    tc, cols = p.channels // V, p.tile_w // PX
    ih, iw = (p.tile_h - 1) * stride + R, (p.tile_w - 1) * stride + S
    tiles_w, groups = -(-W // p.tile_w), -(-K // p.channels)
    blocks = -(-H // p.tile_h) * tiles_w * groups
    xf, wf = xp.float(), w.float()
    out = torch.full((B, H, W, K), float("nan"))
    written = torch.zeros((H, W, K), dtype=torch.int64)
    for blk in range(blocks):
        grp, rest = blk % groups, blk // groups
        ty, tx = divmod(rest, tiles_w)
        oh0, ow0, k0 = ty * p.tile_h, tx * p.tile_w, grp * p.channels
        c0 = k0 // M
        halo = torch.zeros((B, ih, iw, p.channels))
        y1, x1 = min(Hp, oh0 * stride + ih), min(Wp, ow0 * stride + iw)
        c1 = min(C, c0 + p.channels)
        halo[:, :y1 - oh0 * stride, :x1 - ow0 * stride, :c1 - c0] = \
            xf[:, oh0 * stride:y1, ow0 * stride:x1, c0:c1]
        assert depthwise_conv.smem_bytes(p, R, S, stride, xp.dtype) \
            == halo[0].numel() * xp.element_size()
        for t in range(tc * p.tile_h * cols):
            cv, rest = t % tc, t // tc
            row, col = rest // cols, rest % cols * PX
            k = k0 + cv * V
            oh = oh0 + row
            for px in range(PX):
                ow = ow0 + col + px
                for v in range(V):
                    if oh >= H or ow >= W or k + v >= K:
                        continue
                    ci = (k + v) // M - c0
                    assert 0 <= ci < p.channels
                    acc = torch.zeros(B)
                    for r in range(R):
                        for s in range(S):
                            hy = row * stride + r
                            hx = (col + px) * stride + s
                            assert hy < ih and hx < iw
                            acc = acc + halo[:, hy, hx, ci] * wf[r, s, 0,
                                                                  k + v]
                    out[:, oh, ow, k + v] = acc
                    written[oh, ow, k + v] += 1
    assert (written == 1).all()
    return tref.apply_act(out * scale + bias, act).to(xp.dtype)


# (B, H, W, C, M, stride): H != W, C of no 16-byte run (12, 6), M = 2
MIRROR_CASES = [(2, 9, 7, 12, 1, 1), (1, 10, 13, 8, 1, 2),
                (1, 7, 9, 6, 2, 2), (1, 5, 6, 20, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,M,stride", MIRROR_CASES)
def test_kernel_tiles_give_the_plain_version_bitwise(B, H, W, C, M, stride,
                                                     dtype):
    R = 3
    x = torch.from_numpy(_data(H * W + C, B, H, W, C)).to(dtype)
    w = torch.from_numpy(_data(C + M, R, R, 1, M * C, scale=1 / R)).to(dtype)
    rng = np.random.default_rng(C)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, M * C).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(M * C) * 0.1).astype(
        np.float32))
    xp = tref.pad_same(x, R, R, stride)
    want = depthwise_conv.depthwise_conv(xp, w, stride=stride, scale=scale,
                                         bias=bias, act="relu6")
    Ho, Wo = want.shape[1:3]
    picked = depthwise_conv.plan(xp, w, stride)
    opts = depthwise_conv.options(Ho, Wo, M * C, R, R, stride, dtype)
    assert picked in opts
    # the pick, and the smallest and the largest of the other tiles
    for p in {picked, opts[0], opts[-1]}:
        got = kernel_mirror(xp, w, stride, p, scale, bias, "relu6")
        assert torch.equal(got, want), p


# ---- the plain version against the Pallas kernel ---------------------------

# (H, W, C, M, stride): H != W, C a multiple of no 8 (12, 6), M = 2
REF_CASES = [(9, 10, 12, 1, 1), (10, 9, 12, 1, 2), (7, 8, 6, 2, 1),
             (8, 7, 6, 2, 2)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,C,M,stride", REF_CASES)
def test_plain_matches_pallas(H, W, C, M, stride, dtype):
    tdt, jdt = DTYPES[dtype]
    R = 3
    xa = _data(H + C, 1, H, W, C)
    wa = _data(W + M, R, R, 1, M * C, scale=1 / R)
    rng = np.random.default_rng(C + M)
    sc = rng.uniform(0.5, 1.5, M * C).astype(np.float32)
    bi = (rng.standard_normal(M * C) * 0.1).astype(np.float32)
    xp_t = tref.pad_same(torch.from_numpy(xa).to(tdt), R, R, stride)
    xp_j = jref.pad_same(jnp.asarray(xa, dtype=jdt), R, R, stride)
    y = depthwise_conv.depthwise_conv(
        xp_t, torch.from_numpy(wa).to(tdt), stride=stride,
        scale=torch.from_numpy(sc), bias=torch.from_numpy(bi), act="relu6")
    assert y.shape == (1, -(-H // stride), -(-W // stride), M * C)
    assert y.dtype == tdt
    for impl in ("pallas", "jnp"):
        ref = jops.depthwise(xp_j, jnp.asarray(wa, dtype=jdt), impl=impl,
                             stride=stride, scale=jnp.asarray(sc),
                             bias=jnp.asarray(bi), act="relu6")
        assert _rel(y, ref) <= tolerance(dtype), impl


# ---- sources and bindings ---------------------------------------------------

def test_entry_point_takes_the_plan():
    # dtype; x, w, scale, bias, out; B, Hp, Wp, C, R, S, K, H, W, stride,
    # act, tile_h, tile_w, channels; stream
    sig = _build.SIGNATURES["depthwise_conv_launch"]
    assert len(sig) == 21 and sig[-1] == _build._P
    src = (CSRC / "depthwise_conv.cu").read_text()
    assert "int tile_w, int channels, void* stream) {\n" in src


def test_kernel_stages_a_halo_with_cp_async_and_unrolls_the_3x3():
    src = (CSRC / "depthwise_conv.cu").read_text()
    assert "cp_async16(" in src and "cp_async4(" in src
    assert "template <typename T, int ST>" in src
    for st in (1, 2):
        assert f"return run(dw3x3_kernel<T, {st}>);" in src
    assert "return run(dw_generic_kernel<T>);" in src
    assert f"constexpr int PX = {depthwise_conv.PIXELS};" in src
    assert f"constexpr int DW_MAX_THREADS = {depthwise_conv.MAX_THREADS};" \
        in src
    assert f"constexpr int DW_MAX_SMEM = {depthwise_conv.MAX_SMEM};" in src


def test_kernel_of_mirrors_the_launchers_dispatch():
    x = torch.empty(1, 9, 9, 32)
    w = torch.empty(3, 3, 1, 32)
    assert depthwise_conv.kernel_of(x, w, 1) == "3x3"
    assert depthwise_conv.kernel_of(x, w, 2) == "3x3"
    assert depthwise_conv.kernel_of(x, w, 3) == "generic"
    assert depthwise_conv.kernel_of(x, torch.empty(3, 3, 1, 64), 2) \
        == "generic"
    assert depthwise_conv.kernel_of(x, torch.empty(5, 5, 1, 32), 1) \
        == "generic"
    x12 = torch.empty(1, 9, 9, 12, dtype=torch.bfloat16)
    # a ragged C, an unaligned x: the generic kernel
    assert depthwise_conv.kernel_of(
        x12, torch.empty(3, 3, 1, 12, dtype=torch.bfloat16), 1) \
        == "generic"
    assert depthwise_conv.kernel_of(x[..., 1:], w[..., 1:], 1) \
        == "generic"
    src = (CSRC / "depthwise_conv.cu").read_text()
    assert "aligned16(bias) && g.M == 1 && R == 3 && S == 3;" in src
    assert "if (vec && stride == 1)" in src
    assert "if (vec && stride == 2)" in src
