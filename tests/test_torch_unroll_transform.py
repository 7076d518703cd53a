"""The two gathers' Hopper kernels, ``im2col_unroll`` and
``winograd_input_transform``, on the CPU: im2col's launch plan, Python
mirrors of both kernels' launches, and the plain versions against the JAX
package's Pallas kernels.

- **Plan and launch.** ``im2col_conv.plan`` is a function of shape and
  dtype alone (one image and four plan alike; ``_plan`` takes no number of
  images), picks one of its ``options``, fits shared memory with two CTAs
  a SM, and, through the mirror, writes every output element exactly once,
  at the paper's four im2col classes and a ragged shape, in fp32, bf16 and
  fp16. The input transform has no plan (one thread an (image, tile,
  channel) over a grid-stride loop); its mirror writes every V element
  exactly once at ResNet-18's three Winograd classes and a ragged shape.
- **Mirrors.** ``unroll_mirror`` walks the CTAs of
  ``csrc/im2col_unroll.cu`` as the kernel does: the unit a launch copies
  (``im2col_conv.unit_bytes`` of a pixel's channel run), the grid's pixel
  runs and channel groups, the halo staged in shared memory, and the store
  offsets in units. ``transform_mirror`` walks
  ``csrc/winograd_input_transform.cu``'s grid-stride loop: each thread's
  (image, tile, channel), its 16 window loads, rows then columns of Bᵀ d B
  with each add or subtract in the dtype (the kernel's ``add`` and
  ``sub``: one round-to-nearest), and its 16 stores. Each must give the plain version
  bitwise at small and ragged shapes (H != W; C = 5, 6 and 12, so channel
  runs of 10, 12, 20, 24 and 48 bytes and every unit; odd W; 1x1 and 5x5
  filters for im2col's generic path), im2col at every option of the
  plan's search.
- **Reference.** ``ref.im2col_unroll`` equals the Pallas
  ``im2col_unroll`` and ``ref.winograd_input_transform`` the Pallas
  ``winograd_input_transform`` (both in interpret mode) bitwise in fp32,
  bf16 and fp16: the Pallas transform computes in the input dtype,
  rounding after each add, and so does the port.
- **Sources.** ``im2col_unroll`` stages its halo with ``cp.async`` and its
  launcher's trailing arguments in the source and in ``_build.SIGNATURES``
  are its plan's fields; the transform adds in the dtype and uses no
  shared memory.

The CUDA kernels cannot run here; chip_smoke.py holds them against their
plain versions on the card, bitwise, at every class in fp32, bf16 and
fp16 and at a ragged class each.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import im2col_conv as jim2col
from repro.kernels import ref as jref
from repro.kernels import winograd_conv as jwg
from repro_torch.kernels import _build, im2col_conv
from repro_torch.kernels import ref as tref

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
SM_SMEM, CTA_RESERVED = 233472, 1024  # an SM's shared memory, a CTA's share
# (H, W, C): the paper's four 3x3 layers (forced im2col's 13 sites) and
# chip_smoke.py's ragged class; ResNet-18's three even 3x3/1 layers and the
# transform's ragged class
# csrc/winograd_input_transform.cu: threads a CTA, and CTAs at most
TRANSFORM_THREADS, TRANSFORM_GRID = 256, 132 * 64
UNROLL_CLASSES = [(56, 56, 64), (28, 28, 128), (14, 14, 256), (7, 7, 512),
                  (9, 11, 6)]
TRANSFORM_CLASSES = [(56, 56, 64), (28, 28, 128), (14, 14, 256),
                     (10, 14, 12)]
# small and ragged shapes for the mirrors: (H, W, C[, R])
UNROLL_SMALL = [(5, 7, 6, 3), (4, 9, 12, 3), (3, 5, 5, 3), (6, 5, 8, 1),
                (4, 3, 6, 5)]
TRANSFORM_SMALL = [(10, 14, 12), (4, 6, 6), (6, 4, 5), (8, 8, 16)]


def _data(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _padded(seed, b, h, w, c, r, dtype):
    x = _data(seed, b, h, w, c)
    t, j = DTYPES[dtype]
    return (tref.pad_same(torch.from_numpy(x).to(t), r, r),
            jref.pad_same(jnp.asarray(x).astype(j), r, r))


def _units(x):
    """x (..., C) as (..., C / n, n): the unit of n elements the kernel
    copies a pixel's channel run in (``im2col_conv.unit_bytes``), and n."""
    n = im2col_conv.unit_bytes(x.shape[-1] * x.element_size()) \
        // x.element_size()
    return x.reshape(*x.shape[:-1], x.shape[-1] // n, n), n


# ---- mirrors of the kernels' CTAs ------------------------------------------

def unroll_mirror(xp, r, s, p):
    """The output of ``csrc/im2col_unroll.cu`` under plan ``p``, CTA by
    CTA, in units, and how often each output unit was written."""
    B, Hp, Wp, C = xp.shape
    H, W, RS = Hp - r + 1, Wp - s + 1, r * s
    xu, n = _units(xp)
    cu = xu.shape[3]
    cg = min(p.channels, C) // n
    pixels = min(p.pixels, W)
    groups, hwp = -(-cu // cg), pixels + s - 1
    out = torch.full((B * H * W * RS * cu, n), float("nan"), dtype=xp.dtype)
    written = torch.zeros(out.shape[0], dtype=torch.int64)
    for b in range(B):
        for oh in range(H):  # blockIdx.y
            for bx in range(-(-W // pixels) * groups):  # blockIdx.x
                run = bx // groups
                c0 = (bx - run * groups) * cg
                ow0 = run * pixels
                cn, np_ = min(cg, cu - c0), min(pixels, W - ow0)
                xs = torch.full((r * hwp * cg, n), float("nan"),
                                dtype=xp.dtype)
                for rr in range(r):
                    for col in range(np_ + s - 1):
                        at = (rr * hwp + col) * cg
                        xs[at:at + cn] = xu[b, oh + rr, ow0 + col, c0:c0 + cn]
                ob = ((b * H + oh) * W + ow0) * RS * cu + c0
                for j in range(np_ * RS):
                    pp = j // RS
                    tap = j - pp * RS
                    rr = tap // s
                    ss = tap - rr * s
                    src = (rr * hwp + pp + ss) * cg
                    out[ob + j * cu:ob + j * cu + cn] = xs[src:src + cn]
                    written[ob + j * cu:ob + j * cu + cn] += 1
    return out.reshape(B, H * W, RS * C), written


def _bt(d0, d1, d2, d3):
    """The kernel's ``bt_combine``: each add or subtract in the operands'
    dtype, rounded to nearest once."""
    return [d0 - d2, d1 + d2, d2 - d1, d1 - d3]


def transform_mirror(xp, H, W):
    """The output of ``csrc/winograd_input_transform.cu``: its grid of
    ``min(ceil(total / 256), 132 * 64)`` CTAs of 256 threads walks i =
    (b * nt + t) * C + c in a grid-stride loop, and how often each V
    element was written."""
    B, Hp, Wp, C = xp.shape
    th, tw = H // 2, W // 2
    nt = th * tw
    total = B * nt * C
    grid = min(-(-total // TRANSFORM_THREADS), TRANSFORM_GRID)
    stride = grid * TRANSFORM_THREADS
    first = torch.arange(stride)  # blockIdx.x * THREADS + threadIdx.x
    i = (first + stride * torch.arange(-(-total // stride))[:, None]).ravel()
    i = i[i < total]
    c, bt = i % C, i // C
    t, b = bt % nt, bt // nt
    h0, w0 = 2 * (t // tw), 2 * (t % tw)
    xf = xp.reshape(-1)
    d = [[xf[((b * Hp + h0 + r) * Wp + w0 + s) * C + c] for s in range(4)]
         for r in range(4)]
    rows = [_bt(*(d[r][s] for r in range(4))) for s in range(4)]
    v = torch.full((B * 16 * nt * C,), float("nan"), dtype=xp.dtype)
    written = torch.zeros(v.shape[0], dtype=torch.int64)
    vb = (b * 16 * nt + t) * C + c
    for a in range(4):
        for e, o in enumerate(_bt(*(rows[s][a] for s in range(4)))):
            at = vb + (a * 4 + e) * nt * C
            v[at] = o
            written.index_add_(0, at, torch.ones_like(at))
    return v.reshape(B, 4, 4, nt, C), written


# ---- plans ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,C", UNROLL_CLASSES)
def test_unroll_plan_is_batch_blind_fits_and_covers_once(H, W, C, dtype):
    t = DTYPES[dtype][0]
    plans = {im2col_conv.plan(torch.empty(b, H + 2, W + 2, C, dtype=t), 3, 3)
             for b in (1, 4)}
    assert len(plans) == 1
    p = plans.pop()
    opts = im2col_conv.options(H, W, C, 3, 3, t)
    assert p in opts
    size = torch.empty(0, dtype=t).element_size()
    assert p.channels == C or p.channels * size % 16 == 0
    smem = im2col_conv.smem_bytes(p, 3, 3, t)
    assert smem <= im2col_conv.CTA_SMEM
    assert 2 * (smem + CTA_RESERVED) <= SM_SMEM
    big = [o for o in opts if im2col_conv.row_bytes(
        o, W, C, 3, 3, t) >= im2col_conv.MIN_ROW_BYTES]
    if big:
        assert im2col_conv.row_bytes(p, W, C, 3, 3, t) \
            >= im2col_conv.MIN_ROW_BYTES
    least = min(im2col_conv.MIN_CTAS,
                max(im2col_conv.ctas(o, H, W, C) for o in big or opts))
    assert im2col_conv.ctas(p, H, W, C) >= least
    xp = torch.zeros(1, H + 2, W + 2, C, dtype=t)
    _, written = unroll_mirror(xp, 3, 3, p)
    assert written.eq(1).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,C", TRANSFORM_CLASSES)
def test_transform_launch_covers_every_output_once(H, W, C, dtype):
    t = DTYPES[dtype][0]
    for b in (1, 2):
        _, written = transform_mirror(
            torch.zeros(b, H + 2, W + 2, C, dtype=t), H, W)
        assert written.eq(1).all()


def test_plans_take_no_number_of_images():
    assert im2col_conv._plan.__wrapped__.__code__.co_varnames[:6] == (
        "h", "w", "c", "r", "s", "dtype")


# ---- the mirrors against the plain versions --------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,C,R", UNROLL_SMALL)
def test_unroll_mirror_is_the_plain_version_at_every_option(H, W, C, R,
                                                           dtype):
    xp, _ = _padded(70, 2, H, W, C, R, dtype)
    plain = tref.im2col_unroll(xp, R, R)
    opts = im2col_conv.options(H, W, C, R, R, xp.dtype)
    assert im2col_conv.plan(xp, R, R) in opts
    for p in opts:
        y, written = unroll_mirror(xp, R, R, p)
        assert written.eq(1).all(), p
        assert torch.equal(y, plain), p


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,C", TRANSFORM_SMALL)
def test_transform_mirror_is_the_plain_version(H, W, C, dtype):
    xp, _ = _padded(71, 2, H, W, C, 3, dtype)
    y, written = transform_mirror(xp, H, W)
    assert written.eq(1).all()
    assert torch.equal(y, tref.winograd_input_transform(xp, H, W))


# ---- the plain versions against the Pallas kernels --------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,C,R", UNROLL_SMALL[:3])
def test_plain_unroll_is_bitwise_the_pallas_kernel(H, W, C, R, dtype):
    xp_t, xp_j = _padded(72, 2, H, W, C, R, dtype)
    y = tref.im2col_unroll(xp_t, R, R)
    ref = jim2col.im2col_unroll(xp_j, r=R, s=R, interpret=True)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,C", TRANSFORM_SMALL[:3])
def test_plain_transform_is_bitwise_the_pallas_kernel(H, W, C, dtype):
    """The Pallas kernel computes in the input dtype, each add rounded; so
    does the plain version (and the CUDA kernel), in every dtype."""
    xp_t, xp_j = _padded(73, 2, H, W, C, 3, dtype)
    v = tref.winograd_input_transform(xp_t, H, W)
    assert v.dtype == xp_t.dtype
    ref = jwg.winograd_input_transform(xp_j, interpret=True)
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(ref, np.float32))


# ---- the sources -------------------------------------------------------------

def _launch_params(name):
    """The parameter names of ``extern "C" int <name>_launch(...)``."""
    src = " ".join((CSRC / f"{name}.cu").read_text().split())
    args = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src)[1]
    return [a.split()[-1].lstrip("*") for a in args.split(",")]


def test_unroll_launcher_takes_the_plan_and_stages_with_cp_async():
    params = _launch_params("im2col_unroll")
    fields = im2col_conv.UnrollPlan._fields
    assert params[-1] == "stream"
    assert tuple(params[-1 - len(fields):-1]) == fields
    _I, _P = _build.SIGNATURES["gemm_launch"][0], _build.SIGNATURES[
        "gemm_launch"][3]
    assert _build.SIGNATURES["im2col_unroll_launch"] == \
        [_I] + [_P] * 2 + [_I] * (8 + len(fields)) + [_P]
    assert len(params) == len(_build.SIGNATURES["im2col_unroll_launch"])
    src = (CSRC / "im2col_unroll.cu").read_text()
    assert "gridDim" not in src  # no grid-stride loop
    assert "stage_unit(" in src and "cp_async_wait_all()" in src
    assert re.search(r"cp\.async\.ca\.shared\.global \[%0\], \[%1\], 8", src)
    assert "cp_async16(dst, src, true)" in src
    assert "cp_async4(dst, src, true)" in src


def test_transform_adds_in_the_input_dtype_and_uses_no_shared_memory():
    params = _launch_params("winograd_input_transform")
    assert params == ["dtype", "x", "v", "B", "Hp", "Wp", "C", "stream"]
    assert len(params) == len(
        _build.SIGNATURES["winograd_input_transform_launch"])
    src = (CSRC / "winograd_input_transform.cu").read_text()
    assert "__shared__" not in src
    # V's values are computed and stored in T: no conversion to fp32
    assert "to_f32" not in src and "from_f32" not in src
    assert "T d[4][4];" in src and "T rw[4][4];" in src
    for op in ("__hadd(a, b)", "__hsub(a, b)"):  # bf16 and fp16
        assert src.count(op) == 2
