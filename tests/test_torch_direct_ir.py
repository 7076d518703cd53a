"""``direct_conv`` (a resident filter slice, split over the contraction)
and ``fused_inverted_residual`` (split over the mid width) on the CPU:
Python models of the kernels' grids and index math, their launch plans,
and the order in which they sum.

- **Direct's grid.** A mirror of ``direct_block`` and of the walk over a
  CTA's chunks: the K tiles x contraction slices x pixel tiles cover
  every (pixel, output channel, contraction row) exactly once, and the
  patch rows the kernel gathers (``StridedPatch``) are the reference
  patch, at strides 1 and 2, R in {1, 3, 7}, C = 3 and H != W.
- **The inverted residual's grid.** Each output pixel's projection sums
  every mid channel exactly once over the (tile, slab) grid, and the
  staged halo holds every depthwise tap of the tile's outputs at the
  place SAME padding puts it.
- **Plans.** Neither plan has a batch argument; both fit shared memory at
  every ResNet-18 and MobileNetV2 class, give the deep classes about 128
  CTAs, and the inverted residual's tiles recompute at most
  ``MAX_RECOMPUTE``; 16-bit shapes with C = 3 or ragged channels plan on
  the CUDA cores.
- **Sum.** An fp32 model of the slice-order and slab-order sums with each
  epilogue (the residual ``T(y) + x`` included), at every slice count
  direct accepts, matches the JAX package's kernels
  (``repro.kernels.ops``, ``impl`` ``pallas`` in interpret mode and
  ``jnp``) within ``tolerance(dtype)``.
- **Sources.** Both kernels use ``mma.sync`` for 16-bit types and no TF32,
  include ``gemm_tile.cuh`` (direct never ``conv_tile.cuh``), and the old
  ``block_gemm`` and shared-memory projection accumulator are gone.

The CUDA kernels cannot run here; chip_smoke.py holds them against their
plain versions on the card.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get, tiny_variant
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import _build, direct_conv, fused_block, gemm
from repro_torch.kernels import ref as tref
from repro_torch.models import mobilenet, resnet

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ALL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _data(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, dtype=jdt)


def _rel(y, ref):
    y = y.float().numpy()
    r = np.asarray(ref, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    return float(np.abs(y - r).max() / np.abs(r).max())


def _epilogue(seed, k):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    bias = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return (torch.from_numpy(scale), torch.from_numpy(bias),
            jnp.asarray(scale), jnp.asarray(bias))


# ---- direct: classes and plan ---------------------------------------------

def _direct_classes(name="resnet18"):
    """(H, C, K, R, stride) of every conv site of the network: forced
    direct runs them all."""
    return sorted({(s.h, s.c, s.k, s.r, s.stride)
                   for _, s in resnet.conv_specs(get(name))})


DIRECT_CLASSES = _direct_classes()


def _direct_plan(H, C, K, R, stride, dtype, batch=1, W=None):
    x = torch.empty(batch, H, H if W is None else W, C, dtype=dtype)
    return direct_conv.plan(tref.pad_same(x, R, R, stride),
                            torch.empty(R, R, C, K, dtype=dtype), stride)


def _chunks(C, R, chunk):
    return -(-R * R * C // chunk)


def test_direct_classes_are_forced_directs_sites():
    assert len(DIRECT_CLASSES) == 11
    assert (224, 3, 64, 7, 2) in DIRECT_CLASSES    # the stem
    assert (7, 512, 512, 3, 1) in DIRECT_CLASSES
    assert (56, 64, 128, 1, 2) in DIRECT_CLASSES   # a projection


def test_direct_plan_has_no_argument_for_the_number_of_images():
    params = list(inspect.signature(direct_conv.plan).parameters)
    assert params == ["x_padded", "w", "stride"]


@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("H,C,K,R,stride", DIRECT_CLASSES)
def test_direct_plan_ignores_the_batch_and_fits_shared_memory(
        H, C, K, R, stride, dtype):
    p = _direct_plan(H, C, K, R, stride, dtype)
    assert p == _direct_plan(H, C, K, R, stride, dtype, batch=4)
    tensor = dtype != torch.float32 and C % 8 == 0 and K % 8 == 0
    assert p.path == ("tensor" if tensor else "fp32")
    assert p.tile == direct_conv.TILE
    assert p.chunk == gemm.CHUNK[p.path]
    chunks = _chunks(C, R, p.chunk)
    assert 1 <= p.slices <= min(chunks, direct_conv.MAX_SLICES)
    size = torch.empty(0, dtype=dtype).element_size()
    assert direct_conv.smem_bytes(
        p.path, size, p.chunk,
        direct_conv.slice_depth(chunks, p.chunk, p.slices)) \
        <= direct_conv.MAX_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_direct_plan_gives_the_deep_classes_about_128_ctas(dtype):
    """One pixel tile a CTA; the classes whose unsplit grid (tiles x K
    tiles) is below the card's SMs reach at least 128 CTAs an image by
    slices of the contraction, up to MIN_CTAS (the 7² 3x3: 32 slices of
    144 fp32 rows x 8 K tiles); the 7x7 stem, 196 tiles, is not split."""
    for H, C, K, R, stride in DIRECT_CLASSES:
        p = _direct_plan(H, C, K, R, stride, dtype)
        Ho = -(-H // stride)
        grid = -(-K // direct_conv.TILE_K) * -(-Ho * Ho // direct_conv.TILE)
        chunks = _chunks(C, R, p.chunk)
        if grid >= gemm.SMS:
            assert p.slices == 1
        else:
            assert grid * p.slices >= min(128, grid * chunks)
            assert grid * (p.slices - 1) < direct_conv.MIN_CTAS
    p = _direct_plan(7, 512, 512, 3, 1, torch.float32)
    assert p.slices == 32
    assert direct_conv.slice_depth(_chunks(512, 3, 16), 16, 32) == 144
    assert _direct_plan(224, 3, 64, 7, 2, dtype).slices == 1


def test_direct_16_bit_shapes_the_tensor_cores_cannot_take_plan_on_cuda_cores():
    for dt in (torch.bfloat16, torch.float16):
        assert _direct_plan(224, 3, 64, 7, 2, dt).path == "fp32"
        assert _direct_plan(13, 12, 20, 3, 2, dt, W=10).path == "fp32"
        assert _direct_plan(13, 16, 24, 3, 2, dt, W=10).path == "tensor"


def test_direct_plan_slices_a_bank_that_overflows_shared_memory():
    """One fp32 slice of a 3x3x1024 contraction does not fit a block: the
    plan cuts it until the deepest slice does."""
    p = _direct_plan(7, 1024, 64, 3, 1, torch.float32)
    depth = direct_conv.slice_depth(_chunks(1024, 3, 16), 16, p.slices)
    assert p.slices >= 11
    assert direct_conv.smem_bytes("fp32", 4, 16, depth) \
        <= direct_conv.MAX_SMEM


# ---- direct: a Python mirror of the grid and the gather -------------------

def direct_blocks(HW, K, Kc, p):
    """Mirror of ``direct_block`` over one image's grid: (K tile start,
    slice, pixel tile, contraction range) of each CTA, blockIdx.x =
    (tile * slices + slice) * K tiles + K tile."""
    ktiles, tiles = -(-K // direct_conv.TILE_K), -(-HW // direct_conv.TILE)
    bounds = gemm.split_bounds(Kc, p.chunk, p.slices)
    for bx in range(ktiles * p.slices * tiles):
        kt, rest = bx % ktiles, bx // ktiles
        s, t = rest % p.slices, rest // p.slices
        yield (kt * direct_conv.TILE_K, s, t, *bounds[s])


def walk_rows(kb, ke, chunk):
    """Mirror of ``direct_walk``: the first contraction row of each chunk,
    in order."""
    return [kb + c * chunk for c in range(-(-(ke - kb) // chunk))]


def patch_offset(xp_shape, p, k, W, S, stride):
    """Mirror of ``StridedPatch``: the flat offset in one padded image of
    contraction row k of output pixel p."""
    _, Hp, Wp, C = xp_shape
    tap = k // C
    row = ((p // W * stride) * Wp + p % W * stride) * C
    return row + (tap // S * Wp + tap % S) * C + k - tap * C


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("R,C", [(1, 5), (3, 3), (3, 12), (7, 3)])
def test_direct_grid_covers_every_pixel_channel_and_row_once(stride, R, C):
    """At the plan's slices and at others: every (pixel, channel,
    contraction row) of an H != W image is computed by exactly one CTA, at
    exactly one step, from the reference patch's element."""
    H, W, K = 11, 9, 70
    x = torch.from_numpy(_data(R + C, 1, H, W, C))
    xp = tref.pad_same(x, R, R, stride)
    Ho, Wo = -(-H // stride), -(-W // stride)
    HW, Kc = Ho * Wo, R * R * C
    patches = tref._patches(xp, R, R, stride)[0].reshape(HW, Kc).numpy()
    flat = xp[0].reshape(-1).numpy()
    w = torch.empty(R, R, C, K)
    base = direct_conv.plan(xp, w, stride)
    chunks = -(-Kc // base.chunk)
    for slices in {base.slices, 1, chunks, min(3, chunks)}:
        p = base._replace(slices=slices)
        seen = np.zeros((HW, K, Kc), dtype=int)
        for k0, _, t, kb, ke in direct_blocks(HW, K, Kc, p):
            for r0 in walk_rows(kb, ke, p.chunk):
                for pix in range(t * 64, min(HW, t * 64 + 64)):
                    for k in range(r0, min(ke, r0 + p.chunk)):
                        off = patch_offset(xp.shape, pix, k, Wo, R, stride)
                        assert flat[off] == patches[pix, k]
                        seen[pix, k0:k0 + 64, k] += 1
        assert (seen == 1).all(), slices


# ---- direct: the order of summation, against the Pallas kernel ------------

def direct_model(xp, w, stride, slices, chunk, scale, bias, act):
    """The kernel's sum: each slice's fp32 partial over its contraction
    rows (the patch against the flattened filter), the partials added in
    slice order, the epilogue once, one cast."""
    R, S, C, K = w.shape
    B = xp.shape[0]
    patches = tref._patches(xp, R, S, stride).float()
    Ho, Wo = patches.shape[1:3]
    wf = w.float().reshape(R * S * C, K)
    acc = None
    for kb, ke in gemm.split_bounds(R * S * C, chunk, slices):
        part = patches[..., kb:ke] @ wf[kb:ke]
        acc = part if acc is None else acc + part
    y = tref.apply_act(acc * scale + bias, act)
    assert y.shape == (B, Ho, Wo, K)
    return y.to(xp.dtype)


# (B, H, W, C, K, R, stride): H != W, C = 3 and 12 (no 16-byte run), K =
# 20 (no tile), a 7x7 stem
DIRECT_CASES = [(1, 9, 7, 12, 20, 3, 2), (2, 6, 5, 16, 24, 3, 1),
                (1, 10, 9, 3, 8, 7, 2), (1, 7, 6, 24, 16, 1, 2)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C,K,R,stride", DIRECT_CASES)
def test_direct_slice_order_matches_pallas(B, H, W, C, K, R, stride, dtype):
    act = ("relu", "relu6", None)[(C + R) % 3]
    x_t, x_j = _both(_data(C, B, H, W, C), dtype)
    w_t, w_j = _both(_data(K, R, R, C, K, scale=(R * R * C) ** -0.5), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(C + K, K)
    xp_t = tref.pad_same(x_t, R, R, stride)
    xp_j = jref.pad_same(x_j, R, R, stride)
    refs = [jops.direct(xp_j, w_j, impl=impl, stride=stride, block_h=8,
                        scale=sc_j, bias=bi_j, act=act)
            for impl in ("pallas", "jnp")]
    p = direct_conv.plan(xp_t, w_t, stride)
    for slices in range(1, _chunks(C, R, p.chunk) + 1):
        y = direct_model(xp_t, w_t, stride, slices, p.chunk, sc_t, bi_t, act)
        for ref in refs:
            assert _rel(y, ref) <= tolerance(dtype), slices


# ---- the inverted residual: classes and plan -----------------------------

def _ir_classes(cfg):
    return sorted({(b.h, b.w, b.cin, b.mid, b.cout, b.r, b.stride,
                    b.expanded) for _, b in mobilenet.block_specs(cfg)})


IR_CLASSES = _ir_classes(get("mobilenet_v2"))


def test_inverted_residual_plan_is_a_pure_function_of_shape_and_dtype():
    params = list(inspect.signature(fused_block.plan).parameters)
    assert params == ["h", "w", "cin", "mid", "cout", "r", "s", "stride",
                      "expanded", "dtype"]
    assert "sms" not in inspect.getsource(fused_block.plan)
    assert not hasattr(fused_block, "choose_tile")


@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("h,w,cin,mid,cout,r,stride,expanded", IR_CLASSES)
def test_inverted_residual_plan_fits_and_keeps_the_recompute_low(
        h, w, cin, mid, cout, r, stride, expanded, dtype):
    p = fused_block.plan(h, w, cin, mid, cout, r, r, stride, expanded, dtype)
    assert p.path == fused_block.ir_path(cin, mid, cout, dtype)
    assert p.path == ("tensor" if dtype != torch.float32 else "fp32")
    assert p.parts == -(-mid // fused_block.IR_SLAB)
    assert fused_block.recompute(p.tile, stride, r, r) \
        <= fused_block.MAX_RECOMPUTE <= 2.3
    assert fused_block.acc_blocks(p.path, p.tile, cout) \
        <= fused_block.IR_MAX_ACC
    size = torch.empty(0, dtype=dtype).element_size()
    assert fused_block.ir_smem_bytes(p.path, size, p.tile, stride, r, r,
                                     cin, cout, expanded) \
        <= fused_block.MAX_SMEM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inverted_residual_plan_splits_mid_at_the_deep_blocks(dtype):
    """At 14² and 7² the blocks reach at least 96 CTAs, and at most one
    wave of the path's CTAs a SM, by splitting the mid width, not by a
    tile below 2 (the old plan's 49 CTAs of tile 1 or 2)."""
    for h, w, cin, mid, cout, r, stride, expanded in IR_CLASSES:
        if h > 14:
            continue
        p = fused_block.plan(h, w, cin, mid, cout, r, r, stride, expanded,
                             dtype)
        oh = -(-h // stride)
        ctas = (-(-oh // p.tile)) ** 2 * p.parts
        wave = gemm.SMS * fused_block.CTAS_PER_SM[p.path]
        assert p.parts > 1 and 96 <= ctas <= wave, (h, cin, mid, cout, p)
        assert p.tile >= 2


def test_inverted_residual_16_bit_ragged_channels_plan_on_cuda_cores():
    for dt in (torch.bfloat16, torch.float16):
        assert fused_block.plan(11, 9, 12, 36, 12, 3, 3, 1, True,
                                dt).path == "fp32"
        assert fused_block.plan(11, 9, 16, 40, 16, 3, 3, 1, True,
                                dt).path == "tensor"


# ---- the inverted residual: a Python mirror of the grid -------------------

def ir_slabs(mid):
    """Mirror of the kernel's slab ranges, one a CTA: slab q takes mid
    channels [32·q, 32·(q+1)), the last clipped to mid."""
    return [(m0, min(mid, m0 + fused_block.IR_SLAB))
            for m0 in range(0, mid, fused_block.IR_SLAB)]


@pytest.mark.parametrize("h,w,mid,stride,tile", [
    (11, 9, 36, 1, 4), (7, 7, 960, 1, 4), (14, 14, 576, 2, 3),
    (10, 9, 40, 2, 2), (9, 11, 100, 1, 8)])
def test_inverted_residual_grid_sums_every_mid_channel_once(
        h, w, mid, stride, tile):
    """Over the (tile, slab) grid each output pixel's projection sums
    every mid channel exactly once; each tile's staged halo holds its
    outputs' depthwise taps, at the input position SAME padding (low
    first) gives them."""
    r = s = 3
    oh, ow = -(-h // stride), -(-w // stride)
    pad_top = max((oh - 1) * stride + r - h, 0) // 2
    pad_left = max((ow - 1) * stride + s - w, 0) // 2
    ih, iw = (tile - 1) * stride + r, (tile - 1) * stride + s
    ranges = ir_slabs(mid)
    assert ranges[0][0] == 0 and ranges[-1][1] == mid
    seen = np.zeros((oh, ow, mid), dtype=int)
    tiles_w = -(-ow // tile)
    for t in range(-(-oh // tile) * tiles_w):
        oh0, ow0 = t // tiles_w * tile, t % tiles_w * tile
        ih0, iw0 = oh0 * stride - pad_top, ow0 * stride - pad_left
        for m0, m1 in ranges:
            for q in range(tile * tile):
                qy, qx = divmod(q, tile)
                if oh0 + qy >= oh or ow0 + qx >= ow:
                    continue
                seen[oh0 + qy, ow0 + qx, m0:m1] += 1
                for dr in range(r):
                    for ds in range(s):
                        hy, hx = qy * stride + dr, qx * stride + ds
                        assert hy < ih and hx < iw
                        # the reference's padded input row of this tap
                        assert ih0 + hy == (oh0 + qy) * stride + dr - pad_top
                        assert iw0 + hx == (ow0 + qx) * stride + ds - pad_left
    assert (seen == 1).all()


# ---- the inverted residual: the order of summation, against Pallas --------

def _ir_weights(seed, cin, mid, cout, dtype):
    """Weights for both packages, expand and depthwise biases > 0 (SAME
    padding of the expanded tensor must be an exact 0 after the act)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = {"wdw": normal(3, 3, 1, mid, scale=1 / 3),
              "sdw": rng.uniform(0.5, 1.5, mid).astype(np.float32),
              "bdw": rng.uniform(0.1, 0.5, mid).astype(np.float32),
              "w2": normal(1, 1, mid, cout, scale=mid ** -0.5),
              "s2": rng.uniform(0.5, 1.5, cout).astype(np.float32),
              "b2": normal(cout, scale=0.1)}
    if mid != cin:
        arrays.update(w1=normal(1, 1, cin, mid, scale=cin ** -0.5),
                      s1=rng.uniform(0.5, 1.5, mid).astype(np.float32),
                      b1=rng.uniform(0.1, 0.5, mid).astype(np.float32))
    tdt, jdt = DTYPES[dtype]
    wt = {k: torch.from_numpy(v).to(tdt) if k[0] == "w"
          else torch.from_numpy(v) for k, v in arrays.items()}
    wj = {k: jnp.asarray(v, dtype=jdt) if k[0] == "w" else jnp.asarray(v)
          for k, v in arrays.items()}
    return wt, wj


def ir_model(x, wt, stride, residual, act="relu6", out_act=None):
    """The kernel's sum: expand and depthwise stage by stage (each rounded
    to T), each slab's fp32 projection partial over its mid channels, the
    partials added in slab order, then out_act(v·s2 + b2), rounded to T,
    plus x for a residual block, one cast."""
    dt = x.dtype
    h = x
    if "w1" in wt:
        h = tref.pointwise_conv(h, wt["w1"], scale=wt["s1"], bias=wt["b1"],
                                act=act)
    wdw = wt["wdw"]
    d = tref.depthwise_conv(tref.pad_same(h, 3, 3, stride), wdw,
                            stride=stride, scale=wt["sdw"], bias=wt["bdw"],
                            act=act).float()
    w2 = wt["w2"][0, 0].float()
    acc = None
    for m0, m1 in ir_slabs(w2.shape[0]):
        part = d[..., m0:m1] @ w2[m0:m1]
        acc = part if acc is None else acc + part
    y = tref.apply_act(acc * wt["s2"] + wt["b2"], out_act)
    if residual:
        y = y.to(dt).float() + x.float()
    return y.to(dt)


IR_CASES = [  # (h, w, cin, mid, cout, stride, residual, block_m)
    (9, 7, 8, 8, 8, 1, False, 512),     # t = 1
    (9, 11, 4, 72, 4, 1, True, 8),      # identity add, 3 slabs
    (10, 9, 8, 40, 16, 2, False, 8),    # stride 2, a short last slab
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,w,cin,mid,cout,stride,residual,block_m",
                         IR_CASES)
def test_inverted_residual_part_order_matches_pallas(
        h, w, cin, mid, cout, stride, residual, block_m, dtype):
    x_t, x_j = _both(_data(30 + mid, 1, h, w, cin), dtype)
    wt, wj = _ir_weights(31 + mid, cin, mid, cout, dtype)
    refs = [jops.fused_inverted_residual(
        x_j, wj, impl=impl, stride=stride, block_m=block_m,
        residual=residual, act="relu6", out_act=None)
        for impl in ("pallas", "jnp")]
    p = fused_block.plan(h, w, cin, mid, cout, 3, 3, stride, "w1" in wt,
                         x_t.dtype)
    assert p.parts == len(ir_slabs(mid))
    y = ir_model(x_t, wt, stride, residual)
    for ref in refs:
        assert _rel(y, ref) <= tolerance(dtype)


# ---- sources and bindings --------------------------------------------------

def _csrc(name):
    return (CSRC / name).read_text()


def _code(name):
    """A source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", _csrc(name), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_both_kernels_use_the_tensor_cores_and_gemm_tiles_primitives():
    for name in ("direct_conv.cu", "fused_inverted_residual.cu"):
        code = _code(name)
        assert '#include "gemm_tile.cuh"' in code
        assert "conv_tile.cuh" not in code
        assert "mma16816<T>(" in code and "ldmatrix_x4(" in code
        assert "ldmatrix_x4_trans(" in code and "cp_async16(" in code
        assert "launch_splitk_reduce(" in code and "fmaf(" in code
        assert "tf32" not in code.lower()
        for defined in ("mma.sync", "ldmatrix.sync", "cp.async.cg",
                        "splitk_reduce(const float*"):
            assert defined not in code, (name, defined)


def test_the_old_serial_bodies_are_gone():
    ir = _code("fused_inverted_residual.cu")
    for old in ("block_gemm", "GEMM_ROWS", "accs", "choose_tile"):
        assert old not in ir, old
    direct = _code("direct_conv.cu")
    for old in ("offs[CHUNK]", "float ws[CHUNK]", "BAND"):
        assert old not in direct, old
    assert not hasattr(fused_block, "IR_GEMM_ROWS")
    # one pixel tile and one slab a CTA: no walk over tiles or slabs
    assert "groups" not in direct and "rows_tile" not in direct
    for old in ("parts", "stage_weights", "off_stage"):
        assert old not in ir, old


def test_entry_points_take_the_plans_and_a_workspace():
    # dtype; x, w, scale, bias, out; B, Hp, Wp, C, R, S, K, H, W, stride,
    # act, tile, slices; workspace, stream
    sig = _build.SIGNATURES["direct_conv_launch"]
    assert len(sig) == 21 and sig[-2:] == [_build._P, _build._P]
    src = " ".join(_csrc("direct_conv.cu").split())
    assert "int tile, int slices, void* ws, void* stream" in src
    # dtype; x, w1, s1, b1, wdw, sdw, bdw, w2, s2, b2, out; B, H, W, Cin,
    # mid, Cout, R, S, stride, act, out_act, residual, tile; workspace,
    # stream
    sig = _build.SIGNATURES["fused_inverted_residual_launch"]
    assert len(sig) == 27 and sig[-2:] == [_build._P, _build._P]
    src = " ".join(_csrc("fused_inverted_residual.cu").split())
    assert "int residual, int tile, void* ws, void* stream" in src


def test_tiny_mobilenet_plans_fit():
    """The tiny config's blocks (images down to 1x1) all have a plan."""
    for h, w, cin, mid, cout, r, stride, expanded in _ir_classes(
            tiny_variant(get("mobilenet_v2"))):
        for dt in ALL_DTYPES:
            p = fused_block.plan(h, w, cin, mid, cout, r, r, stride,
                                 expanded, dt)
            assert p.tile in fused_block.IR_TILES
