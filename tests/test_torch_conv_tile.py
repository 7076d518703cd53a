"""``ilpm_conv`` and ``fused_residual_conv`` on the halo-resident, split
conv tile (``csrc/conv_tile.cuh``), on the CPU: a Python model of the
tile's index math, its launch plan, and the order in which it sums.

- **Index math.** A mirror of ``conv_stage`` (the halo'd tile staged with
  each stride phase's columns together) and of the pixel and tap offsets
  the kernels read at: for strides 1 and 2, R ∈ {1, 3, 7} and H ≠ W, the
  shifted windows of the staged tile pick exactly the elements of the
  reference patch; on the tensor cores every ldmatrix phase's 8 rows fall
  on 8 bank groups.
- **Split.** The parts (channel chunks x filter rows) cover the
  contraction exactly once.
- **Plan.** ``ilpm_conv.plan`` never sees the number of images, sizes the
  deep classes to 8-16 chunk splits at 7² and 14² and 1-4 at 56², fits
  shared memory, and puts a 16-bit C = 3 stem on the CUDA cores.
- **Sum.** The kernels' sum (each part's fp32 partial, the parts added in
  order, the epilogue once, one cast; the residual converted to the
  compute dtype before the shortcut add) at every part count the kernels
  accept, held against the JAX package's Pallas kernels in interpret mode
  within ``tolerance(dtype)``.
- **Sources.** Both kernels build on the new tile, the 16-bit path uses
  ``mma.sync`` and no TF32, the mma, ldmatrix, cp.async and split-reduce
  code exists once, and the old serial body is gone.

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

from repro.kernels import fused_block as jfused
from repro.kernels import ilpm_conv as jilpm
from repro.kernels import ref as jref
from repro_torch.configs import get
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import _build, gemm, ilpm_conv
from repro_torch.kernels import ref as tref
from repro_torch.models import mobilenet, resnet

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
T = ilpm_conv.TILE


def _classes():
    """(kernel, H, C, K, R, stride) of every site of full-width ResNet-18
    and MobileNetV2 that the conv tile runs on some path: the dense ilpm
    sites (strided ones and the 1x1/2 projections included, which the
    forced paths send to ilpm), the fused residual blocks' 3x3s, and the
    ResNet-50 1x1 fused class."""
    classes = {("fused_residual_conv", 56, 64, 256, 1, 1)}
    for name, model in (("resnet18", resnet), ("mobilenet_v2", mobilenet)):
        for _, spec in model.conv_specs(get(name)):
            if spec.groups != 1 or (spec.r == 1 and spec.stride == 1):
                continue
            classes.add(("ilpm_conv", spec.h, spec.c, spec.k, spec.r,
                         spec.stride))
            if name == "resnet18" and spec.r == 3 and spec.stride == 1:
                classes.add(("fused_residual_conv", spec.h, spec.c, spec.k,
                             3, 1))
    return sorted(classes)


CLASSES = _classes()


def _plan(H, C, K, R, stride, dtype, batch=1, W=None):
    x = torch.empty(batch, H, H if W is None else W, C, dtype=dtype)
    return ilpm_conv.plan(tref.pad_same(x, R, R, stride),
                          torch.empty(R, R, C, K, dtype=dtype), stride)


def test_classes_are_the_networks_tile_sites():
    assert ("ilpm_conv", 224, 3, 64, 7, 2) in CLASSES    # ResNet-18 stem
    assert ("ilpm_conv", 224, 3, 32, 3, 2) in CLASSES    # MobileNetV2 stem
    assert ("ilpm_conv", 56, 64, 128, 1, 2) in CLASSES   # a projection
    fused = [c[1:] for c in CLASSES if c[0] == "fused_residual_conv"]
    assert fused == [(7, 512, 512, 3, 1), (14, 256, 256, 3, 1),
                     (28, 128, 128, 3, 1), (56, 64, 64, 3, 1),
                     (56, 64, 256, 1, 1)]


# ---- a Python mirror of the tile's index math ----------------------------

def halo_geometry(R, S, stride, rsplit=1):
    """(IH, IW, half, IWp) as ``launch_conv_tile`` derives them: rows for
    the most filter rows a part takes, columns of the tile's receptive
    field, stored columns per stride phase and in all."""
    nr = -(-R // rsplit)
    ih, iw = (T - 1) * stride + nr, (T - 1) * stride + S
    half = -(-iw // stride)
    return ih, iw, half, half * stride


def stage_halo(xp, oh0, ow0, r0, nr, c0, chunk, S, stride, pix_ld):
    """Mirror of ``conv_stage``'s halo copy for one image: (IH·IWp,
    pix_ld) staged pixels; input column hx at hx % stride · half +
    hx // stride of its row; zeros past the image and past C."""
    Hp, Wp, C = xp.shape
    ih, iw, half, iwp = halo_geometry(nr, S, stride)
    staged = np.zeros((ih * iwp, pix_ld), xp.dtype)
    for hy in range(ih):
        for hx in range(iw):
            gy, gx = oh0 * stride + r0 + hy, ow0 * stride + hx
            if gy < Hp and gx < Wp:
                vals = xp[gy, gx, c0:min(C, c0 + chunk)]
                staged[hy * iwp + hx % stride * half + hx // stride,
                       :len(vals)] = vals
    return staged, half, iwp


def pixel_offset(i, j, stride, iwp):
    """Staged pixel of output pixel (i, j) of the tile at tap (0, 0)."""
    return i * stride * iwp + j


def tap_offset(r, s, stride, half, iwp):
    """Mirror of ``for_each_tap``'s offsets: the staged offset of tap
    (r, s) from its pixel's, in staged pixels."""
    return r * iwp + s % stride * half + s // stride


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("R,rsplit", [(1, 1), (3, 1), (3, 2), (7, 1),
                                      (7, 2)])
def test_shifted_windows_of_the_staged_tile_are_the_reference_patch(
        stride, R, rsplit):
    """Every output pixel of every tile, at every tap of every row part,
    read from the staged tile through pixel_offset + tap_offset, is the
    reference patch's element; H != W and a ragged last tile included."""
    C, chunk = 6, 4
    H, W = 11, 9
    x = torch.from_numpy(np.random.default_rng(R).standard_normal(
        (1, H, W, C)).astype(np.float32))
    xp = tref.pad_same(x, R, R, stride)
    Ho, Wo = -(-H // stride), -(-W // stride)
    patches = tref._patches(xp, R, R, stride)[0].numpy()  # (Ho, Wo, R*R*C)
    xpn = xp[0].numpy()
    seen = np.zeros((Ho, Wo, R * R * C), dtype=int)
    for oh0 in range(0, Ho, T):
        for ow0 in range(0, Wo, T):
            for sr in range(rsplit):
                r0, r1 = sr * R // rsplit, (sr + 1) * R // rsplit
                for c0 in range(0, C, chunk):
                    staged, half, iwp = stage_halo(
                        xpn, oh0, ow0, r0, r1 - r0, c0, chunk, R, stride,
                        chunk)
                    for i in range(T):
                        for j in range(T):
                            if oh0 + i >= Ho or ow0 + j >= Wo:
                                continue
                            for r in range(r0, r1):
                                for s in range(R):
                                    row = staged[pixel_offset(
                                        i, j, stride, iwp) + tap_offset(
                                        r - r0, s, stride, half, iwp)]
                                    for c in range(c0, min(C, c0 + chunk)):
                                        col = (r * R + s) * C + c
                                        assert row[c - c0] == patches[
                                            oh0 + i, ow0 + j, col]
                                        seen[oh0 + i, ow0 + j, col] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("chunk", [16, 32])
def test_ldmatrix_rows_cover_the_tile_on_distinct_bank_groups(stride, chunk):
    """The tensor-core path's A rows: lane l of warp (wm, wn), m tile i,
    reads tile pixel wm·32 + 16 i + l % 16 at channel (l // 16)·8; the 64
    pixels are covered, and each ldmatrix phase (8 lanes, 16 bytes each)
    touches 8 distinct 16-byte bank groups, at every tap."""
    R = S = 3
    _, _, half, iwp = halo_geometry(R, S, stride)
    pix_ld = chunk + ilpm_conv.TC_PAD
    covered = set()
    for wm in range(2):
        for i in range(2):
            rows = []
            for lane in range(32):
                p = wm * 32 + 16 * i + lane % 16
                covered.add(p)
                rows.append(((p // T * stride * iwp + p % T) * pix_ld
                             + lane // 16 * 8))
            for r in range(R):
                for s in range(S):
                    toff = tap_offset(r, s, stride, half, iwp) * pix_ld
                    for ks in range(0, chunk, 16):
                        for phase in range(4):
                            addr = [2 * (rows[lane] + toff + ks)
                                    for lane in range(8 * phase,
                                                      8 * phase + 8)]
                            assert all(a % 16 == 0 for a in addr)
                            assert len({a // 16 % 8 for a in addr}) == 8
    assert covered == set(range(T * T))


# ---- the split -----------------------------------------------------------

def split_parts(C, R, chunk, split, rsplit):
    """Mirror of ``conv_block``: the contraction of each part, in the
    reduction's order. Part p = (channel split p // rsplit, row split
    p % rsplit) takes channels [c0, c1) (whole chunks, as
    ``gemm.split_bounds`` gives them) and filter rows [r0, r1)."""
    return [(c0, c1, sr * R // rsplit, (sr + 1) * R // rsplit)
            for c0, c1 in gemm.split_bounds(C, chunk, split)
            for sr in range(rsplit)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("kernel,H,C,K,R,stride", CLASSES)
def test_plan_ignores_the_batch_and_its_parts_cover_the_contraction_once(
        kernel, H, C, K, R, stride, dtype):
    one, four = (_plan(H, C, K, R, stride, dtype, batch=b) for b in (1, 4))
    assert one == four
    p = one
    assert p.tile == T and p.split in (1, 2, 4, 8, 16)
    assert 1 <= p.rsplit <= R
    tensor = dtype != torch.float32 and C % 8 == 0 and K % 8 == 0
    assert p.path == ("tensor" if tensor else "fp32")
    assert p.chunk in ((16, 32) if tensor else (4, 8, 16))
    assert p.split <= -(-C // p.chunk)
    assert ilpm_conv.smem_bytes(p.path, torch.empty(0, dtype=dtype)
                                .element_size(), p.chunk, R, R, stride,
                                p.rsplit) <= ilpm_conv.MAX_SMEM
    covered = np.zeros((R, C), dtype=int)
    for c0, c1, r0, r1 in split_parts(C, R, p.chunk, p.split, p.rsplit):
        assert c0 < c1 and c0 % p.chunk == 0 and r0 < r1
        covered[r0:r1, c0:c1] += 1
    assert (covered == 1).all()
    assert len(split_parts(C, R, p.chunk, p.split, p.rsplit)) == p.parts


def test_plan_has_no_argument_for_the_number_of_images():
    params = list(inspect.signature(ilpm_conv.plan).parameters)
    assert params == ["x_padded", "w", "stride"]


def test_plan_sizes_the_deep_classes():
    """8-16 chunk splits at 7² and 14², 1-4 at 56², on both paths. Rows
    split where the grid stays small: all three at 7² and on the tensor
    cores' 56², two at the fp32 56² and at the 7x7 stem; MobileNetV2's
    3x3 stem, 12 products a filter row, is not split at all."""
    for dt in (torch.float32, torch.bfloat16):
        for H, C in ((7, 512), (14, 256)):
            assert 8 <= _plan(H, C, C, 3, 1, dt).split <= 16
        assert 1 <= _plan(56, 64, 64, 3, 1, dt).split <= 4
        assert _plan(7, 512, 512, 3, 1, dt).rsplit == 3
        assert _plan(224, 3, 64, 7, 2, dt).parts == 2
        assert _plan(224, 3, 32, 3, 2, dt).parts == 1
    assert _plan(56, 64, 64, 3, 1, torch.float32).rsplit == 2
    assert _plan(56, 64, 64, 3, 1, torch.bfloat16).rsplit == 3
    assert _plan(14, 256, 256, 3, 1, torch.float32).rsplit == 1


def test_a_16_bit_shape_the_tensor_cores_cannot_take_plans_on_cuda_cores():
    for dt in (torch.bfloat16, torch.float16):
        for H, C, K, R in ((224, 3, 64, 7), (224, 3, 32, 3)):
            p = _plan(H, C, K, R, 2, dt)
            assert p.path == "fp32" and p.chunk == 4
        assert _plan(11, 12, 20, 3, 1, dt, W=9).path == "fp32"
        assert _plan(11, 16, 24, 3, 1, dt, W=9).path == "tensor"


def test_a_chunk_that_overflows_shared_memory_is_halved_or_split_by_rows():
    """A 7x7 filter over many channels: two stages of a full chunk do not
    fit a block, so the plan halves the chunk (the CUDA cores) or gives
    every filter row a part (the tensor cores' least chunk)."""
    p = _plan(28, 64, 64, 7, 1, torch.float32)
    assert p.chunk == 8
    p = _plan(28, 64, 64, 7, 1, torch.bfloat16)
    assert p.chunk == 16 and p.rsplit == 7


# ---- the kernels' order of summation, held against the Pallas kernels ----

def _data(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, dtype=jdt)


def _epilogue(seed, k):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    bias = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return (torch.from_numpy(scale), torch.from_numpy(bias),
            jnp.asarray(scale), jnp.asarray(bias))


def _rel(y, ref):
    y = y.float().numpy()
    r = np.asarray(ref, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    return float(np.abs(y - r).max() / np.abs(r).max())


def split_model(xp, w, stride, parts):
    """The kernels' fp32 sum: each part's partial over its channels and
    filter rows (tap by tap, a strided window of the padded image), the
    partials added in part order."""
    R, S, _, K = w.shape
    B, Hp, Wp, _ = xp.shape
    H, W = (Hp - R) // stride + 1, (Wp - S) // stride + 1
    xf, wf = xp.float(), w.float()
    acc = None
    for c0, c1, r0, r1 in parts:
        part = torch.zeros(B, H, W, K)
        for r in range(r0, r1):
            for s in range(S):
                win = xf[:, r:r + (H - 1) * stride + 1:stride,
                         s:s + (W - 1) * stride + 1:stride, c0:c1]
                part += win @ wf[r, s, c0:c1]
        acc = part if acc is None else acc + part
    return acc


def _all_parts(C, R, chunk):
    chunks = -(-C // chunk)
    return [(s, rs) for s in (1, 2, 4, 8, 16) if s <= chunks
            for rs in range(1, R + 1)]


# (B, H, W, C, K, R, stride): H != W, stride 1 and 2, C = 12 and K = 20
# (multiples of no tile), C = 40 (a short last chunk)
ILPM_CASES = [(1, 9, 7, 12, 20, 3, 2), (2, 6, 5, 40, 16, 3, 1),
              (1, 10, 9, 3, 8, 7, 2), (1, 7, 6, 24, 16, 1, 2)]
RES_CASES = [(2, 6, 5, 40, 16, 3), (1, 9, 7, 12, 20, 3),
             (1, 5, 6, 16, 24, 1)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C,K,R,stride", ILPM_CASES)
def test_ilpm_split_order_matches_pallas(B, H, W, C, K, R, stride, dtype):
    act = ("relu", "relu6", None)[(C + R) % 3]
    x_t, x_j = _both(_data(C, B, H, W, C), dtype)
    w_t, w_j = _both(_data(K, R, R, C, K, scale=(R * R * C) ** -0.5), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(C + K, K)
    xp_t = tref.pad_same(x_t, R, R, stride)
    xp_j = jref.pad_same(x_j, R, R, stride)
    ref = jilpm.ilpm_conv(xp_j, w_j, stride=stride, scale=sc_j, bias=bi_j,
                          act=act, interpret=True)
    p = ilpm_conv.plan(xp_t, w_t, stride)
    combos = _all_parts(C, R, p.chunk)
    assert (p.split, p.rsplit) in combos
    for split, rsplit in combos:
        parts = split_parts(C, R, p.chunk, split, rsplit)
        acc = split_model(xp_t, w_t, stride, parts)
        y = tref.apply_act(acc * sc_t + bi_t, act).to(x_t.dtype)
        assert _rel(y, ref) <= tolerance(dtype), (split, rsplit)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C,K,R", RES_CASES)
def test_fused_residual_split_order_matches_pallas(B, H, W, C, K, R, dtype):
    """The reduction's residual epilogue: acc·scale + bias converted to
    the compute dtype, then the shortcut added, then the activation."""
    act = ("relu", "relu6", None)[(C + K) % 3]
    x_t, x_j = _both(_data(C, B, H, W, C), dtype)
    w_t, w_j = _both(_data(K, R, R, C, K, scale=(R * R * C) ** -0.5), dtype)
    res_t, res_j = _both(_data(K + 1, B, H, W, K), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(C + K, K)
    xp_t, xp_j = tref.pad_same(x_t, R, R), jref.pad_same(x_j, R, R)
    ref = jfused.fused_residual_conv(
        xp_j, {"w": w_j, "scale": sc_j, "bias": bi_j}, res=res_j, act=act,
        interpret=True)
    p = ilpm_conv.plan(xp_t, w_t, 1)
    for split, rsplit in _all_parts(C, R, p.chunk):
        parts = split_parts(C, R, p.chunk, split, rsplit)
        acc = split_model(xp_t, w_t, 1, parts)
        y = (acc * sc_t + bi_t).to(x_t.dtype).float() + res_t.float()
        y = tref.apply_act(y, act).to(x_t.dtype)
        assert _rel(y, ref) <= tolerance(dtype), (split, rsplit)


# ---- sources and bindings -------------------------------------------------

def _csrc(name):
    return (CSRC / name).read_text()


def test_both_kernels_build_on_the_new_tile():
    tile = _csrc("conv_tile.cuh")
    assert '#include "gemm_tile.cuh"' in tile
    for name in ("ilpm_conv", "fused_residual_conv"):
        src = _csrc(f"{name}.cu")
        assert '#include "conv_tile.cuh"' in src
        assert "launch_conv_tile<T>(" in src
    assert "ScaleBiasRes<T>" in _csrc("fused_residual_conv.cu")
    # the 16-bit path: mma.sync fed by ldmatrix from the staged tile
    assert "conv_tc_kernel" in tile and "mma16816<T>(" in tile
    assert "ldmatrix_x4(" in tile and "ldmatrix_x4_trans(" in tile
    assert "cp_async16(" in tile and "launch_splitk_reduce(" in tile
    assert "fmaf(" in tile


def test_old_serial_body_is_gone():
    tile = _csrc("conv_tile.cuh")
    for old in ("conv_tile_kernel", "channel_chunk", "FILTER_SMEM_BUDGET",
                "acc[4][4]", "float* xs = smem"):
        assert old not in tile, old


def test_primitives_exist_once_and_no_source_asks_for_tf32():
    defs = {
        "mma": r"mma\.sync\.aligned\.m16n8k16",
        "ldmatrix": r"ldmatrix\.sync\.aligned",
        "cp.async": r"cp\.async\.cg\.shared\.global",
        "split reduce": r"__global__ void splitk_reduce",
        "split range": r"void split_range\(",
    }
    for what, pattern in defs.items():
        files = [p.name for p in CSRC.iterdir()
                 if re.search(pattern, p.read_text())]
        assert files == ["gemm_tile.cuh"], (what, files)
    for path in CSRC.iterdir():
        assert ".tf32" not in path.read_text(), path.name


def test_entry_points_take_tile_chunk_splits_and_workspace():
    # dtype; x, w, scale, bias, out; B, Hp, Wp, C, R, S, K, H, W, stride,
    # act, tile, chunk, split, rsplit; workspace, stream
    sig = _build.SIGNATURES["ilpm_conv_launch"]
    assert len(sig) == 23 and sig[-2:] == [_build._P, _build._P]
    # dtype; x, w, scale, bias, res, out; B, Hp, Wp, C, R, S, K, act,
    # tile, chunk, split, rsplit; workspace, stream
    sig = _build.SIGNATURES["fused_residual_conv_launch"]
    assert len(sig) == 21 and sig[-2:] == [_build._P, _build._P]
    for name in ("ilpm_conv", "fused_residual_conv"):
        src = " ".join(_csrc(f"{name}.cu").split())
        assert "int tile, int chunk, int split, int rsplit, void* ws" in src

