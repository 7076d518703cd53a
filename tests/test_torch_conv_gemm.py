"""``pointwise_conv`` and ``libdnn_conv`` on ``gemm``'s split-K tile, on
the CPU: their launch plans, a Python model of the order in which the
kernels sum, and the address math of their A rows.

- **Plan.** Each 1x1 class (``pointwise_conv``) and stride-1 3x3 class
  (``libdnn_conv``) of full-width ResNet-18 and MobileNetV2 gets a split
  from ``gemm.conv_plan`` that does not depend on the number of images,
  and ``gemm.split_bounds`` covers its contraction exactly once.
- **Split-K order.** The kernels' split s sums its fp32 partial product
  over the contraction range ``gemm.split_bounds`` gives it; the
  reduction adds the splits in order 0..split-1 and applies the epilogue
  ``act(acc*scale + bias)`` once, then casts once. That model, at every
  split the kernel accepts, is held against the JAX package's Pallas
  kernels in interpret mode within ``tolerance(dtype)``.
- **A rows.** A Python mirror of ``PixelRows`` (pointwise: row q is the
  pixel ``x[(q // Wo)·s, (q % Wo)·s]``) and of ``PatchRows`` (libdnn:
  ``row(q) + col(k)``, an offset into the padded image) is held against
  ``x[::s, ::s]`` and the JAX package's patch matrix element by element.
- **Sources.** Both kernels include ``gemm_tile.cuh``, which carries the
  bf16 and fp16 ``mma.sync`` and no TF32.

The CUDA kernels cannot run here; chip_smoke.py holds them against their
plain versions on the card.
"""
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import libdnn_conv as jlibdnn
from repro.kernels import pointwise_conv as jpointwise
from repro.kernels import ref as jref
from repro_torch.configs import get
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import _build, gemm, libdnn_conv, pointwise_conv
from repro_torch.kernels import ref as tref
from repro_torch.models import mobilenet, resnet

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
PLAN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _classes():
    """(kernel, H, C, K, R, stride) of every pointwise site of full-width
    ResNet-18 and MobileNetV2 and every stride-1 3x3 site of ResNet-18
    (those forced libdnn sends to libdnn_conv), each class once."""
    classes = set()
    for name, model in (("resnet18", resnet), ("mobilenet_v2", mobilenet)):
        for _, spec in model.conv_specs(get(name)):
            if spec.groups != 1:
                continue
            if spec.r == 1:
                classes.add(("pointwise_conv", spec.h, spec.c, spec.k, 1,
                             spec.stride))
            elif name == "resnet18" and spec.r == 3 and spec.stride == 1:
                classes.add(("libdnn_conv", spec.h, spec.c, spec.k, 3, 1))
    return sorted(classes)


CLASSES = _classes()


def _plan(kernel, x, w, stride):
    if kernel == "pointwise_conv":
        return pointwise_conv.plan(x, w, stride)
    return libdnn_conv.plan(tref.pad_same(x, 3, 3), w)


def test_classes_are_the_networks_1x1_layers_and_the_papers_four():
    libdnn = [c for c in CLASSES if c[0] == "libdnn_conv"]
    assert [(h, c, k) for _, h, c, k, _, _ in libdnn] == [
        (7, 512, 512), (14, 256, 256), (28, 128, 128), (56, 64, 64)]
    assert len(CLASSES) - len(libdnn) == 22


def test_conv_plan_has_no_argument_for_the_number_of_images():
    params = list(inspect.signature(gemm.conv_plan).parameters)
    assert params == ["M", "K", "Kc", "dtype", "kind"]


@pytest.mark.parametrize("dtype", PLAN_DTYPES)
@pytest.mark.parametrize("kernel,H,C,K,R,stride", CLASSES)
def test_plan_ignores_the_batch_and_covers_the_contraction_once(
        kernel, H, C, K, R, stride, dtype):
    w = torch.empty(R, R, C, K, dtype=dtype)
    one, four = (_plan(kernel, torch.empty(b, H, H, C, dtype=dtype), w,
                       stride) for b in (1, 4))
    assert one == four
    tile, split = one
    kind = gemm.conv_path(torch.empty(1, H, H, C, dtype=dtype), w)
    assert kind == ("fp32" if dtype == torch.float32 else "tensor")
    Kc, chunk = R * R * C, gemm.CHUNK[kind]
    # an fp32 pointwise conv splits at its 32-channel slabs, one a split
    slab = gemm.SLAB if kernel == "pointwise_conv" \
        and dtype == torch.float32 else 0
    assert tile == gemm.TILE and (split == -(-Kc // slab) if slab
                                  else split in (1, 2, 4, 8, 16))
    assert split <= -(-Kc // chunk)
    covered = np.zeros(Kc, dtype=int)
    for k0, k1 in gemm.split_bounds(Kc, chunk, split, slab):
        assert k0 < k1 and k0 % chunk == 0
        covered[k0:k1] += 1
    assert (covered == 1).all()


def test_plan_sizes_the_deep_classes():
    """libdnn's four classes get what im2col's products get from
    ``gemm.plan``; pointwise's 7² and 14² classes, 3-24 tiles each, are
    split down to one chunk a split (two on the tensor cores) while the
    grid is below one CTA per SM."""
    f32, bf = torch.float32, torch.bfloat16

    def ctas(M, K, kind, dt, Kc):
        tile, split = gemm.conv_plan(M, K, Kc, dt, kind)
        return -(-M // tile) * -(-K // tile) * split
    for (M, Kc, K), fp, tc in [((3136, 576, 64), 392, 196),
                               ((784, 1152, 128), 416, 208),
                               ((196, 2304, 256), 256, 128),
                               ((49, 4608, 512), 128, 128)]:
        assert ctas(M, K, "fp32", f32, Kc) == fp
        assert ctas(M, K, "tensor", bf, Kc) == tc
        assert gemm.conv_plan(M, K, Kc, f32, "fp32") \
            == gemm.plan(M, K, Kc, 1, f32, f32)
    # 7²×960→160: 3 tiles, 60 chunks of 16 or 30 of 32
    assert gemm.conv_plan(49, 160, 960, f32, "fp32") == (64, 16)
    assert gemm.conv_plan(49, 160, 960, bf, "tensor") == (64, 8)
    # 14²×384→64: 4 tiles, 24 or 12 chunks
    assert ctas(196, 64, "fp32", f32, 384) == 64
    assert ctas(196, 64, "tensor", bf, 384) == 16
    # 14²×64→384: 24 tiles, 4 or 2 chunks
    assert gemm.conv_plan(196, 384, 64, f32, "fp32") == (64, 4)
    assert gemm.conv_plan(196, 384, 64, bf, "tensor") == (64, 1)
    # 112²×32→16: 196 tiles, a wave already: not split
    assert gemm.conv_plan(12544, 16, 32, f32, "fp32") == (64, 1)


def test_a_16_bit_shape_the_tensor_cores_cannot_take_plans_on_cuda_cores():
    for dt in (torch.bfloat16, torch.float16):
        x = torch.empty(1, 15, 17, 12, dtype=dt)
        w = torch.empty(1, 1, 12, 20, dtype=dt)
        assert gemm.conv_path(x, w) == "fp32"
        assert gemm.conv_path(x[..., :8].contiguous(),
                              w[:, :, :8, :16].contiguous()) == "tensor"
        assert pointwise_conv.plan(x, w, 2) == gemm.plan(
            72, 20, 12, 1, dt, torch.float32)


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


def pixel_rows(x, stride):
    """Mirror of ``PixelRows`` in csrc/pointwise_conv.cu: A (B, Ho·Wo, C),
    row q the pixel ((q // Wo)·stride, (q % Wo)·stride)."""
    _, H, W, _ = x.shape
    Ho, Wo = -(-H // stride), -(-W // stride)
    q = torch.arange(Ho * Wo)
    return x[:, q // Wo * stride, q % Wo * stride, :]


def patch_offsets(H, W, C, S, Wp, R):
    """Mirror of ``PatchRows`` in csrc/libdnn_conv.cu: the offset of
    element (q, k) of the patch matrix in one padded image (Hp, Wp, C),
    ``row(q) + col(k)`` with tap = k // C = r·S + s and channel k % C."""
    q = np.arange(H * W)[:, None]
    k = np.arange(R * S * C)[None, :]
    tap = k // C
    return (q // W * Wp + q % W) * C + (tap // S * Wp + tap % S) * C \
        + (k - tap * C)


def patch_rows(xp, R, S):
    """A (B, H·W, R·S·C) gathered through ``patch_offsets``."""
    B, Hp, Wp, C = xp.shape
    offs = torch.from_numpy(patch_offsets(Hp - R + 1, Wp - S + 1, C, S, Wp,
                                          R))
    return xp.reshape(B, -1)[:, offs]


def split_k_model(a, b, scale, bias, act, split, chunk, dtype, slab=0):
    """The kernels' sum: split s's fp32 partial product over its range
    (``gemm.split_bounds``, at ``slab``-channel slabs where given), the
    partials added in split order, the epilogue once, one cast."""
    acc = None
    for k0, k1 in gemm.split_bounds(a.shape[-1], chunk, split, slab):
        part = a[..., k0:k1].float() @ b[k0:k1].float()
        acc = part if acc is None else acc + part
    return tref.apply_act(acc * scale + bias, act).to(dtype)


def _splits(Kc, chunk):
    chunks = -(-Kc // chunk)
    return [s for s in (1, 2, 4, 8, 16) if s <= chunks]


# (B, H, W, C, K, stride): stride 1 and 2, H != W, and C = 12, K = 20,
# multiples of no 16-byte run and no tile
POINTWISE_CASES = [(2, 9, 7, 96, 40, 1), (1, 10, 13, 64, 24, 2),
                   (2, 5, 6, 12, 20, 2)]
# (B, H, W, C, K, R): C = 6 puts 4- and 8-element runs across taps
LIBDNN_CASES = [(1, 6, 5, 16, 24, 3), (2, 5, 7, 6, 20, 3)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C,K,stride", POINTWISE_CASES)
def test_pointwise_split_k_order_matches_pallas(B, H, W, C, K, stride,
                                                dtype):
    act = ("relu6", None, "relu")[(C + stride) % 3]
    x_t, x_j = _both(_data(C, B, H, W, C), dtype)
    w_t, w_j = _both(_data(K, 1, 1, C, K, scale=C ** -0.5), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(C + K, K)
    ref = jpointwise.pointwise_conv(x_j, w_j, stride=stride, scale=sc_j,
                                    bias=bi_j, act=act, interpret=True)
    kind = gemm.conv_path(x_t, w_t)
    assert kind == ("fp32" if dtype == "float32" or C % 8 or K % 8
                    else "tensor")
    a = pixel_rows(x_t, stride)
    assert torch.equal(a, x_t[:, ::stride, ::stride].reshape(B, -1, C))
    # fp32 takes one split a 32-channel slab; 16-bit types a power of two
    slab = gemm.SLAB if dtype == "float32" else 0
    splits = [-(-C // slab)] if slab else _splits(C, gemm.CHUNK[kind])
    assert pointwise_conv.plan(x_t, w_t, stride)[1] in splits
    for split in splits:
        y = split_k_model(a, w_t[0, 0], sc_t, bi_t, act, split,
                          gemm.CHUNK[kind], x_t.dtype, slab)
        y = y.reshape(B, -(-H // stride), -(-W // stride), K)
        assert _rel(y, ref) <= tolerance(dtype), split


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C,K,R", LIBDNN_CASES)
def test_libdnn_split_k_order_matches_pallas(B, H, W, C, K, R, dtype):
    act = "relu" if C % 2 else "relu6"
    x_t, x_j = _both(_data(C, B, H, W, C), dtype)
    w_t, w_j = _both(_data(K, R, R, C, K, scale=(R * R * C) ** -0.5), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(C + K, K)
    xp_t, xp_j = tref.pad_same(x_t, R, R), jref.pad_same(x_j, R, R)
    ref = jlibdnn.libdnn_conv(xp_j, w_j, scale=sc_j, bias=bi_j, act=act,
                              interpret=True)
    kind = gemm.conv_path(xp_t, w_t)
    assert kind == ("fp32" if dtype == "float32" or C % 8 or K % 8
                    else "tensor")
    Kc = R * R * C
    splits = _splits(Kc, gemm.CHUNK[kind])
    assert len(splits) > 1
    assert libdnn_conv.plan(xp_t, w_t)[1] in splits
    a = patch_rows(xp_t, R, R)
    for split in splits:
        y = split_k_model(a, w_t.reshape(Kc, K), sc_t, bi_t, act, split,
                          gemm.CHUNK[kind], x_t.dtype).reshape(B, H, W, K)
        assert _rel(y, ref) <= tolerance(dtype), split


# ---- the A rows' address math --------------------------------------------

@pytest.mark.parametrize("H,W,C,R,S", [(5, 7, 6, 3, 3), (4, 4, 16, 3, 3),
                                       (6, 5, 3, 1, 3), (3, 4, 5, 2, 3)])
def test_libdnn_patch_offsets_match_the_reference_patch_matrix(H, W, C, R,
                                                               S):
    xp = _data(H * W + C, 2, H + R - 1, W + S - 1, C)
    want = np.asarray(jref.im2col_unroll(jnp.asarray(xp), R, S))
    got = patch_rows(torch.from_numpy(xp), R, S).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("C", [6, 8, 12, 16, 64])
def test_libdnn_16_byte_runs_stay_in_one_tap_exactly_where_the_kernel_copies_them(C):  # noqa: E501
    """Where C is a multiple of the run (4 fp32, 8 16-bit elements) every
    run that starts at a multiple of it is contiguous in x_padded: the
    kernel copies it with one cp.async. Where it is not, some run
    straddles a tap, and the kernel loads scalars."""
    H, W, R = 4, 5, 3
    offs = patch_offsets(H, W, C, R, W + R - 1, R)
    for run in (4, 8):
        starts = offs[:, :offs.shape[1] - run + 1:run]
        spans = np.stack([offs[:, k:k + run] for k in
                          range(0, offs.shape[1] - run + 1, run)], axis=1)
        contiguous = (spans == starts[..., None] + np.arange(run)).all()
        assert contiguous == (C % run == 0)


@pytest.mark.parametrize("stride", [1, 2])
def test_pointwise_pixel_rows_read_only_the_strided_pixels(stride):
    x = torch.from_numpy(_data(stride, 2, 7, 10, 3))
    a = pixel_rows(x, stride)
    want = torch.from_numpy(np.array(jnp.asarray(
        x.numpy())[:, ::stride, ::stride])).reshape(2, -1, 3)
    assert torch.equal(a, want)


# ---- sources and bindings -------------------------------------------------

def test_both_convs_build_on_the_shared_tile_with_tensor_cores_and_no_tf32():
    tile = (CSRC / "gemm_tile.cuh").read_text()
    for t in ("bf16", "f16"):
        assert f"mma.sync.aligned.m16n8k16.row.col.f32.{t}.{t}.f32" in tile
    assert "ldmatrix" in tile and "cp.async" in tile and "fmaf(" in tile
    for name in ("gemm", "pointwise_conv", "libdnn_conv"):
        src = (CSRC / f"{name}.cu").read_text()
        assert '#include "gemm_tile.cuh"' in src
        assert "launch_tile(" in src
        assert "mma.sync.aligned" not in src  # one main loop: the header's
    for path in CSRC.iterdir():
        assert ".tf32" not in path.read_text(), path.name


def test_conv_entry_points_take_tile_split_and_workspace():
    # dtype; x, w, scale, bias, out; B, H, W, C, K, stride, act, tile,
    # split; workspace, stream
    sig = _build.SIGNATURES["pointwise_conv_launch"]
    assert len(sig) == 17 and sig[-2:] == [_build._P, _build._P]
    # dtype; x, w, scale, bias, out; B, Hp, Wp, C, R, S, K, H, W, act,
    # tile, split; workspace, stream
    sig = _build.SIGNATURES["libdnn_conv_launch"]
    assert len(sig) == 20 and sig[-2:] == [_build._P, _build._P]
    for name in ("pointwise_conv", "libdnn_conv"):
        src = (CSRC / f"{name}.cu").read_text()
        assert "int tile, int split, void* ws" in src


def test_workspace_only_where_the_contraction_is_split():
    assert gemm.workspace(1, 4, 49, 160, "cpu") is None
    ws = gemm.workspace(8, 4, 49, 160, "cpu")
    assert ws.shape == (8, 4, 49, 160) and ws.dtype == torch.float32
