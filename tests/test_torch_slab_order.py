"""One fp32 summation order for every 1x1 contraction of the port, on the
CPU: the fused and the per-layer MobileNetV2 give bitwise equal logits on
the card only if ``pointwise_conv`` sums like the expand and the project
of ``fused_inverted_residual``.

- **The contract.** In fp32 each 32-channel slab of a contraction
  (``gemm.SLAB``, the fused block's ``IR_SLAB``) is one fmaf chain from 0
  in channel order, the slabs are folded left to right, and the epilogue
  runs once. ``pointwise_conv.plan`` gives an fp32 conv one split a slab,
  and ``gemm.split_bounds`` cuts those splits at multiples of 32 channels,
  at every 1x1 class of MobileNetV2 and ResNet-18.
- **Nothing else moves.** bf16/fp16 pointwise plans and the plans of
  ``gemm`` and ``libdnn_conv``, which share the split-K tile, are pinned
  at their values before the slab order.
- **The model.** The slab-ordered sum is held against the JAX package's
  Pallas pointwise kernel in interpret mode within ``tolerance(dtype)``.
- **Sources.** The CUDA side reads one slab constant: ``gemm_tile.cuh``'s
  ``SLAB``, which the pointwise launch passes for fp32 and the inverted
  residual's mid slab and expand fold use.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pointwise_conv as jpointwise
from repro_torch.configs import get
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import fused_block, gemm, libdnn_conv, pointwise_conv
from repro_torch.kernels import ref as tref
from repro_torch.models import mobilenet, resnet

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"


def _pointwise_classes():
    """(H, C, K, stride) of every 1x1 site of full-width ResNet-18 and
    MobileNetV2, each class once."""
    return sorted({(s.h, s.c, s.k, s.stride)
                   for name, model in (("resnet18", resnet),
                                       ("mobilenet_v2", mobilenet))
                   for _, s in model.conv_specs(get(name))
                   if s.groups == 1 and s.r == 1})


POINTWISE = _pointwise_classes()

# (tile, split) of each class before the slab order, bf16 and fp16 alike
# (both on the tensor cores): they must not move
HALF_SPLITS = {
    (7, 160, 960, 1): 2, (7, 320, 1280, 1): 4, (7, 576, 160, 1): 8,
    (7, 960, 160, 1): 8, (7, 960, 320, 1): 8, (14, 64, 384, 1): 1,
    (14, 96, 576, 1): 1, (14, 192, 64, 1): 2, (14, 256, 512, 2): 4,
    (14, 384, 64, 1): 4, (14, 384, 96, 1): 4, (14, 576, 96, 1): 8,
    (28, 32, 192, 1): 1, (28, 128, 256, 2): 2, (28, 144, 32, 1): 2,
    (28, 192, 32, 1): 2, (56, 24, 144, 1): 1, (56, 64, 128, 2): 1,
    (56, 96, 24, 1): 1, (56, 144, 24, 1): 2, (112, 16, 96, 1): 1,
    (112, 32, 16, 1): 1}
# libdnn's four classes (H, C, K): split in fp32, bf16, fp16
LIBDNN_SPLITS = {(7, 512, 512): (16, 16, 16), (14, 256, 256): (16, 8, 8),
                 (28, 128, 128): (16, 8, 8), (56, 64, 64): (8, 4, 4)}
# gemm's classes (M, Kc, N, batch_b): split for a/b fp32/fp32, bf16/bf16,
# bf16/fp32, fp16/fp16
GEMM_SPLITS = {(3136, 576, 64, 1): (8, 4, 8, 4),
               (784, 1152, 128, 1): (16, 8, 16, 8),
               (196, 2304, 256, 1): (16, 8, 16, 8),
               (49, 4608, 512, 1): (16, 16, 16, 16),
               (784, 64, 64, 16): (1, 1, 1, 1),
               (196, 128, 128, 16): (2, 1, 2, 1),
               (49, 256, 256, 16): (4, 2, 4, 2)}
GEMM_PAIRS = ((torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32),
              (torch.float16, torch.float16))


def test_one_slab_constant():
    assert gemm.SLAB == fused_block.IR_SLAB == 32
    assert gemm.SLAB % gemm.CHUNK["fp32"] == 0


def test_the_classes_include_the_deep_and_ragged_contractions():
    assert set(HALF_SPLITS) == set(POINTWISE)
    cs = {c for _, c, _, _ in POINTWISE}
    assert {16, 24, 32, 144, 320, 960} <= cs


@pytest.mark.parametrize("H,C,K,stride", POINTWISE)
def test_fp32_pointwise_splits_at_its_slabs(H, C, K, stride):
    x = torch.empty(1, H, H, C)
    w = torch.empty(1, 1, C, K)
    tile, split = pointwise_conv.plan(x, w, stride)
    assert tile == gemm.TILE
    assert split == -(-C // gemm.SLAB)
    assert (split == 1) == (C <= gemm.SLAB)
    assert pointwise_conv.plan(torch.empty(4, H, H, C), w, stride) \
        == (tile, split)
    bounds = gemm.split_bounds(C, gemm.CHUNK["fp32"], split, gemm.SLAB)
    covered = np.zeros(C, dtype=int)
    for s, (k0, k1) in enumerate(bounds):
        assert k0 == s * gemm.SLAB and k1 == min(C, k0 + gemm.SLAB)
        covered[k0:k1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("C", [144, 320, 960, 36, 12])
def test_split_bounds_cut_at_multiples_of_32_channels(C):
    split = -(-C // gemm.SLAB)
    bounds = gemm.split_bounds(C, 16, split, gemm.SLAB)
    assert [k0 for k0, _ in bounds] == list(range(0, C, 32))
    assert bounds[-1][1] == C
    assert all(k1 - k0 == 32 for k0, k1 in bounds[:-1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H,C,K,stride", POINTWISE)
def test_16_bit_pointwise_plans_do_not_move(H, C, K, stride, dtype):
    x = torch.empty(1, H, H, C, dtype=dtype)
    w = torch.empty(1, 1, C, K, dtype=dtype)
    assert gemm.conv_path(x, w) == "tensor"
    assert pointwise_conv.plan(x, w, stride) == (gemm.TILE,
                                                 HALF_SPLITS[(H, C, K,
                                                              stride)])
    M = -(-H // stride) ** 2
    assert pointwise_conv.plan(x, w, stride) == gemm.conv_plan(
        M, K, C, dtype, "tensor")


def test_a_16_bit_pointwise_on_the_cuda_cores_keeps_gemms_plan():
    """A 16-bit shape the tensor cores cannot take plans as the "fp32"
    kind but is not fp32: the slab contract does not cover it."""
    for dt in (torch.bfloat16, torch.float16):
        x = torch.empty(1, 15, 17, 100, dtype=dt)
        w = torch.empty(1, 1, 100, 20, dtype=dt)
        assert gemm.conv_path(x, w) == "fp32"
        assert pointwise_conv.plan(x, w, 2) == gemm.plan(
            72, 20, 100, 1, dt, torch.float32)


@pytest.mark.parametrize("H,C,K", sorted(LIBDNN_SPLITS))
def test_libdnn_plans_do_not_move(H, C, K):
    for dt, split in zip((torch.float32, torch.bfloat16, torch.float16),
                         LIBDNN_SPLITS[(H, C, K)]):
        xp = tref.pad_same(torch.empty(1, H, H, C, dtype=dt), 3, 3)
        assert libdnn_conv.plan(xp, torch.empty(3, 3, C, K, dtype=dt)) \
            == (gemm.TILE, split)


@pytest.mark.parametrize("M,Kc,N,batch_b", sorted(GEMM_SPLITS))
def test_gemm_plans_do_not_move(M, Kc, N, batch_b):
    for (a, b), split in zip(GEMM_PAIRS, GEMM_SPLITS[(M, Kc, N, batch_b)]):
        assert gemm.plan(M, N, Kc, batch_b, a, b) == (gemm.TILE, split)
    # and the even split's bounds are the chunk ranges they were
    assert gemm.split_bounds(144, 16, 4) == [(0, 32), (32, 64), (64, 96),
                                             (96, 144)]


# ---- the slab-ordered sum against the Pallas kernel -------------------------

def slab_model(a, b, scale, bias, act):
    """The fp32 kernels' sum: each ``gemm.SLAB``-channel slab's partial
    product, the partials folded left to right, the epilogue once."""
    acc = None
    C = a.shape[-1]
    for k0, k1 in gemm.split_bounds(C, gemm.CHUNK["fp32"],
                                    -(-C // gemm.SLAB), gemm.SLAB):
        part = a[..., k0:k1].float() @ b[k0:k1].float()
        acc = part if acc is None else acc + part
    return tref.apply_act(acc * scale + bias, act)


@pytest.mark.parametrize("C,K,stride", [(144, 24, 1), (96, 40, 2),
                                        (36, 12, 1), (12, 20, 2)])
def test_slab_order_matches_pallas(C, K, stride):
    rng = np.random.default_rng(C + K)
    x = rng.standard_normal((2, 7, 9, C)).astype(np.float32)
    w = (rng.standard_normal((1, 1, C, K)) * C ** -0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, K).astype(np.float32)
    bias = (rng.standard_normal(K) * 0.1).astype(np.float32)
    ref = jpointwise.pointwise_conv(
        jnp.asarray(x), jnp.asarray(w), stride=stride,
        scale=jnp.asarray(scale), bias=jnp.asarray(bias), act="relu6",
        interpret=True)
    xt = torch.from_numpy(x)[:, ::stride, ::stride]
    y = slab_model(xt, torch.from_numpy(w)[0, 0], torch.from_numpy(scale),
                   torch.from_numpy(bias), "relu6")
    r = np.asarray(ref)
    assert y.shape == r.shape
    assert np.abs(y.numpy() - r).max() / np.abs(r).max() \
        <= tolerance("float32")


# ---- the CUDA sources ----------------------------------------------------

def _code(name):
    """A source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", (CSRC / name).read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_sources_read_one_slab_constant():
    tile = _code("gemm_tile.cuh")
    assert f"constexpr int SLAB = {gemm.SLAB};" in tile
    assert "split == (Kc + SLAB - 1) / SLAB" in tile
    assert "split_range(Kc, BK, split, s, &kb, &ke, per);" in tile
    assert "slabs ? SLAB / F32_CHUNK : 0" in tile
    ir = _code("fused_inverted_residual.cu")
    assert "constexpr int TM = SLAB;" in ir
    assert "c0 += SLAB" in ir
    assert "a[i][j] = c0 == 0 ? p[i][j] : a[i][j] + p[i][j];" in ir
    pw = _code("pointwise_conv.cu")
    assert "sizeof(T) == 4);" in pw and "launch_tile(" in pw
    for name in ("gemm.cu", "libdnn_conv.cu"):
        assert "SLAB" not in _code(name)
