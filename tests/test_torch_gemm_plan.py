"""``gemm.plan``, the launch plan of the port's split-K ``gemm``, on the
CPU: it never sees the number of images, it gives one image's grid at
least 128 CTAs at each of ResNet-18's seven product classes, its splits
cover the contraction exactly once, and summing per-split fp32 partials
in split order stays within tolerance("float32") of the JAX package's
``ref.gemm`` at the four full-width im2col products.

The kernel itself runs only on the card; chip_smoke.py holds it against
its plain version there at these classes in fp32, bf16 and fp16.
"""
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import gemm

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# ResNet-18 at 224²: im2col's products (M, Kc, N), batch_b 1, and
# Winograd's 16 products of one image, batch_b 16
IM2COL = [(3136, 576, 64), (784, 1152, 128), (196, 2304, 256),
          (49, 4608, 512)]
WINOGRAD = [(784, 64, 64), (196, 128, 128), (49, 256, 256)]
CLASSES = [(*mkn, 1) for mkn in IM2COL] + [(*mkn, 16) for mkn in WINOGRAD]


def _ctas(M, N, batch_b, tile, split):
    return -(-M // tile) * -(-N // tile) * batch_b * split


def test_plan_has_no_argument_for_the_number_of_images():
    params = list(inspect.signature(gemm.plan).parameters)
    assert params == ["M", "N", "Kc", "batch_b", "a_dtype", "b_dtype"]


@pytest.mark.parametrize("b_fp32", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,Kc,N,batch_b", CLASSES)
def test_one_image_gets_at_least_128_ctas(M, Kc, N, batch_b, dtype, b_fp32):
    b_dtype = torch.float32 if b_fp32 else dtype
    tile, split = gemm.plan(M, N, Kc, batch_b, dtype, b_dtype)
    assert tile == gemm.TILE
    assert split in (1, 2, 4, 8, 16)
    assert _ctas(M, N, batch_b, tile, split) >= 128
    chunk = gemm.CHUNK[gemm.path(dtype, b_dtype)]
    assert split == 1 or split * gemm.MIN_SPLIT_CHUNKS <= -(-Kc // chunk)


def test_plan_matches_the_sizing_of_the_deep_classes():
    """49×4608 @ 4608×512: 8 tiles × 16 splits in either path; Winograd's
    49×256 @ 256×256: 4 tiles × 16 products × 2 splits on the tensor
    cores, × 4 on the fp32 path (2-warp CTAs, 4 chunks a split); a
    contraction of 4 chunks is not split."""
    f32, bf = torch.float32, torch.bfloat16
    for dt in (f32, bf):
        assert gemm.plan(49, 512, 4608, 1, dt, dt) == (64, 16)
        assert gemm.plan(784, 64, 64, 16, dt, dt) == (64, 1)
    assert gemm.plan(49, 256, 256, 16, bf, bf) == (64, 2)
    assert gemm.plan(49, 256, 256, 16, f32, f32) == (64, 4)
    assert gemm.plan(49, 256, 256, 16, bf, f32) == (64, 4)


def test_path_takes_the_tensor_cores_only_for_one_16_bit_dtype():
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    assert gemm.path(bf, bf) == gemm.path(f16, f16) == "tensor"
    assert gemm.path(f32, f32) == gemm.path(bf, f32) == "fp32"
    assert gemm.path(f16, f32) == "fp32"


# (Kc, chunk, split) with split at most the number of chunks, as plan has it
SPLITS = [(kc, chunk, split) for kc in (1, 15, 16, 17, 576, 2305, 4608)
          for chunk in (16, 32) for split in (1, 2, 4, 8, 16)
          if split <= -(-kc // chunk)]


@pytest.mark.parametrize("Kc,chunk,split", SPLITS)
def test_splits_cover_the_contraction_exactly_once(Kc, chunk, split):
    bounds = gemm.split_bounds(Kc, chunk, split)
    covered = np.zeros(Kc, dtype=int)
    for k0, k1 in bounds:
        assert k0 < k1 and k0 % chunk == 0
        covered[k0:k1] += 1
    assert (covered == 1).all()
    assert [k0 for k0, _ in bounds] == sorted(k0 for k0, _ in bounds)
    lengths = [-(-(k1 - k0) // chunk) for k0, k1 in bounds]
    assert max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize("M,Kc,N", IM2COL)
def test_split_k_order_matches_reference(M, Kc, N):
    """Per-split fp32 partial products, summed in split order, as the
    kernel and its reduction compute them."""
    rng = np.random.default_rng(M)
    a = rng.standard_normal((M, Kc)).astype(np.float32)
    b = (rng.standard_normal((Kc, N)) * Kc ** -0.5).astype(np.float32)
    tile, split = gemm.plan(M, N, Kc, 1, torch.float32, torch.float32)
    assert split > 1
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    parts = [at[:, k0:k1] @ bt[k0:k1]
             for k0, k1 in gemm.split_bounds(Kc, gemm.CHUNK["fp32"], split)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    ref = np.asarray(jref.gemm(jnp.asarray(a), jnp.asarray(b)), np.float32)
    assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() \
        <= tolerance("float32")


def test_kernel_source_uses_tensor_cores_for_16_bit_and_no_tf32():
    """gemm.cu and the split-K tile it includes (gemm_tile.cuh, shared
    with pointwise_conv and libdnn_conv)."""
    src = (CSRC / "gemm.cu").read_text()
    assert '#include "gemm_tile.cuh"' in src
    src += (CSRC / "gemm_tile.cuh").read_text()
    for t in ("bf16", "f16"):
        assert f"mma.sync.aligned.m16n8k16.row.col.f32.{t}.{t}.f32" in src
    assert "ldmatrix" in src and "cp.async" in src
    assert ".tf32" not in src  # IEEE fp32 on the CUDA cores
    assert "fmaf(" in src
