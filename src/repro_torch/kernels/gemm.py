"""Tiled matrix product as a CUDA kernel for Hopper: im2col's second phase
and Winograd's 16 products.

Replaces the Pallas kernel ``gemm`` in ``src/repro/kernels/gemm.py``; the
source is ``csrc/gemm.cu``, an instantiation of the split-K tile of
``csrc/gemm_tile.cuh`` with a plain row-major ``a`` and no epilogue.
``pointwise_conv`` and ``libdnn_conv`` run on the same tile with their own
A rows (a pixel, a gathered patch) and the folded-BN epilogue; this module
plans all three (``plan``, ``conv_plan``).

What bounds it on the H100: ResNet-18's im2col products do 0.23 GFLOP and
must move 1-9 MB, so in fp32 (IEEE, on CUDA cores) the arithmetic bounds
them and in bf16 or fp16 (tensor cores) the bytes do; Winograd's 16
products of a layer do 0.10 GFLOP against 4-7 MB. At the deep layers a
CTA per 64 x 64 output tile gives only 8-26 CTAs, so ``plan`` splits the
contraction by the product's shape and dtypes (never by the number of
images), and split s's CTAs write fp32 partial tiles to a workspace that
a second kernel of the same launch sums in split order and casts once.
The fp32 path runs 64 threads a CTA, each with 8 x 8 fp32 accumulators,
fed by double-buffered ``cp.async`` copies; the 16-bit path (``b`` in
``a.dtype``) runs ``mma.sync`` on the tensor cores, 128 threads a CTA.
A batched ``b`` (batch_b, Kc, N) serves Winograd: batch element z reads
``b[z % batch_b]``, so one launch runs an image's 16 products, as the TPU
kernel's one ``pallas_call`` vmapped over them.

``gemm`` runs the kernel for a CUDA tensor and the plain version
(``ref.gemm``) for a CPU tensor; ``gemm.launches`` counts the wrapper's
launches (one launch is two device kernels when ``split > 1``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.gemm

TILE = 64  # rows and columns of c per CTA
CHUNK = {"fp32": 16, "tensor": 32}  # contraction depth of a chunk
# CTAs one image's grid should reach: the fp32 path's CTAs are 2 warps
# and want about 4 a SM, the tensor cores' 4 warps about 1 (132 SMs);
# measured with gemm_sweep.py
MIN_CTAS = {"fp32": 512, "tensor": 128}
# Chunks a split walks at least; while one image's grid has fewer CTAs
# than the card has SMs (the 1x1 convs: 64-960 deep on 3-80 tiles), fewer:
# one where the CUDA cores are slow to walk a chunk, two on the tensor
# cores, where the second kernel of a split launch costs more than a
# chunk; measured with gemm_sweep.py
MIN_SPLIT_CHUNKS = 4
MIN_SPLIT_CHUNKS_BELOW_SMS = {"fp32": 1, "tensor": 2}
SMS = 132
MAX_SPLIT = 16
HALF = (torch.bfloat16, torch.float16)
# The fp32 1x1 contractions' unit of summation (csrc/gemm_tile.cuh
# ``SLAB``): ``pointwise_conv`` and both products of
# ``fused_inverted_residual`` sum each 32-channel slab of their
# contraction as one chain from 0 and fold the slabs left to right, so the
# per-layer and the fused plans agree to the bit
SLAB = 32


def path(a_dtype, b_dtype) -> str:
    """``"tensor"`` (mma.sync) where a and b are the same 16-bit dtype,
    else ``"fp32"`` (CUDA-core fmaf, b read as fp32)."""
    return "tensor" if a_dtype in HALF and b_dtype == a_dtype else "fp32"


def plan(M, N, Kc, batch_b, a_dtype, b_dtype) -> tuple[int, int]:
    """(tile, split) of one product: the CTA tile's rows and columns and
    the number of contraction splits, the smallest power of two that
    gives one image's grid, M tiles x N tiles x batch_b x split, the
    path's ``MIN_CTAS``, at most ``MAX_SPLIT`` and leaving each split
    ``MIN_SPLIT_CHUNKS`` chunks, or ``MIN_SPLIT_CHUNKS_BELOW_SMS`` while
    the grid has fewer CTAs than the card has SMs. It never sees the
    number of images, so a batch of images sums in the same order as
    one."""
    kind = path(a_dtype, b_dtype)
    chunks = -(-Kc // CHUNK[kind])
    ctas = -(-M // TILE) * -(-N // TILE) * batch_b
    split = 1
    while ctas * split < MIN_CTAS[kind] and 2 * split <= MAX_SPLIT:
        floor = MIN_SPLIT_CHUNKS_BELOW_SMS[kind] if ctas * split < SMS \
            else MIN_SPLIT_CHUNKS
        if 2 * split * floor > chunks:
            break
        split *= 2
    return TILE, split


def conv_path(x, w) -> str:
    """The path of a conv on ``gemm``'s tile (``pointwise_conv``,
    ``libdnn_conv``), as their kernels decide it: ``"tensor"`` for a
    16-bit x whose C and K (``x``'s and ``w``'s last dims) are multiples of
    8, x and w 16-byte aligned; else ``"fp32"`` (the CUDA cores; a 16-bit
    w is converted to fp32 as it is read)."""
    tensor = x.dtype in HALF and x.shape[-1] % 8 == 0 \
        and w.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0 \
        and w.data_ptr() % 16 == 0
    return "tensor" if tensor else "fp32"


def conv_plan(M, K, Kc, dtype, kind) -> tuple[int, int]:
    """(tile, split) of one image's conv product (M, Kc) @ (Kc, K) on path
    ``kind``: ``plan`` with ``batch_b`` 1 and the dtypes that select that
    path (a 16-bit x on the CUDA cores plans as against an fp32 b). Like
    ``plan`` it never sees the number of images."""
    b_dtype = dtype if kind == "tensor" else torch.float32
    return plan(M, K, Kc, 1, dtype, b_dtype)


def workspace(split, batch, M, N, device):
    """The fp32 split-K workspace (split, batch, M, N), or None where the
    contraction is not split."""
    if split == 1:
        return None
    return torch.empty((split, batch, M, N), dtype=torch.float32,
                       device=device)


def split_bounds(Kc, chunk, split, slab=0) -> list[tuple[int, int]]:
    """The contraction range [k0, k1) of each split, as the kernel walks
    it: split s takes chunks [s·chunks/split, (s+1)·chunks/split), so the
    splits differ by at most one chunk and only the last chunk of the
    contraction may be short. With ``slab`` (channels, a multiple of
    ``chunk``; the fp32 1x1 convs pass ``SLAB``) split s takes channels
    [s·slab, (s+1)·slab) instead, and ``split`` is the number of slabs."""
    if slab:
        return [(s * slab, min(Kc, (s + 1) * slab)) for s in range(split)]
    chunks = -(-Kc // chunk)
    return [(s * chunks // split * chunk,
             min(Kc, (s + 1) * chunks // split * chunk))
            for s in range(split)]


def gemm(a, b):
    """a: (M, Kc) or (batch, M, Kc); b: (Kc, N), shared by the batch, or
    (batch_b, Kc, N) with batch element z reading ``b[z % batch_b]``; b in
    ``a.dtype`` or fp32 -> (M, N) or (batch, M, N) in ``a.dtype``."""
    if a.device.type == "cpu":
        return plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for {a.device}")
    batched_b = b.dim() == 3
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) \
            or a.shape[-1] != b.shape[-2] or 0 in a.shape or 0 in b.shape \
            or (batched_b and (a.dim() != 3 or a.shape[0] % b.shape[0])):
        raise ValueError(f"gemm: bad shapes a {tuple(a.shape)} "
                         f"b {tuple(b.shape)}")
    dev, dt = a.device, a.dtype
    code = _build.kernel_dtype("gemm", a)
    _build.check_operand("gemm", "a", a, dev, dt)
    b_fp32 = b.dtype == torch.float32
    _build.check_operand("gemm", "b", b, dev, torch.float32 if b_fp32 else dt)
    a3 = a if a.dim() == 3 else a[None]
    batch, M, Kc = a3.shape
    N = b.shape[-1]
    batch_b = b.shape[0] if batched_b else 1
    if path(dt, b.dtype) == "tensor" and (
            Kc % 8 or N % 8 or a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"gemm: the {dt} tensor-core path needs Kc and N "
                         f"multiples of 8 and 16-byte aligned operands, got "
                         f"Kc={Kc} N={N}")
    tile, split = plan(M, N, Kc, batch_b, dt, b.dtype)
    out = torch.empty((batch, M, N), dtype=dt, device=dev)
    ws = workspace(split, batch, M, N, dev)
    err = _build.library().gemm_launch(
        code, int(b_fp32), a3.data_ptr(), b.data_ptr(), out.data_ptr(),
        batch, batch_b, M, N, Kc, tile, split,
        ws.data_ptr() if ws is not None else None, _build.stream(dev))
    _build.check(err, "gemm")
    gemm.launches += 1
    return out if a.dim() == 3 else out[0]


gemm.launches = 0
