"""Tiled matrix product as a CUDA kernel for Hopper: im2col's second phase
and Winograd's 16 products.

Replaces the Pallas kernel ``gemm`` in ``src/repro/kernels/gemm.py``; the
source is ``csrc/gemm.cu``.

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
MIN_SPLIT_CHUNKS = 4  # a split walks at least this many chunks
MAX_SPLIT = 16
HALF = (torch.bfloat16, torch.float16)


def path(a_dtype, b_dtype) -> str:
    """``"tensor"`` (mma.sync) where a and b are the same 16-bit dtype,
    else ``"fp32"`` (CUDA-core fmaf, b read as fp32)."""
    return "tensor" if a_dtype in HALF and b_dtype == a_dtype else "fp32"


def plan(M, N, Kc, batch_b, a_dtype, b_dtype) -> tuple[int, int]:
    """(tile, split) of one product: the CTA tile's rows and columns and
    the number of contraction splits, the smallest power of two that
    gives one image's grid, M tiles x N tiles x batch_b x split, the
    path's ``MIN_CTAS``, at most ``MAX_SPLIT`` and leaving each split
    ``MIN_SPLIT_CHUNKS`` chunks. It never sees the number of images, so a
    batch of images sums in the same order as one."""
    kind = path(a_dtype, b_dtype)
    chunks = -(-Kc // CHUNK[kind])
    ctas = -(-M // TILE) * -(-N // TILE) * batch_b
    split = 1
    while ctas * split < MIN_CTAS[kind] and 2 * split <= MAX_SPLIT \
            and 2 * split * MIN_SPLIT_CHUNKS <= chunks:
        split *= 2
    return TILE, split


def split_bounds(Kc, chunk, split) -> list[tuple[int, int]]:
    """The contraction range [k0, k1) of each split, as the kernel walks
    it: split s takes chunks [s·chunks/split, (s+1)·chunks/split), so the
    splits differ by at most one chunk and only the last chunk of the
    contraction may be short."""
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
    ws = torch.empty((split, batch, M, N), dtype=torch.float32, device=dev) \
        if split > 1 else None
    err = _build.library().gemm_launch(
        code, int(b_fp32), a3.data_ptr(), b.data_ptr(), out.data_ptr(),
        batch, batch_b, M, N, Kc, tile, split,
        ws.data_ptr() if ws is not None else None, _build.stream(dev))
    _build.check(err, "gemm")
    gemm.launches += 1
    return out if a.dim() == 3 else out[0]


gemm.launches = 0
