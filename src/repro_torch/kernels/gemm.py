"""Tiled matrix product as a CUDA kernel for Hopper: im2col's second phase
and Winograd's 16 products.

Replaces the Pallas kernel ``gemm`` in ``src/repro/kernels/gemm.py``; the
source is ``csrc/gemm.cu``.

What bounds it on the H100: at the paper's four layers an im2col product
does 0.23 GFLOP and must move 1-8 MB (the patch matrix dominates), so in
fp32 (IEEE, on CUDA cores) the arithmetic bounds it; Winograd's 16 products
of a layer do 0.10 GFLOP against 4-7 MB. A block owns a 64 x 64 output
tile and one batch element, walks the contraction 32 at a time with both
operand tiles staged in shared memory, and keeps a 4 x 4 register tile of
fp32 accumulators a thread. Where the TPU kernel zero-pads the contraction
to its tile with a copy, predicated loads fill the tail with 0. The store
casts once, to ``a.dtype``. A batched ``b`` (batch_b, Kc, N) serves
Winograd: batch element z reads ``b[z % batch_b]``, so one launch runs an
image's 16 products, as the TPU kernel's one ``pallas_call`` vmapped over
them does.

``gemm`` runs the kernel for a CUDA tensor and the plain version
(``ref.gemm``) for a CPU tensor; ``gemm.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.gemm


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
    out = torch.empty((batch, M, N), dtype=dt, device=dev)
    err = _build.library().gemm_launch(
        code, int(b_fp32), a3.data_ptr(), b.data_ptr(), out.data_ptr(),
        batch, b.shape[0] if batched_b else 1, M, N, Kc, _build.stream(dev))
    _build.check(err, "gemm")
    gemm.launches += 1
    return out if a.dim() == 3 else out[0]


gemm.launches = 0
