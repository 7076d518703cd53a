"""Depthwise causal 1-D conv (the Mamba-2 conv stem) as a CUDA kernel for
Hopper.

Replaces the Pallas kernel ``causal_conv1d`` in ``src/repro/kernels/
causal_conv1d.py``; the source is ``csrc/causal_conv1d.cu``.

What bounds it on the H100: K multiply-adds per output against one input
read and one output write, so the bytes bound it at every length. The TPU
kernel stages a sequence tile and the previous tile in VMEM for its K - 1
halo (and breaks on tiles shorter than K - 1); here a thread owns two
neighbouring channels (one where the layout is not aligned for pairs),
keeps the K weights in registers and walks 16 time steps with its K - 1
halo loaded in the same register window, lanes along C so every access
coalesces, on a (channel groups, L tiles, batch) grid. Any length works,
and ``x`` may be a view whose rows are strided, such as the xBC slice of
the in-projection, which is read in place. Each output is the plain
version's chain of separately rounded fp32 multiplies and adds, then the
bias and one cast, so the two agree bitwise.

``causal_conv1d`` runs the kernel for a CUDA tensor and the plain version
(``ref.causal_conv1d``) for a CPU tensor; ``causal_conv1d.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.causal_conv1d

MAX_TAPS = 8


def _pairs_aligned(x, w, b, out) -> bool:
    """Whether two neighbouring channels can move as one aligned load."""
    C = x.shape[2]
    pair = 2 * x.element_size()
    ptrs = [x.data_ptr(), w.data_ptr(), out.data_ptr()]
    if b is not None:
        ptrs.append(b.data_ptr())
    return (C % 2 == 0 and x.stride(0) % 2 == 0 and x.stride(1) % 2 == 0
            and all(p % pair == 0 for p in ptrs))


def causal_conv1d(x, w, b=None):
    """x: (B, L, C) with unit channel stride (rows may be strided); w:
    (K, C); b: (C,) or None -> (B, L, C) contiguous, in ``x.dtype``."""
    if x.device.type == "cpu":
        return plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv1d: no kernel for {x.device}")
    name = "causal_conv1d"
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be (B, L, C) and "
                         f"w {tuple(w.shape)} (K, C)")
    B, L, C = x.shape
    K = w.shape[0]
    if w.shape[1] != C or not 1 <= K <= MAX_TAPS or min(B, L, C) < 1:
        raise ValueError(f"{name}: bad geometry x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} (1 <= K <= {MAX_TAPS})")
    if x.stride(2) != 1 and C > 1:
        raise ValueError(f"{name}: x needs unit channel stride, has strides "
                         f"{x.stride()}")
    dev, dt = x.device, x.dtype
    code = _build.kernel_dtype(name, x)
    _build.check_operand(name, "w", w, dev, dt)
    if b is not None:
        _build.check_operand(name, "b", b, dev, dt, (C,))
    out = torch.empty((B, L, C), dtype=dt, device=dev)
    vec = 2 if _pairs_aligned(x, w, b, out) else 1
    err = _build.library().causal_conv1d_launch(
        code, x.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), B, L, C, K,
        x.stride(0), x.stride(1), vec, _build.stream(dev))
    _build.check(err, name)
    causal_conv1d.launches += 1
    return out


causal_conv1d.launches = 0
