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

The gradient. A launch on raw pointers records nothing for autograd, so
where grad is enabled and ``x``, ``w`` or ``b`` requires it the wrapper
runs ``CausalConv1d``, a ``torch.autograd.Function`` whose backward
reuses the forward kernel: with ``y[t] = b + sum_j w[j] x[t - (K-1) + j]``,

    dx = flip_L(causal_conv1d(flip_L(dy), w))

(the same taps, no bias), one more launch; ``dw[j] = sum over (B, t) of
dy[t] x[t - (K-1) + j]`` and ``db = sum dy`` are plain reductions in
fp32, cast to the operands' dtypes, as the reference leaves its backward
to XLA. The Function saves ``x`` as given, the strided view included.
Under rematerialization the forward runs twice, so a Mamba layer's
train step launches the kernel three times. On the CPU the plain version
stands in for the kernel inside the Function; the wrapper itself runs
the plain version there, which autograd differentiates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    (K, C); b: (C,) or None -> (B, L, C) contiguous, in ``x.dtype``;
    differentiable (``CausalConv1d`` on the card)."""
    if x.device.type == "cpu":
        return plain(x, w, b)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return CausalConv1d.apply(x, w, b)
    return _launch(x, w, b)


def _conv(x, w, b=None):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    return plain(x, w, b) if x.device.type == "cpu" else _launch(x, w, b)


class CausalConv1d(torch.autograd.Function):
    """``causal_conv1d`` with its gradient (see the module's docstring)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = None if b is None else b.dtype
        return _conv(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx = torch.flip(_conv(torch.flip(dy, dims=(1,)).contiguous(), w),
                            dims=(1,))
        if need_w:
            K, L = w.shape[0], x.shape[1]
            dy32 = dy.float()
            dw = torch.stack([
                (dy32 * F.pad(x, (0, 0, K - 1 - j, 0))[:, :L].float())
                .sum(dim=(0, 1)) for j in range(K)]).to(w.dtype)
        if need_b and ctx.b_dtype is not None:
            db = dy.float().sum(dim=(0, 1)).to(ctx.b_dtype)
        return dx, dw, db


def _launch(x, w, b):
    name = "causal_conv1d"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
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
