"""Depthwise causal 1-D conv (the Mamba-2 conv stem) and its gradient as
CUDA kernels for Hopper.

Replaces the Pallas kernel ``causal_conv1d`` in ``src/repro/kernels/
causal_conv1d.py``; the source of both kernels is ``csrc/causal_conv1d.cu``.
The reference has no backward kernel (no ``custom_vjp``: JAX's autodiff
differentiates ``ref.causal_conv1d``); the port's backward is a kernel of
its own because the eager backward it replaces (about 25 operations a
call, dw tap by tap in fp32) moved many times the bytes one pass needs.

What bounds it on the H100: K multiply-adds per output against one input
read and one output write, so the bytes bound it at every length. The TPU
kernel stages a sequence tile and the previous tile in VMEM for its K - 1
halo (and breaks on tiles shorter than K - 1); here a thread owns ``vec``
neighbouring channels (4 where the operands are aligned for it: 16 bytes
in fp32, 8 in bf16 or fp16), keeps the K weights in registers and walks
``steps`` time steps, its K - 1 halo carried in a register window from
step to step and its rows streamed through a ring in shared memory by
cp.async, many in flight, lanes along C so every access coalesces.
``plan`` picks the vector width, the walk and the block. Any length works,
and ``x`` may be a view whose rows are strided, such as the xBC slice of
the in-projection, which is read in place. Each output is the plain
version's chain of separately rounded fp32 multiplies and adds, then the
bias and one cast, so the two agree bitwise.

The gradient. A launch on raw pointers records nothing for autograd, so
where grad is enabled and ``x``, ``w`` or ``b`` requires it the wrapper
runs ``CausalConv1d``, a ``torch.autograd.Function`` whose backward is one
``causal_conv1d_bwd`` call: with ``y[t] = b + sum_j w[j] x[t - (K-1) + j]``,

    dx[t] = sum_j w[j] dy[t + K - 1 - j],
    dw[j] = sum over (B, t) of dy[t] x[t - (K-1) + j],   db = sum dy,

in one pass over (channel groups, time tiles, batch), tiles as the
forward's but longer (``plan(..., backward=True)``): dx in tap order, then
one cast (bitwise the forward run on the reversed ``dy``, as the backward
computed it before it had a kernel); dw and db as fp32 chains over each
tile in time order, stored to an fp32 workspace (B, tiles, K + 1, C), then
summed over (b, tile) in index order by a second kernel of the same call,
and cast once. No atomics, so two runs are bitwise equal.
``ref.causal_conv1d_bwd`` computes the same sums in the same order. The
Function saves ``x`` as given, the strided view included. Under
rematerialization the forward runs twice, so a Mamba layer's train step
launches the forward twice and the backward once.

``causal_conv1d`` and ``causal_conv1d_bwd`` run the kernels for CUDA
tensors and the plain versions for CPU tensors (the Function on the CPU
runs ``ref.causal_conv1d_bwd`` with the tile ``plan`` would pick);
``causal_conv1d.launches`` counts forward launches and
``causal_conv1d_bwd.launches`` backward calls (two device kernels each).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

plain = ref.causal_conv1d
plain_bwd = ref.causal_conv1d_bwd

MAX_TAPS = 8
VEC_BYTES = 16          # the widest load a thread issues
MAX_VEC = 4             # channels a thread, at most
# walks tried, longest first: the forward's are short (a thread's rows are
# a serial chain of fp32 operations, so the grid wants many threads), the
# backward's long (each walk adds K + 1 partial rows to write and sum)
STEPS = (16, 8)
BWD_STEPS = (64, 32, 16, 8)
ASYNC_BYTES = 4         # the narrowest row a cp.async streams
MIN_WARPS = 512         # a walk shrinks until the grid has this many warps
THREADS = (128, 64, 32)  # block sizes tried, largest first
SMS = 132               # the H100 SXM's streaming multiprocessors
# a block size shrinks until the grid has this many blocks an SM: small
# blocks spread a narrow grid evenly (the backward at the train class:
# 32 threads 4-6% faster than 128)
BLOCKS_PER_SM = 8


class Plan(NamedTuple):
    vec: int      # channels a thread: one load of vec * element bytes
    steps: int    # time steps a thread walks (the backward's tile)
    threads: int  # threads a block
    blocks: int   # blocks of the grid


def plan(B, L, C, K, dtype, align=VEC_BYTES, backward=False) -> Plan:
    """The launch of the forward (or with ``backward`` the backward) of a
    (B, L, C) conv with K taps in ``dtype`` whose pointers and row and
    batch strides are aligned to ``align`` bytes (``align_bytes``): the
    widest vector of at most ``MAX_VEC`` channels that divides C and the
    alignment; the longest walk of ``STEPS`` (``BWD_STEPS``) whose grid
    has ``MIN_WARPS`` warps (the halo's K - 1 re-read rows then cost
    (K - 1) / (steps + K - 1) of the loads), the shortest where none has
    or where a row is narrower than a cp.async; the largest block of
    ``THREADS`` that leaves ``BLOCKS_PER_SM`` blocks an SM, the smallest
    where none does. ``gemm_sweep.py conv1d`` times every walk, block
    and the half vector beside this pick."""
    del K  # every tap count takes the same plan
    size = torch.empty((), dtype=dtype).element_size()
    vec = max(min(align // size, MAX_VEC), 1)
    while C % vec:
        vec //= 2
    groups = C // vec
    walks = BWD_STEPS if backward else STEPS
    # a row narrower than a cp.async is loaded synchronously: the
    # shortest walks, the most threads
    for steps in walks if vec * size >= ASYNC_BYTES else walks[-1:]:
        walkers = groups * -(-L // steps) * B
        if walkers >= MIN_WARPS * 32:
            break
    for threads in THREADS:
        if -(-walkers // threads) >= BLOCKS_PER_SM * SMS:
            break
    return Plan(vec, steps, threads, -(-walkers // threads))


def halo_share(p: Plan, L, K) -> float:
    """The share of a thread column's row loads that re-read another
    walk's rows: K - 1 halo rows for every walk after the first."""
    reread = (-(-L // p.steps) - 1) * (K - 1)
    return reread / (L + reread)


def align_bytes(*tensors) -> int:
    """The largest power of two up to ``VEC_BYTES`` that divides every
    pointer and every stride in bytes but the last (the channels') of
    ``tensors`` (None skipped)."""
    align = VEC_BYTES
    for t in tensors:
        if t is None:
            continue
        size = t.element_size()
        for v in (t.data_ptr(), *(s * size for s in t.stride()[:-1])):
            while v % align:
                align //= 2
    return align


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
        ctx.has_bias = b is not None
        return _conv(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        grads = causal_conv1d_bwd(dy, x, w, ctx.has_bias)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def _check(name, x, w):
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
    code = _build.kernel_dtype(name, x)
    _build.check_operand(name, "w", w, x.device, x.dtype)
    return code, B, L, C, K


def _launch(x, w, b):
    name = "causal_conv1d"
    code, B, L, C, K = _check(name, x, w)
    if b is not None:
        _build.check_operand(name, "b", b, x.device, x.dtype, (C,))
    out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    p = plan(B, L, C, K, x.dtype, align_bytes(x, w, b, out))
    err = _build.library().causal_conv1d_launch(
        code, x.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), B, L, C, K,
        x.stride(0), x.stride(1), p.vec, p.steps, p.threads,
        _build.stream(x.device))
    _build.check(err, name)
    causal_conv1d.launches += 1
    return out


def causal_conv1d_bwd(dy, x, w, has_bias):
    """The gradient of ``causal_conv1d`` at ``x`` (rows may be strided),
    ``w`` (K, C) and a bias or none: dy (B, L, C) -> (dx (B, L, C)
    contiguous in ``x.dtype``, dw (K, C) in ``w.dtype``, db (C,) in
    ``w.dtype`` or None). One pass and the ordered sum of its partials on
    a CUDA tensor (one launch in the counter); ``ref.causal_conv1d_bwd``
    at the plan's tile on a CPU one."""
    name = "causal_conv1d_bwd"
    if dy.device.type == "cpu":
        B, L, C = x.shape
        tile = plan(B, L, C, w.shape[0], x.dtype, align_bytes(dy, x, w),
                    backward=True).steps
        return plain_bwd(dy, x, w, has_bias, tile)
    code, B, L, C, K = _check(name, x, w)
    if (tuple(dy.shape) != (B, L, C) or dy.dtype != x.dtype
            or dy.device != x.device):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}, expected {(B, L, C)} {x.dtype} on "
                         f"{x.device}")
    # the kernel reads dy's rows at any stride but needs its channels
    # contiguous; autograd hands the gradient of the forward's contiguous
    # output, so this copies only a dy that arrives as another view
    if dy.stride(2) != 1 and C > 1:
        dy = dy.contiguous()
    dx = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    dw = torch.empty((K, C), dtype=w.dtype, device=x.device)
    db = torch.empty((C,), dtype=w.dtype, device=x.device) \
        if has_bias else None
    p = plan(B, L, C, K, x.dtype, align_bytes(dy, x, w, dx, dw, db),
             backward=True)
    part = torch.empty((B, -(-L // p.steps), K + 1, C), dtype=torch.float32,
                       device=x.device)
    err = _build.library().causal_conv1d_bwd_launch(
        code, dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), None if db is None else db.data_ptr(),
        part.data_ptr(), B, L, C, K, dy.stride(0), dy.stride(1),
        x.stride(0), x.stride(1), p.vec, p.steps, p.threads,
        _build.stream(x.device))
    _build.check(err, name)
    causal_conv1d_bwd.launches += 1
    return dx, dw, db


causal_conv1d.launches = 0
causal_conv1d_bwd.launches = 0
