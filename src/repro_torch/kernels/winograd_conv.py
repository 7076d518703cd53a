"""Winograd F(2x2, 3x3) convolution, the paper's last baseline (§3.2,
Lavin & Gray): an input-transform kernel for Hopper, the ``gemm`` kernel
for the 16 products, then an output-transform kernel with the fused
epilogue.

Replaces the Pallas kernels ``winograd_input_transform`` and
``winograd_output_transform`` and their composition ``winograd_conv`` in
``src/repro/kernels/winograd_conv.py``; the sources are
``csrc/winograd_input_transform.cu`` and
``csrc/winograd_output_transform.cu``.

What bounds it on the H100: the transforms do adds and subtracts only, so
bytes bound them: V, written in the input dtype, is 4x the image, and M,
written in the same dtype, 4x the output. One thread owns one (image,
tile, channel) in registers, lanes along C, so every load and store
coalesces; the TPU kernels' whole-image VMEM block does not fit a block's
227 KB, and a tile block's halo staged in shared memory with 16-byte
channel vectors measured slower on the H100 (L1 serves the windows'
overlap). The input transform rounds each add or subtract to the input
dtype, as the Pallas kernel computes it, so the two agree bitwise in
every dtype. The 16 products contract over C alone, where the direct
algorithms walk 9·C, so their CTAs' serial loops are 9x shorter. The
filter transform U = G g Gᵀ is an einsum outside any kernel, as in the
reference; the engine caches it per plan site (weights are frozen at
inference), and without a cache it is computed per call, in fp32.

``winograd_input_transform`` and ``winograd_output_transform`` run their
kernels for a CUDA tensor and their plain versions (``ref.*``) for a CPU
tensor; each counts its kernel's launches in ``.launches``.
``winograd_conv`` launches the input transform, ``gemm`` and the output
transform once each.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gemm import gemm

plain_input_transform = ref.winograd_input_transform
plain_output_transform = ref.winograd_output_transform


def _even_dims(kernel, H, W):
    if H < 2 or W < 2 or H % 2 or W % 2:
        raise ValueError(f"{kernel}: winograd F(2,3) needs even output "
                         f"dims, got {H}x{W}")


def winograd_input_transform(x_padded, H, W):
    """x_padded: (B, H+2, W+2, C) -> V (B, 4, 4, (H/2)(W/2), C) in
    ``x_padded.dtype``, tiles row-major over (tile row, tile column)."""
    if x_padded.device.type == "cpu":
        return plain_input_transform(x_padded, H, W)
    if x_padded.device.type != "cuda":
        raise ValueError(f"winograd_input_transform: no kernel for "
                         f"{x_padded.device}")
    B, Hp, Wp, C = x_padded.shape
    _even_dims("winograd_input_transform", H, W)
    if (Hp, Wp) != (H + 2, W + 2) or B < 1 or C < 1:
        raise ValueError(f"winograd_input_transform: bad geometry x "
                         f"{tuple(x_padded.shape)} for {H}x{W}")
    dev, dt = x_padded.device, x_padded.dtype
    code = _build.kernel_dtype("winograd_input_transform", x_padded)
    _build.check_operand("winograd_input_transform", "x_padded", x_padded,
                         dev, dt)
    out = torch.empty((B, 4, 4, (H // 2) * (W // 2), C), dtype=dt,
                      device=dev)
    err = _build.library().winograd_input_transform_launch(
        code, x_padded.data_ptr(), out.data_ptr(), B, Hp, Wp, C,
        _build.stream(dev))
    _build.check(err, "winograd_input_transform")
    winograd_input_transform.launches += 1
    return out


winograd_input_transform.launches = 0


def winograd_output_transform(m, H, W, *, scale=None, bias=None, act=None):
    """m: (B, 4, 4, (H/2)(W/2), K) -> (B, H, W, K) in ``m.dtype``: Aᵀ m A
    per tile with ``act(y*scale + bias)`` fused into the write."""
    if m.device.type == "cpu":
        return plain_output_transform(m, H, W, scale=scale, bias=bias,
                                      act=act)
    if m.device.type != "cuda":
        raise ValueError(f"winograd_output_transform: no kernel for "
                         f"{m.device}")
    _even_dims("winograd_output_transform", H, W)
    if m.dim() != 5 or tuple(m.shape[1:4]) != (4, 4, (H // 2) * (W // 2)) \
            or 0 in m.shape:
        raise ValueError(f"winograd_output_transform: bad shape m "
                         f"{tuple(m.shape)} for {H}x{W}")
    B, K = m.shape[0], m.shape[-1]
    dev, dt = m.device, m.dtype
    code = _build.kernel_dtype("winograd_output_transform", m)
    _build.check_operand("winograd_output_transform", "m", m, dev, dt)
    sc, bi = _build.epilogue_vectors(scale, bias, K, dev)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    err = _build.library().winograd_output_transform_launch(
        code, m.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), B,
        H, W, K, _build.act_code(act), _build.stream(dev))
    _build.check(err, "winograd_output_transform")
    winograd_output_transform.launches += 1
    return out


winograd_output_transform.launches = 0


def winograd_conv(x_padded, w, *, u=None, scale=None, bias=None, act=None):
    """x_padded (B, H+2, W+2, C), w (3,3,C,K), even H and W -> (B,H,W,K).
    ``u`` is the cached filter transform (4,4,C,K), in ``w.dtype`` or
    fp32; without it U is computed here in fp32."""
    R, S, C, K = w.shape
    if (R, S) != (3, 3):
        raise ValueError(f"winograd F(2,3) is 3x3-only, got {R}x{S}")
    B, Hp, Wp, _ = x_padded.shape
    H, W = Hp - 2, Wp - 2
    _even_dims("winograd_conv", H, W)
    if u is None:
        u = ref.winograd_filter_transform(w)
    v = winograd_input_transform(x_padded, H, W)
    m = gemm(v.reshape(B * 16, -1, C), u.reshape(16, C, K).contiguous())
    return winograd_output_transform(m.reshape(B, 4, 4, -1, K), H, W,
                                     scale=scale, bias=bias, act=act)
