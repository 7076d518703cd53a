"""Fused ResNet block tail as a CUDA kernel for Hopper.

Replaces the Pallas kernel ``fused_residual_conv`` in ``src/repro/
kernels/fused_block.py``; the source is ``csrc/fused_residual_conv.cu``
over the halo'd-tile body in ``csrc/conv_tile.cuh``. The other Pallas
kernel of that file, ``fused_inverted_residual``, comes with the
MobileNetV2 slice.

What bounds it on the H100: a ResNet-18 block's second conv does 0.23
GFLOP per launch and must move 1-10 MB, so in fp32 (IEEE, on CUDA cores)
the arithmetic bounds it and in bf16 the bytes do. The tiling is
``ilpm_conv``'s: an 8x8-output halo'd tile staged in shared memory chunk
by chunk of C, reused over a 64-channel filter slab and every tap. The
shortcut add and the outer activation ride in the single output write,
so the conv output makes no separate round trip: the kernel converts
``acc*scale + bias`` to the compute dtype, adds ``res`` and applies the
activation, the op order of the unfused ``act(conv(x) + identity)``.

``fused_residual_conv`` runs the kernel for a CUDA tensor and the plain
version (``ref.fused_residual_conv``) for a CPU tensor;
``fused_residual_conv.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.fused_residual_conv


def fused_residual_conv(x_padded, weights, *, res, act="relu"):
    """x_padded: (B, H+R-1, W+S-1, C) pre-padded, stride 1; weights:
    ``w`` (R, S, C, K) and optional ``scale``/``bias`` (K,); res: the
    (B, H, W, K) shortcut -> (B, H, W, K)."""
    if x_padded.device.type == "cpu":
        return plain(x_padded, weights, res=res, act=act)
    if x_padded.device.type != "cuda":
        raise ValueError(f"fused_residual_conv: no kernel for "
                         f"{x_padded.device}")
    w = weights["w"]
    B, Hp, Wp, C = x_padded.shape
    R, S, Cw, K = w.shape
    H, W = Hp - R + 1, Wp - S + 1
    if Cw != C or H < 1 or W < 1:
        raise ValueError(f"fused_residual_conv: bad geometry x "
                         f"{tuple(x_padded.shape)} w {tuple(w.shape)}")
    dev, dt = x_padded.device, x_padded.dtype
    name = "fused_residual_conv"
    code = _build.kernel_dtype(name, x_padded)
    _build.check_operand(name, "x_padded", x_padded, dev, dt)
    _build.check_operand(name, "w", w, dev, dt)
    _build.check_operand(name, "res", res, dev, dt, (B, H, W, K))
    sc, bi = _build.epilogue_vectors(weights.get("scale"),
                                     weights.get("bias"), K, dev)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    err = _build.library().fused_residual_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), res.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S,
        K, _build.act_code(act), _build.stream(dev))
    _build.check(err, name)
    fused_residual_conv.launches += 1
    return out


fused_residual_conv.launches = 0
