"""int8 weights with the dequantization folded into the epilogue
(``repro/quant.py``).

Per-output-channel symmetric int8 weight quantization for the CNN
engines. For per-channel scales ``s_k``

    conv(x, codes_k · s_k) = conv(x, codes_k) · s_k

so the dequantization multiply is the fused ``y·scale + bias`` epilogue
every kernel already applies in its output write: the folded-BN ``scale``
absorbs ``s_k``. No new kernel and no extra pass, and the codes (integers
of at most 127) are exact in any float compute dtype. ``quantize`` is the
per-tensor form of the same rule (one scalar scale).

Rounding is half to even, as ``jnp.round``'s, so the codes equal the JAX
package's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.dtypes import torch_dtype


def quantize(x):
    """x -> (int8 codes, fp32 scale). Symmetric per-tensor."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    codes = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize(codes, scale):
    """Inverse of ``quantize`` (also per-channel: the scale broadcasts)."""
    return codes.float() * scale


def quantize_per_channel(w, axis: int = -1):
    """w -> (int8 codes, fp32 scales along ``axis``). Symmetric; for HWIO
    filters ``axis=-1`` is the output channel K, the granularity the
    epilogue's (K,) ``scale`` absorbs exactly."""
    w32 = w.float()
    axis %= w32.dim()
    reduce_dims = tuple(i for i in range(w32.dim()) if i != axis)
    scales = torch.clamp_min(w32.abs().amax(dim=reduce_dims), 1e-12) / 127.0
    shape = [1] * w32.dim()
    shape[axis] = -1
    codes = torch.clamp(torch.round(w32 / scales.reshape(shape)),
                        -127, 127).to(torch.int8)
    return codes, scales


@dataclass(frozen=True)
class QuantizedConv:
    """One conv site's int8 weights: codes (R,S,Cg,K) and per-channel
    scales (K,). ``storage_bytes`` is what ships: int8 codes and fp32
    scales."""

    codes: torch.Tensor  # int8
    scales: torch.Tensor  # fp32, (K,)

    @property
    def storage_bytes(self) -> int:
        return self.codes.numel() + 4 * self.scales.numel()


def _is_conv_site(node) -> bool:
    return (isinstance(node, dict) and {"w", "scale", "bias"} <= node.keys()
            and getattr(node["w"], "ndim", 0) == 4)


def quantize_params(params, *, compute_dtype=None):
    """Quantize every conv site of a nested-dict CNN param tree to int8
    weights with the per-channel scales folded into the epilogue.

    Returns ``(qparams, report)``: ``qparams`` is a tree the unchanged
    forward runs, each conv ``w`` replaced by its codes cast to
    ``compute_dtype`` (default ``w.dtype``; exact) and its ``scale`` by
    ``scale · s_k`` in fp32 (``bias`` untouched: the epilogue adds it after
    the scale); ``report`` maps each site's dotted name to its
    ``QuantizedConv``. Other leaves (the fc head) pass through."""
    report: dict[str, QuantizedConv] = {}

    def walk(node, path):
        if _is_conv_site(node):
            w = node["w"]
            dt = w.dtype if compute_dtype is None \
                else torch_dtype(compute_dtype)
            codes, scales = quantize_per_channel(w, axis=-1)
            report[".".join(path)] = QuantizedConv(codes, scales)
            out = dict(node)
            out["w"] = codes.to(dt)
            out["scale"] = node["scale"].float() * scales
            return out
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    with torch.no_grad():
        return walk(params, ()), report


def quantization_error(params, qreport) -> dict:
    """Max |w - dequant(w)| / max |w| per quantized site."""
    out = {}
    for name, q in qreport.items():
        node = params
        for part in name.split("."):
            node = node[part]
        w32 = node["w"].detach().float()
        err = (w32 - dequantize(q.codes, q.scales)).abs().max()
        out[name] = float(err / (w32.abs().max() + 1e-12))
    return out
