"""Error-feedback int8 gradient compression (``repro/optim/
compression.py``): a gradient plus the residual the last step left is
quantized to int8 with one fp32 scale, and what the codes miss is the
next residual (Karimireddy et al., arXiv:1901.09847).

The reference applies it inside an all-reduce over its pod axis
(``compressed_psum_pod``, a ``shard_map`` collective); the port runs on
one card and has no pod axis, so the collective is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.models.spec import tree_map
from repro_torch.quant import dequantize, quantize


def ef_compress(g, err):
    """-> (int8 codes, fp32 scale, the new fp32 residual)."""
    corrected = g.float() + err
    codes, scale = quantize(corrected)
    return codes, scale, corrected - dequantize(codes, scale)


def init_error_state(params):
    """A zero fp32 residual for every leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
