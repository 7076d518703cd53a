"""The learning-rate schedule and the global-norm clip
(``repro/optim/schedule.py``).

The reference computes these in fp32: under jit its Python constants are
weakly typed, so each becomes an fp32 value before it meets an array.
Here each constant is an fp32 0-d tensor on the operand's device
(``const``), so every operation rounds as the reference's does; Python
floats would take fp64 into the arithmetic.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.spec import flatten, tree_map


def const(value, like) -> torch.Tensor:
    """``value`` as an fp32 0-d tensor on ``like``'s device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps, floor=0.1):
    """The learning rate at ``step`` (a 0-d integer tensor): linear warmup
    to ``peak_lr`` over ``warmup_steps``, then a cosine to ``floor`` of it
    at ``total_steps``; an fp32 0-d tensor."""
    t = step.float()
    warm = t / const(max(warmup_steps, 1), t)
    prog = ((t - const(warmup_steps, t))
            / const(max(total_steps - warmup_steps, 1), t)).clamp(0.0, 1.0)
    cos = const(floor, t) + const((1 - floor) * 0.5, t) * (
        const(1.0, t) + torch.cos(const(math.pi, t) * prog))
    return const(peak_lr, t) * torch.where(t < warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """The fp32 L2 norm over every leaf, summed leaf by leaf in the
    trees' sorted-key order."""
    leaves = list(flatten(tree).values())
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        total = total + (leaf.float() ** 2).sum()
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm):
    """(``tree`` scaled so that its global norm is at most ``max_norm``,
    the norm before): each leaf scaled in fp32 and cast back to its own
    dtype."""
    norm = global_norm(tree)
    scale = torch.minimum(const(1.0, norm),
                          const(max_norm, norm)
                          / torch.maximum(norm, const(1e-9, norm)))
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm
