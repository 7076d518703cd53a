"""Pieces of the comparisons that decide ``correct``: PyTorch's TF32
switches, and the gap of an answer vector to the reference's.

A configuration's reference module judges the window's answers
(``judge``); the runner adds the answers that raised or never came, and
``correct`` needs every number compared within its limit.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_products(allow_tf32=False):
    """TF32 off (or on) in both of PyTorch's switches, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rel_errors(answers, expected):
    """Per answer (index, vector) max |y - r| / max |r| against row
    ``index`` of ``expected`` (inf where y is not finite)."""
    if not answers:
        return torch.zeros(0)
    idx = torch.tensor([k for k, _ in answers])
    got = torch.stack([y.float() for _, y in answers])
    want = expected[idx]
    err = (got - want).abs().amax(dim=1) / want.abs().amax(dim=1)
    return torch.where(torch.isfinite(got).all(dim=1), err,
                       torch.full_like(err, float("inf")))
