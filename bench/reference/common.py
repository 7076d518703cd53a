"""Plain PyTorch pieces the reference networks share: SAME padding, a
convolution followed by inference BatchNorm, and the TF32 rounding that
the correctness control uses.

Everything here is NCHW with OIHW filters, computed in float32. Nothing
here imports the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size, k, stride):
    """(low, high) SAME padding of one spatial dim: the total pad
    ``(ceil(size / stride) - 1) * stride + k - size`` split with the
    smaller half low."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x, r, s, stride, value=0.0):
    """SAME padding of an NCHW tensor for an r x s window at ``stride``."""
    top, bottom = same_pads(x.shape[2], r, stride)
    left, right = same_pads(x.shape[3], s, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def round_tf32(t):
    """``t`` (float32) rounded to TF32's 10 stored mantissa bits, to
    nearest with ties to even: what a TF32 tensor core reads of an fp32
    operand."""
    u = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def operand(t, precision):
    """An fp32 operand of a product as ``precision`` reads it."""
    if precision == "float32":
        return t
    if precision == "tf32":
        return round_tf32(t)
    raise ValueError(f"unknown precision {precision!r}")


def conv_bn(x, site, stride, eps, precision, groups=1):
    """SAME conv of ``x`` (NCHW) by ``site["w"]`` (HWIO, as drawn), then
    BatchNorm with the site's running statistics, unfolded."""
    w = site["w"].permute(3, 2, 0, 1)
    xp = pad_same(x, w.shape[2], w.shape[3], stride)
    y = F.conv2d(operand(xp, precision), operand(w.contiguous(), precision),
                 stride=stride, groups=groups)
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(site["var"] + eps)
    return (y - site["mean"].view(shape)) * (inv * site["gamma"]).view(shape) \
        + site["beta"].view(shape)


def linear(x, fc, precision):
    """The classifier head: x (B, C) @ w (C, classes) + b."""
    return operand(x, precision) @ operand(fc["w"], precision) + fc["b"]


def conv_site(name, r, s, cin, cout, stride, h, groups=1):
    """One conv site's geometry (square images): input h x h, output
    ceil(h / stride) squared."""
    ho = -(-h // stride)
    return {"name": name, "r": r, "s": s, "cin": cin, "cout": cout,
            "stride": stride, "groups": groups, "h": h, "w": h,
            "ho": ho, "wo": ho}
