"""Plain PyTorch ResNet (He et al. 2016, Table 1), the reference the
benchmark holds the program's logits to.

Basic blocks for ``bottleneck: false``: 3x3 conv, BN, ReLU, 3x3 conv, BN,
then the shortcut (identity, or a 1x1 projection with BN where the block
strides or widens), the add and a ReLU. The stem is a 7x7/2 conv, BN and
ReLU, then a 3x3/2 max-pool. Departures from the paper's table, as the
program defines the network: SAME padding split low first (the stem pads
2 above and 3 below, where a symmetric pad of 3 would shift every window
by a pixel), and the pool pads with -inf the same way.

``sites(cfg)`` lists every conv site with its geometry; ``forward`` takes
the benchmark's drawn weights ({site: {w, gamma, beta, mean, var}}, ``fc``:
{w, b}) and (B, H, W, C) images, and runs in fp32 (``precision="tf32"``
rounds every product's operands to TF32 first: the correctness control).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.harness import counts
from bench.reference import cnn
from bench.reference.common import conv_bn, conv_site, linear, pad_same


def _blocks(cfg):
    """(name, cin, cout, stride) per basic block, in forward order."""
    cin = cfg["stem_width"]
    for si, (n, width) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        for bi in range(n):
            yield f"s{si}b{bi}", cin, width, 2 if si > 0 and bi == 0 else 1
            cin = width


def sites(cfg):
    """Every conv site, forward order, with its geometry."""
    if cfg["bottleneck"]:
        raise ValueError("the reference has basic blocks only")
    img, k = cfg["image_size"], cfg["stem_kernel"]
    out = [conv_site("stem", k, k, cfg["in_channels"], cfg["stem_width"],
                     cfg["stem_stride"], img)]
    size = -(-img // cfg["stem_stride"])
    size = -(-size // cfg["max_pool"]["stride"])
    for name, cin, cout, stride in _blocks(cfg):
        if stride != 1 or cin != cout:
            out.append(conv_site(f"{name}.proj", 1, 1, cin, cout, stride,
                                 size))
        out.append(conv_site(f"{name}.c1", 3, 3, cin, cout, stride, size))
        size = -(-size // stride)
        out.append(conv_site(f"{name}.c2", 3, 3, cout, cout, 1, size))
    return out


def head_width(cfg):
    return cfg["widths"][-1]


def forward(params, cfg, images, precision="float32"):
    """images (B, H, W, C) float32 -> logits (B, classes)."""
    eps = cfg["bn_eps"]
    x = images.permute(0, 3, 1, 2)
    x = F.relu(conv_bn(x, params["stem"], cfg["stem_stride"], eps,
                       precision))
    k, s = cfg["max_pool"]["kernel"], cfg["max_pool"]["stride"]
    x = F.max_pool2d(pad_same(x, k, k, s, value=float("-inf")), k, s)
    for name, cin, cout, stride in _blocks(cfg):
        p = params[name]
        h = F.relu(conv_bn(x, p["c1"], stride, eps, precision))
        h = conv_bn(h, p["c2"], 1, eps, precision)
        short = conv_bn(x, p["proj"], stride, eps, precision) \
            if "proj" in p else x
        x = F.relu(h + short)
    return linear(x.mean(dim=(2, 3)), params["fc"], precision)


@torch.no_grad()
def logits(params, cfg, images, precision="float32"):
    return forward(params, cfg, images, precision)


# what the harness asks of a configuration's reference module


def draw(cfg, seed, device):
    """The weights from ``seed``, on ``device`` (``cnn.draw``)."""
    return cnn.draw(sites(cfg), head_width(cfg), cfg["num_classes"], seed,
                    device)


def inputs(cfg, count, seed):
    """The pool of host images from ``seed`` (``cnn.images``)."""
    return cnn.images(cfg, count, seed)


def judge(weights, cfg, pool, answers, device):
    """(answers over the limit, checks) of the window's answers."""
    return cnn.judge(logits, weights, cfg, pool, answers, device)


def flops(cfg):
    """Operations of one image, from the published layer shapes."""
    return counts.image_flops(sites(cfg), head_width(cfg) * cfg["num_classes"])
