"""Plain PyTorch MobileNetV2 (Sandler et al. 2018, Table 2, 1.0x), the
reference the benchmark holds the program's logits to.

A 3x3/2 stem conv, BN, ReLU6; then the (t, c, n, s) rows of inverted
residual blocks: a 1x1 expansion to t x cin with BN and ReLU6 (none where
t = 1), a 3x3 depthwise conv at the block's stride with BN and ReLU6, a
linear 1x1 projection with BN, and the identity added where the block
keeps stride 1 and width; then a 1x1 conv to the head width with BN and
ReLU6, global average pooling and the classifier. Departure from the
paper, as the program defines the network: SAME padding split low first
(at stride 2 on an even size the 3x3 windows pad 0 above and 1 below).

``sites(cfg)`` lists every conv site with its geometry; ``forward`` takes
the benchmark's drawn weights and (B, H, W, C) images and runs in fp32
(``precision="tf32"`` rounds every product's operands to TF32 first).
"""
from __future__ import annotations

import torch

from bench.harness import counts
from bench.reference import cnn
from bench.reference.common import conv_bn, conv_site, linear


def relu6(x):
    return x.clamp(0.0, 6.0)


def _blocks(cfg):
    """(name, cin, mid, cout, stride) per inverted residual block."""
    cin = cfg["stem_width"]
    for si, (t, c, n, s) in enumerate(cfg["settings"]):
        for bi in range(n):
            yield f"s{si}b{bi}", cin, cin * t, c, s if bi == 0 else 1
            cin = c


def sites(cfg):
    """Every conv site, forward order, with its geometry."""
    img = cfg["image_size"]
    out = [conv_site("stem", 3, 3, cfg["in_channels"], cfg["stem_width"],
                     cfg["stem_stride"], img)]
    size = -(-img // cfg["stem_stride"])
    cout = cfg["stem_width"]
    for name, cin, mid, cout, stride in _blocks(cfg):
        if mid != cin:
            out.append(conv_site(f"{name}.pw1", 1, 1, cin, mid, 1, size))
        out.append(conv_site(f"{name}.dw", 3, 3, mid, mid, stride, size,
                             groups=mid))
        size = -(-size // stride)
        out.append(conv_site(f"{name}.pw2", 1, 1, mid, cout, 1, size))
    out.append(conv_site("head", 1, 1, cout, cfg["head_width"], 1, size))
    return out


def head_width(cfg):
    return cfg["head_width"]


def forward(params, cfg, images, precision="float32"):
    """images (B, H, W, C) float32 -> logits (B, classes)."""
    eps = cfg["bn_eps"]
    x = images.permute(0, 3, 1, 2)
    x = relu6(conv_bn(x, params["stem"], cfg["stem_stride"], eps, precision))
    for name, cin, mid, cout, stride in _blocks(cfg):
        p = params[name]
        h = x
        if "pw1" in p:
            h = relu6(conv_bn(h, p["pw1"], 1, eps, precision))
        h = relu6(conv_bn(h, p["dw"], stride, eps, precision, groups=mid))
        h = conv_bn(h, p["pw2"], 1, eps, precision)
        x = h + x if stride == 1 and cin == cout else h
    x = relu6(conv_bn(x, params["head"], 1, eps, precision))
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
