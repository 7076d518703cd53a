"""MobileNetV2, NHWC with inference-folded BatchNorm
(``repro/models/mobilenet.py``).

Inverted-residual blocks (expand 1x1 -> depthwise 3x3 -> project 1x1)
built from ``repro_torch.core.algorithms.conv2d`` sites, so the whole
backbone runs under a TuningPlan as ``resnet.forward`` does: the strided
dense stem runs ilpm, every 1x1 site the pointwise kernel and every
depthwise site (stride 1 and 2) the depthwise kernel, each with its
ReLU6/BN epilogue in the kernel's output write. A ``<block>.block`` plan
entry runs the whole block, identity add included, as one
``fused_inverted_residual`` launch.

Config ``extra`` keys: ``settings``, MobileNetV2's (t, c, n, s) rows
(expansion, output channels, repeats, first-block stride); ``stem`` and
``head`` widths; ``img``, the input size; ``arch: "mobilenet"`` routes the
engine here. ``MobileNetV2`` is the family's ``models.module.SpecNetwork``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import algorithms
from repro_torch.core.convspec import ConvSpec, FusedBlockSpec
from repro_torch.core.dtypes import torch_dtype
from repro_torch.models import resnet
from repro_torch.models.module import SpecNetwork
from repro_torch.models.spec import ParamSpec


def _dw_spec(c):
    """Depthwise 3x3: HWIO filters (3, 3, 1, C) + folded BN."""
    return {"w": ParamSpec((3, 3, 1, c), (None, None, None, None)),
            "scale": ParamSpec((c,), (None,), "ones"),
            "bias": ParamSpec((c,), (None,), "zeros")}


def _blocks(cfg):
    """Yield (name, cin, mid, cout, stride) per inverted-residual block."""
    cin = cfg.extra["stem"]
    for si, (t, c, n, s) in enumerate(cfg.extra["settings"]):
        for bi in range(n):
            yield f"s{si}b{bi}", cin, cin * t, c, s if bi == 0 else 1
            cin = c


def model_specs(cfg):
    conv_spec = resnet._conv_spec
    sp = {"stem": conv_spec(3, 3, 3, cfg.extra["stem"])}
    for name, cin, mid, cout, _ in _blocks(cfg):
        block = {}
        if mid != cin:  # t == 1 blocks have no expansion conv
            block["pw1"] = conv_spec(1, 1, cin, mid)
        block["dw"] = _dw_spec(mid)
        block["pw2"] = conv_spec(1, 1, mid, cout)
        sp[name] = block
        last = cout
    sp["head"] = conv_spec(1, 1, last, cfg.extra["head"])
    sp["fc"] = {"w": ParamSpec((cfg.extra["head"], cfg.vocab_size),
                               (None, None)),
                "b": ParamSpec((cfg.vocab_size,), (None,), "zeros")}
    return sp


def conv_specs(cfg):
    """(name, ConvSpec) per conv site, keyed like the params, walking the
    exact geometry of ``forward``: the 3x3/2 stem, then per block pw1 at
    the incoming size, dw (carrying the block's stride) and pw2 at the
    downsampled size, then the 1x1 head; every spec carries ``cfg.dtype``."""
    img = cfg.extra["img"]
    specs = [("stem", ConvSpec(h=img, w=img, c=3, k=cfg.extra["stem"],
                               stride=2))]
    size = -(-img // 2)
    for name, cin, mid, cout, stride in _blocks(cfg):
        if mid != cin:
            specs.append((f"{name}.pw1", ConvSpec(h=size, w=size, c=cin,
                                                  k=mid, r=1, s=1)))
        specs.append((f"{name}.dw", ConvSpec(h=size, w=size, c=mid, k=mid,
                                             stride=stride, groups=mid)))
        size = -(-size // stride)
        specs.append((f"{name}.pw2", ConvSpec(h=size, w=size, c=mid, k=cout,
                                              r=1, s=1)))
        last = cout
    specs.append(("head", ConvSpec(h=size, w=size, c=last,
                                   k=cfg.extra["head"], r=1, s=1)))
    return [(name, dataclasses.replace(sp, dtype=cfg.dtype))
            for name, sp in specs]


def block_specs(cfg):
    """(name, FusedBlockSpec) per inverted-residual block, keyed
    ``<block>.block``, with ``residual`` set where the forward adds the
    identity (stride 1, cin == cout)."""
    size = -(-cfg.extra["img"] // 2)  # after the stride-2 stem
    specs = []
    for name, cin, mid, cout, stride in _blocks(cfg):
        specs.append((f"{name}.block", FusedBlockSpec(
            "inverted_residual", h=size, w=size, cin=cin, mid=mid,
            cout=cout, stride=stride,
            residual=(stride == 1 and cin == cout), dtype=cfg.dtype)))
        size = -(-size // stride)
    return specs


def forward(params, cfg, images, *, algorithm="auto", plan=None,
            impl="auto", winograd_u=None):
    """images: (B,H,W,3) NHWC -> logits (B, classes); an unbatched
    (H,W,3) image maps to (classes,). ``plan`` maps site names to
    ``Choice``s, overriding ``algorithm`` where present; a
    ``<block>.block`` entry runs the block as one fused dispatch.
    Activations are ReLU6 in each conv's epilogue; projections are
    linear, and a block with ``stride == 1 and cin == cout`` adds its
    input in the compute dtype. ``winograd_u`` maps site names to cached
    Winograd filter transforms; the stem is the only 3x3 dense site."""
    single = images.dim() == 3
    if single:
        images = images[None]
    images = images.to(torch_dtype(cfg.dtype)).contiguous()
    plan = plan or {}
    conv = resnet._conv
    wu = winograd_u or {}
    x = conv(params["stem"], images, 2, algorithm, choice=plan.get("stem"),
             act="relu6", impl=impl, u=wu.get("stem"))
    for name, cin, mid, cout, stride in _blocks(cfg):
        p = params[name]
        residual = stride == 1 and cin == cout
        bch = plan.get(f"{name}.block")
        if bch is not None:
            x = algorithms.block_inverted_residual(
                x, p, bch, stride=stride, residual=residual, impl=impl)
            continue
        h = x
        if "pw1" in p:
            h = conv(p["pw1"], h, 1, algorithm,
                     choice=plan.get(f"{name}.pw1"), act="relu6", impl=impl)
        h = conv(p["dw"], h, stride, algorithm,
                 choice=plan.get(f"{name}.dw"), act="relu6", impl=impl)
        h = conv(p["pw2"], h, 1, algorithm, choice=plan.get(f"{name}.pw2"),
                 impl=impl)
        x = h + x if residual else h
    x = conv(params["head"], x, 1, algorithm, choice=plan.get("head"),
             act="relu6", impl=impl)
    x = x.mean(dim=(1, 2))
    fc = params["fc"]  # promoted as jnp promotes a mixed-dtype product
    dt = torch.promote_types(x.dtype, fc["w"].dtype)
    logits = x.to(dt) @ fc["w"].to(dt) + fc["b"]
    return logits[0] if single else logits


class MobileNetV2(SpecNetwork):
    model_specs = staticmethod(model_specs)
    forward_fn = staticmethod(forward)


Network = MobileNetV2
