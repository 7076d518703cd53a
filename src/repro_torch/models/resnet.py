"""ResNet, NHWC with inference-folded BatchNorm (``repro/models/resnet.py``).

Every convolution (the 7x7/2 stem, every 3x3, every 1x1) routes through
``repro_torch.core.algorithms`` with its folded-BN scale/bias and its
activation as the kernel's fused epilogue, so the whole backbone runs
under a TuningPlan. A ``<block>.block`` plan entry replaces a block's last
conv and its shortcut add + ReLU with one fused-block dispatch.

``ResNet`` is the family's ``models.module.SpecNetwork``, whose ``state_dict()``
keys are the JAX parameter paths (``stem.w``, ``s1b0.proj.scale``,
``fc.b``); ``forward`` is the same function on a nested dict of tensors.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import algorithms
from repro_torch.core.convspec import ConvSpec, FusedBlockSpec
from repro_torch.core.dtypes import torch_dtype
from repro_torch.kernels import ref
from repro_torch.models.module import SpecNetwork
from repro_torch.models.spec import ParamSpec

WIDTHS = (64, 128, 256, 512)


def _conv_spec(r, s, cin, cout):
    return {"w": ParamSpec((r, s, cin, cout), (None, None, None, None)),
            # folded BN: y = conv(x) * scale + bias
            "scale": ParamSpec((cout,), (None,), "ones"),
            "bias": ParamSpec((cout,), (None,), "zeros")}


def _block_specs(cin, cout, bottleneck, stride):
    if bottleneck:
        mid = cout // 4
        sp = {"c1": _conv_spec(1, 1, cin, mid),
              "c2": _conv_spec(3, 3, mid, mid),
              "c3": _conv_spec(1, 1, mid, cout)}
    else:
        sp = {"c1": _conv_spec(3, 3, cin, cout),
              "c2": _conv_spec(3, 3, cout, cout)}
    if stride != 1 or cin != cout:
        sp["proj"] = _conv_spec(1, 1, cin, cout)
    return sp


def _widths(cfg):
    return [w * 4 for w in WIDTHS] if cfg.extra["bottleneck"] \
        else list(WIDTHS)


def _stage_blocks(cfg):
    """(stage, block, stride) in forward order."""
    for si, n in enumerate(cfg.extra["blocks"]):
        for bi in range(n):
            yield si, bi, 2 if (si > 0 and bi == 0) else 1


def model_specs(cfg):
    bottleneck = cfg.extra["bottleneck"]
    widths = _widths(cfg)
    sp = {"stem": _conv_spec(7, 7, 3, 64)}
    cin = 64
    for si, bi, stride in _stage_blocks(cfg):
        sp[f"s{si}b{bi}"] = _block_specs(cin, widths[si], bottleneck, stride)
        cin = widths[si]
    sp["fc"] = {"w": ParamSpec((cin, cfg.vocab_size), (None, None)),
                "b": ParamSpec((cfg.vocab_size,), (None,), "zeros")}
    return sp


def conv_specs(cfg):
    """(name, ConvSpec) per conv site, keyed like the params, walking the
    exact geometry of ``forward``; every spec carries ``cfg.dtype``."""
    img = cfg.extra["img"]
    bottleneck = cfg.extra["bottleneck"]
    widths = _widths(cfg)
    specs = [("stem", ConvSpec(h=img, w=img, c=3, k=64, r=7, s=7,
                               stride=2))]
    size = img // 4  # stem stride 2, then 3x3/2 max-pool
    cin = 64
    for si, bi, stride in _stage_blocks(cfg):
        cout = widths[si]
        name = f"s{si}b{bi}"
        out = -(-size // stride)
        if stride != 1 or cin != cout:
            specs.append((f"{name}.proj", ConvSpec(
                h=size, w=size, c=cin, k=cout, r=1, s=1, stride=stride)))
        if bottleneck:
            mid = cout // 4
            specs.append((f"{name}.c1", ConvSpec(
                h=size, w=size, c=cin, k=mid, r=1, s=1)))
            specs.append((f"{name}.c2", ConvSpec(
                h=size, w=size, c=mid, k=mid, stride=stride)))
            specs.append((f"{name}.c3", ConvSpec(
                h=out, w=out, c=mid, k=cout, r=1, s=1)))
        else:
            specs.append((f"{name}.c1", ConvSpec(
                h=size, w=size, c=cin, k=cout, stride=stride)))
            specs.append((f"{name}.c2", ConvSpec(
                h=out, w=out, c=cout, k=cout)))
        size = out
        cin = cout
    return [(name, dataclasses.replace(sp, dtype=cfg.dtype))
            for name, sp in specs]


def block_specs(cfg):
    """(name, FusedBlockSpec) per residual block, keyed ``<block>.block``:
    the block's last conv (basic c2: 3x3, bottleneck c3: 1x1, stride 1)
    with the shortcut add and outer ReLU fused into its write."""
    bottleneck = cfg.extra["bottleneck"]
    widths = _widths(cfg)
    size = cfg.extra["img"] // 4
    specs = []
    for si, bi, stride in _stage_blocks(cfg):
        cout = widths[si]
        size = -(-size // stride)  # the final conv runs post-stride
        mid = cout // 4 if bottleneck else cout
        rs = 1 if bottleneck else 3
        specs.append((f"s{si}b{bi}.block", FusedBlockSpec(
            "residual_conv", h=size, w=size, cin=mid, mid=mid, cout=cout,
            r=rs, s=rs, residual=True, dtype=cfg.dtype)))
    return specs


def _conv(p, x, stride, algorithm, choice=None, act=None, impl="auto",
          u=None):
    return algorithms.conv2d(x, p["w"], stride=stride, algorithm=algorithm,
                             choice=choice, scale=p["scale"],
                             bias=p["bias"], act=act, impl=impl, u=u)


def _block(p, x, bottleneck, stride, algorithm, name, plan, impl, wu):
    """``wu`` maps site names to cached Winograd filter transforms."""
    idn = x
    if "proj" in p:
        idn = _conv(p["proj"], x, stride, algorithm,
                    choice=plan.get(f"{name}.proj"), impl=impl)
    bch = plan.get(f"{name}.block")
    if bottleneck:
        h = _conv(p["c1"], x, 1, algorithm, choice=plan.get(f"{name}.c1"),
                  act="relu", impl=impl)
        h = _conv(p["c2"], h, stride, algorithm,
                  choice=plan.get(f"{name}.c2"), act="relu", impl=impl,
                  u=wu.get(f"{name}.c2"))
        last, site = p["c3"], f"{name}.c3"
    else:
        h = _conv(p["c1"], x, stride, algorithm,
                  choice=plan.get(f"{name}.c1"), act="relu", impl=impl,
                  u=wu.get(f"{name}.c1"))
        last, site = p["c2"], f"{name}.c2"
    if bch is not None:
        return algorithms.block_residual_conv(h, last, bch, res=idn,
                                              impl=impl)
    h = _conv(last, h, 1, algorithm, choice=plan.get(site), impl=impl,
              u=wu.get(site))
    return torch.clamp_min(h + idn, 0)


def max_pool_same(x):
    """3x3/2 SAME max-pool of an NHWC tensor, -inf padding split low
    first (explicitly: ``F.max_pool2d(padding=1)`` pads symmetrically and
    shifts the windows by one pixel at even H)."""
    xp = ref.pad_same(x, 3, 3, stride=2, value=float("-inf"))
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), kernel_size=3, stride=2)
    return y.permute(0, 2, 3, 1).contiguous()


def forward(params, cfg, images, *, algorithm="ilpm", plan=None,
            impl="auto", winograd_u=None):
    """images: (B,H,W,3) NHWC -> logits (B, classes); an unbatched
    (H,W,3) image maps to (classes,). ``params`` is a nested dict of
    tensors; ``plan`` maps site names to ``Choice``s (``<block>.block``
    entries fuse a block), overriding ``algorithm`` where present;
    ``winograd_u`` maps site names to cached filter transforms
    U = G g Gᵀ (the engine computes them once per build)."""
    single = images.dim() == 3
    if single:
        images = images[None]
    images = images.to(torch_dtype(cfg.dtype)).contiguous()
    plan = plan or {}
    wu = winograd_u or {}
    bottleneck = cfg.extra["bottleneck"]
    x = _conv(params["stem"], images, 2, algorithm, choice=plan.get("stem"),
              act="relu", impl=impl, u=wu.get("stem"))
    x = max_pool_same(x)
    for si, bi, stride in _stage_blocks(cfg):
        name = f"s{si}b{bi}"
        x = _block(params[name], x, bottleneck, stride, algorithm, name,
                   plan, impl, wu)
    x = x.mean(dim=(1, 2))
    fc = params["fc"]  # promoted as jnp promotes a mixed-dtype product
    dt = torch.promote_types(x.dtype, fc["w"].dtype)
    logits = x.to(dt) @ fc["w"].to(dt) + fc["b"]
    return logits[0] if single else logits


class ResNet(SpecNetwork):
    model_specs = staticmethod(model_specs)
    forward_fn = staticmethod(forward)


Network = ResNet
