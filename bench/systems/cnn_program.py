"""What the CNN systems share: the program's configuration of a
benchmark configuration, and the benchmark's weights in the form the
program's parameter tree takes. Not a system: no mix names it."""
from __future__ import annotations

import dataclasses

import torch

BN = ("gamma", "beta", "mean", "var")


def program_config(cfg):
    """The program's configuration named by ``cfg``, at ``cfg``'s image
    size, checked against ``cfg``: the file holds the configuration as it
    is run, so a program whose own sizes differ is refused."""
    from repro_torch.configs import get

    pcfg = get(cfg["program_config"])
    if pcfg.extra["img"] != cfg["image_size"]:  # the CPU tests' images
        pcfg = dataclasses.replace(
            pcfg, extra={**pcfg.extra, "img": cfg["image_size"]})
    extra = pcfg.extra
    want = {"classes": cfg["num_classes"], "dtype": cfg["dtype"]}
    have = {"classes": pcfg.vocab_size, "dtype": pcfg.dtype}
    if "blocks" in cfg:
        want["blocks"] = list(cfg["blocks"])
        have["blocks"] = list(extra["blocks"])
        want["bottleneck"], have["bottleneck"] = \
            cfg["bottleneck"], extra["bottleneck"]
    if "settings" in cfg:
        want["settings"] = [list(r) for r in cfg["settings"]]
        have["settings"] = [list(r) for r in extra["settings"]]
        want["stem"], have["stem"] = cfg["stem_width"], extra["stem"]
        want["head"], have["head"] = cfg["head_width"], extra["head"]
    if want != have:
        raise SystemExit(f"{cfg['name']}: the program's configuration "
                         f"{have} differs from the benchmark's {want}")
    return pcfg


def folded(weights, eps):
    """The program's parameter tree: each site's ``w`` as drawn, with
    BatchNorm folded into the ``scale`` and ``bias`` the kernels apply
    after the conv (scale = gamma / sqrt(var + eps), bias = beta - mean *
    scale); ``fc`` as drawn."""
    out = {}
    for key, node in weights.items():
        if set(BN) <= node.keys():
            scale = node["gamma"] * torch.rsqrt(node["var"] + eps)
            out[key] = {"w": node["w"], "scale": scale,
                        "bias": node["beta"] - node["mean"] * scale}
        elif key == "fc":
            out[key] = dict(node)
        else:
            out[key] = folded(node, eps)
    return out
