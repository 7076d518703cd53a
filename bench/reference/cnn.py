"""What the image classifiers' references share beyond their layers:
the weights and images drawn from the run's seed, and the judgement of
the program's logits. Each network's module binds these to its own conv
sites (``resnet.py``, ``mobilenet_v2.py``).

The weights are drawn on the run's device by one seeded generator in a
few large calls, and sliced into the network's leaves: per conv site an
HWIO filter ``w`` (He-normal, std sqrt(2 / fan-in)) and its BatchNorm
``gamma`` in [0.5, 1), ``beta`` and ``mean`` in [-0.1, 0.1) and ``var`` in
[0.5, 1.5); the classifier ``fc`` (``w`` of std sqrt(1 / fan-in), ``b`` in
[-0.05, 0.05)). The same tensors go to the reference, which applies
BatchNorm as it stands, and to the program's system, which folds it. The
images are a pool of float32 (H, W, C) arrays in host memory, standard
normal, as a camera or an upload hands them over.

The judgement: every answer, (pool index, logits in host memory), is held
to the reference's fp32 logits of the same image on the same weights,
run once the window has closed, in blocks of images, with TF32 off. The
number compared is ``logit_rel_err``: over all answers, the largest of
max |program - reference| / max |reference|, each answer's gap over its
own logits' scale; the configuration's ``limits`` hold its limit.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.harness.compare import fp32_products, rel_errors

BLOCK = 16  # images the reference runs at once


def _seed(seed):
    return int(seed) % 2 ** 63


def _nest(flat):
    """{"a.b": leaf} -> {"a": {"b": leaf}}."""
    out = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def draw(sites, head, classes, seed, device):
    """The network's weights as a nested dict of tensors on ``device``:
    ``{site: {w, gamma, beta, mean, var}, fc: {w, b}}``, for ``sites``
    as the network's ``sites(cfg)`` names them (``s0b0.c1`` nests as
    ``s0b0`` -> ``c1``) and a classifier of ``head`` x ``classes``."""
    shapes = [(s["r"], s["s"], s["cin"] // s["groups"], s["cout"])
              for s in sites]
    n_normal = sum(int(np.prod(sh)) for sh in shapes) + head * classes
    n_uniform = 4 * sum(s["cout"] for s in sites) + classes
    gen = torch.Generator(device=device).manual_seed(_seed(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    flat, i, j = {}, 0, 0
    for site, shape in zip(sites, shapes):
        n = int(np.prod(shape))
        fan_in = shape[0] * shape[1] * shape[2]
        flat[f"{site['name']}.w"] = \
            normal[i:i + n].view(shape) * (2.0 / fan_in) ** 0.5
        i += n
        k = site["cout"]
        u = uniform[j:j + 4 * k].view(4, k)
        j += 4 * k
        flat[f"{site['name']}.gamma"] = 0.5 + 0.5 * u[0]
        flat[f"{site['name']}.beta"] = 0.2 * (u[1] - 0.5)
        flat[f"{site['name']}.mean"] = 0.2 * (u[2] - 0.5)
        flat[f"{site['name']}.var"] = 0.5 + u[3]
    flat["fc.w"] = normal[i:i + head * classes].view(head, classes) \
        * (1.0 / head) ** 0.5
    flat["fc.b"] = 0.1 * (uniform[j:j + classes] - 0.5)
    return _nest(flat)


def images(cfg, count, seed):
    """``count`` float32 (H, W, C) images in host memory, from ``seed``."""
    size, c = cfg["image_size"], cfg["in_channels"]
    rng = np.random.default_rng(_seed(seed))
    return rng.standard_normal((count, size, size, c), dtype=np.float32)


def expected(logits, weights, cfg, pool, device):
    """(len(pool), classes) logits of the reference network ``logits``
    on the host, in fp32 with TF32 off."""
    out = []
    with fp32_products():
        for i in range(0, len(pool), BLOCK):
            x = torch.as_tensor(pool[i:i + BLOCK], device=device)
            out.append(logits(weights, cfg, x, "float32").cpu())
    return torch.cat(out)


def judge(logits, weights, cfg, pool, answers, device):
    """(answers over the limit, checks) of ``answers`` against the
    reference network ``logits``."""
    err = rel_errors(answers, expected(logits, weights, cfg, pool, device))
    limit = cfg["limits"]["logit_rel_err"]
    worst = err.max().item() if len(err) else float("inf")
    return int((err > limit).sum()), {
        "logit_rel_err": {"value": worst, "limit": limit}}
