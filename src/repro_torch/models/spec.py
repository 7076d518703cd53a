"""Parameter specification trees (``repro/models/spec.py``).

A model declares a nested dict of ``ParamSpec`` leaves; ``init_params``
materialises it as a nested dict of tensors. Each leaf draws from its own
``torch.Generator``, seeded from ``seed`` and a CRC-32 of the leaf's dotted
path, so a seed gives the same weights in every process (Python's
``hash`` of a string changes from process to process). The numbers are
not JAX's: tests carry weights across with ``repro_torch.convert``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.dtypes import torch_dtype


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # stddev override; default fan-in scaled
    dtype: str | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def stack(spec: ParamSpec, n: int) -> ParamSpec:
    """Add a leading stacked-layer dim (one slice per layer of a segment)."""
    return ParamSpec((n, *spec.shape), ("layer", *spec.axes), spec.init,
                     spec.scale, spec.dtype)


def stack_tree(tree, n: int):
    """``stack`` on every leaf of a spec tree."""
    if isinstance(tree, dict):
        return {k: stack_tree(v, n) for k, v in tree.items()}
    return stack(tree, n)


def count(spec_tree) -> int:
    """Number of parameters in a spec tree."""
    return sum(int(np.prod(s.shape)) for _, s in walk(spec_tree))


def _fan_in(spec: ParamSpec) -> int:
    if len(spec.shape) == 0:
        return 1
    # convention: last axis is the output axis for 2D+ weights
    fan = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 \
        else spec.shape[0]
    return max(fan, 1)


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              default_dtype) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype)
    if spec.init == "embed":
        scale = 0.02
    else:
        scale = spec.scale if spec.scale is not None \
            else _fan_in(spec) ** -0.5
    z = torch.randn(spec.shape, generator=generator, dtype=torch.float32)
    return (z * scale).to(dtype)


def walk(tree, path=()):
    """Yield (path, leaf) in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    else:
        yield path, tree


def init_params(spec_tree, seed: int, param_dtype: str,
                device="cpu") -> dict:
    """Materialise a spec tree as a nested dict of tensors on ``device``.

    Leaves are drawn on the CPU, so a seed gives the same weights on every
    device."""
    out: dict = {}
    for path, spec in walk(spec_tree):
        if not isinstance(spec, ParamSpec):
            raise TypeError(f"bad spec node at {path}: {type(spec)}")
        gen = torch.Generator().manual_seed(
            (seed * 0x9E3779B1 + zlib.crc32(".".join(path).encode()))
            % 2 ** 63)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = init_leaf(spec, gen, param_dtype).to(device)
    return out


def flatten(tree) -> dict:
    """Nested dict -> {dotted path: leaf}, the ``state_dict`` layout."""
    return {".".join(path): leaf for path, leaf in walk(tree)}


def unflatten(flat) -> dict:
    """{dotted path: leaf} -> nested dict."""
    out: dict = {}
    for key, leaf in flat.items():
        *parents, last = key.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out

