"""Parameter specification trees (``repro/models/spec.py``).

A model declares a nested dict of ``ParamSpec`` leaves; ``init_params``
materialises it as a nested dict of tensors. Each leaf draws from its own
``torch.Generator``, seeded from ``seed`` and a CRC-32 of the leaf's dotted
path, so a seed gives the same weights in every process (Python's
``hash`` of a string changes from process to process). The numbers are
not JAX's: tests carry weights across with ``repro_torch.convert``.
"""
from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.core.dtypes import torch_dtype
from repro_torch.sharding.rules import logical_sharding


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


# a leaf above this many elements is drawn in flat pieces of this size
# (a multiple of 16, see ``init_leaf``)
_PIECE = 1 << 24
# leaves drawn at once by ``init_params`` (each holds one piece on the
# host): a thread a core, the generator being serial
_DRAW_THREADS = min(max(os.cpu_count() or 4, 4), 16)


def _std(spec: ParamSpec) -> float:
    if spec.init == "embed":
        return 0.02
    return spec.scale if spec.scale is not None else _fan_in(spec) ** -0.5


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              default_dtype, device="cpu") -> torch.Tensor:
    """One leaf on ``device``: zeros, ones, or ``torch.randn(shape,
    generator=generator)`` times its scale, cast to its dtype.

    A large leaf is drawn in flat pieces of ``_PIECE`` elements, each
    scaled, cast and copied to the device, so the host holds one piece at
    a time. The pieces are its whole draw: the CPU generator fills a
    contiguous fp32 tensor of at least 16 elements with all its uniforms
    first, then maps them to normals 16 at a time, so consecutive draws
    whose sizes are multiples of 16 give the values of one draw
    (``tests/test_torch_hybrid_encdec.py`` holds them equal); a leaf
    whose size is not a multiple of 16 is drawn whole."""
    dtype = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    scale = _std(spec)
    n = int(np.prod(spec.shape))
    if n <= _PIECE or n % 16:
        z = torch.randn(spec.shape, generator=generator, dtype=torch.float32)
        return (z * scale).to(dtype).to(device)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    z = torch.empty(_PIECE, dtype=torch.float32)  # one buffer, refilled
    for start in range(0, n, _PIECE):
        m = min(_PIECE, n - start)
        piece = z[:m].normal_(generator=generator)  # what randn draws
        flat[start:start + m].copy_(piece.mul_(scale))
    return out


def walk(tree, path=()):
    """Yield (path, leaf) in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    else:
        yield path, tree


def param_shardings(spec_tree, mesh, rules):
    """The DTensor placements of every leaf of a spec tree on ``mesh``
    under ``rules`` (``sharding.logical_sharding`` of its axes)."""
    return tree_map(lambda s: logical_sharding(s.axes, s.shape, rules, mesh),
                    spec_tree)


def init_params(spec_tree, seed: int, param_dtype: str,
                device="cpu", mesh=None, shardings=None) -> dict:
    """Materialise a spec tree as a nested dict of tensors on ``device``.

    Leaves are drawn on the CPU, so a seed gives the same weights on every
    device; ``_DRAW_THREADS`` leaves are drawn at once (each from its own
    generator, so the order does not change a value). With a ``mesh``,
    each leaf is drawn whole and then distributed by its placements in
    ``shardings`` (a tree shaped as ``spec_tree``), each rank keeping its
    own block: every rank holds the unsharded values, and no rank the
    whole tree at once."""
    leaves = list(walk(spec_tree))
    for path, spec in leaves:
        if not isinstance(spec, ParamSpec):
            raise TypeError(f"bad spec node at {path}: {type(spec)}")

    def draw(item):
        path, spec = item
        gen = torch.Generator().manual_seed(
            (seed * 0x9E3779B1 + zlib.crc32(".".join(path).encode()))
            % 2 ** 63)
        leaf = init_leaf(spec, gen, param_dtype, device)
        if mesh is None:
            return leaf
        node = shardings
        for p in path:
            node = node[p]
        return distribute_tensor(leaf, mesh, node, src_data_rank=None)

    with ThreadPoolExecutor(_DRAW_THREADS) as pool:
        drawn = list(pool.map(draw, leaves))
    out: dict = {}
    for (path, _), leaf in zip(leaves, drawn):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure; ``rest``
    are trees of the same keys, their leaves passed beside ``tree``'s."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


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

