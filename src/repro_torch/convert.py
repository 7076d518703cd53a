"""Carry parameters from the JAX package into the port.

``params_from_reference`` takes the reference's parameter tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's
side; this module imports no JAX) and returns the port's flat
``state_dict``: dotted keys, torch tensors on ``device``. bf16 leaves
pass through fp32, which is exact both ways; integer leaves (an
optimizer's int32 ``step``) are copied as they are. An optimizer-state
tree (``m``, ``v``, ``vr``, ``vc``, ``step``, the ``(0,)`` placeholders)
comes across the same way, each leaf in its own dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dtypes import canonical, torch_dtype
from repro_torch.models.spec import flatten


def params_from_reference(tree, device="cpu", dtype=None) -> dict:
    """Nested dict of numpy arrays -> {dotted path: tensor}. Each leaf
    keeps its own dtype unless ``dtype`` is given."""
    out = {}
    for key, leaf in flatten(tree).items():
        if np.asarray(leaf).dtype.kind in "iu":
            out[key] = torch.from_numpy(np.array(leaf)).to(device)
            continue
        target = torch_dtype(dtype if dtype is not None
                             else canonical(leaf.dtype))
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))  # a copy
        out[key] = t.to(device=device, dtype=target)
    return out
