"""Precision rules for the convspec → autotune → kernels pipeline.

The port's copy of ``repro/core/dtypes.py``: the same element sizes, the
same fp32 accumulator rule, the same parity tolerances and the same
canonical names, so a spec, a plan or a tolerance means the same thing in
both packages. ``canonical`` also accepts ``torch.dtype`` objects
(``torch.float32`` prints as ``"torch.float32"``), and ``TORCH_DTYPES``
maps a canonical name back to its torch dtype.

Every kernel accumulates in fp32 regardless of the input dtype and casts
once on the output write; ``tolerance(dtype)`` is the kernel-vs-reference
bound ``max|y - ref| / max|ref|``.
"""
from __future__ import annotations

import torch

# Bytes per stored element, keyed by canonical name.
_ELEMENT_SIZES = {
    "float64": 8,
    "float32": 4,
    "int32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int8": 1,
    "uint8": 1,
}

# The accumulator rule: accumulate wide, cast once on the output write.
ACC_DTYPE = "float32"
ACC_BYTES = 4

# Dtypes the kernel families accept end to end (plan-tunable precisions).
KERNEL_DTYPES = ("float32", "bfloat16", "float16")

# Kernel-vs-reference parity bounds (relative to the reference's max
# magnitude): one rounding of the inputs plus one of the output write.
_TOLERANCES = {
    "float32": 2e-5,
    "float16": 5e-3,
    "bfloat16": 3e-2,
}

TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "int32": torch.int32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "uint8": torch.uint8,
}


def canonical(dtype) -> str:
    """Canonical string name for a dtype-like (str, numpy or torch dtype)."""
    s = str(dtype)
    if s.startswith("torch."):
        s = s[len("torch."):]
    for name in _ELEMENT_SIZES:
        if s == name or s.endswith(f".{name}'>") or s == f"<dtype: {name}>":
            return name
    return s


def element_size(dtype) -> int:
    """Bytes per stored element; raises on unknown dtypes."""
    name = canonical(dtype)
    try:
        return _ELEMENT_SIZES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {dtype!r}; known: {sorted(_ELEMENT_SIZES)}"
        ) from None


def tolerance(dtype) -> float:
    """Documented kernel-vs-fp32-reference relative tolerance."""
    return _TOLERANCES[canonical(dtype)]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a dtype-like."""
    return TORCH_DTYPES[canonical(dtype)]


def with_precision(cfg, dtype):
    """An ``ArchConfig`` variant computing and storing params in ``dtype``."""
    name = canonical(dtype)
    if name not in KERNEL_DTYPES:
        raise ValueError(
            f"unsupported engine precision {dtype!r}; "
            f"kernel dtypes: {KERNEL_DTYPES}")
    if cfg.dtype == name and cfg.param_dtype == name:
        return cfg
    return cfg.replace(dtype=name, param_dtype=name)
