"""Architecture configs: the CNN subset of ``repro/configs/base.py``.

Only the fields a CNN reads are here; the LM configs come with their
slice. Field names and defaults match the reference so a config names the
same network in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # cnn (the LM families come with a later slice)
    num_layers: int = 0
    vocab_size: int = 0
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # stored dtype
    use_ilpm_conv: bool = False  # paper technique applies to this arch
    extra: dict[str, Any] = field(default_factory=dict)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers the configs)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]

