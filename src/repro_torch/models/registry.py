"""Model registry: per-family dispatch (``repro/models/registry.py``)."""
from __future__ import annotations

from repro_torch.models import mobilenet, resnet


def cnn_module(cfg):
    """The CNN family module (``Network`` / forward / model_specs /
    conv_specs / block_specs) for a config; ``extra["arch"]`` routes,
    ResNet is the default."""
    return mobilenet if cfg.extra.get("arch") == "mobilenet" else resnet

