"""Model registry: per-family dispatch (``repro/models/registry.py``)."""
from __future__ import annotations

from repro_torch.models import resnet


def cnn_module(cfg):
    """The CNN family module (forward / model_specs / conv_specs /
    block_specs) for a config; ``extra["arch"]`` routes, ResNet is the
    default."""
    if cfg.extra.get("arch") == "mobilenet":
        raise NotImplementedError(
            "MobileNetV2 is not ported yet: ROADMAP queue 1 item 10")
    return resnet

