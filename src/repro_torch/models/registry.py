"""Model registry: per-family dispatch and parameter counting
(``repro/models/registry.py``). The CNNs, the ssm family and the dense
GQA family build; MLA, MoE and the hybrid plan raise in ``lm``'s layer
check, the encoder-decoder models here."""
from __future__ import annotations

from repro_torch.models import lm, mobilenet, resnet
from repro_torch.models import spec as pspec


def cnn_module(cfg):
    """The CNN family module (``Network`` / forward / model_specs /
    conv_specs / block_specs) for a config; ``extra["arch"]`` routes,
    ResNet is the default."""
    return mobilenet if cfg.extra.get("arch") == "mobilenet" else resnet


def _lm_only(cfg):
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder models come with a later "
            f"slice {lm.LATER}")


def model_specs(cfg):
    if cfg.family == "cnn":
        return cnn_module(cfg).model_specs(cfg)
    _lm_only(cfg)
    return lm.model_specs(cfg)


def forward_fn(cfg):
    if cfg.family == "cnn":
        return cnn_module(cfg).forward
    _lm_only(cfg)
    return lm.forward


def cache_struct(cfg, batch, max_seq):
    _lm_only(cfg)
    return lm.cache_struct(cfg, batch, max_seq)


def count_params(cfg) -> int:
    """Parameter count from the spec tree."""
    return pspec.count(model_specs(cfg))
