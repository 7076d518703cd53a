"""Model registry: per-family dispatch and parameter counting
(``repro/models/registry.py``): the CNNs, the decoder-only LMs (``lm``:
the ssm, dense, moe, hybrid and vlm families) and the encoder-decoder
(``encdec``: whisper-base)."""
from __future__ import annotations

from repro_torch.models import encdec, lm, mobilenet, resnet
from repro_torch.models import spec as pspec


def cnn_module(cfg):
    """The CNN family module (``Network`` / forward / model_specs /
    conv_specs / block_specs) for a config; ``extra["arch"]`` routes,
    ResNet is the default."""
    return mobilenet if cfg.extra.get("arch") == "mobilenet" else resnet


def model_specs(cfg):
    if cfg.family == "cnn":
        return cnn_module(cfg).model_specs(cfg)
    if cfg.is_encoder_decoder:
        return encdec.model_specs(cfg)
    return lm.model_specs(cfg)


def forward_fn(cfg):
    if cfg.family == "cnn":
        return cnn_module(cfg).forward
    if cfg.is_encoder_decoder:
        return encdec.forward
    return lm.forward


def cache_struct(cfg, batch, max_seq):
    if cfg.is_encoder_decoder:
        return encdec.cache_struct(cfg, batch, max_seq)
    return lm.cache_struct(cfg, batch, max_seq)


def count_params(cfg, active_only: bool = False) -> int:
    """Parameter count from the spec tree; ``active_only`` counts only the
    routed experts a token visits (``top_k`` of ``num_experts`` in each
    MoE layer)."""
    if cfg.family == "cnn":
        return pspec.count(cnn_module(cfg).model_specs(cfg))
    total = pspec.count(model_specs(cfg))
    if active_only and cfg.num_experts:
        per_expert = cfg.d_model * cfg.moe_d_ff * 3
        n_moe_layers = sum(1 for _, f in lm.layer_plan(cfg) if f == "moe")
        total -= (cfg.num_experts - cfg.top_k) * per_expert * n_moe_layers
    return total
