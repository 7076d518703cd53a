"""Step functions of the LM path (``repro/launch/steps.py``): the state a
run starts from, one prefill and one decode step.

The reference builds these as closures for ``jax.jit`` over a device
mesh; here they are plain functions on one device, run eagerly. The
train step and its optimizer state come with a later slice.
"""
from __future__ import annotations

from repro_torch.core.engine import resolve_device
from repro_torch.models import lm, registry
from repro_torch.models.spec import init_params


def init_state(cfg, seed=0, device=None):
    """{"params": the model's weights drawn from ``seed``} on ``device``:
    the card unless the caller names another device; no card and no
    ``device`` raises."""
    device = resolve_device(device)
    return {"params": init_params(registry.model_specs(cfg), seed,
                                  cfg.param_dtype, device=device)}


def prefill_step(params, cfg, tokens, *, cache_len=0, impl="auto"):
    """The prompt ``tokens`` (B, S) -> (last-position logits (B, 1, V),
    caches)."""
    logits, caches, _ = lm.forward(params, cfg, tokens, mode="prefill",
                                   cache_len=cache_len, impl=impl)
    return logits, caches


def decode_step(params, cfg, tokens, caches, pos, *, impl="auto"):
    """One new token per row, ``tokens`` (B, 1), at position ``pos`` ->
    (logits (B, 1, V), caches)."""
    logits, caches, _ = lm.decode_step(params, cfg, tokens, caches, pos,
                                       impl=impl)
    return logits, caches
