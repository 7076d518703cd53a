"""LM building blocks: the norms and embeddings of
``repro/models/layers.py``.

Activations are (batch, seq, d_model); parameters are declared as
``ParamSpec`` trees. Attention, MLA, the MLP and MoE come with later
slices.
"""
from __future__ import annotations

import torch

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models.spec import ParamSpec


def padded_vocab(vocab: int) -> int:
    """Megatron-style vocab padding to a multiple of 512."""
    return (vocab + 511) // 512 * 512


def rms_norm(x, w, eps):
    """RMS norm in fp32, cast back to ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x, w, b, eps):
    """Layer norm in fp32, cast back to ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def norm_spec(d, kind="rms"):
    if kind == "rms":
        return {"w": ParamSpec((d,), (None,), "ones")}
    return {"w": ParamSpec((d,), (None,), "ones"),
            "b": ParamSpec((d,), (None,), "zeros")}


def apply_norm(p, x, eps):
    if "b" in p:
        return layer_norm(x, p["w"], p["b"], eps)
    return rms_norm(x, p["w"], eps)


def embed_specs(cfg):
    v = padded_vocab(cfg.vocab_size)
    sp = {"table": ParamSpec((v, cfg.d_model), ("vocab", "embed_fsdp"),
                             "embed")}
    if cfg.pos_emb == "learned":
        sp["pos"] = ParamSpec((cfg.extra.get("max_seq", 32_768), cfg.d_model),
                              (None, "embed_fsdp"), "embed")
    if not cfg.tie_embeddings:
        sp["unembed"] = ParamSpec((cfg.d_model, v), ("embed_fsdp", "vocab"))
    return sp


def embed(p, cfg, tokens, positions=None):
    """tokens (B, S) -> (B, S, d_model) in the compute dtype."""
    dt = torch_dtype(cfg.dtype)
    x = p["table"][tokens.long()].to(dt)
    if cfg.pos_emb == "learned" and positions is not None:
        x = x + p["pos"][positions].to(dt)
    return x


def unembed(p, cfg, x):
    """(B, S, d_model) -> logits (B, S, padded vocab); the padding columns
    are masked with the dtype's most negative value."""
    dt = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        logits = torch.einsum("bse,ve->bsv", x, p["table"].to(dt))
    else:
        logits = torch.einsum("bse,ev->bsv", x, p["unembed"].to(dt))
    mask = torch.arange(logits.shape[-1], device=logits.device) \
        < cfg.vocab_size
    return logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
