"""Modality frontends (``repro/models/frontends.py``): the ViT patch embed
of a vision-language model and Whisper's two-conv audio stem.

The serving paths read their outputs' shapes as inputs (patch embeddings
before the text tokens, frame embeddings into the encoder); these are the
convolutions that make them. Neither launches a kernel of the port: the
patch embed is a stride-``patch`` conv that ``core.algorithms.conv2d``
runs as a reshape and one product, and the reference computes the stem's
1-D convs with XLA (``ops.conv1d_dense``).
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.core import algorithms
from repro_torch.kernels import ops
from repro_torch.models.spec import ParamSpec


def vit_patch_specs(cfg, patch=14, in_ch=3):
    return {"w": ParamSpec((patch, patch, in_ch, cfg.d_model),
                           (None, None, None, "embed_fsdp")),
            "b": ParamSpec((cfg.d_model,), (None,), "zeros")}


def vit_patch_embed(p, cfg, images, patch=14, algorithm="ilpm"):
    """images: (B, H, W, 3) -> (B, n_patches, d_model): a stride-``patch``
    ``patch``×``patch`` VALID conv, i.e. non-overlapping patches unrolled
    and multiplied by the filter, plus the bias."""
    y = algorithms.conv2d(images, p["w"], stride=patch, padding="VALID",
                          algorithm=algorithm)
    B, Hp, Wp, C = y.shape
    return (y + p["b"]).reshape(B, Hp * Wp, C)


def audio_stem_specs(cfg, n_mels=80):
    return {
        "w1": ParamSpec((3, n_mels, cfg.d_model), (None, None, "embed_fsdp")),
        "b1": ParamSpec((cfg.d_model,), (None,), "zeros"),
        "w2": ParamSpec((3, cfg.d_model, cfg.d_model),
                        (None, None, "embed_fsdp")),
        "b2": ParamSpec((cfg.d_model,), (None,), "zeros"),
    }


def audio_stem(p, cfg, mel):
    """mel: (B, T, n_mels) -> (B, ceil(T / 2), d_model): Whisper's stem,
    a k=3 conv at stride 1 then one at stride 2, each followed by GELU
    (the tanh approximation, ``jax.nn.gelu``'s default)."""
    x = F.gelu(ops.conv1d_dense(mel, p["w1"], p["b1"], stride=1),
               approximate="tanh")
    return F.gelu(ops.conv1d_dense(x, p["w2"], p["b2"], stride=2),
                  approximate="tanh")
