"""Encoder-decoder transformer, Whisper-style (``repro/models/encdec.py``).

The encoder reads frame embeddings (the audio stem's output, or a stand-in
of its shape) plus learned positions; each decoder block is causal
self-attention, cross-attention to the encoder's output and a GELU MLP,
pre-LayerNorm, with learned positions and an unembedding tied to the
token table. The reference scans the stacked encoder and decoder layers;
here a Python loop runs them, and the per-layer caches are stacked back
along the layer axis. In training (``remat="full"``) each layer is
rematerialized, as the reference checkpoints its scan bodies.

A prefill runs the encoder once, projects every decoder layer's
cross-attention K and V from its output (``cross_kv``: ``wk`` and ``wv``
alone, no bias, no position) and returns them as the ``cross`` cache
beside the ``self`` K and V, which it pads to ``cache_len``; a decode step
reads ``cross`` and passes it through unchanged.

``EncDec`` is the network as an ``nn.Module``: its ``state_dict()`` keys
are the reference's parameter paths (``embed.table``, ``enc_pos``,
``dec.attn.wq`` with its stacked (layers, ...) shape, ``dec_ln.b``).
"""
from __future__ import annotations

import torch

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.lm import _index, _stack, pad_seq, remat
from repro_torch.models.module import SpecNetwork
from repro_torch.models.spec import ParamSpec, stack_tree
from repro_torch.sharding.rules import constrain

# the residual stream's logical axes, and an activation's whole along the
# sequence (sequence parallelism's gather before a layer's products)
_RESIDUAL = ("batch", "seq", "embed")
_WHOLE_SEQ = ("batch", None, "embed")
# the decode caches' logical axes (``cache_struct``), each stacked along a
# leading layer axis: the self K and V, the cross K and V
_SELF_CACHE = ("layer", "batch", "kv_seq", "kv_heads", None)
_CROSS_CACHE = ("layer", "batch", None, "kv_heads", None)


def _enc_block_specs(cfg):
    return {"ln1": L.norm_spec(cfg.d_model, "ln"),
            "attn": L.gqa_specs(cfg),
            "ln2": L.norm_spec(cfg.d_model, "ln"),
            "ffn": L.ffn_specs(cfg)}


def _dec_block_specs(cfg):
    return {"ln1": L.norm_spec(cfg.d_model, "ln"),
            "attn": L.gqa_specs(cfg),
            "lnx": L.norm_spec(cfg.d_model, "ln"),
            "xattn": L.gqa_specs(cfg),
            "ln2": L.norm_spec(cfg.d_model, "ln"),
            "ffn": L.ffn_specs(cfg)}


def model_specs(cfg):
    v = L.padded_vocab(cfg.vocab_size)
    return {
        "embed": {
            "table": ParamSpec((v, cfg.d_model), ("vocab", "embed_fsdp"),
                               "embed"),
            "pos": ParamSpec((cfg.extra.get("max_seq", 32_768), cfg.d_model),
                             (None, "embed_fsdp"), "embed"),
        },
        "enc_pos": ParamSpec((cfg.encoder_seq, cfg.d_model),
                             (None, "embed_fsdp"), "embed"),
        "enc": stack_tree(_enc_block_specs(cfg), cfg.num_encoder_layers),
        "enc_ln": L.norm_spec(cfg.d_model, "ln"),
        "dec": stack_tree(_dec_block_specs(cfg), cfg.num_layers),
        "dec_ln": L.norm_spec(cfg.d_model, "ln"),
    }


def _iota(B, S, device):
    return torch.arange(S, dtype=torch.int64, device=device)[None].expand(
        B, S)


def encode(params, cfg, frames, mode="prefill"):
    """frames: (B, T_enc, E) -> the encoder's output (B, T_enc, E) in the
    compute dtype; T_enc is at most ``encoder_seq``. In a train-mode
    forward each layer is rematerialized (``lm.remat``)."""
    dt = torch_dtype(cfg.dtype)
    T = frames.shape[1]
    x = constrain(frames.to(dt) + params["enc_pos"][None, :T].to(dt),
                  _RESIDUAL)
    pos = _iota(x.shape[0], T, x.device)

    def layer(x, p):
        h = constrain(L.apply_norm(p["ln1"], x, cfg.norm_eps), _WHOLE_SEQ)
        out, _ = L.gqa_attn(p["attn"], cfg, h, pos, causal=False)
        x = x + constrain(out, _WHOLE_SEQ)
        h = constrain(L.apply_norm(p["ln2"], x, cfg.norm_eps), _WHOLE_SEQ)
        return constrain(x + constrain(L.ffn(p["ffn"], cfg, h), _WHOLE_SEQ),
                         _RESIDUAL)

    layer = remat(layer, cfg, mode)
    for i in range(cfg.num_encoder_layers):
        x = layer(x, _index(params["enc"], i))
    return constrain(L.apply_norm(params["enc_ln"], x, cfg.norm_eps),
                     _WHOLE_SEQ)


def cross_kv(params, cfg, enc_out):
    """Every decoder layer's cross-attention K and V from the encoder's
    output: {"xk", "xv"}, each (layers, B, T_enc, KV, D)."""
    dt = torch_dtype(cfg.dtype)
    xk, xv = [], []
    for i in range(cfg.num_layers):
        p = _index(params["dec"], i)["xattn"]
        xk.append(L.to_heads(enc_out, p["wk"].to(dt)))
        xv.append(L.to_heads(enc_out, p["wv"].to(dt)))
    return {"xk": _stack(xk), "xv": _stack(xv)}


def _dec_block(p, cfg, x, positions, enc_kv, enc_pos, *, mode, cache, pos):
    """One decoder layer -> (x, its self-attention cache {"k", "v"})."""
    h = constrain(L.apply_norm(p["ln1"], x, cfg.norm_eps), _WHOLE_SEQ)
    if mode == "decode":
        out, new_cache = L.gqa_decode(p["attn"], cfg, h, cache, pos)
    else:
        out, (k, v) = L.gqa_attn(p["attn"], cfg, h, positions)
        new_cache = {"k": k, "v": v}
    x = x + constrain(out, _WHOLE_SEQ)
    h = constrain(L.apply_norm(p["lnx"], x, cfg.norm_eps), _WHOLE_SEQ)
    out, _ = L.gqa_attn(p["xattn"], cfg, h, positions, causal=False,
                        kv=(enc_kv["xk"], enc_kv["xv"]), kv_pos=enc_pos)
    x = x + constrain(out, _WHOLE_SEQ)
    h = constrain(L.apply_norm(p["ln2"], x, cfg.norm_eps), _WHOLE_SEQ)
    return constrain(x + constrain(L.ffn(p["ffn"], cfg, h), _WHOLE_SEQ),
                     _RESIDUAL), new_cache


def forward(params, cfg, tokens, frames=None, *, mode="train", caches=None,
            pos=0, cache_len=0):
    """tokens: (B, S) decoder ids; frames: (B, T_enc, E) frame embeddings.

    mode=train   -> (logits (B,S,V), None, 0)
    mode=prefill -> (last-position logits (B,1,V), {"self": K and V
                    padded to ``cache_len``, "cross": ``cross_kv``}, 0)
    mode=decode  -> (logits (B,1,V), caches, 0); tokens (B,1), frames
                    ignored (the cross K and V are cached)

    V is the padded vocab, its padding columns masked. ``pos`` is the
    first position: an int, or (decode) a 0-d tensor on the tokens'
    device."""
    dt = torch_dtype(cfg.dtype)
    B, S = tokens.shape
    positions = pos + _iota(B, S, tokens.device)
    x = L.lookup(params["embed"]["table"], tokens).to(dt)
    x = constrain(x + L.lookup(params["embed"]["pos"], positions).to(dt),
                  _RESIDUAL)
    if mode == "decode":
        enc_kv_all = caches["cross"]
    else:
        enc_kv_all = cross_kv(params, cfg, encode(params, cfg, frames,
                                                  mode))
    enc_pos = _iota(B, enc_kv_all["xk"].shape[2], tokens.device)
    if mode == "prefill" and cache_len and cache_len < S:
        raise ValueError(f"cache_len {cache_len} < the prompt's {S}")
    self_caches = caches.get("self") if caches else None
    new_self = []

    def block(x, p, enc_kv, cache):
        return _dec_block(p, cfg, x, positions, enc_kv, enc_pos, mode=mode,
                          cache=cache, pos=pos)

    block = remat(block, cfg, mode)
    for i in range(cfg.num_layers):
        x, c = block(x, _index(params["dec"], i), _index(enc_kv_all, i),
                     _index(self_caches, i) if self_caches else None)
        if mode == "prefill" and cache_len:
            c = {k: pad_seq(a, cache_len) for k, a in c.items()}
        if mode == "prefill":  # placed as a decode cell reads them
            c = {k: constrain(a, _SELF_CACHE[1:]) for k, a in c.items()}
        new_self.append(c)
    x = constrain(L.apply_norm(params["dec_ln"], x, cfg.norm_eps),
                  _WHOLE_SEQ)
    if mode == "prefill":
        x = x[:, -1:]
    logits = torch.einsum("bse,ve->bsv", x, params["embed"]["table"].to(dt))
    mask = torch.arange(logits.shape[-1], device=logits.device) \
        < cfg.vocab_size
    logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    logits = constrain(logits, ("batch", "seq", "vocab_act"))
    new_caches = None
    if mode == "prefill":
        enc_kv_all = {k: constrain(v, _CROSS_CACHE)
                      for k, v in enc_kv_all.items()}
    if mode != "train":
        new_caches = {"self": _stack(new_self), "cross": enc_kv_all}
    return logits, new_caches, torch.zeros((), dtype=torch.float32,
                                           device=logits.device)


def cache_struct(cfg, batch: int, max_seq: int):
    """The decode cache as {name: (shape, dtype, axes)} leaves: the self
    K and V of ``max_seq`` positions and the cross K and V of
    ``encoder_seq``, each stacked along a leading layer axis."""
    dt = torch_dtype(cfg.dtype)
    n = cfg.num_layers
    kvd = (n, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    xkvd = (n, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    ax, xax = _SELF_CACHE, _CROSS_CACHE
    return {"self": {"k": (kvd, dt, ax), "v": (kvd, dt, ax)},
            "cross": {"xk": (xkvd, dt, xax), "xv": (xkvd, dt, xax)}}


class EncDec(SpecNetwork):
    """The encoder-decoder as a module; ``forward(tokens, frames=...,
    **kw)`` is ``encdec.forward``."""
    model_specs = staticmethod(model_specs)
    forward_fn = staticmethod(forward)
