"""LM building blocks of ``repro/models/layers.py``: the norms and
embeddings, rotary position embedding, the attention core (full scores
below ``_FULL_THRESH``, online softmax over KV chunks above it), the GQA
block with its decode-cache write, and the FFN (SwiGLU or the GELU MLP).

Activations are (batch, seq, d_model); parameters are declared as
``ParamSpec`` trees. The reference writes attention and the FFN in jnp,
outside any Pallas kernel, so they are plain PyTorch here, op for op: the
same einsums, the scores and the softmax in fp32, the GQA expansion of K
and V to the full head count (``jnp.repeat`` as ``repeat_interleave``).
MLA and MoE come with a later slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models.spec import ParamSpec

# full-score attention only up to this Sq*Sk (else online-softmax chunks)
_FULL_THRESH = 2048 * 2048
_INT32_MAX = 2 ** 31 - 1  # the position of a padded KV slot


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


# ----------------------------------------------------------------------
# rotary position embedding (half-split / llama convention)


def rope(x, positions, theta):
    """x: (..., seq, heads, dim); positions: broadcastable to (..., seq).
    The angles in fp32; the rotation promotes x to fp32 as jnp does, then
    casts back to ``x.dtype``."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention core: full scores and online softmax over KV chunks (B,S,H,D)


def _attend_full(q, k, v, *, causal, q_pos, kv_pos, scale):
    """q: (B,Sq,H,D); k/v: (B,Sk,H,D). The scores scale in the compute
    dtype, then mask and softmax in fp32."""
    scores = torch.einsum("bshd,bthd->bhst", q, k) * scale
    scores = scores.float()
    if causal:
        m = q_pos[:, :, None] >= kv_pos[:, None, :]  # (B,Sq,Sk)
        scores = scores.masked_fill(~m[:, None], -math.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)


def _attend_chunked(q, k, v, *, causal, q_pos, kv_pos, scale, chunk):
    """Online softmax over KV chunks (the Rabe & Staats / FlashAttention
    recurrence), never the whole (Sq, Sk) score matrix: the reference's
    scan as a loop over the chunks. The scores cast to fp32 before they
    scale; the running max, sum and accumulator are fp32."""
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[1]
    n = -(-Sk // chunk)
    pad = n * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=_INT32_MAX)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    for c in range(n):
        kc, vc = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]
        pc = kv_pos[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bshd,bthd->bhst", q, kc).float() * scale
        valid = pc[:, None, :] <= q_pos[:, :, None] if causal else \
            (pc < _INT32_MAX)[:, None, :]
        s = s.masked_fill(~valid[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, zero)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B,Sq,H,Dv)


def attention(q, k, v, *, causal, q_pos, kv_pos, chunk=2048, scale=None):
    """Attention core. q: (B,Sq,Hq,D); k/v: (B,Sk,Hkv,D) with Hkv | Hq;
    q_pos (B,Sq), kv_pos (B,Sk)."""
    D = q.shape[-1]
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv != Hq:  # GQA: expand KV to the full head count
        G = Hq // Hkv
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    if scale is None:
        scale = D ** -0.5
    if q.shape[1] * k.shape[1] <= _FULL_THRESH:
        return _attend_full(q, k, v, causal=causal, q_pos=q_pos,
                            kv_pos=kv_pos, scale=scale)
    return _attend_chunked(q, k, v, causal=causal, q_pos=q_pos,
                           kv_pos=kv_pos, scale=scale, chunk=chunk)


# ----------------------------------------------------------------------
# GQA attention block


def gqa_specs(cfg):
    E, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sp = {
        "wq": ParamSpec((E, H, D), ("embed_fsdp", "heads", None)),
        "wk": ParamSpec((E, KV, D), ("embed_fsdp", "kv_heads", None)),
        "wv": ParamSpec((E, KV, D), ("embed_fsdp", "kv_heads", None)),
        "wo": ParamSpec((H, D, E), ("heads", None, "embed_fsdp")),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((H, D), ("heads", None), "zeros")
        sp["bk"] = ParamSpec((KV, D), ("kv_heads", None), "zeros")
        sp["bv"] = ParamSpec((KV, D), ("kv_heads", None), "zeros")
    return sp


def gqa_qkv(p, cfg, x, positions):
    dt = torch_dtype(cfg.dtype)
    q = torch.einsum("bse,ehd->bshd", x, p["wq"].to(dt))
    k = torch.einsum("bse,ehd->bshd", x, p["wk"].to(dt))
    v = torch.einsum("bse,ehd->bshd", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attn(p, cfg, x, positions, *, causal=True, kv=None, kv_pos=None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v))."""
    q, k, v = gqa_qkv(p, cfg, x, positions)
    if kv is not None:  # cross-attention: precomputed encoder kv
        k, v = kv
    kvp = kv_pos if kv_pos is not None else positions
    out = attention(q, k, v, causal=causal, q_pos=positions, kv_pos=kvp,
                    chunk=cfg.attn_chunk)
    out = torch.einsum("bshd,hde->bse", out, p["wo"].to(torch_dtype(
        cfg.dtype)))
    return out, (k, v)


def _masked_cache_write(cache_arr, new, pos):
    """Write ``new`` (B,1,...) at sequence index ``pos`` through an iota
    mask, as the reference does: ``pos`` may be a Python int or a 0-d
    tensor on the cache's device (a CUDA graph's static position)."""
    S = cache_arr.shape[1]
    iota = torch.arange(S, device=cache_arr.device).reshape(
        (1, S) + (1,) * (cache_arr.ndim - 2))
    return torch.where(iota == pos, new.to(cache_arr.dtype), cache_arr)


def gqa_decode(p, cfg, x, cache, pos):
    """One-token decode against a (B, Smax, KV, D) cache {"k", "v"}; the
    write index is ``pos`` (an int or a 0-d device tensor), the same for
    the whole batch."""
    dt = torch_dtype(cfg.dtype)
    B = x.shape[0]
    if isinstance(pos, torch.Tensor):
        positions = pos.reshape(1, 1).expand(B, 1)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    q, k_new, v_new = gqa_qkv(p, cfg, x, positions)
    k = _masked_cache_write(cache["k"], k_new, pos)
    v = _masked_cache_write(cache["v"], v_new, pos)
    kv_pos = torch.arange(k.shape[1], device=x.device)[None].expand(
        B, k.shape[1])
    out = attention(q, k.to(dt), v.to(dt), causal=True, q_pos=positions,
                    kv_pos=kv_pos, chunk=cfg.attn_chunk)
    out = torch.einsum("bshd,hde->bse", out, p["wo"].to(dt))
    return out, {"k": k, "v": v}


# ----------------------------------------------------------------------
# FFN: SwiGLU / GELU MLP


def ffn_specs(cfg, d_ff=None):
    E = cfg.d_model
    F_ = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w1": ParamSpec((E, F_), ("embed_fsdp", "d_ff")),
            "w3": ParamSpec((E, F_), ("embed_fsdp", "d_ff")),
            "w2": ParamSpec((F_, E), ("d_ff", "embed_fsdp")),
        }
    return {
        "w1": ParamSpec((E, F_), ("embed_fsdp", "d_ff")),
        "b1": ParamSpec((F_,), ("d_ff",), "zeros"),
        "w2": ParamSpec((F_, E), ("d_ff", "embed_fsdp")),
        "b2": ParamSpec((E,), (None,), "zeros"),
    }


def ffn(p, cfg, x):
    """SwiGLU where the params have ``w3``, else the GELU MLP with the
    tanh approximation (``jax.nn.gelu``'s default)."""
    dt = torch_dtype(cfg.dtype)
    if "w3" in p:
        h = F.silu(x @ p["w1"].to(dt)) * (x @ p["w3"].to(dt))
        return h @ p["w2"].to(dt)
    h = F.gelu(x @ p["w1"].to(dt) + p["b1"].to(dt), approximate="tanh")
    return h @ p["w2"].to(dt) + p["b2"].to(dt)
