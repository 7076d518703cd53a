"""LM building blocks of ``repro/models/layers.py``: the norms and
embeddings, rotary position embedding, the attention core (full scores
below ``_FULL_THRESH``, online softmax over KV chunks above it), the GQA
block with its decode-cache write, MLA (multi-head latent attention, its
decode absorbing ``W_uk`` into the query), the FFN (SwiGLU or the GELU
MLP) and the MoE ffn (a top-k router, then the dense or the sort-based
capacity dispatch).

Activations are (batch, seq, d_model); parameters are declared as
``ParamSpec`` trees. The reference writes all of these in jnp, outside
any Pallas kernel, so they are plain PyTorch here, op for op: the same
einsums, the scores and the softmax in fp32, the GQA expansion of K and V
to the full head count (``jnp.repeat`` as ``repeat_interleave``). The
sharding hints (``constrain``) have no counterpart on one device. Nothing
in a decode step or in ``moe`` waits on the host, so both run inside a
CUDA graph capture.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models.spec import ParamSpec
from repro_torch.sharding.rules import (as_dtensor, axis_size, constrain,
                                        current, current_mesh, run_local)

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


def lookup(table, idx):
    """``table[idx]``: the rows of an embedding table at (B, S) indices.
    Under a mesh each rank looks its own block of the indices up in the
    whole table (``run_local``; the table gathered, its gradient a
    partial sum), not through DTensor's indexing strategies."""
    if current() is None:
        return table[idx.long()]
    B, S = idx.shape
    return run_local(lambda t, i: t[i.long()], (table, idx),
                     ((None, None), ("batch", "seq")),
                     [(("batch", "seq", None), (B, S, table.shape[1]))])


def embed(p, cfg, tokens, positions=None):
    """tokens (B, S) -> (B, S, d_model) in the compute dtype."""
    dt = torch_dtype(cfg.dtype)
    x = lookup(p["table"], tokens).to(dt)
    if cfg.pos_emb == "learned" and positions is not None:
        x = x + lookup(p["pos"], positions).to(dt)
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
    q_pos (B,Sq), kv_pos (B,Sk).

    Under a mesh (``sharding.axis_rules``) each rank attends with its own
    block of the batch and of the heads (``heads_act``), K and V
    replicated over the heads' mesh axis where their fewer heads do not
    divide it; every (row, head) is the unsharded one's."""
    if current() is not None:
        return _attention_sharded(q, k, v, causal=causal, q_pos=q_pos,
                                  kv_pos=kv_pos, chunk=chunk, scale=scale)
    return _attention(q, k, v, causal=causal, q_pos=q_pos, kv_pos=kv_pos,
                      chunk=chunk, scale=scale)


def _attention_sharded(q, k, v, *, causal, q_pos, kv_pos, chunk, scale):
    """``attention`` through ``run_local``: q, K and V by (batch, heads),
    the positions by batch. Where q's heads are split and K and V are
    whole, a rank expands them to the full head count and keeps its
    own."""
    _, mesh = current()
    Hq, Hkv = q.shape[2], k.shape[2]
    ax = ("batch", None, "heads_act", None)
    model = (mesh.get_local_rank(mesh.mesh_dim_names.index("model"))
             if "model" in mesh.mesh_dim_names else 0)

    def core(q, k, v, q_pos, kv_pos):
        hq, hkv = q.shape[2], k.shape[2]
        if hkv == Hkv and hq != Hq:  # q split, K and V whole
            k = torch.repeat_interleave(k, Hq // Hkv, dim=2)
            v = torch.repeat_interleave(v, Hq // Hkv, dim=2)
            k, v = (t[:, :, model * hq:(model + 1) * hq] for t in (k, v))
        return _attention(q, k, v, causal=causal, q_pos=q_pos,
                          kv_pos=kv_pos, chunk=chunk, scale=scale)

    return run_local(core, (q, k, v, q_pos, kv_pos),
                     (ax, ax, ax, ("batch", None), ("batch", None)),
                     [(ax, (*q.shape[:3], v.shape[3]))])


def _attention(q, k, v, *, causal, q_pos, kv_pos, chunk=2048, scale=None):
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
# products into and out of the heads


def merged(t, d):
    """``t`` with dims d and d + 1 merged. Under a mesh a split of dim d
    stays on the merged dim (dim d + 1 is gathered first), and the
    gradient is held to the same placements before it takes the reverse
    view: DTensor's views reject a split they cannot carry across."""
    shape = (*t.shape[:d], t.shape[d] * t.shape[d + 1], *t.shape[d + 2:])
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    whole = [Replicate() if p == Shard(d + 1) else p for p in t.placements]
    kept = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > d + 1
            else p for p in whole]
    mesh = t.device_mesh
    return t.redistribute(mesh, whole).reshape(shape).redistribute(mesh,
                                                                   kept)


# a (batch, seq, heads, dim) activation, and one with (heads, dim)
# flattened, each placed by its heads
_HEADS = ("batch", None, "heads_act", None)
_HEADS_FLAT = ("batch", None, "heads_act")


def column(eq, x, w, axes, shape):
    """``torch.einsum(eq, x, w)`` of an activation x (B, S, E) and a
    weight w (E, ...) -> an output whose dims ``axes`` place, of global
    ``shape``. Under a mesh it is a column-parallel product in
    ``run_local``: x whole along E and along the sequence, w gathered
    along E and split as the output's trailing dims, each rank
    multiplying its rows by its columns. No partial sums, and nothing for
    DTensor to plan: its own plan of such a product could split the
    flattened (batch, seq) rows over a mesh axis, a strided shard."""
    if current() is None:
        return torch.einsum(eq, x, w)
    return run_local(lambda a, b: torch.einsum(eq, a, b), (x, w),
                     (("batch", None, None), (None, *axes[2:])),
                     [(axes, shape)])


def to_heads(x, w):
    """x (B, S, E) against w (E, H, D) -> (B, S, H, D): the reference's
    einsum("bse,ehd->bshd"), column-parallel over the heads under a mesh
    (``column``)."""
    E, H, D = w.shape
    return column("bse,ehd->bshd", x, w, _HEADS, (*x.shape[:2], H, D))


def from_heads(x, w):
    """x (B, S, H, D) against w (H, D, E) -> (B, S, E): the reference's
    einsum("bshd,hde->bse"), one head-major product under a mesh (see
    ``to_heads``)."""
    if current() is None:
        return torch.einsum("bshd,hde->bse", x, w)
    H, D, E = w.shape
    B, S = x.shape[:2]
    x = constrain(constrain(x, _HEADS).reshape(B, S, H * D), _HEADS_FLAT,
                  (B, S, H))
    return x @ merged(w, 0)


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


def _gqa_proj(p, cfg, x, positions, w, b, rotate):
    dt = torch_dtype(cfg.dtype)
    y = to_heads(x, p[w].to(dt))
    if cfg.qkv_bias:
        y = y + p[b].to(dt)
    if rotate and cfg.pos_emb == "rope":
        y = rope(y, positions, cfg.rope_theta)
    return y


def gqa_qkv(p, cfg, x, positions):
    return (_gqa_proj(p, cfg, x, positions, "wq", "bq", True),
            _gqa_proj(p, cfg, x, positions, "wk", "bk", True),
            _gqa_proj(p, cfg, x, positions, "wv", "bv", False))


def gqa_attn(p, cfg, x, positions, *, causal=True, kv=None, kv_pos=None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v)).
    Cross-attention passes the encoder's K and V as ``kv`` (and their
    positions as ``kv_pos``): the reference computes K and V from ``x``
    and drops them, so only the query is projected here."""
    if kv is None:
        q, k, v = gqa_qkv(p, cfg, x, positions)
    else:
        q = _gqa_proj(p, cfg, x, positions, "wq", "bq", True)
        k, v = kv
    kvp = kv_pos if kv_pos is not None else positions
    out = attention(q, k, v, causal=causal, q_pos=positions, kv_pos=kvp,
                    chunk=cfg.attn_chunk)
    out = from_heads(out, p["wo"].to(torch_dtype(cfg.dtype)))
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
# MLA (multi-head latent attention, DeepSeek-V2)


def mla_specs(cfg):
    E, H = cfg.d_model, cfg.num_heads
    qk, qr, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    Lr, Q = cfg.kv_lora_rank, cfg.q_lora_rank
    return {
        "w_dq": ParamSpec((E, Q), ("embed_fsdp", "q_lora")),
        "q_norm": norm_spec(Q),
        "w_uq": ParamSpec((Q, H, qk + qr), ("q_lora", "heads", None)),
        "w_dkv": ParamSpec((E, Lr), ("embed_fsdp", "kv_lora")),
        "kv_norm": norm_spec(Lr),
        "w_kr": ParamSpec((E, qr), ("embed_fsdp", None)),
        "w_uk": ParamSpec((Lr, H, qk), ("kv_lora", "heads", None)),
        "w_uv": ParamSpec((Lr, H, vd), ("kv_lora", "heads", None)),
        "wo": ParamSpec((H, vd, E), ("heads", None, "embed_fsdp")),
    }


def _down(x, w):
    """x (B, S, E) against an MLA down-projection w (E, R), whose R no
    rule splits: einsum("bse,er->bsr"), replicated over the model axis
    under a mesh (``column``)."""
    return column("bse,er->bsr", x, w, ("batch", None, None),
                  (*x.shape[:2], w.shape[1]))


def _mla_q(p, cfg, x, positions):
    dt = torch_dtype(cfg.dtype)
    cq = rms_norm(_down(x, p["w_dq"].to(dt)), p["q_norm"]["w"], cfg.norm_eps)
    q = to_heads(cq, p["w_uq"].to(dt))
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = rope(q[..., cfg.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, cfg, x, positions):
    dt = torch_dtype(cfg.dtype)
    c_kv = rms_norm(_down(x, p["w_dkv"].to(dt)), p["kv_norm"]["w"],
                    cfg.norm_eps)
    k_r = _down(x, p["w_kr"].to(dt))
    k_r = rope(k_r[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_r


def mla_attn(p, cfg, x, positions):
    """Train / prefill MLA: K and V decompressed per head from the latent
    (not absorbed), the nope and rope parts of q and k concatenated into
    one inner product of ``qk_nope + qk_rope`` through the shared
    attention core, scaled by its inverse square root. Returns (out,
    (c_kv, k_rope)), the latent cache."""
    dt = torch_dtype(cfg.dtype)
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_r = _mla_latent(p, cfg, x, positions)
    k_nope = to_heads(c_kv, p["w_uk"].to(dt))
    v = to_heads(c_kv, p["w_uv"].to(dt))
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_r[:, :, None].expand(
        B, S, H, cfg.qk_rope_head_dim)], dim=-1)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    out = attention(q_cat, k_cat, v, causal=True, q_pos=positions,
                    kv_pos=positions, chunk=cfg.attn_chunk, scale=scale)
    out = from_heads(out, p["wo"].to(dt))
    return out, (c_kv, k_r)


def mla_decode(p, cfg, x, cache, pos):
    """Absorbed-matrix MLA decode against a cache of the latent only,
    {"c_kv" (B, Smax, kv_lora_rank), "k_rope" (B, Smax, qk_rope)}:
    ``W_uk`` is folded into the query and ``W_uv`` applied after the
    weighted sum of latents. ``pos`` is an int or a 0-d device tensor."""
    dt = torch_dtype(cfg.dtype)
    B = x.shape[0]
    if isinstance(pos, torch.Tensor):
        positions = pos.reshape(1, 1).expand(B, 1)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_new, kr_new = _mla_latent(p, cfg, x, positions)
    c_kv = _masked_cache_write(cache["c_kv"], c_new, pos)
    k_r = _masked_cache_write(cache["k_rope"], kr_new, pos)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, p["w_uk"].to(dt))
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshl,btl->bhst", q_lat, c_kv.to(dt))
              + torch.einsum("bshd,btd->bhst", q_rope, k_r.to(dt))) * scale
    valid = torch.arange(c_kv.shape[1], device=x.device)[None, :] <= pos
    scores = scores.float().masked_fill(~valid[:, None, None], -math.inf)
    w = torch.softmax(scores, dim=-1).to(dt)
    lat_out = torch.einsum("bhst,btl->bshl", w, c_kv.to(dt))
    out = torch.einsum("bshl,lhd->bshd", lat_out, p["w_uv"].to(dt))
    out = torch.einsum("bshd,hde->bse", out, p["wo"].to(dt))
    return out, {"c_kv": c_kv, "k_rope": k_r}


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


# ----------------------------------------------------------------------
# MoE: top-k router, then the dense (GShard one-hot) or the sort-based
# capacity dispatch

# the dense dispatch up to this many (token, expert) pairs (T * N)
_DENSE_MAX = 1 << 22


def moe_specs(cfg):
    E, F_, N = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    sp = {
        "router": ParamSpec((E, N), ("embed_fsdp", None), scale=E ** -0.5),
        "w1": ParamSpec((N, E, F_), ("experts", "embed_fsdp", "moe_ff")),
        "w3": ParamSpec((N, E, F_), ("experts", "embed_fsdp", "moe_ff")),
        "w2": ParamSpec((N, F_, E), ("experts", "moe_ff", "embed_fsdp")),
    }
    if cfg.num_shared_experts:
        sp["shared"] = ffn_specs(cfg,
                                 d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return sp


def top_k(probs, k):
    """The ``k`` largest values along the last axis and their indices,
    largest first, the lower index first among equal values, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order on
    ties, which bf16 router logits make common)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, cfg, x):
    """The router over (B, S, E) activations: logits in the compute dtype
    cast to fp32, softmax, top-k, the gates renormalised over the k.
    Returns (probs (B,S,N) fp32, gate (B,S,k) fp32, idx (B,S,k))."""
    logits = torch.einsum("bse,ef->bsf", x, p["router"].to(
        torch_dtype(cfg.dtype))).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def capacity(cfg, T):
    """Slots an expert has for T tokens: the capacity factor's share of
    the T * top_k entries, rounded up to 8 (the dense dispatch counts all
    B * S tokens, the sort-based one each batch row's S)."""
    cap = max(int(cfg.capacity_factor * T * cfg.top_k / cfg.num_experts), 1)
    return -(-cap // 8) * 8


def dense_slots(idxf, N, cap):
    """Each (token, j) entry's slot in its expert's buffer, counted in
    token-major order over all T tokens, and whether it is below ``cap``
    (the entries at or past it are dropped). idxf: (T, k).

    The reference's running count of its (T * k, N) one-hot along the
    entries, taken here along the innermost axis of the (N, T * k)
    one-hot: the same integers, but a CUDA scan along an outer axis runs
    one thread a column (on an H100, 6.1 ms against 0.09 ms for the
    32768 x 40 entries of a 4 x 1024 prompt at top-8 of 40)."""
    T, k = idxf.shape
    flat = idxf.reshape(1, T * k)
    onehot = (torch.arange(N, device=idxf.device)[:, None] == flat).to(
        torch.int32)                                           # (N,T*k)
    run = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(run, 0, flat).reshape(T, k)             # (T,k)
    return pos, pos < cap


def dispatch_mask(idxf, pos, inside, N, cap, dtype):
    """The dense dispatch tensor (T, N, cap): 1 at (t, idx[t, j],
    pos[t, j]) for each entry inside capacity. Written by one scatter
    instead of the reference's (T, k, N, cap) one-hot product summed over
    k; the two are equal because a token's k experts are distinct, so no
    two entries share a slot (a dropped entry writes 0 at its clamped
    slot, in its own expert's row)."""
    T = idxf.shape[0]
    slot = idxf * cap + torch.clamp(pos, max=cap - 1)
    disp = torch.zeros((T, N * cap), dtype=dtype, device=idxf.device)
    disp.scatter_(1, slot, inside.to(dtype))
    return disp.reshape(T, N, cap)


# expert buffers (experts, capacity, d_model), placed by their experts
_EXPERTS = ("experts_act", None, None)


def _dispatch_product(disp, xf):
    """einsum("tnc,te->nce"); under a mesh one product over the (N, cap)
    slots flattened expert-major (see ``to_heads``)."""
    if current() is None:
        return torch.einsum("tnc,te->nce", disp, xf)
    T, N, cap = disp.shape
    E = xf.shape[1]
    buf = disp.reshape(T, N * cap).transpose(0, 1) @ xf
    buf = constrain(buf, ("experts_act", None), (N, E))
    return constrain(buf.reshape(N, cap, E), _EXPERTS)


def _combine_product(w, out_buf):
    """einsum("tnc,nce->te"); under a mesh one product over the (N, cap)
    slots flattened expert-major."""
    if current() is None:
        return torch.einsum("tnc,nce->te", w, out_buf)
    T, N, cap = w.shape
    E = out_buf.shape[2]
    flat = constrain(constrain(out_buf, _EXPERTS).reshape(N * cap, E),
                     ("experts_act", None), (N, E))
    return w.reshape(T, N * cap) @ flat


def _dense_dispatch(idxf, N, cap, dtype):
    """``dispatch_mask`` of the slots ``dense_slots`` counts. Under a mesh
    the count runs over every token of the batch, so each rank counts
    them all from the gathered (T, k) indices, and the dispatch tensor is
    replicated."""
    ctx = current()
    full = idxf.full_tensor() if ctx is not None else idxf
    pos, inside = dense_slots(full, N, cap)
    disp = dispatch_mask(full, pos, inside, N, cap, dtype)
    return disp if ctx is None else as_dtensor(disp, ctx[1])


def _expert_ffn(p, cfg, buf):
    """buf: (experts, cap, E) -> (experts, cap, E), SwiGLU per expert."""
    dt = torch_dtype(cfg.dtype)
    h = F.silu(torch.einsum("xcd,xdf->xcf", buf, p["w1"].to(dt))) \
        * torch.einsum("xcd,xdf->xcf", buf, p["w3"].to(dt))
    return torch.einsum("xcf,xfd->xcd", h, p["w2"].to(dt))


def moe(p, cfg, x):
    """Mixture of experts over (B, S, E) activations -> (out, aux).

    ``aux`` is the Switch load-balancing loss N * sum(me * ce). The
    dispatch is the dense one (every token against every expert slot, by
    two contractions with the dispatch tensor) when ``moe_dispatch`` is
    "dense" or T * N <= ``_DENSE_MAX``, else the sort-based one; they drop
    different entries (capacity over all T tokens, or per batch row), so
    the choice is the reference's, exactly."""
    B, S, E = x.shape
    dt = torch_dtype(cfg.dtype)
    T = B * S
    k, N = cfg.top_k, cfg.num_experts
    probs, gate, idx = route(p, cfg, x)

    me = probs.mean(dim=(0, 1))
    ce = (idx[..., None] == torch.arange(N, device=x.device)).float().sum(
        dim=(0, 1, 2)) / (T * k)
    aux = N * torch.sum(me * ce)

    if cfg.moe_dispatch == "dense" or T * N <= _DENSE_MAX:
        # the tokens split as the batch is, on both sides of the views
        xf = constrain(x.reshape(T, E), ("batch", None), (B, E))
        idxf, gatef = idx.reshape(T, k), constrain(gate.reshape(T, k),
                                                   ("batch", None), (B, k))
        cap = capacity(cfg, T)
        disp = _dense_dispatch(idxf, N, cap, dt)
        buf = _dispatch_product(disp, xf.to(dt))
        out_buf = _expert_ffn(p, cfg, buf)
        gates_tn = ((idxf[..., None] == torch.arange(N, device=x.device))
                    .float() * gatef[..., None]).sum(1)
        # the reference's einsum("tnc,nce,tn->te"), in a fixed order: the
        # gates onto the 0/1 dispatch tensor (exact), then one contraction
        yf = _combine_product(disp * gates_tn.to(dt)[..., None], out_buf)
        y = constrain(constrain(yf, ("batch", None), (B, E)).reshape(B, S, E),
                      ("batch", None, None))
    else:
        y = _moe_scatter_dispatch(p, cfg, x, idx, gate,
                                  current_mesh())

    if cfg.num_shared_experts:
        # added whole along the sequence, as the routed experts' output
        y = y + constrain(ffn(p["shared"], cfg, x), ("batch", None, None))
    return y, aux


def _sorted_slots(e_flat, N):
    """Each row's entries sorted by expert (stable): (order, counts (R,N),
    exclusive starts (R,N)). e_flat: (R, L) experts of (token, j)."""
    order = torch.argsort(e_flat, dim=-1, stable=True)
    counts = (e_flat[..., None] == torch.arange(N, device=e_flat.device)
              ).to(torch.int64).sum(1)
    return order, counts, torch.cumsum(counts, dim=-1) - counts


def _group_dispatch(x, e_flat, k, N, cap):
    """Each row's expert buffers: x (R, S, E), e_flat (R, S * k) -> (R, N,
    cap, E), slot (n, c) holding the c-th entry routed to expert n (0
    past the count)."""
    R, _, E = x.shape
    L = e_flat.shape[1]
    dev = x.device
    order, counts, starts = _sorted_slots(e_flat, N)
    # for each buffer slot (n, c), which sorted entry?
    slot_n = torch.arange(N * cap, device=dev) // cap
    slot_c = torch.arange(N * cap, device=dev) % cap
    src = starts[:, slot_n] + slot_c                    # (R,N*cap)
    valid = slot_c[None] < counts[:, slot_n]
    entry = torch.gather(order, 1, torch.clamp(src, max=L - 1))
    tok = entry // k
    xbuf = torch.gather(x, 1, tok[..., None].expand(R, N * cap, E)) \
        * valid[..., None].to(x.dtype)
    return xbuf.reshape(R, N, cap, E)


def _group_combine(out_flat, e_flat, g_flat, k, N, cap):
    """Each (token, j) entry reads its slot back, weighted by its gate, 0
    where dropped: out_flat (R, N * cap, E) -> (R, S, E)."""
    R, _, E = out_flat.shape
    L = e_flat.shape[1]
    order, _, starts = _sorted_slots(e_flat, N)
    inv = torch.argsort(order, dim=-1)                  # entry -> sorted pos
    rank = inv - torch.gather(starts, 1, e_flat)
    inside = rank < cap
    slot = torch.clamp(e_flat * cap + rank, max=N * cap - 1)
    y_ent = torch.gather(out_flat, 1, slot[..., None].expand(R, L, E))
    y_ent = y_ent * (g_flat * inside.float())[..., None].to(out_flat.dtype)
    return y_ent.reshape(R, L // k, k, E).sum(2)


def _group_experts(p, dt, buf):
    """Each expert's SwiGLU over its slots of every (row, group): buf
    (B, G, N, cap, E) -> the same shape. Under a mesh, three batched
    products over the experts, their (row, group, slot) dims flattened
    batch-major and held so on both sides of the views (see ``merged``):
    an einsum's own flattening leaves a rank's block of them
    non-contiguous, which DTensor's views reject."""
    w1, w3, w2 = (p[k].to(dt) for k in ("w1", "w3", "w2"))
    if current() is None:
        h = F.silu(torch.einsum("bgxcd,xdf->bgxcf", buf, w1)) \
            * torch.einsum("bgxcd,xdf->bgxcf", buf, w3)
        return torch.einsum("bgxcf,xfd->bgxcd", h, w2)
    B, G, N, cap, E = buf.shape
    flat = ("experts_act", "batch", None)
    xb = constrain(constrain(buf.permute(2, 0, 1, 3, 4), _SLOTS).reshape(
        N, B * G * cap, E), flat, (N, B, E))
    h = F.silu(torch.bmm(xb, w1)) * torch.bmm(xb, w3)
    out = constrain(torch.bmm(h, w2), flat, (N, B, E))
    return constrain(out.reshape(N, B, G, cap, E), _SLOTS).permute(
        1, 2, 0, 3, 4)


# expert-major slot buffers (experts, batch, groups, capacity, d_model)
_SLOTS = ("experts_act", "batch", None, None, None)


def _moe_scatter_dispatch(p, cfg, x, idx, gate, mesh=None):
    """Sort-based (MegaBlocks-style) capacity dispatch, gathers only.

    Each batch row's sequence splits into G groups, G the size of the
    mesh's ``model`` axis (1 without a mesh, or where it does not divide
    S), and capacity is counted per (row, group) of S / G tokens. In each
    group the entries are sorted by expert (stable), each expert's
    ``cap`` buffer slots gather their tokens, the experts run, and each
    (token, j) entry reads its slot back, weighted by its gate, 0 where
    dropped. Under ``axis_rules`` a rank sorts and gathers its own (row,
    group) blocks (``run_local``), and the buffers move between group and
    expert sharding by ``constrain``: the expert-parallel all-to-all."""
    dt = torch_dtype(cfg.dtype)
    B, S, E = x.shape
    k, N = cfg.top_k, cfg.num_experts
    G = axis_size(mesh, "model")
    if S % G:
        G = 1
    S_loc = S // G
    L = S_loc * k
    cap = capacity(cfg, S_loc)
    grp = ("batch", "seq_group", None)

    xg = constrain(x.reshape(B, G, S_loc, E), ("batch", "seq_group", None,
                                                None))
    e_flat = idx.reshape(B, G, L)                       # expert of (tok, j)
    g_flat = gate.reshape(B, G, L)

    def dispatch(xg, e):
        b, g = e.shape[:2]
        buf = _group_dispatch(xg.reshape(b * g, S_loc, E),
                              e.reshape(b * g, L), k, N, cap)
        return buf.reshape(b, g, N, cap, E)

    buf = run_local(dispatch, (xg, e_flat), (grp + (None,), grp),
                    [(grp + (None, None), (B, G, N, cap, E))])
    # the all-to-all: group sharding -> expert sharding
    buf = constrain(buf, ("batch", None, "experts_act", None, None))
    out_buf = _group_experts(p, dt, buf)
    # expert sharding kept on the product's output, so its weight
    # gradient sees both operands expert-sharded
    out_buf = constrain(out_buf, ("batch", None, "experts_act", None, None))
    out_flat = out_buf.reshape(B, G, N * cap, E)
    # the reverse all-to-all, back to group sharding for the combine
    out_flat = constrain(out_flat, grp + (None,))

    def combine(out, e, g):
        b, gg = e.shape[:2]
        y = _group_combine(out.reshape(b * gg, N * cap, E),
                           e.reshape(b * gg, L), g.reshape(b * gg, L),
                           k, N, cap)
        return y.reshape(b, gg, S_loc, E)

    y = run_local(combine, (out_flat, e_flat, g_flat),
                  (grp + (None,), grp, grp),
                  [(grp + (None,), (B, G, S_loc, E))])
    y = constrain(y, grp + (None,))
    return y.reshape(B, S, E).to(dt)
