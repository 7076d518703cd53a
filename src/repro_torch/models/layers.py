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

Under a mesh the reference's split-KV decode holds (its
``gqa_decode`` and ``mla_decode`` constraints): a decode cache is split
along its sequence (``kv_seq``), the query and the attention output are
replicated over that split, and each rank attends over its own block,
the blocks' softmax statistics merged in rank order; a serving lookup is
vocab-parallel. Where the ``model`` axis has size 1 the products take the
unsharded op sequence, so a (1, 1) mesh computes the unsharded bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models.spec import ParamSpec
from repro_torch.sharding.rules import (as_dtensor, axis_rules, axis_size,
                                        axis_sizes, constrain, current,
                                        current_mesh, logical_spec,
                                        run_local, serving)

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
    partial sum), not through DTensor's indexing strategies; in a serving
    step, vocab-parallel (``_lookup_vocab_parallel``)."""
    if current() is None:
        return table[idx.long()]
    if serving():
        return _lookup_vocab_parallel(table, idx)
    B, S = idx.shape
    return run_local(lambda t, i: t[i.long()], (table, idx),
                     ((None, None), ("batch", "seq")),
                     [(("batch", "seq", None), (B, S, table.shape[1]))])


def _lookup_vocab_parallel(table, idx):
    """``lookup`` with the table left where its placements put it
    (Megatron's vocab-parallel embedding): each rank looks every index up
    in its block of rows and columns, zero where the row is another
    rank's, the blocks summed over the vocab's split (an exact sum: one
    row and zeros) and their columns moved to the batch's split. Only the
    indices and the looked-up rows move, never the table."""
    B, S = idx.shape
    V, E = table.shape
    rules, mesh = current()
    entry = logical_spec(("vocab", "embed_fsdp"), (V, E), rules, mesh)[0]
    split = () if entry is None else (entry if isinstance(entry, tuple)
                                      else (entry,))

    def local(t, rows, i):
        j = i.long() - rows[0]
        inside = (j >= 0) & (j < t.shape[0])
        picked = t[j.clamp(0, t.shape[0] - 1)]
        return torch.where(inside[..., None], picked,
                           torch.zeros((), dtype=t.dtype, device=t.device))
    rows = torch.arange(V, device=table.device)
    out = run_local(local, (table, rows, idx),
                    (("vocab", "embed_fsdp"), ("vocab",), (None, None)),
                    [((None, None, "embed_fsdp"), (B, S, E), split)])
    return constrain(out, ("batch", None, None))


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


def _mesh_axes(entry) -> tuple:
    """A spec entry's mesh axes: () for None, a tuple for a joint one."""
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def stationary(eq, x, w, w_axes, out_axes, shape):
    """``torch.einsum(eq, x, w)`` of a few tokens' activations x (B, S, K)
    and a weight w (K, ...) of logical axes ``w_axes``, the weight left on
    its placements: x moved to the split of K and whole along the batch
    but for its split over mesh axes that split no dim of w (``pod``'s
    model replicas), each rank's product a partial sum over the split of
    K, reduced onto ``out_axes`` (global ``shape``). A serving step's
    products thus move activations, not weights. None where that would
    not move fewer bytes than gathering the weight's block along K, as
    ``column`` does: no mesh, a training step (its gradients keep the
    weights' placements), no mesh axis splitting K, or a prefill's many
    tokens."""
    if not serving():
        return None
    rules, mesh = current()
    spec = logical_spec(w_axes, tuple(w.shape), rules, mesh)
    sizes = axis_sizes(mesh)
    split = _mesh_axes(spec[0])
    d = math.prod(sizes[a] for a in split)
    K = w.shape[0]
    n = math.prod(w.shape[1:]) // math.prod(
        sizes[a] for e in spec[1:] for a in _mesh_axes(e))
    held = {a for e in spec for a in _mesh_axes(e)}
    kept = tuple(a for a in _mesh_axes(logical_spec(
        ("batch",), x.shape[:1], rules, mesh)[0]) if a not in held)
    rows = x.shape[0] * x.shape[1] // math.prod(sizes[a] for a in kept)
    # per rank: x's rows and the partial outputs, against w's block of K
    if d == 1 or rows * (K + n) >= d * K * n:
        return None
    # the batch's kept split as a logical axis of its own
    with axis_rules({**rules, _KEPT: (kept or None,)}, mesh, serving=True):
        out = run_local(lambda a, b: torch.einsum(eq, a, b), (x, w),
                        ((_KEPT, None, w_axes[0]), w_axes),
                        [((_KEPT, None, *w_axes[1:]), shape, split)])
    # the partial sums reduced onto the batch's split first: a gather of
    # the other dims before it would move every row of them
    return constrain(constrain(out, ("batch", None, *w_axes[1:])), out_axes)


_KEPT = "batch_kept"


def column(eq, x, w, axes, shape):
    """``torch.einsum(eq, x, w)`` of an activation x (B, S, E) and a
    weight w (E, ...) -> an output whose dims ``axes`` place, of global
    ``shape``. Under a mesh it is a column-parallel product in
    ``run_local``: x whole along E and along the sequence, w gathered
    along E and split as the output's trailing dims, each rank
    multiplying its rows by its columns. No partial sums, and nothing for
    DTensor to plan: its own plan of such a product could split the
    flattened (batch, seq) rows over a mesh axis, a strided shard. A
    serving step's few tokens move instead of the weight
    (``stationary``)."""
    if current() is None:
        return torch.einsum(eq, x, w)
    out = stationary(eq, x, w, ("embed_fsdp", *axes[2:]), axes, shape)
    if out is not None:
        return out
    return run_local(lambda a, b: torch.einsum(eq, a, b), (x, w),
                     (("batch", None, None), (None, *axes[2:])),
                     [(axes, shape)])


def to_heads(x, w):
    """x (B, S, E) against w (E, H, D) -> (B, S, H, D): the reference's
    einsum("bse,ehd->bshd"), column-parallel over the heads under a mesh
    (``column``)."""
    E, H, D = w.shape
    return column("bse,ehd->bshd", x, w, _HEADS, (*x.shape[:2], H, D))


def _heads_whole() -> bool:
    """No mesh, or one whose ``model`` axis has size 1: nothing splits
    the heads (nor the experts), so a product runs the unsharded op
    sequence, and a (1, 1) mesh computes the unsharded bits."""
    return axis_size(current_mesh(), "model") == 1


def from_heads(x, w):
    """x (B, S, H, D) against w (H, D, E) -> (B, S, E): the reference's
    einsum("bshd,hde->bse"), one head-major product under a mesh whose
    ``model`` axis splits the heads (see ``to_heads``)."""
    if _heads_whole():
        return torch.einsum("bshd,hde->bse", x, w)
    H, D, E = w.shape
    B, S = x.shape[:2]
    x = constrain(constrain(x, _HEADS).reshape(B, S, H * D), _HEADS_FLAT,
                  (B, S, H))
    w = merged(w, 0)
    out = stationary("bsk,ke->bse", x, w, ("heads", "embed_fsdp"),
                     ("batch", None, None), (B, S, E))
    return x @ w if out is None else out


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


def _masked_cache_write(cache_arr, new, pos, iota=None):
    """Write ``new`` (B,1,...) at sequence index ``pos`` through an iota
    mask, as the reference does: ``pos`` may be a Python int or a 0-d
    tensor on the cache's device (a CUDA graph's static position).
    ``iota`` holds the positions of the cache's rows (a rank's block of
    them under a split-KV decode; ``arange`` of its length by default),
    so the write stays local under any split of the sequence."""
    S = cache_arr.shape[1]
    if iota is None:
        iota = torch.arange(S, device=cache_arr.device)
    iota = iota.reshape((1, S) + (1,) * (cache_arr.ndim - 2))
    return torch.where(iota == pos, new.to(cache_arr.dtype), cache_arr)


# ----------------------------------------------------------------------
# split-KV decode (FlashDecoding): under a mesh that splits a decode
# cache's sequence, the one query is replicated over the split, each rank
# attends over its own block of the cache (its running max, sum and
# unnormalised output), and the blocks' statistics are reduced over the
# split: their maximum, then their rescaled sums, the output's summed
# into the heads' split. Only the query, the new K and V and the
# statistics move; a cache block never does.

# a decode cache's logical axes: GQA's K and V, MLA's latent and rope key
_KV_CACHE = ("batch", "kv_seq", "kv_heads", None)
_LATENT_CACHE = ("batch", "kv_seq", None)
# a one-token activation replicated over every axis but the batch's
_REPLICATED = ("batch", None, None, None)
# the per-block statistics (batch, heads, blocks[, dim]), the blocks split
# as the cache's sequence is
_STATS = ("batch", None, "kv_seq")
_STATS_ACC = ("batch", None, "kv_seq", None)


def _seq_split(axes, shape) -> tuple:
    """The mesh axes that split a decode cache's sequence (dim 1) under
    the ambient mesh; () outside a mesh or where none of more than one
    rank splits it."""
    ctx = current()
    if ctx is None:
        return ()
    sizes = axis_sizes(ctx[1])
    return tuple(a for a in _mesh_axes(logical_spec(axes, shape, *ctx)[1])
                 if sizes[a] > 1)


def _pos_axes(pos):
    """``run_local``'s axes for a decode position: an int passes through,
    a 0-d tensor is replicated."""
    return () if isinstance(pos, torch.Tensor) else None


def _block_stats(s, valid, weigh):
    """One block's softmax statistics: s (b,H,1,T) fp32 scores, ``valid``
    (T,) the positions attended, ``weigh`` the weighted sum of the
    block's values by fp32 weights (b,H,1,T) -> (running max (b,H,1), sum
    of exponents (b,H,1), unnormalised output (b,H,1,Dv) fp32). A block
    with no valid position has max -inf and zero sum and output."""
    s = s.masked_fill(~valid, -math.inf)
    m = s.amax(dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, zero)[..., None])
    return m, p.sum(dim=-1), weigh(p).float()


def _rescaled(m, l, acc, top):
    """A rank's blocks rescaled to the global max ``top`` (b,H) and summed
    over its blocks: m, l (b,H,k), acc (b,H,k,Dv) -> (sum (b,H), output
    (b,H,Dv)), terms of the sums over every block."""
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    corr = torch.where(torch.isfinite(m), torch.exp(m - top[..., None]),
                       zero)
    return (l * corr).sum(dim=-1), (acc * corr[..., None]).sum(dim=2)


def _split_kv(core, args, in_axes, caches, stats_shape, split):
    """``core(*local args)`` -> (new cache blocks..., m, l, acc) on each
    rank's block of the caches (``run_local``), then the statistics
    reduced over the mesh axes ``split``: the max gathered (B·H·n
    values), each rank's output rescaled to it, and the sums reduced,
    the output's into the heads' split -> (output (B,1,H,Dv) fp32 split
    by its heads, new caches on their axes). ``caches``: (logical axes,
    shape) of each cache output; ``stats_shape``: (B, H, Dv)."""
    B, H, Dv = stats_shape
    n = math.prod(axis_sizes(current_mesh())[a] for a in split)
    outs = run_local(core, args, in_axes,
                     [*caches, (_STATS, (B, H, n)), (_STATS, (B, H, n)),
                      (_STATS_ACC, (B, H, n, Dv))])
    m, l, acc = outs[-3:]
    top = constrain(m, ("batch", None, None)).amax(dim=-1)
    l, acc = run_local(_rescaled, (m, l, acc, top),
                       (_STATS, _STATS, _STATS_ACC, ("batch", None)),
                       [(("batch", None), (B, H), split),
                        (("batch", None, None), (B, H, Dv), split)])
    l = constrain(l, ("batch", None))
    acc = constrain(acc, ("batch", "heads_act", None))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return constrain(out[:, None], _HEADS), outs[:-3]


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
    split = _seq_split(_KV_CACHE, cache["k"].shape)
    if split:
        return _gqa_decode_split(p, cfg, q, k_new, v_new, cache, pos, split)
    k = _masked_cache_write(cache["k"], k_new, pos)
    v = _masked_cache_write(cache["v"], v_new, pos)
    kv_pos = torch.arange(k.shape[1], device=x.device)[None].expand(
        B, k.shape[1])
    out = attention(q, k.to(dt), v.to(dt), causal=True, q_pos=positions,
                    kv_pos=kv_pos, chunk=cfg.attn_chunk)
    out = from_heads(out, p["wo"].to(dt))
    # under a mesh the caches stay where a decode cell places them
    return out, {"k": constrain(k, _KV_CACHE), "v": constrain(v, _KV_CACHE)}


def _gqa_decode_split(p, cfg, q, k_new, v_new, cache, pos, split):
    """``gqa_decode``'s attention split over the blocks the mesh axes
    ``split`` make of the cache's sequence (see ``_split_kv``): the query
    and the new K and V
    replicated over the split, each rank writing and attending over its
    own block of K and V (whole along the heads), the blocks merged."""
    dt = torch_dtype(cfg.dtype)
    B, S, KV, D = cache["k"].shape
    H, Dv = q.shape[2], cache["v"].shape[3]
    scale = q.shape[-1] ** -0.5
    # the cache's heads whole inside: a query of every head meets them
    blk = ("batch", "kv_seq", None, None)

    def core(q, kc, vc, kn, vn, t, pos):
        k = _masked_cache_write(kc, kn, pos, t)
        v = _masked_cache_write(vc, vn, pos, t)
        kk, vv = k.to(dt), v.to(dt)
        if KV != H:  # GQA: expand K and V to the full head count
            kk = torch.repeat_interleave(kk, H // KV, dim=2)
            vv = torch.repeat_interleave(vv, H // KV, dim=2)
        s = (torch.einsum("bshd,bthd->bhst", q, kk) * scale).float()
        return (k, v, *_block_stats(s, t <= pos, lambda w: torch.einsum(
            "bhst,bthd->bhsd", w.to(vv.dtype), vv)))

    t = torch.arange(S, device=cache["k"].device)
    out, (k, v) = _split_kv(
        core, (q, cache["k"], cache["v"], k_new, v_new, t, pos),
        (_REPLICATED, blk, blk, _REPLICATED, _REPLICATED, ("kv_seq",),
         _pos_axes(pos)),
        [(blk, (B, S, KV, D)), (blk, (B, S, KV, Dv))], (B, H, Dv), split)
    out = from_heads(out.to(q.dtype), p["wo"].to(dt))
    return out, {"k": constrain(k, _KV_CACHE), "v": constrain(v, _KV_CACHE)}


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


def per_head(eq, x, w, dim):
    """``torch.einsum(eq, x, w)`` of an activation x (B, S, H, ·) and a
    weight w (·, H, ·) whose heads are not contracted -> (B, S, H, dim).
    Under a mesh each rank multiplies its own heads (``run_local``)."""
    if current() is None:
        return torch.einsum(eq, x, w)
    return run_local(lambda a, b: torch.einsum(eq, a, b), (x, w),
                     (_HEADS, (None, "heads", None)),
                     [(_HEADS, (*x.shape[:3], dim))])


def mla_decode(p, cfg, x, cache, pos):
    """Absorbed-matrix MLA decode against a cache of the latent only,
    {"c_kv" (B, Smax, kv_lora_rank), "k_rope" (B, Smax, qk_rope)}:
    ``W_uk`` is folded into the query and ``W_uv`` applied after the
    weighted sum of latents. ``pos`` is an int or a 0-d device tensor.

    Under a mesh the query's latent ``q_lat`` and its rope part are
    replicated over the split of the cache's sequence, each rank writing
    and attending over its own block of ``c_kv`` and ``k_rope``, the
    blocks reduced into the heads' split (``_split_kv``); without a split
    each rank runs the unsharded op sequence on its rows. ``W_uk``,
    ``W_uv`` and ``wo`` multiply each rank's heads."""
    dt = torch_dtype(cfg.dtype)
    B, S, Lr = cache["c_kv"].shape
    if isinstance(pos, torch.Tensor):
        positions = pos.reshape(1, 1).expand(B, 1)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_new, kr_new = _mla_latent(p, cfg, x, positions)
    H = q_nope.shape[2]
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    q_lat = per_head("bshd,lhd->bshl", q_nope, p["w_uk"].to(dt), Lr)
    split = _seq_split(_LATENT_CACHE, cache["c_kv"].shape)
    t = torch.arange(S, device=cache["c_kv"].device)

    def core(q_lat, q_rope, cc, kc, cn, kn, t, pos):
        c_kv = _masked_cache_write(cc, cn, pos, t)
        k_r = _masked_cache_write(kc, kn, pos, t)
        s = ((torch.einsum("bshl,btl->bhst", q_lat, c_kv.to(dt))
              + torch.einsum("bshd,btd->bhst", q_rope, k_r.to(dt)))
             * scale).float()
        if split:
            return (c_kv, k_r, *_block_stats(s, t <= pos, lambda w:
                                             torch.einsum("bhst,btl->bhsl",
                                                          w.to(dt),
                                                          c_kv.to(dt))))
        w = torch.softmax(s.masked_fill(~(t <= pos)[None, None, None],
                                        -math.inf), dim=-1).to(dt)
        return c_kv, k_r, torch.einsum("bhst,btl->bshl", w, c_kv.to(dt))

    args = (q_lat, q_rope, cache["c_kv"], cache["k_rope"], c_new, kr_new, t,
            pos)
    in_axes = (_REPLICATED, _REPLICATED, _LATENT_CACHE, _LATENT_CACHE,
               ("batch", None, None), ("batch", None, None), ("kv_seq",),
               _pos_axes(pos))
    caches = [(_LATENT_CACHE, tuple(cache["c_kv"].shape)),
              (_LATENT_CACHE, tuple(cache["k_rope"].shape))]
    if split:
        lat_out, (c_kv, k_r) = _split_kv(core, args, in_axes, caches,
                                         (B, H, Lr), split)
        lat_out = lat_out.to(dt)
    else:
        c_kv, k_r, lat_out = run_local(core, args, in_axes, [
            *caches, (_REPLICATED, (B, 1, H, Lr))])
    out = per_head("bshl,lhd->bshd", lat_out, p["w_uv"].to(dt),
                   cfg.v_head_dim)
    out = from_heads(out, p["wo"].to(dt))
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


def matmul(x, w, w_axes, out_axes):
    """``x @ w`` of activations x (B, S, K) and a weight w (K, N) of
    logical axes ``w_axes``: DTensor's product under a mesh, or, for a
    serving step's few tokens, ``stationary``'s onto ``out_axes``."""
    out = stationary("bsk,kn->bsn", x, w, w_axes, out_axes,
                     (*x.shape[:2], w.shape[1]))
    return x @ w if out is None else out


def ffn(p, cfg, x):
    """SwiGLU where the params have ``w3``, else the GELU MLP with the
    tanh approximation (``jax.nn.gelu``'s default)."""
    dt = torch_dtype(cfg.dtype)
    up, down = ("embed_fsdp", "d_ff"), ("d_ff", "embed_fsdp")
    hidden = ("batch", None, "d_ff")

    def into(w):
        return matmul(x, p[w].to(dt), up, hidden)
    if "w3" in p:
        h = F.silu(into("w1")) * into("w3")
        return matmul(h, p["w2"].to(dt), down, _REPLICATED[:3])
    h = F.gelu(into("w1") + p["b1"].to(dt), approximate="tanh")
    return matmul(h, p["w2"].to(dt), down, _REPLICATED[:3]) \
        + p["b2"].to(dt)


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
    if _heads_whole():
        return torch.einsum("tnc,te->nce", disp, xf)
    T, N, cap = disp.shape
    E = xf.shape[1]
    if serving() and T < N * cap:
        # serving's few tokens gathered, not every slot's partial sums
        return run_local(lambda d, x: torch.einsum("tnc,te->nce", d, x),
                         (disp, xf), ((None, "experts_act", None),
                                      (None, None)),
                         [(_EXPERTS, (N, cap, E))])
    buf = disp.reshape(T, N * cap).transpose(0, 1) @ xf
    buf = constrain(buf, ("experts_act", None), (N, E))
    return constrain(buf.reshape(N, cap, E), _EXPERTS)


def _combine_product(w, out_buf):
    """einsum("tnc,nce->te"); under a mesh one product over the (N, cap)
    slots flattened expert-major."""
    if _heads_whole():
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
    if _heads_whole():
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
