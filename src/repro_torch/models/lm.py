"""Decoder-only LM assembly (``repro/models/lm.py``): layer planning,
segments of stacked layers, caches, forward and decode.

A config's layers are planned as (mixer, ffn) pairs, then grouped into
repeating segments whose parameters are stacked along a leading layer
axis. The reference scans a segment with ``jax.lax.scan``; here a Python
loop over the layer index runs it, and the per-layer caches are stacked
back along the same axis. In training (``remat="full"``) each period of a
segment is rematerialized, as the reference checkpoints its scan body. A layer's mixer is Mamba-2, GQA or MLA, its
ffn dense, MoE or none: the ssm family (mamba2-370m) runs Mamba with no
ffn, the dense and moe families (qwen2-0.5b, granite-3-2b, granite-8b,
minitron-8b, internvl2-26b's backbone; granite-moe-3b-a800m,
deepseek-v2-236b) attention with an ffn, and the hybrid family
(jamba-1.5-large-398b) Mamba with a dense or MoE ffn beside GQA layers,
so one segment may hold Mamba ``conv``/``state`` caches and GQA ``k``/
``v`` caches side by side. A prefill pads each attention cache to
``cache_len`` as the reference does (a Mamba cache has a fixed size); an
MLA layer caches its latent (``c_kv``, ``k_rope``), not per-head K and
V. Each MoE layer's load-balancing loss is summed into the forward's
``aux``.

``LM`` is the network as an ``nn.Module``: its ``state_dict()`` keys are
the reference's parameter paths (``embed.table``,
``seg0.sub0.mamba.in_proj`` with its stacked (layers, ...) shape,
``ln_f.w``), so ``convert.params_from_reference`` carries the weights
across unchanged.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.module import SpecNetwork
from repro_torch.models.spec import stack_tree
from repro_torch.sharding.rules import constrain, current, sharded_region

Plan = tuple  # (mixer, ffn)
# the logical axes of an activation whole along the sequence
_WHOLE_SEQ = ("batch", None, "embed")

# ----------------------------------------------------------------------
# layer planning


def layer_plan(cfg) -> list[Plan]:
    plans = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.family == "hybrid":
            mixer = ("gqa" if cfg.attn_layer_period and
                     i % cfg.attn_layer_period == cfg.attn_layer_offset
                     else "mamba")
        else:
            mixer = cfg.attn_impl
        if cfg.family == "ssm":
            ffn = "none"
        elif (cfg.num_experts and i >= cfg.first_dense_layers
              and i % cfg.moe_layer_period == cfg.moe_layer_offset):
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "dense"
        else:
            ffn = "none"
        plans.append((mixer, ffn))
    return plans


def segments(cfg) -> list[tuple[tuple[Plan, ...], int]]:
    """Group the layer plan into (period_body, repeat_count) segments."""
    plans = layer_plan(cfg)
    pre = cfg.first_dense_layers
    out = [((p,), 1) for p in plans[:pre]]
    body = plans[pre:]
    if not body:
        return out
    m = len(body)
    for p in range(1, m + 1):
        if m % p == 0 and all(body[i] == body[i % p] for i in range(m)):
            out.append((tuple(body[:p]), m // p))
            return out
    out.append((tuple(body), 1))
    return out


# ----------------------------------------------------------------------
# per-layer block


def _check_plan(plan: Plan) -> None:
    mixer, ffn_kind = plan
    if mixer not in ("mamba", "gqa", "mla"):
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn_kind not in ("none", "dense", "moe"):
        raise ValueError(f"unknown ffn {ffn_kind!r}")


def block_specs(cfg, plan: Plan):
    _check_plan(plan)
    mixer, ffn_kind = plan
    sp = {"ln1": L.norm_spec(cfg.d_model)}
    if mixer == "gqa":
        sp["attn"] = L.gqa_specs(cfg)
    elif mixer == "mla":
        sp["attn"] = L.mla_specs(cfg)
    else:
        sp["mamba"] = S.mamba_specs(cfg)
    if ffn_kind != "none":
        sp["ln2"] = L.norm_spec(cfg.d_model)
        sp["ffn"] = L.moe_specs(cfg) if ffn_kind == "moe" \
            else L.ffn_specs(cfg)
    return sp


def cache_spec(cfg, plan: Plan, batch: int, max_seq: int):
    """Decode-cache entry for one layer: {name: (shape, dtype, axes)}.
    A GQA layer's K and V, and an MLA layer's latent ``c_kv`` and
    ``k_rope``, hold ``max_seq`` positions; a Mamba layer's cache does not
    grow with it."""
    _check_plan(plan)
    dt = torch_dtype(cfg.dtype)
    if plan[0] == "gqa":
        kvd = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        return {"k": (kvd, dt, ("batch", "kv_seq", "kv_heads", None)),
                "v": (kvd, dt, ("batch", "kv_seq", "kv_heads", None))}
    if plan[0] == "mla":
        return {"c_kv": ((batch, max_seq, cfg.kv_lora_rank), dt,
                         ("batch", "kv_seq", None)),
                "k_rope": ((batch, max_seq, cfg.qk_rope_head_dim), dt,
                           ("batch", "kv_seq", None))}
    d_inner, G, N, P, H, Hg, conv_ch = S._dims(cfg)
    return {"conv": ((batch, cfg.ssm_conv_k - 1, conv_ch), dt,
                     S.CONV_CACHE),
            "state": ((batch, G, Hg, P, N), dt, S.STATE_CACHE)}


def place_cache(cfg, plan: Plan, cache):
    """A layer's cache on the placements ``cache_spec`` gives a decode
    cell under the ambient mesh (a no-op without one): a prefill's caches
    are made as the layer computes them (K and V split by heads, a Mamba
    state by ``run_local``'s heads) and read by the decode step this
    way."""
    if current() is None:
        return cache
    axes = {k: ax for k, (_, _, ax) in cache_spec(cfg, plan, 1, 1).items()}
    return {k: constrain(a, axes[k]) for k, a in cache.items()}


def apply_block(p, cfg, plan: Plan, x, positions, *, mode, cache, pos,
                impl="auto"):
    """One layer. mode: train | prefill | decode. Returns (x, cache, aux):
    ``aux`` is an MoE layer's load-balancing loss, else 0. ``pos``
    (decode) is an int or a 0-d tensor on ``x``'s device."""
    _check_plan(plan)
    mixer, ffn_kind = plan
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # under a mesh a layer's input is whole along the sequence (the
    # residual stream is split along it): sequence parallelism's gather
    h = constrain(L.apply_norm(p["ln1"], x, cfg.norm_eps), _WHOLE_SEQ)
    new_cache = None
    if mixer == "gqa":
        if mode == "decode":
            out, new_cache = L.gqa_decode(p["attn"], cfg, h, cache, pos)
        else:
            out, (k, v) = L.gqa_attn(p["attn"], cfg, h, positions)
            if mode == "prefill":
                new_cache = {"k": k, "v": v}
    elif mixer == "mla":
        if mode == "decode":
            out, new_cache = L.mla_decode(p["attn"], cfg, h, cache, pos)
        else:
            out, (c_kv, k_r) = L.mla_attn(p["attn"], cfg, h, positions)
            if mode == "prefill":
                new_cache = {"c_kv": c_kv, "k_rope": k_r}
    elif mode == "decode":
        out, new_cache = S.mamba_decode(p["mamba"], cfg, h, cache, pos)
    else:
        out, new_cache = S.mamba_forward(p["mamba"], cfg, h,
                                         want_cache=(mode == "prefill"),
                                         impl=impl)
    # the layer's output is added whole along the sequence, so its
    # gradient comes back whole as well
    x = x + constrain(out, _WHOLE_SEQ)
    if ffn_kind != "none":
        h = constrain(L.apply_norm(p["ln2"], x, cfg.norm_eps), _WHOLE_SEQ)
        if ffn_kind == "moe":
            out, aux = L.moe(p["ffn"], cfg, h)
        else:
            out = L.ffn(p["ffn"], cfg, h)
        x = x + constrain(out, _WHOLE_SEQ)
    x = constrain(x, ("batch", "seq", "embed"))
    return x, new_cache, aux


# ----------------------------------------------------------------------
# cache padding: a prefill writes its caches for the prompt, padded to
# the decode length


def _pad_cache_seq(cfg, plan, cache, max_seq):
    """An attention layer's prefill cache zero-padded along its sequence
    axis to ``max_seq`` (never cut); a Mamba cache as it is."""
    mixer, _ = plan
    if cache is None or mixer == "mamba":
        return cache

    return {k: pad_seq(a, max_seq) for k, a in cache.items()}


def pad_seq(a, n):
    """``a`` zero-padded along dim 1 to length ``n`` (never cut). A
    DTensor pads each rank's block, whole along dim 1: DTensor's own pad
    (torch 2.11, on four cards) gave its output one placement on a
    two-dim mesh, and the constraint after it a block at the whole
    length."""
    s = a.shape[1]
    if s >= n:
        return a
    widths = (0, 0) * (a.ndim - 2) + (0, n - s)
    if not isinstance(a, DTensor):
        return F.pad(a, widths)
    mesh = a.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in a.placements]
    return _from_local(F.pad(a.redistribute(mesh, pl).to_local(), widths),
                       mesh, pl, (a.shape[0], n, *a.shape[2:]))


def _from_local(local, mesh, placements, shape):
    """``DTensor.from_local`` of each rank's block, its global ``shape``
    (contiguous) given, not inferred from the block."""
    stride = [1] * len(shape)
    for j in range(len(shape) - 2, -1, -1):
        stride[j] = stride[j + 1] * shape[j + 1]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


# ----------------------------------------------------------------------
# model-level specs and forward


def model_specs(cfg):
    sp = {"embed": L.embed_specs(cfg), "ln_f": L.norm_spec(cfg.d_model)}
    for si, (body, n) in enumerate(segments(cfg)):
        subs = {f"sub{j}": block_specs(cfg, pl) for j, pl in enumerate(body)}
        sp[f"seg{si}"] = stack_tree(subs, n) if n > 1 else subs
    return sp


def cache_struct(cfg, batch: int, max_seq: int):
    """Decode cache for the whole model, segment-structured, as
    {name: (shape, dtype, axes)} leaves; a segment of n > 1 layers stacks
    its entries along a leading layer axis."""
    out = {}
    for si, (body, n) in enumerate(segments(cfg)):
        subs = {}
        for j, pl in enumerate(body):
            entry = cache_spec(cfg, pl, batch, max_seq)
            if n > 1:
                entry = {k: ((n, *shp), dt, ("layer", *ax))
                         for k, (shp, dt, ax) in entry.items()}
            subs[f"sub{j}"] = entry
        out[f"seg{si}"] = subs
    return out


def _index(tree, i):
    """Layer ``i`` of a tree of stacked tensors; a DTensor's layer is
    taken from each rank's block (``_blockwise``)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return _blockwise([tree], lambda b: b[0][i], -1, tree.shape[1:])
    return tree[i]


def _stack(trees):
    """The per-layer trees stacked along a new leading layer axis;
    DTensors stack their blocks (``_blockwise``)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], DTensor):
        return _blockwise(trees, torch.stack, 1,
                          (len(trees), *trees[0].shape))
    return torch.stack(trees)


def _blockwise(ts, fn, shift, shape):
    """``fn`` of the blocks each rank holds of DTensors ``ts`` on one
    placement (the first one's; the others moved to it), its result on
    those placements with each split dim moved by ``shift``: a layer axis
    added (1) or taken (-1) in front, which no mesh axis splits; of global
    ``shape``. Every rank does the same local stack or select: nothing
    moves and DTensor plans nothing, and ``to_local`` and ``from_local``
    carry the gradient back the same way."""
    mesh, pl = ts[0].device_mesh, tuple(ts[0].placements)
    blocks = [(t if tuple(t.placements) == pl else
               t.redistribute(mesh, pl)).to_local() for t in ts]
    return _from_local(fn(blocks), mesh, [
        Shard(p.dim + shift) if isinstance(p, Shard) else p for p in pl],
        shape)


def remat(fn, cfg, mode):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when a
    train-mode forward records gradients and ``cfg.remat == "full"``: its
    activations are recomputed in the backward, as the reference's
    ``jax.checkpoint`` of a scanned layer; else ``fn``. No layer draws
    random numbers, so the RNG state is not kept."""
    if not (mode == "train" and cfg.remat == "full"
            and torch.is_grad_enabled()):
        return fn
    ctx = current()
    if ctx is None:
        def run(*args):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return run

    def sharded(*args):
        # the recompute may run on autograd's device thread: it re-enters
        # the forward's sharded region there
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              sharded_region(*ctx)))
    return sharded


def _run_segment(p_seg, cfg, body, n, x, positions, *, mode, caches, pos,
                 impl, cache_len=0):
    """Run one segment: a loop over its n layers when n > 1, each period
    rematerialized in training (``remat``). ``caches`` holds the per-sub
    trees, stacked when n > 1; a prefill pads each layer's attention
    cache to ``cache_len``."""
    def one_period(x, p_period, cache_period):
        new_caches = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, pl in enumerate(body):
            c_in = cache_period.get(f"sub{j}") if cache_period else None
            x, c_new, a = apply_block(p_period[f"sub{j}"], cfg, pl, x,
                                      positions, mode=mode, cache=c_in,
                                      pos=pos, impl=impl)
            if c_new is not None and mode == "prefill" and cache_len:
                c_new = _pad_cache_seq(cfg, pl, c_new, cache_len)
            if c_new is not None and mode == "prefill":
                c_new = place_cache(cfg, pl, c_new)
            if c_new is not None:
                new_caches[f"sub{j}"] = c_new
            aux = aux + a
        return x, new_caches, aux

    if n == 1:
        return one_period(x, p_seg, caches)
    period = remat(one_period, cfg, mode)
    per_layer, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        x, c_new, a = period(x, _index(p_seg, i),
                             _index(caches, i) if caches else None)
        per_layer.append(c_new)
        aux = aux + a
    return x, (_stack(per_layer) if per_layer[0] else {}), aux


def forward(params, cfg, tokens, *, mode="train", prefix_embeds=None, pos=0,
            caches=None, cache_len=0, impl="auto"):
    """tokens: (B, S_text). prefix_embeds: (B, S_px, E) frontend output.

    mode=train   -> (logits (B,S,V), None, aux)
    mode=prefill -> (last-position logits (B,1,V), caches, aux)
    mode=decode  -> (logits (B,1,V), caches, aux); tokens (B,1)

    V is the padded vocab, its padding columns masked. ``cache_len`` is
    the length an attention layer's prefill cache is padded to; Mamba
    caches have a fixed size and ignore it. ``pos`` is the first
    position: an int, or (decode) a 0-d tensor on the tokens' device.
    ``impl`` is the causal conv's (``ops.causal_conv1d``)."""
    x = L.embed(params["embed"], cfg, tokens,
                positions=_positions(tokens, pos)
                if cfg.pos_emb == "learned" else None)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = _positions(x, pos)
    x = constrain(x, ("batch", "seq", "embed"))

    new_caches = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (body, n) in enumerate(segments(cfg)):
        seg_caches = caches.get(f"seg{si}") if caches else None
        x, c_new, a = _run_segment(params[f"seg{si}"], cfg, body, n, x,
                                   positions, mode=mode, caches=seg_caches,
                                   pos=pos, impl=impl, cache_len=cache_len)
        if c_new:
            new_caches[f"seg{si}"] = c_new
        aux = aux + a

    x = constrain(L.apply_norm(params["ln_f"], x, cfg.norm_eps), _WHOLE_SEQ)
    if mode == "prefill":
        x = x[:, -1:]
    logits = L.unembed(params["embed"], cfg, x)
    logits = constrain(logits, ("batch", "seq", "vocab_act"))
    return logits, (new_caches or None), aux


def _positions(x, pos):
    B, S_ = x.shape[:2]
    return pos + torch.arange(S_, dtype=torch.int64,
                              device=x.device)[None].expand(B, S_)


def decode_step(params, cfg, tokens, caches, pos, *, impl="auto"):
    """One decode step: tokens (B,1), pos: the step's position."""
    return forward(params, cfg, tokens, mode="decode", pos=pos,
                   caches=caches, impl=impl)


class LM(SpecNetwork):
    """The LM as a module; ``forward(tokens, **kw)`` is ``lm.forward``."""
    model_specs = staticmethod(model_specs)
    forward_fn = staticmethod(forward)
