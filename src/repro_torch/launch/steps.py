"""Step functions (``repro/launch/steps.py``): the state a run starts
from, the train step, one prefill and one decode step, and
``StepGraphs``, the two serving steps captured as CUDA graphs (the port's
``jax.jit`` of them).

The reference builds these as closures for ``jax.jit`` over a device
mesh; here they are plain functions, on one device or, given a ``mesh``,
on each rank of a ``torch.distributed`` mesh over DTensors placed by the
logical-axis rules (``sharding.rules``). ``make_train_step``
differentiates the forward with ``torch.autograd.grad`` over the fp32
master leaves, cast to the compute dtype once a step as the reference's
loss does, and applies the config's optimizer (``optim``); on the card
``StepGraphs`` captures each serving step once per shape and replays it
(on a mesh, one graph a rank, its collectives inside). A decoder-only
LM (``lm``) may take patch embeddings before its tokens
(``prefix_embeds``, the reference's ``patch_embeds``); an encoder-decoder
(``encdec``) takes its frame embeddings (``frames``) at the prefill and
in training, and reads their cross-attention K and V from the cache at
every decode step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch import optim
from repro_torch.configs import ShapeSpec
from repro_torch.core.device import capture, resolve_device
from repro_torch.core.dtypes import torch_dtype
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import encdec, lm, registry
from repro_torch.models import spec as pspec
from repro_torch.models.spec import flatten, unflatten
from repro_torch.optim import schedule
from repro_torch.sharding.rules import (as_dtensor, logical_sharding,
                                        rules_for, sharded_region)

# the leaves a forward reads in fp32 whatever the compute dtype (norm
# scales and shifts, the SSM's decay and time-step bias); every other
# floating-point leaf is cast to the compute dtype at each use
_STORED_LEAVES = frozenset({"w", "b", "A_log", "dt_bias"})


# ----------------------------------------------------------------------
# inputs and state


def batch_struct(cfg, shape):
    """{input name: (shape, dtype)} of every model input of a
    ``configs.ShapeSpec`` cell; a train cell also has its labels."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, torch_dtype(cfg.dtype)
    ft = cfg.frontend_tokens if cfg.frontend != "none" else 0
    if shape.kind == "decode":  # one new token against a cache of S
        return {"tokens": ((B, 1), i32)}
    if cfg.is_encoder_decoder:
        out = {"tokens": ((B, S), i32),
               "frames": ((B, cfg.encoder_seq, cfg.d_model), dt)}
    elif cfg.frontend in ("vlm", "vit_stub"):
        out = {"tokens": ((B, S - ft), i32),
               "patch_embeds": ((B, ft, cfg.d_model), dt)}
    else:
        out = {"tokens": ((B, S), i32)}
    if shape.kind == "train":
        out["labels"] = ((B, S), i32)
    return out


def batch_axes(cfg, shape) -> dict:
    """{input name: logical axes} of ``batch_struct``'s inputs."""
    if shape.kind == "decode":
        return {"tokens": ("batch", None)}
    return {k: (("batch", "seq") if k in ("tokens", "labels")
                else ("batch", None, None))
            for k in batch_struct(cfg, shape)}


class Struct(NamedTuple):
    """An input or a state leaf that is not made: its global shape and
    dtype, and its DTensor placements on a mesh (None without one)."""
    shape: tuple
    dtype: torch.dtype
    placements: tuple | None


def _to_structs(tree, mesh, rules):
    """{name: (shape, dtype, axes)} leaves (nested) -> ``Struct`` leaves
    placed by the rules on ``mesh``."""
    def leaf(v):
        shp, dt, ax = v
        return Struct(tuple(shp), dt, None if mesh is None
                      else logical_sharding(ax, shp, rules, mesh))
    return {k: _to_structs(v, mesh, rules) if isinstance(v, dict)
            else leaf(v) for k, v in tree.items()}


def input_specs(cfg, shape, mesh=None, rules=None):
    """Every input of a ``configs.ShapeSpec`` cell as a ``Struct``, placed
    for ``mesh`` (the config's ``rules_for`` unless ``rules`` is given); a
    decode cell also has its caches and its position."""
    if mesh is not None and rules is None:
        rules = rules_for(cfg, mesh)
    axes = batch_axes(cfg, shape)
    specs = _to_structs({k: (s, d, axes[k]) for k, (s, d)
                         in batch_struct(cfg, shape).items()}, mesh, rules)
    if shape.kind == "decode":
        specs["caches"] = _to_structs(registry.cache_struct(
            cfg, shape.global_batch, shape.seq_len), mesh, rules)
        specs["pos"] = Struct((), torch.int32, None if mesh is None
                              else logical_sharding((), (), rules, mesh))
    return specs


def state_specs(cfg):
    """{"params": the model's spec tree, "opt": its optimizer state's}."""
    params = registry.model_specs(cfg)
    opt = optim.get(cfg.optimizer).state_specs(params, cfg.opt_state_dtype)
    return {"params": params, "opt": opt}


def init_params(cfg, seed=0, device=None, mesh=None, rules=None):
    """The model's weights drawn from ``seed`` on ``device``: the card
    unless the caller names another device; no card and no ``device``
    raises. What serving draws: no optimizer state.

    With a ``mesh`` (``rules`` default to the config's ``rules_for``)
    each leaf is drawn whole, as without one, and distributed by its
    placements: ``init_state(cfg, seed, mesh=mesh)["params"]``."""
    specs = registry.model_specs(cfg)
    if mesh is None:
        return pspec.init_params(specs, seed, cfg.param_dtype,
                                 device=resolve_device(device))
    rules = rules if rules is not None else rules_for(cfg, mesh)
    return pspec.init_params(specs, seed, cfg.param_dtype,
                             device=mesh_device(mesh), mesh=mesh,
                             shardings=pspec.param_shardings(specs, mesh,
                                                             rules))


def init_state(cfg, seed=0, device=None, mesh=None, rules=None):
    """{"params": ``init_params``' weights, "opt": the optimizer's zero
    state} on ``device`` (the card unless named). A leaf is seeded by its
    path in its own tree, so the params are ``init_params``'.

    With a ``mesh`` (on the mesh's device type; ``rules`` default to the
    config's ``rules_for``) every leaf is drawn whole as without one and
    distributed by its placements, one leaf at a time: the state is the
    unsharded one, and no rank holds all of it."""
    specs = state_specs(cfg)
    if mesh is None:
        device = resolve_device(device)
        return {"params": init_params(cfg, seed, device),
                "opt": pspec.init_params(specs["opt"], seed,
                                         cfg.param_dtype, device=device)}
    rules = rules if rules is not None else rules_for(cfg, mesh)
    shardings = pspec.param_shardings(specs, mesh, rules)
    return {k: pspec.init_params(specs[k], seed, cfg.param_dtype,
                                 device=mesh_device(mesh), mesh=mesh,
                                 shardings=shardings[k])
            for k in ("params", "opt")}


def abstract_state(cfg, mesh, rules):
    """(the state as DTensors whose local blocks are ``torch.empty``,
    their placements) on ``mesh``. Inside a ``FakeTensorMode`` nothing is
    allocated and no rank communicates: the dry run's state."""
    specs = state_specs(cfg)
    shardings = pspec.param_shardings(specs, mesh, rules)

    def leaf(s, pl):
        full = torch.empty(s.shape, dtype=torch_dtype(s.dtype
                                                      or cfg.param_dtype),
                           device=mesh_device(mesh))
        return distribute_tensor(full, mesh, pl, src_data_rank=None)
    return pspec.tree_map(leaf, specs, shardings), shardings


def compute_params(params, cfg):
    """``params`` with every leaf that each use casts to the compute dtype
    cast once, so a step does no cast of the stored weights; the leaves
    read in fp32 stay as stored. The forward computes the same values from
    either tree; a leaf already in the compute dtype is the same tensor.
    A DTensor leaf keeps its placements (the cast is elementwise)."""
    dt = torch_dtype(cfg.dtype)
    out = {}
    for key, v in params.items():
        if isinstance(v, dict):
            out[key] = compute_params(v, cfg)
        elif key in _STORED_LEAVES or not v.is_floating_point():
            out[key] = v
        else:
            out[key] = v.to(dt)
    return out


# ----------------------------------------------------------------------
# the train step


def _ce_loss(logits, labels):
    """Mean cross entropy over the positions whose label is >= 0.

    The max is subtracted (detached) in the logits' dtype before the fp32
    cast, as the reference does; its gold logit is a one-hot contraction
    with an fp32 result, which picks one logit exactly, so a gather gives
    the same value and the same gradient. Logits that are a DTensor (under
    a mesh, the vocab may be split) take the contraction itself: a masked
    sum over the vocab, local on each rank and then one reduction."""
    mask = (labels >= 0).float()
    lab = labels.clamp_min(0).long()
    m = logits.detach().amax(dim=-1, keepdim=True)
    shifted = (logits - m).float()
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0].float()
    if isinstance(logits, DTensor):
        hit = lab[..., None] == torch.arange(logits.shape[-1],
                                             device=logits.device)
        gold = torch.where(hit, logits.float(), 0.0).sum(dim=-1)
    else:
        gold = logits.gather(-1, lab[..., None])[..., 0].float()
    nll = lse - gold
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _forward_for(cfg):
    """The train-mode forward of the config's family: (params, batch) ->
    (logits, caches, aux)."""
    if cfg.is_encoder_decoder:
        def f(params, batch):
            return encdec.forward(params, cfg, batch["tokens"],
                                  batch.get("frames"), mode="train")
        return f

    def f(params, batch):
        return lm.forward(params, cfg, batch["tokens"], mode="train",
                          prefix_embeds=batch.get("patch_embeds"))
    return f


def loss_and_grads(cfg, params, batch, mesh=None, rules=None):
    """(gradients of the total loss as a tree shaped as ``params``,
    {"loss", "aux"}) of one batch.

    Each fp32 leaf is cast to the compute dtype before any use, norm
    scales, ``A_log`` and ``dt_bias`` included, as the reference's loss
    does (the serving ``compute_params`` keeps some leaves fp32); the
    total is the cross entropy plus ``router_aux_weight`` times the MoE
    aux loss. ``torch.autograd.grad`` runs over the leaves in their
    sorted-path order; a leaf the loss does not reach gets zeros.

    With a ``mesh`` the leaves and the batch are DTensors: the forward
    and the backward run in ``sharding.sharded_region(rules, mesh)``,
    each gradient comes back on its leaf's placements (a partial sum
    reduced once over the mesh dims it spans) and the metrics replicated."""
    if mesh is not None and rules is None:
        rules = rules_for(cfg, mesh)
    dt = torch_dtype(cfg.dtype)
    flat = flatten(params)
    keys = sorted(flat)
    leaves = [flat[k].detach().requires_grad_() for k in keys]
    cast = unflatten({k: (v.to(dt) if v.dtype == torch.float32 else v)
                      for k, v in zip(keys, leaves)})
    with sharded_region(rules, mesh):
        logits, _, aux = _forward_for(cfg)(cast, batch)
        loss = _ce_loss(logits, batch["labels"])
        total = loss + cfg.router_aux_weight * aux
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for k, v, g in zip(keys, leaves, grads)}
        metrics = {"loss": loss.detach(), "aux": aux.detach()}
        if mesh is not None:
            grads = {k: _like(g, flat[k]) for k, g in grads.items()}
            metrics = {k: replicated(v, mesh) for k, v in metrics.items()}
    return unflatten(grads), metrics


def _like(t, like):
    """``t`` on ``like``'s placements (a no-op for plain tensors)."""
    if not isinstance(like, DTensor):
        return t
    t = as_dtensor(t, like.device_mesh)
    if tuple(t.placements) == tuple(like.placements):
        return t
    return t.redistribute(like.device_mesh, like.placements)


def replicated(t, mesh):
    """``t`` as a DTensor replicated over ``mesh`` (a partial sum reduced,
    a shard gathered)."""
    t = as_dtensor(t, mesh)
    target = (Replicate(),) * mesh.ndim
    return t if tuple(t.placements) == target else t.redistribute(
        mesh, target)


def batch_grads(cfg, params, batch, accum=1, mesh=None, rules=None):
    """(gradients, {"loss", "aux"}) of ``batch``: ``loss_and_grads`` of
    the whole batch, or with ``accum`` > 1 of ``accum`` micro-batches (the
    batch rows split in order) summed into fp32 zeros in order, then
    divided, the metrics averaged."""
    if accum == 1:
        return loss_and_grads(cfg, params, batch, mesh, rules)
    grads = pspec.tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32), params)
    metrics = {k: torch.zeros((), dtype=torch.float32,
                              device=batch["tokens"].device)
               for k in ("loss", "aux")}
    for i in range(accum):
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        g, m = loss_and_grads(cfg, params, mb, mesh, rules)
        grads = pspec.tree_map(torch.add, grads, g)
        metrics = {k: metrics[k] + m[k] for k in metrics}
    return (pspec.tree_map(lambda g: g / accum, grads),
            {k: v / accum for k, v in metrics.items()})


def make_train_step(cfg, mesh=None, rules=None, *, peak_lr=3e-4,
                    warmup=100, total_steps=10_000, clip_norm=1.0,
                    accum: int = 1):
    """-> ``train_step(state, batch) -> (state, metrics)``: the gradients
    of the batch (``batch_grads``), clipped to ``clip_norm``, one step of
    ``cfg.optimizer`` at ``warmup_cosine(step + 1)``, the step being
    taken. ``metrics``: ``loss``, ``aux`` (averaged over the
    micro-batches), ``grad_norm`` (before the clip) and ``lr``, 0-d fp32
    tensors on the state's device. ``train_step.apply(state, grads,
    metrics)`` is the same step from gradients already taken.

    With a ``mesh`` (``rules`` default to the config's ``rules_for``) the
    state and the batch are DTensors placed by the rules (``init_state``,
    ``pipeline.batch``): the gradients, the clip and the optimizer run on
    the sharded leaves, the new state keeps the state's placements, and
    the metrics come out replicated."""
    opt_mod = optim.get(cfg.optimizer)
    if mesh is not None and rules is None:
        rules = rules_for(cfg, mesh)

    def update(state, grads, gnorm, metrics):
        """The optimizer step of clipped ``grads``."""
        params, opt_state = state["params"], state["opt"]
        lr = schedule.warmup_cosine(opt_state["step"] + 1, peak_lr=peak_lr,
                                    warmup_steps=warmup,
                                    total_steps=total_steps)
        new_params, new_opt = opt_mod.update(grads, opt_state, params, lr=lr)
        new = {"params": new_params, "opt": new_opt}
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        if mesh is not None:
            new = pspec.tree_map(_like, new, state)
            metrics = {k: replicated(v, mesh) for k, v in metrics.items()}
        return new, metrics

    def apply(state, grads, metrics):
        with sharded_region(rules, mesh):
            return update(state, *schedule.clip_by_global_norm(
                grads, clip_norm), metrics)

    def train_step(state, batch):
        with sharded_region(rules, mesh):
            grads, metrics = batch_grads(cfg, state["params"], batch, accum,
                                         mesh, rules)
            # rebound, so the unclipped gradients are freed before the step
            grads, gnorm = schedule.clip_by_global_norm(grads, clip_norm)
            return update(state, grads, gnorm, metrics)

    train_step.apply = apply
    return train_step


# ----------------------------------------------------------------------
# the serving steps


def _rules(cfg, mesh, rules):
    """``rules``, or the config's ``rules_for`` on a ``mesh``."""
    return rules if rules is not None or mesh is None \
        else rules_for(cfg, mesh)


def prefill_step(params, cfg, tokens, *, cache_len=0, impl="auto",
                 frames=None, prefix_embeds=None, mesh=None, rules=None):
    """The prompt ``tokens`` (B, S) -> (last-position logits (B, 1, V),
    caches); an attention layer's cache is padded to ``cache_len``. An
    encoder-decoder reads ``frames`` (B, T_enc, d_model); a decoder-only
    LM may read ``prefix_embeds`` (B, P, d_model) before the tokens.

    With a ``mesh`` (``rules`` default to the config's ``rules_for``) the
    step runs in ``sharding.sharded_region(rules, mesh, serving=True)``
    on ``params`` placed by the rules (``init_params(cfg, mesh=mesh)``);
    the inputs may be DTensors on ``input_specs``' placements or tensors
    alike on every rank, and the caches come out on the placements
    ``input_specs`` gives a decode cell."""
    rules = _rules(cfg, mesh, rules)
    with sharded_region(rules, mesh, serving=True):
        if cfg.is_encoder_decoder:
            logits, caches, _ = encdec.forward(params, cfg, tokens, frames,
                                               mode="prefill",
                                               cache_len=cache_len)
        else:
            logits, caches, _ = lm.forward(params, cfg, tokens,
                                           mode="prefill",
                                           prefix_embeds=prefix_embeds,
                                           cache_len=cache_len, impl=impl)
    return logits, caches


def decode_step(params, cfg, tokens, caches, pos, *, impl="auto", mesh=None,
                rules=None):
    """One new token per row, ``tokens`` (B, 1), at position ``pos`` (an
    int or a 0-d tensor on the tokens' device) -> (logits (B, 1, V),
    caches). With a ``mesh``, as ``prefill_step``: the caches are read
    and written on ``input_specs``' placements, an attention cache split
    along its sequence (the split-KV decode of ``models.layers``)."""
    rules = _rules(cfg, mesh, rules)
    with sharded_region(rules, mesh, serving=True):
        if cfg.is_encoder_decoder:
            logits, caches, _ = encdec.forward(params, cfg, tokens, None,
                                               mode="decode", caches=caches,
                                               pos=pos)
        else:
            logits, caches, _ = lm.decode_step(params, cfg, tokens, caches,
                                               pos, impl=impl)
    return logits, caches


class _Graph:
    """A captured step: its graph, static inputs and static logits; a
    prefill's ``sig`` names the static caches it writes and ``inputs``
    holds its static ``frames`` or ``prefix_embeds``."""

    def __init__(self, graph, tokens, logits, pos=None, sig=None,
                 inputs=None):
        self.graph, self.tokens, self.logits = graph, tokens, logits
        self.pos, self.sig, self.inputs = pos, sig, inputs or {}


def _signature(caches) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype,
                  tuple(getattr(v, "placements", ())))
                 for k, v in flatten(caches).items())


def _local(t):
    """The block of ``t`` this rank holds (``t`` itself for a tensor)."""
    return t.to_local() if isinstance(t, DTensor) else t


def _copy_into(static, new):
    """``new`` copied into the static buffer ``static``: for DTensors,
    each rank's block into its block, the placements the same (nothing
    moves between ranks, so a capture may hold it)."""
    if isinstance(static, DTensor):
        if tuple(new.placements) != tuple(static.placements):
            raise ValueError(f"a step's output on {new.placements}, its "
                             f"static buffer on {static.placements}")
    _local(static).copy_(_local(new))


class StepGraphs:
    """The prefill and the decode step of one model on the card, each a
    CUDA graph captured at its first use of a shape and replayed after.

    ``params`` are cast to the compute dtype once (``compute_params``).
    One prefill graph a (batch, prompt length, ``cache_len``, token
    dtype, and the shape and dtype of its ``frames`` or
    ``prefix_embeds``, static inputs too); its caches are copied, inside
    the graph, into static cache buffers, one set a cache shape, i.e. a
    (batch, cache length). One decode graph a set of static caches: the
    tokens (B, 1) and the position, a 0-d device tensor, are static
    inputs, and the step's new caches are copied back into the static
    caches inside the graph, but for those it passes through unchanged
    (an encoder-decoder's ``cross`` K and V, read and never written). The
    logits returned are the graph's static buffer: read them before the
    next replay. One caller at a time.

    With a ``mesh`` (``params`` placed by ``rules``, the config's
    ``rules_for`` by default) every rank of it builds its own
    ``StepGraphs`` and calls it alike: each captures one graph a step,
    its collectives inside it. The static tokens, position, inputs and
    caches are DTensors on ``input_specs``' placements, and a replay
    copies each rank's block of its arguments into its block of them.

    Before each capture the step runs once eagerly on a side stream (the
    kernels' first build and plans, the thread's cuBLAS handle and, on a
    mesh, the communicators of its collectives, none of which a capture
    can make); the kernel wrappers' launch counters tick at that warm-up
    and at the capture, never on a replay. ``prefills`` and ``steps``
    count the traced prefills and decode steps."""

    mesh = rules = None  # unsharded unless built with a mesh

    def __init__(self, cfg, params, mesh=None, rules=None):
        self.cfg, self.source = cfg, params
        self.mesh, self.rules = mesh, _rules(cfg, mesh, rules)
        self.device = mesh_device(mesh) if mesh is not None else next(
            iter(flatten(params).values())).device
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs run on the card, not on "
                             f"{self.device}: pass replay=False")
        self.params = compute_params(params, cfg)
        self._side = torch.cuda.Stream(self.device)
        self._prefills: dict[tuple, _Graph] = {}
        self._decodes: dict[tuple, _Graph] = {}
        self._caches: dict[tuple, dict] = {}  # signature -> static caches
        self.prefills = 0
        self.steps = 0

    @property
    def graphs(self) -> int:
        return len(self._prefills) + len(self._decodes)

    def _static(self, shape, dtype, axes):
        """A zero static input of the global ``shape``: on a mesh a
        DTensor placed by its logical ``axes``."""
        zeros = torch.zeros(shape, dtype=dtype, device=self.device)
        if self.mesh is None:
            return zeros
        pl = logical_sharding(axes, shape, self.rules, self.mesh)
        return distribute_tensor(zeros, self.mesh, pl, src_data_rank=None)

    def _fill(self, static, t):
        """``t`` copied into the static input ``static``: on a mesh this
        rank's block of it (a tensor alike on every rank is cut, a DTensor
        moved to the static one's placements)."""
        if isinstance(static, DTensor):
            t = t.redistribute(self.mesh, static.placements) \
                if isinstance(t, DTensor) else distribute_tensor(
                    t.to(self.device), self.mesh, static.placements,
                    src_data_rank=None)
        _local(static).copy_(_local(t))

    def _capture(self, fn):
        """``fn()`` once eagerly on the side stream, then captured; returns
        (graph, the captured call's result)."""
        side, current = self._side, torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture(graph, stream=side):
            out = fn()
        return graph, out

    def _prefill_graph(self, tokens, cache_len, inputs):
        key = (*tokens.shape, cache_len, tokens.dtype,
               *((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
        g = self._prefills.get(key)
        if g is not None:
            return g
        shape = ShapeSpec("prefill", tokens.shape[1], tokens.shape[0],
                          "prefill")
        axes = batch_axes(self.cfg, shape)
        static = self._static(tokens.shape, tokens.dtype, axes["tokens"])
        static_inputs = {k: self._static(
            v.shape, v.dtype, axes["patch_embeds" if k == "prefix_embeds"
                                   else k]) for k, v in inputs.items()}
        box = {}

        def run():
            self.prefills += 1
            logits, caches = prefill_step(self.params, self.cfg, static,
                                          cache_len=cache_len,
                                          mesh=self.mesh, rules=self.rules,
                                          **static_inputs)
            if "caches" in box:  # the capture: into the static caches
                for k, v in flatten(caches).items():
                    _copy_into(box["caches"][k], v)
            else:  # the warm-up: the static caches of this shape
                sig = _signature(caches)
                target = self._caches.setdefault(sig, {
                    k: torch.zeros_like(v)
                    for k, v in flatten(caches).items()})
                box.update(caches=target, sig=sig)
            return logits

        graph, logits = self._capture(run)
        g = self._prefills[key] = _Graph(graph, static, logits,
                                         sig=box["sig"],
                                         inputs=static_inputs)
        return g

    def prefill(self, tokens, cache_len=0, *, frames=None,
                prefix_embeds=None):
        """Replay the prefill of ``tokens`` (B, S) on the card, with an
        encoder-decoder's ``frames`` or an LM's ``prefix_embeds`` (see
        ``prefill_step``) -> (static logits (B, 1, V), the static caches
        the decode graph reads)."""
        inputs = {k: v for k, v in (("frames", frames),
                                    ("prefix_embeds", prefix_embeds))
                  if v is not None}
        g = self._prefill_graph(tokens, cache_len, inputs)
        self._fill(g.tokens, tokens)
        for k, v in inputs.items():
            self._fill(g.inputs[k], v)
        g.graph.replay()
        return g.logits, unflatten(self._caches[g.sig])

    def _decode_graph(self, caches, tokens):
        sig = _signature(caches)
        static = self._caches.get(sig)
        if static is None or any(static[k] is not v
                                 for k, v in flatten(caches).items()):
            raise ValueError("decode: caches must be the static caches a "
                             "prefill of this StepGraphs returned")
        key = (sig, tuple(tokens.shape), tokens.dtype)
        g = self._decodes.get(key)
        if g is not None:
            return g
        tok = self._static(tokens.shape, tokens.dtype, ("batch", None))
        pos = self._static((), torch.int64, ())
        nested = unflatten(static)
        captured = [False]

        def run():
            self.steps += 1
            logits, new = decode_step(self.params, self.cfg, tok, nested,
                                      pos, mesh=self.mesh, rules=self.rules)
            if captured[0]:  # the capture: back into the static caches
                for k, v in flatten(new).items():
                    if v is not static[k]:
                        _copy_into(static[k], v)
            captured[0] = True
            return logits

        graph, logits = self._capture(run)
        g = self._decodes[key] = _Graph(graph, tok, logits, pos)
        return g

    def decode(self, tokens, caches, pos):
        """Replay one decode step: ``tokens`` (B, 1) on the card at
        position ``pos`` (an int), against and into the static ``caches``
        of a prefill -> static logits (B, 1, V)."""
        g = self._decode_graph(caches, tokens)
        self._fill(g.tokens, tokens)
        _local(g.pos).fill_(pos)
        g.graph.replay()
        return g.logits
