"""Logical-axis sharding rules (``repro/sharding/rules.py``), over a
``torch.distributed`` ``DeviceMesh``.

Every tensor is annotated with *logical* axis names (``("batch", "seq",
"embed")`` ...). A rule table maps each logical name to mesh axes;
``logical_spec`` resolves them to one entry per dim (None, a mesh axis,
or a tuple of axes sharded jointly), dropping any mesh axis that does not
evenly divide its dim (8 KV heads on a 16-way model axis fall back to
replication, Megatron-style), and using a mesh axis at most once per
spec. ``placements`` turns a spec into DTensor placements, which play
the part of the reference's ``NamedSharding``; ``with_logical_constraint``
is a ``redistribute``, where the reference calls
``with_sharding_constraint``.

Mesh axes:
  pod    -- across pods: pure data parallelism
  data   -- data parallel within a pod, and FSDP sharding of parameters
  model  -- tensor, expert and sequence parallelism

A mesh is a ``DeviceMesh`` with ``mesh_dim_names``; anything with a
``shape`` mapping of axis name to size (a stand-in of the reference's
``Mesh.shape``) also answers ``axis_sizes``.
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

# logical axis -> mesh axes (a tuple of candidates, first divisible wins;
# a tuple candidate shards jointly over those mesh axes)
Rules = dict

DEFAULT_RULES: Rules = {
    # activations
    "batch": (("pod", "data"),),          # joint shard over pod and data
    "seq": (None,),                        # replicated by default
    "seq_shard": ("model",),              # sequence parallelism opt-in
    "kv_seq": ("model",),                 # KV-cache length (split-KV decode)
    "embed": (None,),
    "heads_act": ("model",),              # activation head dim
    "vocab_act": ("model",),
    "experts_act": ("model",),
    "seq_group": ("model",),              # MoE dispatch groups (seq shards)
    # parameters
    "vocab": ("model",),
    "embed_fsdp": ("data",),              # FSDP: a weight's embed dim
    "heads": ("model",),
    "kv_heads": ("model",),
    "d_ff": ("model",),
    "experts": ("model",),
    "moe_ff": (None,),
    "kv_lora": (None,),
    "q_lora": (None,),
    "conv_k": (None,),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": (None,),
    "ssm_groups": (None,),
    "layer": (None,),                      # a segment's stacked layers
    None: (None,),
}


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size}, in the mesh's order."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``; 1 without a mesh or such an axis."""
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(name, 1)


def rules_for(cfg, mesh) -> Rules:
    """The config's rule table: its ``param_sharding`` policy (``fsdp``,
    ``tp`` or ``replicated``), ``batch`` over ``data`` alone on a mesh
    without a ``pod`` axis, and sequence parallelism on residuals and
    logits unless ``cfg.extra["sequence_parallel"]`` is false."""
    rules = dict(DEFAULT_RULES)
    if cfg.param_sharding == "tp":
        rules["embed_fsdp"] = (None,)
    elif cfg.param_sharding == "replicated":
        for k in ("embed_fsdp", "vocab", "heads", "kv_heads", "d_ff",
                  "experts", "ssm_inner", "ssm_heads"):
            rules[k] = (None,)
    if "pod" not in axis_sizes(mesh):
        rules["batch"] = (("data",),)
    if bool(cfg.extra.get("sequence_parallel", True)):
        rules["seq"] = ("model",)
    return rules


def _resolve(axis_name, dim: int, rules: Rules, sizes: dict):
    """A logical axis -> a mesh axis, a tuple of them, or None, honouring
    divisibility."""
    for cand in rules.get(axis_name, (None,)):
        if cand is None:
            return None
        axes = cand if isinstance(cand, tuple) else (cand,)
        axes = tuple(a for a in axes if a in sizes)
        if not axes:
            continue
        total = 1
        for a in axes:
            total *= sizes[a]
        if dim % total == 0 and dim > 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def logical_spec(logical_axes, shape, rules: Rules, mesh) -> tuple:
    """One entry per dim of a tensor with these logical axes and shape:
    None, a mesh axis name, or a tuple of mesh axes; the reference's
    ``PartitionSpec``, entry for entry."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"axes {logical_axes} vs shape {shape}")
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for ax, dim in zip(logical_axes, shape):
        res = _resolve(ax, dim, rules, sizes)
        flat = res if isinstance(res, tuple) else (res,)
        if res is not None and any(a in used for a in flat):
            res = None  # a mesh axis may appear once per spec
        if res is not None:
            used.update(flat)
        out.append(res)
    return tuple(out)


def placements(spec, mesh) -> tuple:
    """A spec's DTensor placements, one a mesh dim: ``Shard(d)`` where
    dim d names that mesh axis, else ``Replicate()``. A joint entry
    ``("pod", "data")`` is ``Shard(d)`` on both mesh dims; DTensor splits
    the dim by them in mesh order, so a rank holds block ``pod * D +
    data``, the one JAX gives that device, and the joint axes must come
    in mesh order. A mesh axis of size 1 splits nothing and is
    ``Replicate()`` (DTensor's views reject a split dim of size 1)."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"joint axes {axes} out of the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def logical_sharding(logical_axes, shape, rules: Rules, mesh) -> tuple:
    """The DTensor placements of a tensor with these logical axes and
    shape on ``mesh``."""
    return placements(logical_spec(logical_axes, shape, rules, mesh), mesh)


def with_logical_constraint(x, logical_axes, rules: Rules | None, mesh,
                            shape=None):
    """``x`` redistributed to the placements its logical axes resolve to
    for ``shape`` (``x.shape`` unless given: the dims of a view that
    ``x`` is about to take, so that their divisibility decides), and its
    gradient to them too; a tensor that is not a DTensor counts as
    replicated. A no-op without rules or a mesh."""
    if rules is None or mesh is None:
        return x
    target = logical_sharding(logical_axes, x.shape if shape is None
                              else shape, rules, mesh)
    # redistributed even where the placements already agree: its backward
    # puts the gradient on them as well
    return as_dtensor(x, mesh).redistribute(mesh, target)


# ----------------------------------------------------------------------
# the ambient context: nested layer code adds constraints without
# threading (rules, mesh) through every signature

_CTX = threading.local()


@contextlib.contextmanager
def axis_rules(rules: Rules | None, mesh, serving: bool = False):
    """Make (rules, mesh) ambient for ``constrain`` in this thread, and
    whether the region is a serving step's (``serving``)."""
    prev = getattr(_CTX, "val", None), getattr(_CTX, "serving", False)
    _CTX.val = (rules, mesh) if rules is not None and mesh is not None \
        else None
    _CTX.serving = serving and _CTX.val is not None
    try:
        yield
    finally:
        _CTX.val, _CTX.serving = prev


def current():
    """The ambient (rules, mesh), or None outside ``axis_rules``."""
    return getattr(_CTX, "val", None)


def serving() -> bool:
    """Whether the ambient region is a serving step's: its products move
    a few tokens' activations instead of weights, where a train step's
    keep the weights' placements for their gradients. False outside a
    mesh."""
    return getattr(_CTX, "serving", False)


@contextlib.contextmanager
def sharded_region(rules: Rules | None, mesh, serving: bool = False):
    """``axis_rules(rules, mesh, serving)`` with DTensor's implicit
    replication: a tensor made alike on every rank (a position, a mask, a
    constant) meets the DTensors as a replicated one. A no-op without a
    mesh."""
    if rules is None or mesh is None or (
            current() == (rules, mesh)
            and getattr(_CTX, "serving", False) == serving):
        yield
        return
    with axis_rules(rules, mesh, serving), replicate_implicitly():
        yield


@contextlib.contextmanager
def replicate_implicitly():
    """DTensor's implicit replication on in this thread, and back to what
    it was on exit (``implicit_replication`` turns it off on exit, also
    where an enclosing region had turned it on)."""
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def current_mesh():
    """The ambient mesh of ``axis_rules``, or None."""
    ctx = current()
    return None if ctx is None else ctx[1]


def constrain(x, logical_axes, shape=None):
    """``with_logical_constraint`` under the ambient ``axis_rules``; ``x``
    itself outside one."""
    ctx = current()
    if ctx is None:
        return x
    rules, mesh = ctx
    return with_logical_constraint(x, logical_axes, rules, mesh, shape)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor counts as
    replicated (a position or a mask made on every rank alike)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def run_local(fn, args, in_axes, out_axes):
    """``fn(*args)`` on each rank's local blocks under the ambient
    ``axis_rules`` (``local_map``, the reference's ``shard_map``); plain
    ``fn(*args)`` outside one.

    ``in_axes`` holds each argument's logical axes (None passes a
    non-tensor through); ``out_axes`` holds (logical axes, global shape)
    of each output, and optionally a third item: the mesh axes over which
    that output is a partial sum (each rank's block a term of it). Each
    input is redistributed to its placements first. An input replicated
    over a mesh dim along which some output is sharded reaches its
    gradient as a partial sum over that dim (each rank's outputs used
    it); otherwise its gradient keeps its placements."""
    ctx = current()
    if ctx is None:
        return fn(*args)
    rules, mesh = ctx
    in_pl = tuple(None if ax is None
                  else logical_sharding(ax, a.shape, rules, mesh)
                  for a, ax in zip(args, in_axes))
    names = list(axis_sizes(mesh))
    out_pl = tuple(tuple(
        Partial() if len(o) > 2 and names[j] in o[2] else p
        for j, p in enumerate(logical_sharding(o[0], o[1], rules, mesh)))
        for o in out_axes)
    sharded = [any(isinstance(pl[j], Shard) for pl in out_pl)
               for j in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if sharded[j] and isinstance(p, Replicate) else p
        for j, p in enumerate(pl)) for pl in in_pl)
    dargs = [a if ax is None else as_dtensor(a, mesh)
             for a, ax in zip(args, in_axes)]
    # local_map reads a tuple as one entry an output, a list as placements
    return local_map(fn, out_placements=tuple(list(pl) for pl in out_pl)
                     if len(out_pl) > 1 else list(out_pl[0]),
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*dargs)
