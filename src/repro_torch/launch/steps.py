"""Step functions of the serving paths (``repro/launch/steps.py``): the
state a run starts from, one prefill and one decode step, and
``StepGraphs``, the two steps captured as CUDA graphs (the port's
``jax.jit`` of them).

The reference builds these as closures for ``jax.jit`` over a device
mesh; here they are plain functions on one device, and on the card
``StepGraphs`` captures each once per shape and replays it. A
decoder-only LM (``lm``) may take patch embeddings before its tokens
(``prefix_embeds``, the reference's ``patch_embeds``); an
encoder-decoder (``encdec``) takes its frame embeddings (``frames``) at
the prefill, which runs the encoder, and reads their cross-attention K
and V from the cache at every decode step. The train step and its
optimizer state come with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import capture, resolve_device
from repro_torch.core.dtypes import torch_dtype
from repro_torch.models import encdec, lm, registry
from repro_torch.models.spec import flatten, init_params, unflatten

# the leaves a forward reads in fp32 whatever the compute dtype (norm
# scales and shifts, the SSM's decay and time-step bias); every other
# floating-point leaf is cast to the compute dtype at each use
_STORED_LEAVES = frozenset({"w", "b", "A_log", "dt_bias"})


def init_state(cfg, seed=0, device=None):
    """{"params": the model's weights drawn from ``seed``} on ``device``:
    the card unless the caller names another device; no card and no
    ``device`` raises."""
    device = resolve_device(device)
    return {"params": init_params(registry.model_specs(cfg), seed,
                                  cfg.param_dtype, device=device)}


def compute_params(params, cfg):
    """``params`` with every leaf that each use casts to the compute dtype
    cast once, so a step does no cast of the stored weights; the leaves
    read in fp32 stay as stored. The forward computes the same values from
    either tree; a leaf already in the compute dtype is the same tensor."""
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


def prefill_step(params, cfg, tokens, *, cache_len=0, impl="auto",
                 frames=None, prefix_embeds=None):
    """The prompt ``tokens`` (B, S) -> (last-position logits (B, 1, V),
    caches); an attention layer's cache is padded to ``cache_len``. An
    encoder-decoder reads ``frames`` (B, T_enc, d_model); a decoder-only
    LM may read ``prefix_embeds`` (B, P, d_model) before the tokens."""
    if cfg.is_encoder_decoder:
        logits, caches, _ = encdec.forward(params, cfg, tokens, frames,
                                           mode="prefill",
                                           cache_len=cache_len)
    else:
        logits, caches, _ = lm.forward(params, cfg, tokens, mode="prefill",
                                       prefix_embeds=prefix_embeds,
                                       cache_len=cache_len, impl=impl)
    return logits, caches


def decode_step(params, cfg, tokens, caches, pos, *, impl="auto"):
    """One new token per row, ``tokens`` (B, 1), at position ``pos`` (an
    int or a 0-d tensor on the tokens' device) -> (logits (B, 1, V),
    caches)."""
    if cfg.is_encoder_decoder:
        logits, caches, _ = encdec.forward(params, cfg, tokens, None,
                                           mode="decode", caches=caches,
                                           pos=pos)
    else:
        logits, caches, _ = lm.decode_step(params, cfg, tokens, caches, pos,
                                           impl=impl)
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
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in flatten(caches).items())


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

    Before each capture the step runs once eagerly on a side stream (the
    kernels' first build and plans, and the thread's cuBLAS handle, which
    a graph cannot hold); the kernel wrappers' launch counters tick at
    that warm-up and at the capture, never on a replay. ``prefills`` and
    ``steps`` count the traced prefills and decode steps."""

    def __init__(self, cfg, params):
        self.cfg, self.source = cfg, params
        self.device = next(iter(flatten(params).values())).device
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
        static = torch.zeros_like(tokens)
        static_inputs = {k: torch.zeros_like(v) for k, v in inputs.items()}
        box = {}

        def run():
            self.prefills += 1
            logits, caches = prefill_step(self.params, self.cfg, static,
                                          cache_len=cache_len,
                                          **static_inputs)
            if "caches" in box:  # the capture: into the static caches
                for k, v in flatten(caches).items():
                    box["caches"][k].copy_(v)
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
        g.tokens.copy_(tokens)
        for k, v in inputs.items():
            g.inputs[k].copy_(v)
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
        tok = torch.zeros(tokens.shape, dtype=tokens.dtype,
                          device=self.device)
        pos = torch.zeros((), dtype=torch.int64, device=self.device)
        nested = unflatten(static)
        captured = [False]

        def run():
            self.steps += 1
            logits, new = decode_step(self.params, self.cfg, tok, nested,
                                      pos)
            if captured[0]:  # the capture: back into the static caches
                for k, v in flatten(new).items():
                    if v is not static[k]:
                        static[k].copy_(v)
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
        g.tokens.copy_(tokens)
        g.pos.fill_(pos)
        g.graph.replay()
        return g.logits

