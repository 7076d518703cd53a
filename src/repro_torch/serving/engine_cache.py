"""LRU cache of built ``InferenceEngine``s + tuned-plan reuse
(``repro/serving/engine_cache.py``).

Many model variants (resnet18/50, mobilenet_v2, tiny variants) share one
serving process. Building an engine is expensive — tune a plan, precompute
Winograd transforms, capture its CUDA graphs — so the cache keys each
built engine by ``(network, input_size, device, compute_dtype,
param_dtype)`` and evicts least-recently-used beyond ``capacity``. The
device is the cache's own, the card unless the caller passes
``device="cpu"``; without a card and without ``device`` the cache raises.

Plans are cached separately, keyed by ``(network, input_size,
compute_dtype)``: a ``TuningPlan`` is device-agnostic, but NOT
dtype-agnostic — ConvSpec carries the compute dtype, byte-traffic terms
scale with its element width, and the tuned algorithm can flip between
fp32 and bf16 for the same geometry. Engines that differ only in
``param_dtype`` (storage precision of the weights) still share a plan:
the plan was tuned for the compute dtype, which is what the kernels
stream; ConvSpec's dtype field makes the engine's plan validation reject
a plan of another compute dtype, so the key must match.

Builds are fault-tolerant: a transient build failure retries with capped
backoff, and a build that fails *persistently while deploying a cached
plan* falls back to the xla-only plan (``xla_fallback_plan``) instead of
failing every request for the key. ``degrade(cfg)`` is the same fallback
on demand — the batcher calls it when an engine's circuit breaker trips —
and ``stats()`` counts both under ``degraded``.

Streaming sessions hold **leases** (``lease``): a leased entry is pinned —
it does not count against ``capacity`` and LRU eviction skips it — so a
burst of classify traffic for other networks can never evict the engine
out from under a live stream. Releasing the lease returns the entry to
normal LRU order as most-recently-used.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict

from repro_torch.core.device import resolve_device
from repro_torch.core.engine import InferenceEngine
from repro_torch.serving.resilience import RetryPolicy, TransientFailure

log = logging.getLogger(__name__)


def xla_fallback_plan(cfg):
    """The degraded-mode plan for ``cfg``: every conv site on the xla
    escape hatch, no fused blocks — same geometry/dtype enumeration as a
    tuned plan, so engine plan-validation accepts it unchanged."""
    from repro_torch.core import autotune
    from repro_torch.models.registry import cnn_module

    return autotune.xla_fallback_plan(cnn_module(cfg).conv_specs(cfg))


def engine_key(cfg, device: str | None = None) -> tuple:
    """The cache key: (network, input_size, device, dtype, param_dtype).

    ``device`` is a torch device type (``"cuda"``, ``"cpu"``); it
    defaults to the card, and without one it raises. Compute dtype and
    param (storage) dtype key independently: they change the captured
    program.
    """
    if device is None:
        device = resolve_device(None).type
    return (cfg.name, cfg.extra.get("img"), device, cfg.dtype,
            cfg.param_dtype)


def plan_key(cfg) -> tuple:
    """Plan reuse key: (network, input_size, compute_dtype).

    Plans are tuned per compute dtype — element width moves every byte
    term of the cost model — but are independent of ``param_dtype``
    (weight storage) and device (the plan is an offline artifact).
    """
    return (cfg.name, cfg.extra.get("img"), cfg.dtype)


class EngineLease:
    """A pin on one cache entry, held by a ``StreamSession`` for its
    lifetime: while any lease on the key is live, the engine is exempt
    from LRU eviction (and from the capacity count). ``release`` — or
    exiting the context manager — drops the pin and restores the entry to
    normal LRU order as most-recently-used."""

    def __init__(self, cache: "EngineCache", key: tuple,
                 engine: InferenceEngine):
        self._cache = cache
        self.key = key
        self.engine = engine
        self._released = False

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._cache._release(self.key)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class EngineCache:
    """Thread-safe LRU of InferenceEngines; hit returns the *identical*
    engine object (same graphs, same params, same plan). Every engine it
    builds runs on ``device``: the card unless the caller passes
    ``device="cpu"``."""

    def __init__(self, capacity: int = 4, tune_mode: str = "cost_model",
                 retry: RetryPolicy | None = None, faults=None,
                 device=None):
        assert capacity >= 1
        self.device = resolve_device(device)
        self.capacity = capacity
        self.tune_mode = tune_mode
        self.retry = retry if retry is not None else RetryPolicy()
        self._faults = faults  # FaultInjector, or None
        self._engines: OrderedDict[tuple, InferenceEngine] = OrderedDict()
        self._plans: dict[tuple, object] = {}
        self._lock = threading.RLock()
        self._build_locks: dict[tuple, threading.Lock] = {}
        self._pins: dict[tuple, int] = {}  # key -> live lease count
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.leases = 0
        self.degraded = 0  # engines (re)built on the xla fallback plan
        self.build_retries = 0
        self._degraded_keys: set[tuple] = set()

    def __len__(self) -> int:
        return len(self._engines)

    def key(self, cfg) -> tuple:
        """``engine_key`` on this cache's device."""
        return engine_key(cfg, self.device.type)

    def __contains__(self, cfg) -> bool:
        return self.key(cfg) in self._engines

    def get(self, cfg, *, params=None, seed: int = 0) -> InferenceEngine:
        """The engine for ``cfg``, building (and possibly evicting) on miss.

        A miss reuses any cached plan for the same (network, input_size,
        compute_dtype), so an evicted-and-rebuilt engine — or a variant
        differing only in param storage — skips tuning.

        The slow build (tune, then capture at first use) runs under a
        per-key lock, not the
        global one: a first request for network B never stalls behind
        network A's multi-second build, and two racing builders of the
        same key still dedupe to one engine.
        """
        key = self.key(cfg)
        with self._lock:
            eng = self._engines.get(key)
            if eng is not None:
                self.hits += 1
                self._engines.move_to_end(key)
                return eng
            build_lock = self._build_locks.setdefault(key, threading.Lock())
        with build_lock:
            with self._lock:
                eng = self._engines.get(key)
                if eng is not None:  # lost the race: the engine exists now
                    self.hits += 1
                    self._engines.move_to_end(key)
                    return eng
                pkey = plan_key(cfg)
                plan = self._plans.get(pkey)
            eng, degraded = self._build(cfg, params=params, seed=seed,
                                        plan=plan)
            with self._lock:
                self.misses += 1
                if degraded:
                    self.degraded += 1
                    self._degraded_keys.add(key)
                else:
                    self._plans.setdefault(pkey, eng.plan)
                self._engines[key] = eng
                self._evict_locked()
                self._build_locks.pop(key, None)
            return eng

    def _build(self, cfg, *, params, seed, plan):
        """Build one engine with the resilience policy: transient build
        failures retry with capped backoff; a *persistent* failure while
        deploying a cached plan (the block-plan-deploy case) falls back
        to the xla-only plan — degraded, but serving — instead of
        failing every request for the key. Returns (engine, degraded)."""
        attempt = 0
        while True:
            try:
                if self._faults is not None:
                    delay = self._faults.check("build")
                    if delay:
                        time.sleep(delay)
                    if plan is not None:
                        self._faults.check("plan_deploy")
                return InferenceEngine(cfg, params=params, seed=seed,
                                       plan=plan, tune_mode=self.tune_mode,
                                       device=self.device), False
            except Exception as e:
                if isinstance(e, TransientFailure) \
                        and attempt < self.retry.max_retries:
                    with self._lock:
                        self.build_retries += 1
                    time.sleep(self.retry.delay(attempt))
                    attempt += 1
                    continue
                if plan is not None:
                    log.warning(
                        "plan deploy for %s failed persistently (%s); "
                        "rebuilding on the xla fallback plan", cfg.name, e)
                    return InferenceEngine(cfg, params=params, seed=seed,
                                           plan=xla_fallback_plan(cfg),
                                           device=self.device), True
                raise

    def degrade(self, cfg, *, params=None, seed: int = 0) -> InferenceEngine:
        """Rebuild ``cfg``'s cache entry on the xla-only fallback plan —
        the degraded-mode path a batcher takes when its engine's circuit
        breaker trips on persistent tuned-kernel failures.

        The replacement keeps the old engine's params (same weights, so
        results differ only by algorithm route), takes over the cache
        slot (leases on the key keep their original engine object — a
        live stream is never yanked mid-frame), and bumps the
        ``degraded`` counter surfaced in ``stats()``.
        """
        key = self.key(cfg)
        with self._lock:
            old = self._engines.get(key)
        if params is None and old is not None:
            params = old.model  # the weights as stored
        eng = InferenceEngine(cfg, params=params, seed=seed,
                              plan=xla_fallback_plan(cfg),
                              device=self.device)
        with self._lock:
            self._engines[key] = eng
            self._engines.move_to_end(key)
            self.degraded += 1
            self._degraded_keys.add(key)
            self._evict_locked()
        log.warning("engine for %s degraded to the xla fallback plan",
                    cfg.name)
        return eng

    def lease(self, cfg, *, params=None, seed: int = 0) -> EngineLease:
        """Pin ``cfg``'s engine for a streaming session (building on miss).

        Pinned entries are exempt from eviction and from the capacity
        count; ``EngineLease.release`` unpins. Re-leasing the same key
        stacks (the entry stays pinned until every lease is released).
        """
        key = self.key(cfg)
        while True:
            eng = self.get(cfg, params=params, seed=seed)
            with self._lock:
                # an eviction may race between get() and the pin; only
                # pin the entry if it is still the one we were handed
                if self._engines.get(key) is eng:
                    self._pins[key] = self._pins.get(key, 0) + 1
                    self.leases += 1
                    return EngineLease(self, key, eng)

    def _release(self, key: tuple) -> None:
        with self._lock:
            n = self._pins.get(key, 0) - 1
            if n > 0:
                self._pins[key] = n
            else:
                self._pins.pop(key, None)
            if key in self._engines:
                self._engines.move_to_end(key)  # back to LRU order, as MRU
            self._evict_locked()

    def _evict_locked(self) -> None:
        """Evict oldest unpinned entries until the unpinned population
        fits ``capacity`` (call with the lock held). Pinned entries ride
        outside the capacity count — they cannot be evicted, and they
        must not starve the unpinned working set either."""
        unpinned = [k for k in self._engines if not self._pins.get(k)]
        for k in unpinned[:max(0, len(unpinned) - self.capacity)]:
            del self._engines[k]
            self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "size": len(self._engines),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "leases": self.leases,
                    "degraded": self.degraded,
                    "degraded_keys": sorted(
                        (list(k) for k in self._degraded_keys), key=str),
                    "build_retries": self.build_retries,
                    "pinned": [k for k in self._engines if self._pins.get(k)],
                    "keys": list(self._engines)}
