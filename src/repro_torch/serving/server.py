"""The serving front door: single-image requests in, logits tickets out
(``repro/serving/server.py``).

One ``Server`` owns one ``EngineCache`` (shared across every network it
serves), one ``MicroBatcher`` per active network, and one
``DeviceScheduler`` that all batchers dispatch through — N networks'
forming batches interleave onto the accelerator oldest-deadline-first, so
a cold or slow network cannot head-of-line block a fast one. ``submit``
routes a request to its network's batcher — building the engine through
the cache on first sight — and returns immediately with a ``Ticket``.
``open_stream`` opens a fixed-rate ``StreamSession`` over the same cache:
the session holds an engine lease (pinned against eviction) and its
dispatch runs on its own thread. This is the seam every future scaling
layer (sharding, multi-backend, remote endpoints) plugs into: everything
above it speaks (network, image) -> logits, everything below it is the
tuned-engine world. The wire tier (``protocol``, ``client``) will sit on
top of exactly this surface; it is the next slice of the port. The
server runs on the card unless the caller passes ``device="cpu"``, and
raises without a card and without ``device``.

Configuration is two frozen options objects: ``ServingOptions`` for the
server-wide knobs (batching window, admission bound, shed deadline,
retry/breaker policy, fault injection) and ``RequestOptions`` for
per-call ones (dtype variant, deadline override, scheduler priority).
The older kwarg spellings (``Server(max_queue=..., deadline_ms=...,
...)``, ``submit(..., dtype=...)``) still work through a deprecation
shim that folds them into the options objects and warns once per call
site.

The front door is overload-safe: ``max_queue`` bounds every batcher's
queue and rejects
beyond it with ``Overloaded``; ``deadline_ms`` sheds expired requests at
dequeue (``DeadlineExceeded``) instead of computing them late; transient
dispatch failures retry with capped backoff; persistent failures trip a
per-engine circuit breaker, which swaps the engine for an xla-only
degraded build through ``EngineCache.degrade`` and keeps serving.
``faults=`` threads one ``FaultInjector`` through the batchers, the
cache, and every stream session — the deterministic chaos-test hook.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from dataclasses import dataclass

from repro_torch.core.device import resolve_device
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.engine_cache import EngineCache
from repro_torch.serving.request import RequestOptions, Ticket
from repro_torch.serving.resilience import (CircuitBreaker, Overloaded,
                                            RetryPolicy)
from repro_torch.serving.scheduler import DeviceScheduler
from repro_torch.serving.streaming import StreamSession


@dataclass(frozen=True)
class ServingOptions:
    """Server-wide serving knobs (frozen — share one object freely).

    ``max_batch`` / ``window_ms`` configure every batcher's forming
    batch; ``deadline_ms`` is the default per-request shed deadline (a
    ``RequestOptions.deadline_ms`` overrides it per call); ``max_queue``
    bounds admission; ``retry`` / ``breaker_threshold`` /
    ``breaker_reset_s`` configure the resilience layer; ``faults`` is
    the chaos-test injection harness. Defaults keep the seed behavior
    (unbounded queue, no deadline, breaker wide at 5 consecutive
    failures).
    """

    max_batch: int = 8
    window_ms: float = 2.0
    deadline_ms: float | None = None
    max_queue: int | None = None
    retry: RetryPolicy | None = None
    breaker_threshold: int = 5
    breaker_reset_s: float = 30.0
    faults: object = None


# the ServingOptions fields that used to be Server(...) kwargs — the
# deprecation shim accepts exactly these and nothing else
_LEGACY_KEYS = tuple(f.name for f in dataclasses.fields(ServingOptions))


class Server:
    """Micro-batched multi-network serving out of one process.

    ``tiny=True`` maps network names through ``tiny_variant`` (the
    CPU/CI path). ``capacity`` bounds the engine cache; everything else
    lives on ``options`` (a ``ServingOptions``). ``device`` is where the
    engines run: the card unless the caller passes ``device="cpu"`` (or
    a ``cache`` built for a device). The old flat kwargs (``max_batch=``,
    ``max_queue=``, ...) still work via a deprecation shim and build a
    bit-identical server.
    """

    def __init__(self, *, options: ServingOptions | None = None,
                 cache: EngineCache | None = None, capacity: int = 4,
                 tune_mode: str = "cost_model", tiny: bool = False,
                 device=None, **legacy):
        if legacy:
            unknown = sorted(set(legacy) - set(_LEGACY_KEYS))
            if unknown:
                raise TypeError(
                    f"Server() got unexpected keyword argument(s): "
                    f"{', '.join(unknown)}")
            if options is not None:
                raise ValueError(
                    "pass ServingOptions OR legacy kwargs, not both: "
                    f"options={options!r} conflicts with "
                    f"{sorted(legacy)}")
            warnings.warn(
                f"Server({', '.join(sorted(legacy))}=...) kwargs are "
                f"deprecated; pass options=ServingOptions(...) instead",
                DeprecationWarning, stacklevel=2)
            options = dataclasses.replace(ServingOptions(), **legacy)
        self.options = options if options is not None else ServingOptions()
        self.faults = self.options.faults
        if cache is not None and device is not None \
                and resolve_device(device) != cache.device:
            raise ValueError(f"device {device!r} differs from the cache's "
                             f"{cache.device}")
        self.engines = cache if cache is not None else EngineCache(
            capacity=capacity, tune_mode=tune_mode, faults=self.faults,
            device=device)
        self.tiny = tiny
        # one device, one scheduler: every batcher dispatch funnels
        # through it under the oldest-deadline-first fairness policy
        self.scheduler = DeviceScheduler()
        self._batchers: dict[tuple, MicroBatcher] = {}
        self._streams: list[StreamSession] = []
        self._lock = threading.Lock()
        self._closed = False

    # -- legacy read access (old call sites read these off the server) --

    @property
    def max_batch(self):
        return self.options.max_batch

    @property
    def window_ms(self):
        return self.options.window_ms

    @property
    def deadline_ms(self):
        return self.options.deadline_ms

    @property
    def max_queue(self):
        return self.options.max_queue

    # ------------------------------------------------------------------

    def _resolve_cfg(self, network, dtype=None):
        if isinstance(network, str):
            from repro_torch.configs import get, tiny_variant

            cfg = get(network)
            if self.tiny:
                cfg = tiny_variant(cfg)
        else:
            cfg = network
        if dtype is not None:
            from repro_torch.core.dtypes import with_precision

            cfg = with_precision(cfg, dtype)
        return cfg

    def _batcher(self, cfg) -> MicroBatcher:
        key = self.engines.key(cfg)
        with self._lock:
            b = self._batchers.get(key)
        if b is not None:
            return b
        # Build (or fetch) the engine OUTSIDE the server lock: the cache
        # serializes builds per key, so a cold network never stalls
        # submits for already-warm ones. The batcher holds its own engine
        # reference, so cache eviction frees the slot without yanking an
        # engine mid-flight.
        engine = self.engines.get(cfg)
        opts = self.options
        with self._lock:
            b = self._batchers.get(key)
            if b is None:  # we won (or were alone): register our batcher
                retry = opts.retry if opts.retry is not None \
                    else RetryPolicy()
                b = MicroBatcher(
                    engine, max_batch=opts.max_batch,
                    window_ms=opts.window_ms, deadline_ms=opts.deadline_ms,
                    max_queue=opts.max_queue, retry=retry,
                    breaker=CircuitBreaker(threshold=opts.breaker_threshold,
                                           reset_s=opts.breaker_reset_s),
                    # the degraded-mode hook: a tripped breaker rebuilds
                    # this key's cache entry on the xla fallback plan
                    degrade=lambda cfg=cfg: self.engines.degrade(cfg),
                    faults=self.faults,
                    scheduler=self.scheduler,
                    name=self._stats_key(key))
                self._batchers[key] = b
            return b

    # ------------------------------------------------------------------

    @staticmethod
    def _request_options(options, dtype):
        """Fold a deprecated per-call ``dtype=`` into the options object
        (warning once); conflicting values are a ValueError."""
        if dtype is not None:
            warnings.warn(
                "the per-call dtype= kwarg is deprecated; pass "
                "options=RequestOptions(dtype=...) instead",
                DeprecationWarning, stacklevel=3)
        opts = options if options is not None else RequestOptions()
        return opts.merged_dtype(dtype)

    def submit(self, network, image, *, options: RequestOptions | None = None,
               dtype=None) -> Ticket:
        """Non-blocking: route one (H, W, C) image to ``network``'s
        batcher; returns a ``Ticket`` resolving to (classes,) logits.

        ``options.dtype`` is the precision knob (``"bfloat16"`` serves
        from the network's bf16 variant — own engine-cache entry, own
        dtype-keyed plan); ``options.deadline_ms`` overrides the server's
        shed deadline for this request; ``options.priority`` biases the
        device scheduler. ``dtype=`` is the deprecated spelling of
        ``options.dtype``.

        Raises ``Overloaded`` (a typed rejection) if the server is closed
        or the target batcher's bounded queue is full.
        """
        return Ticket(self._submit_request(network, image,
                                           options=options, dtype=dtype))

    def _submit_request(self, network, image, *, options=None, dtype=None):
        opts = self._request_options(options, dtype)
        # the closed check happens under the lock, so a submit racing
        # close() either lands before the batchers drain (and resolves)
        # or is rejected here with the same typed error as shedding
        with self._lock:
            if self._closed:
                raise Overloaded("server is closed")
        cfg = self._resolve_cfg(network, opts.dtype)
        return self._batcher(cfg).submit_request(
            image, deadline_ms=opts.deadline_ms, priority=opts.priority)

    def run(self, network, image, timeout: float | None = 120.0, *,
            options: RequestOptions | None = None, dtype=None):
        """Blocking convenience: ``submit(...).result(timeout)``.

        On timeout the request is **cancelled** (via ``Ticket.result``):
        if it is still queued, the batcher sheds it at dequeue
        (``DeadlineExceeded``) instead of burning a dispatch on a result
        nobody is waiting for.
        """
        return self.submit(network, image, options=options,
                           dtype=dtype).result(timeout)

    def warm(self, network, *, options: RequestOptions | None = None,
             dtype=None) -> None:
        """Build ``network``'s engine + batcher ahead of traffic (the
        tuning cost moves out of the first request's latency; each graph
        is still captured at its first use); with a dtype set, warms that
        precision variant."""
        opts = self._request_options(options, dtype)
        self._batcher(self._resolve_cfg(network, opts.dtype))

    def open_stream(self, network, *, fps: float = 30.0,
                    deadline_ms: float | None = None,
                    sim_compute_s: float | None = None,
                    phase_s: float = 0.0,
                    name: str | None = None,
                    dtype=None) -> StreamSession:
        """Open a fixed-rate frame stream on ``network``.

        The session leases the engine from the shared cache — pinned
        against LRU eviction until the session closes — and dispatches on
        its own thread (or synchronously, under the simulated clock when
        ``sim_compute_s`` is set), so streams never head-of-line-block
        each other or the on-demand batchers. Closing the server closes
        every still-open session. ``dtype`` opens the stream on the
        network's precision variant (same knob as ``submit``) — a bf16
        stream leases the bf16 engine, pinned independently of the fp32
        one.
        """
        with self._lock:
            if self._closed:
                raise Overloaded("server is closed")
        cfg = self._resolve_cfg(network, dtype)
        lease = self.engines.lease(cfg)
        with self._lock:
            if name is None:
                name = f"{cfg.name}#{len(self._streams)}"
            session = StreamSession(lease, fps=fps, deadline_ms=deadline_ms,
                                    sim_compute_s=sim_compute_s,
                                    phase_s=phase_s, name=name,
                                    faults=self.faults)
            self._streams.append(session)
            return session

    def close(self) -> None:
        """Flush every batcher and stream (pending requests and frames
        still resolve; stream leases are released), then stop the device
        scheduler. Idempotent: the closed flag flips under the lock, so a
        racing submit either beats the flip (and drains normally) or gets
        the typed rejection."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            batchers = list(self._batchers.values())
            streams = list(self._streams)
        for s in streams:
            s.close()
        for b in batchers:
            b.close()
        # batchers first: their drains still need the device thread
        self.scheduler.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------

    @staticmethod
    def _stats_key(key: tuple) -> str:
        """Human-readable per-network stats key. Includes the compute
        dtype (dtype joins ``engine_key``, so fp32 and bf16 variants of
        one network are distinct batchers and must not overwrite each
        other's stats), and the param dtype when it differs from the
        compute dtype."""
        name, img, _device, dtype, param_dtype = key
        parts = [str(name), str(img), str(dtype)]
        if param_dtype != dtype:
            parts.append(f"params={param_dtype}")
        return "/".join(parts)

    def stats(self) -> dict:
        """Cache counters (including degraded-mode rebuilds), per-network
        batcher aggregates (queue depth, mid-flight joins, dispatch
        causes, shed/retry/breaker telemetry), device-scheduler queue
        stats, per-stream deadline stats."""
        with self._lock:
            per_net = {self._stats_key(k): b.stats()
                       for k, b in self._batchers.items()}
            streams = {s.name: s.stats() for s in self._streams}
        cache = self.engines.stats()
        return {"cache": cache, "networks": per_net, "streams": streams,
                "scheduler": self.scheduler.stats(),
                "degraded": cache["degraded"]}
