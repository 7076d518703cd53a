"""Continuous micro-batching: coalesce concurrent single-image requests
into one padded-batch dispatch with mid-flight admission — and survive
overload (``repro/serving/batcher.py``).

The paper's premise is batch-1 requests arriving one at a time; under
concurrent traffic the device still prefers one dispatch over N. The
batcher keeps one **forming batch** (the pending deque): a new request is
admitted into it mid-flight — it joins the *next* dispatch whenever its
padded power-of-two shape still fits (fewer than ``max_batch`` requests
already formed), instead of waiting for a window of its own. The batch
goes to the device when it fills, or when the window measured from its
**oldest request's arrival** expires — so a request that queued up behind
a long dispatch goes out the moment the engine frees up, never paying a
fresh window on top of the wait (the continuous-batching property; the
deadline-window design it replaces restarted the window at dequeue).
Dispatch shape:

  * **batch == 1** — the single-image fast path: ``engine.run(image)``,
    exactly the paper's tuned per-layer dispatch, zero batching overhead;
  * **batch > 1**  — one ``engine.run_batch`` call on the stacked images,
    padded up to a power-of-two bucket (re-using the last image as filler)
    so a ragged final micro-batch doesn't cost a fresh CUDA-graph capture
    for every distinct batch size.

``run_batch`` replays B single-image computations in one graph, so
outputs are bitwise-equal to sequential ``engine.run`` calls —
micro-batching changes scheduling, never numerics, and mid-flight
admission changes only *when* a request dispatches, never what its batch
computes. A dispatch waits for the card's work before its futures
resolve, so the latency stamps include the compute.

Every dispatch can be routed through a shared ``DeviceScheduler``
(``scheduler=``): the batcher's loop thread then submits the attempt as a
job and blocks while the device thread runs it under the cross-network
fairness policy — and because the loop thread is blocked *outside* the
admission lock, the next batch keeps forming mid-flight underneath it.

Overload and failure handling:

  * **admission control** — ``max_queue`` bounds the pending deque; a
    submit beyond it is rejected *immediately* with ``Overloaded`` (typed,
    cheap, before any work). A closed batcher rejects the same way.
  * **deadline shedding** — with ``deadline_ms`` set (per-batcher default
    or per-request override), a request still queued past its deadline
    (or cancelled by its client) is shed **at dequeue** with
    ``DeadlineExceeded``: an expired request never burns a dispatch,
    which is what keeps an overloaded queue from doing work nobody is
    waiting for.
  * **retry + breaker** — a dispatch raising ``TransientFailure`` (the
    repo-wide transient-error type) is retried with capped exponential
    backoff (``retry``); *every* dispatch failure feeds the per-engine
    ``CircuitBreaker``, which trips open after N consecutive failures so
    a sick engine sheds fast (``CircuitOpen``) instead of queueing.
  * **degraded mode** — when the breaker trips and a ``degrade`` hook was
    provided (the server wires ``EngineCache.degrade``), the batcher swaps
    its engine for the xla-only fallback, resets the breaker, and retries
    the in-flight batch there — serving continues at reduced speed rather
    than going dark.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import torch

from repro_torch.runtime import trace
from repro_torch.serving import request as req_mod
from repro_torch.serving.request import Request, Ticket
from repro_torch.serving.resilience import (
    CircuitBreaker,
    CircuitOpen,
    DeadlineExceeded,
    Overloaded,
    RetryPolicy,
    TransientFailure,
)


def bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch — the padded batch
    size. Bounds the set of captured batch shapes to O(log max_batch)."""
    assert 1 <= n <= max_batch
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def settle(outs) -> None:
    """Wait for the card's work on ``outs`` before resolving: futures
    hand back finished results, and latency stamps include the compute.
    Every output comes off the stream the dispatch ran on, the caller's
    current stream, so synchronising it is enough."""
    devices = {o.device for o in outs if isinstance(o, torch.Tensor)
               and o.device.type == "cuda"}
    for device in devices:
        torch.cuda.current_stream(device).synchronize()


def _dispatch_span(batch: list[Request]):
    """The ``repro_torch.dispatch`` span of ``batch`` when one of its
    requests is traced, as the calling thread's trace context, with each
    request stamped with its start; else None."""
    for r in batch:
        if r.traced:
            span = trace.begin("repro_torch.dispatch")
            for q in batch:
                q.dispatched = span.start
            return span
    return None


class MicroBatcher:
    """One request loop around one engine.

    ``submit`` is non-blocking and returns a ``Ticket``; a daemon thread
    owns batch formation, and dispatch happens either on that thread or —
    with ``scheduler=`` — on the shared device thread under the
    cross-network fairness policy, so callers never contend on the device.
    """

    def __init__(self, engine, *, max_batch: int = 8, window_ms: float = 2.0,
                 pad_batches: bool = True, deadline_ms: float | None = None,
                 max_queue: int | None = None,
                 retry: RetryPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 degrade=None, faults=None, scheduler=None,
                 name: str | None = None):
        assert max_batch >= 1
        self.engine = engine
        self.name = name if name is not None else f"batcher-{id(self):x}"
        # power-of-two invariant: bucket() pads to powers of two, so a
        # non-power-of-two cap would add one extra captured batch shape
        # (the clipped max_batch itself); round down at construction so
        # the captured-shape set stays exactly {1, 2, 4, ..., max_batch}
        self.max_batch = 1 << (max_batch.bit_length() - 1)
        self.window_s = window_ms / 1e3
        # per-request latency SLO (submit -> resolution). Besides the
        # miss telemetry, it is the shed deadline: a request still queued
        # past arrival + deadline is failed at dequeue, before compute.
        self.deadline_s = None if deadline_ms is None else deadline_ms / 1e3
        # admission bound: pending (admitted, not yet dequeued) requests
        # beyond this are rejected with Overloaded. None = unbounded.
        self.max_queue = max_queue
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._degrade = degrade      # () -> replacement engine, or None
        self._faults = faults        # FaultInjector, or None
        self._scheduler = scheduler  # DeviceScheduler, or None (inline)
        self.pad_batches = pad_batches
        self.dispatches: list[dict] = []  # {batch, padded, latencies}
        # the dispatch path appends to the dispatch log while stats()
        # reads it from caller threads: every access takes this lock
        self._stats_lock = threading.Lock()
        self._causes = {"full": 0, "window": 0, "drain": 0}
        self._shed = {"overload": 0, "deadline": 0, "cancelled": 0,
                      "breaker": 0}
        self._retries = 0
        self._joined = 0             # mid-flight admissions into a
        #                              forming batch (pending was nonempty)
        self.degraded = 0            # engine swaps to the xla fallback
        # _cond guards the forming batch: (closed-check + depth-check +
        # append) is atomic against close() and racing submitters, so the
        # admission bound is exact; the loop thread is the only consumer.
        self._cond = threading.Condition()
        self._pending: deque[Request] = deque()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"microbatcher-{id(self):x}")
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(self, image) -> Ticket:
        """Enqueue one (H, W, C) image; the Ticket resolves to (classes,)
        logits. Raises ``Overloaded`` if the batcher is closed or the
        bounded queue is full (admission control — shed before work)."""
        return Ticket(self.submit_request(image))

    def submit_request(self, image, *, deadline_ms: float | None = None,
                       priority: int = 0) -> Request:
        """Like ``submit`` but returns the ``Request`` record, so owners
        (``Server``) can wrap it themselves. ``deadline_ms`` overrides
        the batcher-wide shed deadline for this request; ``priority``
        rides to the device scheduler's ordering key. The request is
        traced when the calling thread is tracing (``runtime/trace.py``)."""
        req = Request(image, priority=priority, traced=trace.tracing())
        deadline_s = (self.deadline_s if deadline_ms is None
                      else deadline_ms / 1e3)
        if deadline_s is not None:
            req.deadline = req.arrival + deadline_s
        with self._cond:
            if self._closed:
                raise Overloaded("batcher is closed")
            if self.max_queue is not None \
                    and len(self._pending) >= self.max_queue:
                with self._stats_lock:
                    self._shed["overload"] += 1
                raise Overloaded(
                    f"queue full ({len(self._pending)}/{self.max_queue} "
                    f"waiting); request shed at admission")
            if self._pending:  # mid-flight: joins the forming batch
                self._joined += 1
            self._pending.append(req)
            self._cond.notify()
        return req

    def close(self, timeout: float | None = 30.0) -> None:
        """Flush the forming batch, dispatch what's pending, stop the
        thread. Idempotent; racing submits either land before the closed
        flag flips (and drain) or are rejected with ``Overloaded``."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------

    def _take(self, req: Request) -> bool:
        """Dequeue-side shedding: returns True if ``req`` should join the
        dispatch, False if it was shed (expired/cancelled) before any
        compute was spent on it."""
        now = time.perf_counter()
        if req.cancelled:
            with self._stats_lock:
                self._shed["cancelled"] += 1
            req_mod.fail(req, DeadlineExceeded(
                f"request {req.id} cancelled by its client; shed at dequeue"))
            return False
        if req.expired(now):
            budget = (req.deadline - req.arrival) * 1e3
            with self._stats_lock:
                self._shed["deadline"] += 1
            req_mod.fail(req, DeadlineExceeded(
                f"request {req.id} missed its {budget:g}ms deadline while "
                f"queued; shed at dequeue"))
            return False
        return True

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending:  # closed and drained: exit
                    return
                # the batching window is anchored at the OLDEST pending
                # request's arrival — a batch that formed while the
                # previous dispatch held the device goes out immediately
                window_end = self._pending[0].arrival + self.window_s
                while len(self._pending) < self.max_batch \
                        and not self._closed:
                    wait = window_end - time.perf_counter()
                    if wait <= 0:
                        break
                    self._cond.wait(wait)
                take = min(len(self._pending), self.max_batch)
                raw = [self._pending.popleft() for _ in range(take)]
                drain = self._closed
            batch = [r for r in raw if self._take(r)]
            if not batch:
                continue  # everything shed at dequeue: no dispatch
            cause = ("drain" if drain
                     else "full" if len(raw) >= self.max_batch
                     else "window")
            with self._stats_lock:
                self._causes[cause] += 1
            self._dispatch(batch)

    # ------------------------------------------------------------------
    # dispatch with retry / breaker / degraded-mode fallback

    def _run(self, batch: list[Request]):
        n = len(batch)
        device = getattr(self.engine, "device", None)
        span = trace.leaf("repro_torch.dispatch.copy_in")
        images = [torch.as_tensor(r.image, device=device) for r in batch]
        if span is not None:
            trace.end(span)
        if n == 1:
            # the paper's single-image fast path: tuned per-layer
            # dispatch on exactly one image, no stacking, no padding
            outs = [self.engine.run(images[0])]
            padded = 1
        else:
            padded = bucket(n, self.max_batch) if self.pad_batches else n
            images += [images[-1]] * (padded - n)  # filler rows
            logits = self.engine.run_batch(torch.stack(images))
            outs = [logits[i] for i in range(n)]
        settle(outs)
        return outs, padded

    def _try_degrade(self) -> bool:
        """Swap in the degraded (xla-only) engine via the owner's hook.
        One swap per batcher: if the fallback is *also* failing, the
        breaker stays open and sheds instead of thrashing rebuilds."""
        if self._degrade is None or self.degraded:
            return False
        try:
            engine = self._degrade()
        except Exception:
            return False  # degrade itself failed: stay open, shed fast
        self.engine = engine
        with self._stats_lock:
            self.degraded += 1
        self.breaker.reset()
        return True

    def _attempt(self, batch: list[Request]):
        """Run ``batch`` to completion under the resilience policy:
        transient failures retry with backoff, every failure feeds the
        breaker, a trip attempts the degraded-mode engine swap, and an
        open breaker sheds with ``CircuitOpen``. When a request of the
        batch is traced, the attempt is a ``repro_torch.dispatch`` span on
        the thread that runs it, and that thread's trace context."""
        span = _dispatch_span(batch)
        attempt, padded = 0, None
        try:
            while True:
                if not self.breaker.allow():
                    if self._try_degrade():
                        continue
                    with self._stats_lock:
                        self._shed["breaker"] += len(batch)
                    raise CircuitOpen(
                        f"engine circuit breaker is {self.breaker.state} "
                        f"after {self.breaker.threshold} consecutive "
                        f"failures; shedding until it recovers")
                try:
                    # injected dispatch faults model a sick tuned kernel,
                    # so a degraded (xla-only) engine no longer has them
                    if self._faults is not None and not self.degraded:
                        delay = self._faults.check("dispatch")
                        if delay:
                            time.sleep(delay)
                    outs, padded = self._run(batch)
                except Exception as e:
                    tripped = self.breaker.record_failure()
                    if tripped and self._try_degrade():
                        continue  # serve this very batch from the fallback
                    if isinstance(e, TransientFailure) \
                            and attempt < self.retry.max_retries \
                            and self.breaker.allow():
                        with self._stats_lock:
                            self._retries += 1
                        time.sleep(self.retry.delay(attempt))
                        attempt += 1
                        continue
                    raise
                self.breaker.record_success()
                return outs, padded
        finally:
            if span is not None:
                trace.end(span, {"requests": [r.id for r in batch],
                                 "padded": padded})

    def _dispatch(self, batch: list[Request]) -> None:
        try:
            if self._scheduler is not None:
                # the shared device thread runs the attempt under the
                # cross-network fairness policy; this loop thread blocks
                # here while the NEXT batch keeps forming via submit()
                outs, padded = self._scheduler.run(
                    lambda: self._attempt(batch),
                    urgency=min(r.urgency for r in batch),
                    priority=max(r.priority for r in batch),
                    network=self.name)
            else:
                outs, padded = self._attempt(batch)
        except Exception as e:  # resolve, don't kill the loop
            for r in batch:
                req_mod.fail(r, e)
            return
        for r, o in zip(batch, outs):
            req_mod.resolve(r, o)
        with self._stats_lock:
            self.dispatches.append({
                "batch": len(batch),
                "padded": padded,
                "latencies": [r.latency for r in batch],
            })

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Dispatch-log aggregates: request count, batch-size histogram,
        latency mean/p50/p95/max (seconds, submit -> future resolution),
        live queue depth, mid-flight joins, dispatch causes (full batch
        vs expired window vs shutdown drain), deadline misses if an SLO
        is set, and the resilience counters (sheds by cause, retries,
        breaker state, degraded-mode swaps)."""
        with self._cond:
            depth = len(self._pending)
            joined = self._joined
        with self._stats_lock:  # snapshot: the dispatch path appends live
            dispatches = list(self.dispatches)
            causes = dict(self._causes)
            shed = dict(self._shed)
            retries = self._retries
            degraded = self.degraded
        lats = sorted(l for d in dispatches for l in d["latencies"])

        def pct(q):
            if not lats:
                return None
            return lats[min(len(lats) - 1, round(q / 100 * (len(lats) - 1)))]

        hist: dict[int, int] = {}
        for d in dispatches:
            hist[d["batch"]] = hist.get(d["batch"], 0) + 1
        misses = (None if self.deadline_s is None
                  else sum(1 for l in lats if l > self.deadline_s))
        return {
            "requests": len(lats),
            "dispatches": len(dispatches),
            "queue_depth": depth,
            "max_queue": self.max_queue,
            "window_ms": self.window_s * 1e3,
            "joined_forming": joined,
            "dispatch_causes": causes,
            "batch_histogram": dict(sorted(hist.items())),
            "shed": shed,
            "shed_total": sum(shed.values()),
            "retries": retries,
            "breaker": self.breaker.stats(),
            "degraded": degraded,
            "deadline_ms": (None if self.deadline_s is None
                            else self.deadline_s * 1e3),
            "deadline_misses": misses,
            "deadline_miss_rate": (None if misses is None or not lats
                                   else misses / len(lats)),
            "latency_mean_s": sum(lats) / len(lats) if lats else None,
            "latency_p50_s": pct(50),
            "latency_p95_s": pct(95),
            "latency_max_s": max(lats) if lats else None,
        }
