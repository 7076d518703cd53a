"""Resilience primitives for the serving front door
(``repro/serving/resilience.py``).

Production serving fails in layers, and each layer wants a different
response:

  * **shed** — the request is not worth starting: the queue is full
    (``Overloaded``), the deadline already passed or the client gave up
    (``DeadlineExceeded``), or the engine is known-sick (``CircuitOpen``).
    Shedding is *cheap by construction*: it happens at admission or at
    dequeue, never after compute was spent.
  * **retry** — the dispatch failed but the failure is transient
    (``TransientFailure``, the same type the training runtime's
    checkpoint/restart loop keys on — one vocabulary for "try again"
    across the repo). Retries back off exponentially with a cap, so a
    blip costs milliseconds and a real outage doesn't hammer the device.
  * **degrade** — the failure is persistent (``CircuitBreaker`` trips
    after N consecutive failures). The owner swaps the tuned engine for
    an xla-only fallback and keeps serving at reduced speed instead of
    going dark; the breaker's open state sheds fast in the meantime.

Every rejection subclasses ``Rejected`` (itself a ``RuntimeError``), so
callers can distinguish "the server said no" from "the computation
broke" with one ``except`` clause.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

# The shared transient-error vocabulary: serving retries exactly what the
# training runtime's restart loop replays.
from repro_torch.runtime.fault_tolerance import TransientFailure  # noqa: F401


class Rejected(RuntimeError):
    """Base of every typed serving rejection (the server said no before
    spending compute — distinct from a dispatch *error*)."""


class Overloaded(Rejected):
    """Admission control: the bounded queue is full (or the target is
    closed) — the request was shed at the front door."""


class DeadlineExceeded(Rejected):
    """The request expired (or its client cancelled) before dispatch —
    shed at dequeue, before any compute was spent on it."""


class CircuitOpen(Rejected):
    """The engine's circuit breaker is open: recent dispatches failed
    persistently, so requests shed fast instead of queueing behind a
    sick engine."""


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff for transient dispatch failures.

    Attempt ``k`` (0-based) sleeps ``min(backoff_s * 2**k, backoff_cap_s)``
    before retrying; ``max_retries`` bounds the retries *after* the first
    attempt (``max_retries=2`` means at most 3 attempts total).
    """

    max_retries: int = 2
    backoff_s: float = 0.001
    backoff_cap_s: float = 0.050

    def delay(self, attempt: int) -> float:
        return min(self.backoff_s * (2 ** attempt), self.backoff_cap_s)


class CircuitBreaker:
    """Per-engine breaker: trip open after N *consecutive* failures.

    States:

      * **closed** — normal operation; failures increment a consecutive
        counter, any success resets it.
      * **open** — ``threshold`` consecutive failures were recorded;
        ``allow()`` returns False (callers shed with ``CircuitOpen``)
        until ``reset_s`` elapses.
      * **half_open** — the cooldown elapsed; ``allow()`` admits one
        probe. Success closes the breaker, failure re-opens it for
        another full cooldown.

    Thread-safe; ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, threshold: int = 5, reset_s: float = 30.0,
                 clock=time.perf_counter):
        assert threshold >= 1
        self.threshold = threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0     # consecutive
        self._opened_at: float | None = None
        self._probing = False  # half-open: one probe in flight
        self.trips = 0         # lifetime closed->open transitions

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._probing or self._clock() - self._opened_at >= self.reset_s:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """May a dispatch proceed? False while open; in half-open, True
        exactly once per cooldown (the probe)."""
        with self._lock:
            state = self._state_locked()
            if state == "closed":
                return True
            if state == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> bool:
        """Count one failure; returns True iff this failure trips (or
        re-trips) the breaker open."""
        with self._lock:
            if self._probing:  # the half-open probe failed: re-open
                self._probing = False
                self._opened_at = self._clock()
                return True
            self._failures += 1
            if self._opened_at is None and self._failures >= self.threshold:
                self._opened_at = self._clock()
                self.trips += 1
                return True
            return False

    def reset(self) -> None:
        """Force-close (the owner swapped in a healthy engine)."""
        self.record_success()

    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state_locked(),
                    "consecutive_failures": self._failures,
                    "threshold": self.threshold,
                    "trips": self.trips}
