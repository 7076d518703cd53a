"""Serving request types — what a client submits and what it awaits
(``repro/serving/request.py``).

A ``Request`` is one single-image inference in flight: the image, a
``concurrent.futures.Future`` that resolves to the logits, and timestamps
so the server can report queueing + batching latency per request. Clients
never construct these directly — the front door hands back a ``Ticket``
wrapping one — but tests and benchmarks read the timing fields off
completed ones.

``RequestOptions`` is the per-call options object (the public replacement
for the deprecated ``dtype=`` kwarg sprawl): precision variant, per-request
deadline override, and scheduling priority, all frozen so a shared options
object can never be mutated mid-flight.

``Ticket`` is the one result handle. ``Server.submit`` returns it,
``Server.run`` blocks on it, and the wire endpoint (a later slice of the
port) will resolve it into a response frame — one type for every call
style. ``result(timeout)`` carries
the cancel-on-timeout semantics that used to live only on ``Server.run``:
a timed-out wait cancels the request so the batcher sheds it at dequeue
instead of computing logits nobody is waiting for.
"""
from __future__ import annotations

import itertools
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field, replace

_IDS = itertools.count()


@dataclass(frozen=True)
class RequestOptions:
    """Per-request options (frozen): ``dtype`` picks the network's
    precision variant (own engine-cache entry, dtype-keyed plan; None =
    the config's native precision), ``deadline_ms`` overrides the server's
    default shed deadline for this request alone, and ``priority`` biases
    the cross-network device scheduler (higher dispatches first)."""

    dtype: str | None = None
    deadline_ms: float | None = None
    priority: int = 0

    def merged_dtype(self, dtype: str | None) -> "RequestOptions":
        """This options object with a (deprecated-path) ``dtype`` folded
        in; rejects conflicting values rather than silently picking one."""
        if dtype is None or dtype == self.dtype:
            return self
        if self.dtype is not None:
            raise ValueError(
                f"conflicting dtypes: options.dtype={self.dtype!r} vs "
                f"dtype={dtype!r}")
        return replace(self, dtype=dtype)


@dataclass
class Request:
    """One single-image request: ``image`` is (H, W, C) NHWC-minus-batch;
    ``future`` resolves to the (classes,) logits (or raises the dispatch
    error). ``arrival`` is set at submit time; ``done`` when the batcher
    resolves the future — their difference is the request's full latency
    (queue wait + batching window + dispatch).

    ``deadline`` is an absolute clock value (``arrival + deadline_s``,
    stamped at admission when the batcher enforces one): a request still
    queued past it is **shed at dequeue** — failed with
    ``DeadlineExceeded`` before any compute is spent. ``cancel()`` marks
    the request for the same shed path (``Ticket.result`` calls it when
    its timeout fires, so a timed-out request never burns a dispatch).
    ``priority`` feeds the device scheduler's ordering key."""

    image: object
    future: Future = field(default_factory=Future)
    arrival: float = field(default_factory=time.perf_counter)
    done: float | None = None
    deadline: float | None = None
    cancelled: bool = False
    priority: int = 0
    id: int = field(default_factory=lambda: next(_IDS))

    @property
    def latency(self) -> float | None:
        """Seconds from submit to resolution; None while in flight."""
        return None if self.done is None else self.done - self.arrival

    @property
    def urgency(self) -> float:
        """The scheduler's time key: the deadline when one is set, the
        arrival otherwise — oldest-deadline-first degrades to FIFO for
        deadline-free traffic."""
        return self.arrival if self.deadline is None else self.deadline

    def cancel(self) -> None:
        """Request shedding at dequeue (client gave up). Best-effort: a
        request already mid-dispatch still completes."""
        self.cancelled = True

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class Ticket:
    """The one result handle for a submitted request.

    ``Server.submit`` returns a Ticket; ``Server.run`` is
    ``submit(...).result(timeout)``; the wire endpoint registers a done
    callback on one; the async client awaits the same states over the
    socket. The raw ``concurrent.futures.Future`` stays an implementation
    detail (``.future`` is the escape hatch).
    """

    __slots__ = ("_request",)

    def __init__(self, request: Request):
        self._request = request

    # ------------------------------------------------------------------
    # result access

    def result(self, timeout: float | None = None):
        """Block for the logits (or re-raise the typed rejection /
        dispatch error). On timeout the request is **cancelled** before
        the ``TimeoutError`` propagates: if it is still queued, the
        batcher sheds it at dequeue instead of burning a dispatch on a
        result nobody is waiting for."""
        try:
            return self._request.future.result(timeout)
        except FutureTimeoutError:
            self.cancel()
            raise

    def exception(self, timeout: float | None = None):
        """The settled exception (None on success); does NOT cancel on
        timeout — it is the inspection hook, ``result`` is the wait."""
        return self._request.future.exception(timeout)

    def cancel(self) -> None:
        """Give up on the request: still-queued, it sheds at dequeue
        (``DeadlineExceeded``); mid-dispatch, it completes anyway."""
        self._request.cancel()

    def done(self) -> bool:
        return self._request.future.done()

    def add_done_callback(self, fn) -> None:
        """``fn(ticket)`` once the request settles (result or error) —
        what the wire endpoint uses to turn completions into frames."""
        self._request.future.add_done_callback(lambda _f: fn(self))

    # ------------------------------------------------------------------
    # latency stamps

    @property
    def id(self) -> int:
        return self._request.id

    @property
    def arrival(self) -> float:
        """Submit-time ``perf_counter`` stamp."""
        return self._request.arrival

    @property
    def done_at(self) -> float | None:
        """Resolution-time stamp; None while in flight."""
        return self._request.done

    @property
    def latency(self) -> float | None:
        """Seconds from submit to resolution; None while in flight."""
        return self._request.latency

    @property
    def future(self) -> Future:
        """The raw Future (escape hatch for executor-style composition)."""
        return self._request.future

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "done" if self.done() else "pending"
        return f"Ticket(id={self.id}, {state})"


def resolve(req: Request, value) -> None:
    """Stamp completion time and fulfil the future."""
    req.done = time.perf_counter()
    req.future.set_result(value)


def fail(req: Request, exc: BaseException) -> None:
    req.done = time.perf_counter()
    req.future.set_exception(exc)
