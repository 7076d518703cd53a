"""Cross-network device scheduler — N request queues, one accelerator
(``repro/serving/scheduler.py``).

Every network a ``Server`` serves owns a ``MicroBatcher`` with its own
forming batch; before this module each batcher's loop thread dispatched
straight onto the device, so the device-order across networks was
whatever the OS thread scheduler produced — a slow or cold network's
dispatches could land back-to-back and head-of-line block a fast one.

``DeviceScheduler`` serializes all dispatch onto one device-owner thread
and makes the interleaving policy explicit: jobs are ordered
**oldest-deadline-first across networks** (a request's deadline when the
batcher enforces one, its arrival otherwise — so deadline-free traffic
degrades to global FIFO), with ``priority`` (from ``RequestOptions``) as
the coarse tier above the time key. Each batcher blocks on at most one
in-flight job, so a network can never have more than one dispatch queued
on the device: however deep a slow network's *request* queue grows, a
fast network's next batch waits behind at most ``N - 1`` other networks'
single dispatches — the fairness bound ``tests/test_frontdoor.py`` pins.

The scheduler is non-preemptive (a running dispatch finishes; the paper's
single-image kernels are short) and intentionally dumb about devices: one
scheduler == one accelerator. Streaming sessions keep their own leases
and threads (cross-stream device scheduling is a roadmap item).
"""
from __future__ import annotations

import heapq
import itertools
import threading


class _Job:
    """One queued dispatch: the thunk, its ordering key, and a settled
    flag the submitting batcher blocks on."""

    __slots__ = ("fn", "network", "done", "result", "error")

    def __init__(self, fn, network):
        self.fn = fn
        self.network = network
        self.done = threading.Event()
        self.result = None
        self.error: BaseException | None = None


class DeviceScheduler:
    """Fair dispatch interleaving for one accelerator.

    ``run(fn, urgency=...)`` enqueues ``fn`` and blocks until the device
    thread executed it, returning its value (or re-raising its error in
    the caller — batcher retry/breaker logic is inside ``fn``, so the
    scheduler never interprets failures, it only orders work).
    """

    def __init__(self, name: str = "device0"):
        self.name = name
        self._cond = threading.Condition()
        self._heap: list[tuple[tuple, int, _Job]] = []
        self._seq = itertools.count()  # FIFO tie-break inside one key
        self._closed = False
        self._completed: dict[str, int] = {}  # network -> jobs finished
        self._depth_high_water = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"device-scheduler-{name}")
        self._thread.start()

    # ------------------------------------------------------------------

    def run(self, fn, *, urgency: float, priority: int = 0,
            network: str | None = None):
        """Execute ``fn`` on the device thread; blocks until done.

        ``urgency`` is the time key (absolute ``perf_counter`` value —
        a deadline or an arrival; smaller dispatches first). ``priority``
        sorts above it: a higher-priority job beats any lower-priority
        one regardless of age.
        """
        job = _Job(fn, network or "?")
        with self._cond:
            if self._closed:
                raise RuntimeError(
                    f"device scheduler {self.name!r} is closed")
            heapq.heappush(self._heap, ((-priority, urgency),
                                        next(self._seq), job))
            self._depth_high_water = max(self._depth_high_water,
                                         len(self._heap))
            self._cond.notify()
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._heap and not self._closed:
                    self._cond.wait()
                if not self._heap and self._closed:
                    return
                _key, _seq, job = heapq.heappop(self._heap)
            try:
                job.result = job.fn()
            except BaseException as e:  # noqa: BLE001 - relayed, not eaten
                job.error = e
            with self._cond:
                self._completed[job.network] = \
                    self._completed.get(job.network, 0) + 1
            job.done.set()

    # ------------------------------------------------------------------

    def close(self, timeout: float | None = 30.0) -> None:
        """Drain queued jobs, then stop the device thread. Idempotent.
        Close batchers first: a ``run`` racing ``close`` either lands in
        the drain or gets the typed closed error."""
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

    def stats(self) -> dict:
        with self._cond:
            return {"device": self.name,
                    "queued": len(self._heap),
                    "depth_high_water": self._depth_high_water,
                    "completed": dict(sorted(self._completed.items())),
                    "jobs": sum(self._completed.values())}
