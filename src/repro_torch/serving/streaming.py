"""Streaming inference: fixed-rate frame sessions over leased engines
(``repro/serving/streaming.py``).

The paper's scenario is latency-bound single-image inference; the
canonical mobile workload for it is not one-shot classification but a
camera loop — fixed-rate frames with a strict per-frame deadline
(openpilot's driver-monitoring model is the ROADMAP's exemplar). A
``StreamSession`` is one such loop:

  * it owns a **per-stream engine lease** from the ``EngineCache``
    (``EngineCache.lease``): the engine is pinned against LRU eviction for
    the session's lifetime, so a burst of classify traffic for other
    networks can never evict the engine out from under a live stream;
  * frames flow through a **double-buffered input slot**: the host→device
    transfer (``engine.device_put_frame``) starts at frame arrival, on the
    submitting thread, so frame ``t+1``'s transfer overlaps frame ``t``'s
    compute; the transfer goes through pinned host buffers that are reused
    once their copy has completed, and ``run_stream`` consumes the frame's
    device buffer (the reference donates it);
  * when compute falls behind the frame rate, the **skip-to-latest** drop
    policy discards every queued frame except the newest — the session
    always works on the freshest camera frame instead of building a
    stale-frame backlog;
  * every frame is stamped (arrival / dispatch / done) against the
    session's clock and judged against its **deadline** (default: one
    frame period after arrival), so the session reports a per-stream
    deadline-miss rate, not just throughput.

Two pacing modes share all of that machinery:

  * **threaded** (default, ``sim_compute_s=None``): a daemon thread owns
    dispatch, stamps are wall-clock, and ``submit_frame`` may be called
    from any producer thread at any real rate. This is the deployment
    shape.
  * **simulated clock** (``sim_compute_s=<seconds>``): ``submit_frame``
    processes synchronously and time is pure event arithmetic — frame
    ``k`` of a ``fps``-rate stream arrives at exactly ``k/fps`` and each
    dispatch occupies the device for exactly ``sim_compute_s``. The real
    kernels still run (outputs are bitwise-equal to ``engine.run``), but
    deadline accounting is deterministic: CI can gate on the miss rate.

``StreamScheduler`` drives K simulated sessions in global arrival order —
the multi-stream merge that lets a 4×30 fps scenario share one engine
cache with on-demand ``Server.submit`` classify traffic, deterministically.
"""
from __future__ import annotations

import heapq
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from repro_torch.serving.batcher import settle

_STOP = object()


class FrameDropped(RuntimeError):
    """Resolution of a frame skipped by the skip-to-latest drop policy."""


class Clock:
    """Wall clock — the threaded (deployment) time source."""

    def now(self) -> float:
        return time.perf_counter()


@dataclass
class Frame:
    """One frame in flight: stamps are seconds on the session's clock.

    ``arrival`` is when the frame entered the session (and its host→device
    transfer started); ``dispatch`` when compute began; ``done`` when the
    logits were ready. ``deadline`` is absolute (``arrival + deadline_s``);
    ``missed`` is ``done > deadline`` — a dropped frame always counts as
    missed (it never produced output at all).
    """

    seq: int
    arrival: float
    deadline: float
    dispatch: float | None = None
    done: float | None = None
    dropped: bool = False
    missed: bool | None = None
    future: Future = field(default_factory=Future)

    @property
    def latency(self) -> float | None:
        """Seconds from arrival to logits; None if dropped / in flight."""
        return None if self.done is None else self.done - self.arrival


class StreamSession:
    """One fixed-rate frame stream over one leased engine.

    ``lease`` is an ``EngineLease`` (see ``EngineCache.lease``); the
    session owns it and releases it on ``close``. ``fps`` sets the nominal
    frame period; ``deadline_ms`` the per-frame deadline (default: one
    frame period). ``sim_compute_s`` switches to the simulated clock
    (synchronous, deterministic — see module docstring); ``phase_s``
    offsets the simulated stream's first arrival so K streams don't all
    tick at the same instant.
    """

    def __init__(self, lease, *, fps: float = 30.0,
                 deadline_ms: float | None = None, clock: Clock | None = None,
                 sim_compute_s: float | None = None, phase_s: float = 0.0,
                 name: str = "stream", faults=None):
        assert fps > 0
        self.lease = lease
        self.engine = lease.engine
        self.name = name
        # FaultInjector (site "frame"): scripted per-frame errors settle
        # the frame and keep the stream alive; scripted latency spikes
        # sleep in threaded mode and add to the compute charge under the
        # simulated clock (deterministic deadline misses).
        self._faults = faults
        self.period_s = 1.0 / fps
        self.deadline_s = (self.period_s if deadline_ms is None
                           else deadline_ms / 1e3)
        self.clock = clock if clock is not None else Clock()
        self.sim_compute_s = sim_compute_s
        self.frames: list[Frame] = []  # settled (completed or dropped)
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False
        if sim_compute_s is None:  # threaded: a daemon thread owns dispatch
            self._queue: queue.Queue = queue.Queue()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"stream-{name}-{id(self):x}")
            self._thread.start()
        else:  # simulated clock: pure event-time arithmetic
            assert sim_compute_s > 0
            self._free_at = 0.0           # device-busy horizon
            self._pending = None          # (Frame, device buffer) slot
            self._next_t = float(phase_s)

    # ------------------------------------------------------------------
    # producer side

    @property
    def next_arrival(self) -> float:
        """Simulated mode: the arrival time of the next auto-paced frame
        (``phase_s + k * period``). The scheduler merges streams on it."""
        assert self.sim_compute_s is not None
        return self._next_t

    def submit_frame(self, image) -> Frame:
        """Feed one (H, W, C) frame; returns its ``Frame`` record.

        The host→device transfer starts here, on the calling thread —
        in threaded mode that is the double-buffer overlap: frame ``t+1``
        transfers while the dispatch thread computes frame ``t``. The
        frame's future resolves to the (classes,) logits, or raises
        ``FrameDropped`` if skip-to-latest discarded it.
        """
        if self._closed:
            raise RuntimeError("stream session is closed")
        if self.sim_compute_s is None:
            arrival = self.clock.now()
        else:
            arrival = self._next_t
            self._next_t += self.period_s
        buf = self.engine.device_put_frame(image)  # async transfer starts
        frame = Frame(seq=self._seq, arrival=arrival,
                      deadline=arrival + self.deadline_s)
        self._seq += 1
        if self.sim_compute_s is None:
            self._queue.put((frame, buf))
        else:
            self._submit_sim(frame, buf)
        return frame

    def flush(self) -> None:
        """Settle every submitted frame (simulated mode: dispatch the
        pending slot; threaded mode: wait for the queue to drain)."""
        if self.sim_compute_s is not None:
            self._drain_sim(float("inf"))
        else:
            self._queue.join()

    def close(self) -> None:
        """Flush, stop the dispatch thread, release the engine lease."""
        if self._closed:
            return
        self._closed = True
        if self.sim_compute_s is None:
            self._queue.put((_STOP, None))
            self._thread.join(30.0)
            # a submit racing close() can enqueue behind the stop
            # sentinel; settle those frames instead of leaving futures
            # unresolved (same contract as MicroBatcher.close)
            while True:
                try:
                    frame, _ = self._queue.get_nowait()
                except queue.Empty:
                    break
                if frame is not _STOP:
                    self._drop(frame)
                self._queue.task_done()
        else:
            self._drain_sim(float("inf"))
        self.lease.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # simulated-clock mode: synchronous, deterministic event arithmetic

    def _submit_sim(self, frame: Frame, buf) -> None:
        self._drain_sim(frame.arrival)
        if self._free_at <= frame.arrival:  # device idle: dispatch now
            self._run_frame(frame, buf, dispatch=frame.arrival)
        else:  # device busy: the new frame takes the single pending slot
            if self._pending is not None:  # skip-to-latest: drop the old
                self._drop(self._pending[0])
            self._pending = (frame, buf)

    def _drain_sim(self, now: float) -> None:
        """Dispatch the pending frame if the device frees by ``now``
        (``inf`` forces it out — flush/close)."""
        if self._pending is not None and self._free_at <= now:
            frame, buf = self._pending
            self._pending = None
            self._run_frame(frame, buf, dispatch=self._free_at)

    # ------------------------------------------------------------------
    # threaded mode: a dispatch loop with skip-to-latest on its queue

    def _loop(self) -> None:
        stopping = False
        while not stopping:
            frame, buf = self._queue.get()
            if frame is _STOP:
                self._queue.task_done()
                break
            # skip-to-latest: everything queued behind the in-flight
            # compute is stale except the newest frame — drop the rest
            while True:
                try:
                    nxt, nbuf = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    self._queue.task_done()
                    break
                self._drop(frame)
                self._queue.task_done()
                frame, buf = nxt, nbuf
            self._run_frame(frame, buf, dispatch=self.clock.now())
            self._queue.task_done()

    # ------------------------------------------------------------------
    # shared: dispatch + settle

    def _run_frame(self, frame: Frame, buf, *, dispatch: float) -> None:
        frame.dispatch = dispatch
        delay = 0.0
        try:
            if self._faults is not None:
                delay = self._faults.check("frame")
                if delay and self.sim_compute_s is None:
                    time.sleep(delay)  # sim mode charges it arithmetically
            logits = self.engine.run_stream(buf)
            settle([logits])
        except Exception as e:  # settle the frame, keep the stream alive
            frame.done = (dispatch + self.sim_compute_s
                          if self.sim_compute_s is not None
                          else self.clock.now())
            frame.missed = True
            with self._lock:
                self.frames.append(frame)
            frame.future.set_exception(e)
            return
        if self.sim_compute_s is not None:
            # injected latency joins the deterministic compute charge, so
            # a scripted spike produces the exact same miss accounting on
            # every run — chaos tests gate on it
            frame.done = dispatch + self.sim_compute_s + delay
            self._free_at = frame.done
        else:
            frame.done = self.clock.now()
        frame.missed = frame.done > frame.deadline
        with self._lock:
            self.frames.append(frame)
        frame.future.set_result(logits)

    def _drop(self, frame: Frame) -> None:
        frame.dropped = True
        frame.missed = True  # a dropped frame never met its deadline
        with self._lock:
            self.frames.append(frame)
        frame.future.set_exception(FrameDropped(
            f"frame {frame.seq} skipped: compute fell behind the "
            f"{1.0 / self.period_s:g} fps frame rate"))

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Per-stream deadline accounting over the settled frames."""
        with self._lock:
            frames = list(self.frames)
        completed = [f for f in frames if not f.dropped and f.done is not None]
        dropped = [f for f in frames if f.dropped]
        total = len(completed) + len(dropped)
        misses = sum(1 for f in frames if f.missed)
        lats = sorted(f.latency for f in completed)

        def pct(q):
            if not lats:
                return None
            return lats[min(len(lats) - 1, round(q / 100 * (len(lats) - 1)))]

        span = (max(f.done for f in completed)
                - min(f.arrival for f in frames)) if completed else None
        return {
            "name": self.name,
            "dtype": self.engine.cfg.dtype,
            "fps_target": 1.0 / self.period_s,
            "deadline_ms": self.deadline_s * 1e3,
            "frames": total,
            "completed": len(completed),
            "dropped": len(dropped),
            "deadline_misses": misses,
            "deadline_miss_rate": misses / total if total else None,
            "fps_achieved": len(completed) / span if span else None,
            "latency_p50_s": pct(50),
            "latency_p95_s": pct(95),
            "latency_max_s": lats[-1] if lats else None,
        }


class StreamScheduler:
    """Drive K simulated-clock sessions in global arrival order.

    The next frame to arrive *across all streams* is submitted next, so K
    fixed-rate streams interleave exactly as their timestamps dictate —
    the deterministic multi-stream merge the bench gate runs. (Threaded
    sessions don't need a scheduler: each owns a dispatch thread, which is
    what keeps one stream's compute from head-of-line-blocking another's.)
    """

    def __init__(self, sessions):
        self.sessions = list(sessions)
        assert self.sessions
        assert all(s.sim_compute_s is not None for s in self.sessions), \
            "StreamScheduler drives simulated-clock sessions only"

    def run(self, n_frames: int, image_fn) -> list[list[Frame]]:
        """Submit ``n_frames`` per stream, ``image_fn(stream_idx, seq)``
        supplying each frame; flushes every session and returns the Frame
        records grouped per stream."""
        heap = [(s.next_arrival, i, 0) for i, s in enumerate(self.sessions)]
        heapq.heapify(heap)
        frames: list[list[Frame]] = [[] for _ in self.sessions]
        while heap:
            _, i, k = heapq.heappop(heap)
            s = self.sessions[i]
            frames[i].append(s.submit_frame(image_fn(i, k)))
            if k + 1 < n_frames:
                heapq.heappush(heap, (s.next_arrival, i, k + 1))
        for s in self.sessions:
            s.flush()
        return frames
