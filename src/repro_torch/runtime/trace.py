"""The port's span recorder: where a request's host time goes, in memory.

One recorder a process. A span is a name, its own id, its parent's id
(0 for a root), its group (the id of the request or dispatch it belongs
to, so the spans of one request share it), the thread that closed it,
and its start and end in ``time.perf_counter_ns``, the clock
``Request.arrival`` and ``Request.done`` are stamped on.

A root is traced when, at its entry call, ``recording()`` is active in
the calling thread or a ``torch.profiler`` session records there
(``torch.autograd._profiler_enabled()``). The entry calls decide:
``InferenceEngine.run`` and ``run_batch`` outside a dispatch, and
``MicroBatcher.submit_request``, whose decision rides on the ``Request``
into the batcher's threads. A dispatch of a traced request is the
context of the thread that runs it until it ends, so the engine's spans
inside it join it.

Off, a root costs one check and an inner span one; nothing is recorded,
locked or launched. On, a span takes two clock reads and one locked
append; nothing touches the device. The log holds ``CAPACITY`` spans;
later ones still count in ``dropped`` and in the per-name totals, so a
session that outlasts the log still reads each name's count and time.

``snapshot()`` returns the totals, the log, ``dropped`` and one anchor
pair, a ``perf_counter_ns`` and a ``time_ns`` read together: a span's
``start_ns - anchor["perf_counter_ns"] + anchor["time_ns"]`` is its
start on the epoch clock of a ``torch.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

CAPACITY = 1 << 16  # spans the log holds

# one id space for requests and spans, so a group names either unambiguously
new_id = itertools.count(1).__next__

_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_thread = threading.get_ident
_FIELDS = ("name", "id", "parent", "group", "thread", "start_ns", "end_ns")


class _Local(threading.local):
    ctx = None      # (group, span id) of the thread's open traced span
    recording = 0   # depth of recording() blocks in the thread


_local = _Local()


class _Span:
    """An open span; ``prev`` is the thread's context it replaced."""

    __slots__ = ("name", "id", "parent", "group", "prev", "start")

    def __init__(self, name, sid, parent, group, prev):
        self.name, self.id, self.parent = name, sid, parent
        self.group, self.prev = group, prev
        self.start = _clock()


class _Recorder:
    def __init__(self, capacity=CAPACITY):
        self._lock = threading.Lock()
        self._capacity = capacity
        self.reset()

    def reset(self):
        with self._lock:
            self._log = [None] * self._capacity
            self._n = 0
            self._dropped = 0
            self._totals = {}

    def add(self, name, sid, parent, group, start, end, extra):
        span = (name, sid, parent, group, _thread(), start, end, extra)
        with self._lock:
            total = self._totals.get(name)
            if total is None:
                total = self._totals[name] = [0, 0]
            total[0] += 1
            total[1] += end - start
            if self._n < self._capacity:
                self._log[self._n] = span
                self._n += 1
            else:
                self._dropped += 1

    def snapshot(self):
        before = _clock()
        epoch = time.time_ns()
        after = _clock()
        with self._lock:
            log = self._log[:self._n]
            totals = {name: {"count": c, "total_ns": t}
                      for name, (c, t) in self._totals.items()}
            dropped = self._dropped
        return {"totals": totals,
                "spans": [dict(zip(_FIELDS, s[:-1]), **(s[-1] or {}))
                          for s in log],
                "dropped": dropped,
                "anchor": {"perf_counter_ns": (before + after) // 2,
                           "time_ns": epoch}}


_recorder = _Recorder()


# ----------------------------------------------------------------------
# the public surface


def snapshot() -> dict:
    """``totals`` (name -> ``count``, ``total_ns``, every span closed,
    the dropped too), ``spans`` (the log, in the order spans closed: dicts
    of ``name``, ``id``, ``parent``, ``group``, ``thread``, ``start_ns``,
    ``end_ns``, and a ``request`` span's ``dispatch_ns`` or a
    ``dispatch`` span's ``requests`` and ``padded``), ``dropped`` (spans
    closed once the log was full) and ``anchor``."""
    return _recorder.snapshot()


def reset() -> None:
    """Clear the log, the totals and ``dropped``."""
    _recorder.reset()


@contextlib.contextmanager
def recording():
    """Trace the roots entered in the calling thread inside the block."""
    _local.recording += 1
    try:
        yield
    finally:
        _local.recording -= 1


# ----------------------------------------------------------------------
# the program's hooks


def tracing() -> bool:
    """Whether a root entered now in the calling thread is traced."""
    return bool(_local.recording) or _profiling()


def root(name):
    """The span of an entry call, or None. Inside the thread's open
    traced span it is that span's child; else, when the thread is
    tracing, a new root. It is the thread's context until ``end``."""
    ctx = _local.ctx
    if ctx is None and not tracing():
        return None
    sid = new_id()
    group, parent = (sid, 0) if ctx is None else ctx
    span = _Span(name, sid, parent, group, ctx)
    _local.ctx = (group, sid)
    return span


def begin(name):
    """A new root span, decided traced by its caller; the thread's
    context until ``end``."""
    sid = new_id()
    span = _Span(name, sid, 0, sid, _local.ctx)
    _local.ctx = (sid, sid)
    return span


def leaf(name):
    """A span inside the thread's open traced span, or None; it holds no
    spans of its own."""
    ctx = _local.ctx
    if ctx is None:
        return None
    return _Span(name, new_id(), ctx[1], ctx[0], ctx)


def end(span, extra=None) -> None:
    """Close ``span`` (adding the fields of ``extra``) and give the
    thread back the context it had when the span opened."""
    stop = _clock()
    _local.ctx = span.prev
    _recorder.add(span.name, span.id, span.parent, span.group, span.start,
                  stop, extra)


def record(name, group, start_ns, end_ns, extra=None) -> None:
    """A root span from stamps taken elsewhere (a request's life)."""
    _recorder.add(name, new_id(), 0, group, start_ns, end_ns, extra)
