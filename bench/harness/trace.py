"""The ``--trace 1`` run's device trace, read from ``torch.profiler``.

The harness marks its own host spans (``bench.window`` around the whole
window, and ``bench.<what>`` around each call into the program) with
``record_function``; they land in the profiler's trace on the same clock
as the device's work. From the trace this module takes:

- the window: the ``bench.window`` span;
- the device's busy time: the union over streams of every kernel, copy
  and set on the device inside the window (operations that overlap count
  once);
- the device operations inside the window;
- the top device operations by time, and the longest idle gaps, each
  named by the innermost ``bench.*`` span open at its middle (``program``
  where none is: the host is in the program's own threads).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: int
    top_ops: list = field(default_factory=list)    # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)  # [[span, seconds]]


class Tracer:
    """Spans and, when ``on``, the profiler around the window."""

    def __init__(self, on):
        self.on = on
        self._prof = None
        if on:
            from torch.profiler import record_function
            self._record = record_function

    def span(self, name):
        """A ``bench.<name>`` span in the trace (nothing when off)."""
        if not self.on:
            return contextlib.nullcontext()
        return self._record(f"bench.{name}")

    def window(self):
        return self.span("window")

    def start(self):
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self):
        if self._prof is not None:
            self._prof.stop()

    def summary(self):
        """The TraceSummary of the window, or None when off or when the
        trace holds no window."""
        if self._prof is None:
            return None
        return summarize(_events(self._prof))


def _kind(e):
    """"device" for a kernel, copy or set on the device, "span" for one of
    the harness's ``bench.*`` host spans, else "other"."""
    name = e.name()
    activity = getattr(e, "activity_type", None)
    if activity is not None:  # newer PyTorch names the activity
        activity = activity()
        if activity in DEVICE_ACTIVITIES:
            return "device"
        return "span" if activity == "user_annotation" \
            and name.startswith("bench.") else "other"
    from torch.autograd import DeviceType

    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if e.device_type() == DeviceType.CUDA:
        # a record_function range also shows on the device as an
        # annotation of the same name, spanning its kernels
        return "other" if annotation or name.startswith("bench.") \
            else "device"
    return "span" if name.startswith("bench.") else "other"


def _events(prof):
    """(name, kind, start_ns, end_ns) of every event in the trace, in
    whole nanoseconds (a float of seconds since the epoch would round to
    a quarter of a microsecond)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), _kind(e), start, start + e.duration_ns()))
    return out


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def summarize(events, top=10):
    """The TraceSummary of ``events`` (times in nanoseconds)."""
    windows = [(s, e) for name, kind, s, e in events
               if kind == "span" and name == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0]
    device, spans = [], []
    for name, kind, s, e in events:
        if kind == "device":
            if e > w0 and s < w1:
                device.append((name, max(s, w0), min(e, w1)))
        elif kind == "span" and name != WINDOW:
            spans.append((name[len("bench."):], s, e))
    busy = union((s, e) for _, s, e in device)
    busy_s = sum(e - s for s, e in busy)
    by_name = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        open_ = [(se - ss, name) for name, ss, se in spans
                 if ss <= mid <= se]
        idle.append([min(open_)[1] if open_ else "program", length])
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy_s / 1e9,
                        device_ops=len(device),
                        top_ops=[[n[:120], t / 1e9] for n, t in top_ops],
                        idle_gaps=[[n, t / 1e9] for n, t in idle])
