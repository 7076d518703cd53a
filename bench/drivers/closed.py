"""A closed loop with ``outstanding`` requests in flight, from one
driver thread: each request is the system's ``submit``, and is replaced
when its answer (``result``) reaches host memory. A request's latency
runs from its submit to its output in host memory; answers still in
flight when the window closes are drained and compared, not counted.
Mix keys: ``outstanding``, ``pool``."""
from __future__ import annotations

import time
from collections import deque

from bench.harness.drive import Record, collect


def drive(system, inputs, mix, seconds, seed, tracer):
    rec = Record()
    n = len(inputs)
    start = time.perf_counter()
    end = start + seconds
    inflight = deque()
    i = 0
    with tracer.window():
        for _ in range(mix["outstanding"]):
            with tracer.span("submit"):
                inflight.append((i % n, time.perf_counter(),
                                 system.submit(inputs[i % n])))
            i += 1
        while inflight:
            k, t0, ticket = inflight.popleft()
            host = collect(system, ticket, tracer, rec, k)
            now = time.perf_counter()
            if host is not None and now <= end:
                rec.completed += 1
                rec.latencies_s.append(now - t0)
            if now < end:
                with tracer.span("submit"):
                    inflight.append((i % n, time.perf_counter(),
                                     system.submit(inputs[i % n])))
                i += 1
            else:
                break
    for k, _, ticket in inflight:  # past the window: drained, compared
        collect(system, ticket, tracer, rec, k)
    rec.attempted = i
    rec.window_s = end - start
    return rec
