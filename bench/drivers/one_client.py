"""A closed loop of one client with no think time: the system's ``run``
on each input in turn, cycling through them, then the output to host
memory. A request's latency runs from the call to its output in host
memory. Mix keys: ``pool``."""
from __future__ import annotations

import time

from bench.harness.drive import Record


def drive(system, inputs, mix, seconds, seed, tracer):
    rec = Record()
    n = len(inputs)
    start = time.perf_counter()
    end = start + seconds
    done = start
    i = 0
    with tracer.window():
        while True:
            t0 = time.perf_counter()
            if t0 >= end:
                break
            k = i % n
            try:
                with tracer.span("engine.run"):
                    out = system.run(inputs[k])
                with tracer.span("copy_out"):
                    host = out.cpu()
            except Exception as e:  # noqa: BLE001 - counted, not hidden
                rec.errors.append(repr(e))
                host = None
            done = time.perf_counter()
            i += 1
            if host is not None:
                rec.answers.append((k, host))
                rec.latencies_s.append(done - t0)
    rec.attempted = i
    rec.completed = len(rec.answers)
    rec.window_s = done - start
    return rec
