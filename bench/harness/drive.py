"""What every traffic driver shares: the record of one window, and the
wait for one answer.

A driver is ``bench/drivers/<driver>.py``, named by the mix's ``driver``
key; its ``drive(system, inputs, mix, seconds, seed, tracer)`` runs one
window of the mix against the system under test and returns a Record.
"""
from __future__ import annotations

from dataclasses import dataclass, field

RESULT_TIMEOUT_S = 60.0  # how long past the window an answer may come


@dataclass
class Record:
    """What one window did. ``answers`` holds (input index, host output)
    of every answer that came, ``missing`` the requests whose answer never
    came, ``errors`` those that raised; ``completed`` counts the answers
    in host memory inside the window of ``window_s`` seconds, and
    ``latencies_s`` their latencies. A driver that records more returns
    a subclass with fields of its own, for the metrics that read them."""
    window_s: float = 0.0
    attempted: int = 0
    completed: int = 0
    latencies_s: list = field(default_factory=list)
    answers: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    missing: int = 0


def collect(system, ticket, tracer, rec, k):
    """Wait for one ticket and record its answer to input ``k``; the
    output in host memory, or None."""
    try:
        with tracer.span("result"):
            out = system.result(ticket, RESULT_TIMEOUT_S)
        with tracer.span("copy_out"):
            host = out.cpu()
    except TimeoutError:
        rec.missing += 1
        return None
    except Exception as e:  # noqa: BLE001 - counted, not hidden
        rec.errors.append(repr(e))
        return None
    rec.answers.append((k, host))
    return host
