"""Deterministic fault injection for the serving stack
(``repro/serving/faults.py``).

Chaos testing a serving tier only proves something if the chaos is
*reproducible*: the same script must produce the same retries, trips,
sheds, and degrades on every run, or the test flakes and the gate is
noise. A ``FaultInjector`` is that script: per **site**, a map from call
index (0-based, in call order) to an injected fault — an exception, a
latency spike, or both. The instrumented code calls ``check(site)`` once
per operation; the injector advances the site's counter, raises the
scripted error (if any) and returns the scripted delay in seconds.

Sites threaded through the serving stack:

  =============  =====================================================
  site           one check per...
  =============  =====================================================
  ``dispatch``   MicroBatcher dispatch *attempt* (retries re-check, so
                 "fail attempts 0 and 1, succeed on 2" is scriptable).
                 Skipped once the batcher runs a degraded engine: the
                 injected fault models a sick *tuned kernel*, and the
                 xla fallback path does not contain it.
  ``frame``      StreamSession frame execution (latency spikes add to
                 the simulated compute charge deterministically).
  ``build``      EngineCache engine-build attempt.
  ``plan_deploy``EngineCache build that deploys a cached tuning plan.
  =============  =====================================================

Scripting:

  * ``fail(site, *indices)`` / ``fail_from(site, start)`` — raise at the
    given call indices / at every index >= ``start`` (persistent fault).
  * ``delay(site, *indices, seconds=s)`` / ``delay_from(site, start,
    seconds=s)`` — inject a latency spike. Threaded callers sleep it;
    the simulated clock adds it to the compute charge (pure arithmetic,
    so deadline accounting stays deterministic).

The default error type is ``TransientFailure`` — the retryable class; a
persistent Pallas-style fault is modeled with ``error=RuntimeError`` (or
any non-transient type) plus ``fail_from``. ``log`` records every
injection as ``(site, index, kind)`` so tests can assert the script
actually fired. Counters are lock-protected; determinism additionally
needs a deterministic caller (one loop thread per site, which is how the
batcher and sessions are built).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

from repro_torch.runtime.fault_tolerance import TransientFailure

SITES = ("dispatch", "frame", "build", "plan_deploy")


@dataclass(frozen=True)
class Fault:
    """One scripted injection: raise ``error`` (a BaseException subclass
    or instance; None = no error) and/or report ``delay_s`` seconds of
    injected latency."""

    error: object = None
    delay_s: float = 0.0
    message: str | None = None

    def raise_if_error(self, site: str, index: int) -> None:
        if self.error is None:
            return
        if isinstance(self.error, BaseException):
            raise self.error
        msg = self.message or f"injected fault at {site}[{index}]"
        raise self.error(msg)


class FaultInjector:
    """A deterministic, scripted fault plan shared across the serving
    stack (pass one injector to ``Server(faults=...)``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._at: dict[str, dict[int, Fault]] = {}     # site -> idx -> Fault
        self._from: dict[str, tuple[int, Fault]] = {}  # site -> (start, Fault)
        self._counts: dict[str, int] = {}
        self.log: list[tuple[str, int, str]] = []      # (site, idx, kind)

    # ------------------------------------------------------------------
    # scripting

    def fail(self, site: str, *indices: int, error=TransientFailure,
             message: str | None = None) -> "FaultInjector":
        """Raise ``error`` on the given call indices of ``site``."""
        with self._lock:
            for i in indices:
                self._at.setdefault(site, {})[i] = Fault(error=error,
                                                         message=message)
        return self

    def fail_from(self, site: str, start: int = 0, *, error=TransientFailure,
                  message: str | None = None) -> "FaultInjector":
        """Raise ``error`` on every call index >= ``start`` — a
        *persistent* fault (what trips the circuit breaker)."""
        with self._lock:
            self._from[site] = (start, Fault(error=error, message=message))
        return self

    def delay(self, site: str, *indices: int,
              seconds: float) -> "FaultInjector":
        """Inject a latency spike of ``seconds`` at the given indices."""
        with self._lock:
            for i in indices:
                self._at.setdefault(site, {})[i] = Fault(delay_s=seconds)
        return self

    def delay_from(self, site: str, start: int = 0, *,
                   seconds: float) -> "FaultInjector":
        """Inject ``seconds`` of latency on every call >= ``start`` (a
        fixed service-time floor — the overload bench's capacity knob)."""
        with self._lock:
            self._from[site] = (start, Fault(delay_s=seconds))
        return self

    def clear(self, site: str | None = None) -> "FaultInjector":
        """Drop the script (one site, or everything); counters survive."""
        with self._lock:
            sites = [site] if site is not None else \
                list(self._at.keys() | self._from.keys())
            for s in sites:
                self._at.pop(s, None)
                self._from.pop(s, None)
        return self

    # ------------------------------------------------------------------
    # the instrumented-code side

    def check(self, site: str) -> float:
        """One operation at ``site``: advance the call counter, raise the
        scripted error if this index has one, return the scripted delay
        in seconds (0.0 when none). Callers apply the delay themselves —
        threaded code sleeps it, simulated clocks add it to the charge."""
        with self._lock:
            i = self._counts.get(site, 0)
            self._counts[site] = i + 1
            fault = self._at.get(site, {}).get(i)
            if fault is None and site in self._from:
                start, f = self._from[site]
                if i >= start:
                    fault = f
            if fault is None:
                return 0.0
            kind = ("error" if fault.error is not None else "delay")
            self.log.append((site, i, kind))
        fault.raise_if_error(site, i)
        return fault.delay_s

    def count(self, site: str) -> int:
        """How many times ``site`` has been checked so far."""
        with self._lock:
            return self._counts.get(site, 0)

    def stats(self) -> dict:
        with self._lock:
            return {"counts": dict(self._counts),
                    "injected": len(self.log)}
