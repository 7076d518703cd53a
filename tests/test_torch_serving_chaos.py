"""The port's serving tier under scripted faults, on the CPU (ported from
``tests/test_chaos.py``): a deterministic ``FaultInjector`` drives retries,
the circuit breaker (on an injected clock), degraded mode on the
``xla_fallback_plan``, typed shedding, and stream frames under faults.
Dispatches are held open with a gate where the reference slept."""
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np
import pytest
import torch

from repro_torch.configs import get, tiny_variant
from repro_torch.core.dtypes import tolerance
from repro_torch.serving import (
    CircuitBreaker,
    CircuitOpen,
    DeadlineExceeded,
    EngineCache,
    FaultInjector,
    MicroBatcher,
    Overloaded,
    RetryPolicy,
    Server,
    ServingOptions,
    StreamSession,
    TransientFailure,
)

RESNET = tiny_variant(get("resnet18"))
MOBILENET = tiny_variant(get("mobilenet_v2"))
WAIT = 60
FAST_RETRY = RetryPolicy(max_retries=2, backoff_s=1e-4)


def _img(i=0):
    return np.random.default_rng(100 + i).standard_normal(
        (32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def engine():
    """One tuned engine for the batcher-level tests (no degrade hook is
    wired there, so nothing replaces it)."""
    return EngineCache(capacity=2, device="cpu").get(RESNET)


class Gate:
    """Holds the first dispatch of ``engine`` open until ``release``."""

    def __init__(self, engine):
        self.engine, self.entered, self.open = engine, threading.Event(), \
            threading.Event()
        real = engine.run

        def held(image):
            if not self.entered.is_set():
                self.entered.set()
                assert self.open.wait(WAIT)
            return real(image)

        engine.run = held

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.open.set()
        del self.engine.run


# ----------------------------------------------------------------------
# the injector: exact and reproducible


def test_faultinjector_script_is_deterministic_and_exact():
    fi = (FaultInjector()
          .fail("dispatch", 1, 3)
          .delay("dispatch", 2, seconds=0.5)
          .fail_from("build", 2, error=RuntimeError, message="persistent"))
    assert fi.check("dispatch") == 0.0
    with pytest.raises(TransientFailure):
        fi.check("dispatch")
    assert fi.check("dispatch") == 0.5
    with pytest.raises(TransientFailure):
        fi.check("dispatch")
    assert fi.check("dispatch") == 0.0
    assert fi.check("build") == 0.0 and fi.check("build") == 0.0
    for _ in range(3):
        with pytest.raises(RuntimeError, match="persistent"):
            fi.check("build")
    assert fi.count("dispatch") == 5 and fi.count("build") == 5
    assert fi.log == [("dispatch", 1, "error"), ("dispatch", 2, "delay"),
                      ("dispatch", 3, "error"), ("build", 2, "error"),
                      ("build", 3, "error"), ("build", 4, "error")]
    fi.clear("build")
    assert fi.check("build") == 0.0
    assert fi.count("build") == 6
    assert fi.stats() == {"counts": {"dispatch": 5, "build": 6},
                          "injected": 6}


def test_fault_error_instance_is_raised_as_is():
    boom = OSError("disk")
    fi = FaultInjector().fail("frame", 0, error=boom)
    with pytest.raises(OSError) as ei:
        fi.check("frame")
    assert ei.value is boom


# ----------------------------------------------------------------------
# transient faults: retried, resolved, bitwise


def test_transient_dispatch_fault_retried_bitwise(engine):
    fi = FaultInjector().fail("dispatch", 0)
    with MicroBatcher(engine, max_batch=1, window_ms=1.0, faults=fi,
                      retry=FAST_RETRY) as b:
        out = b.submit(_img()).result(WAIT)
    assert torch.equal(out, engine.run(_img()))
    st = b.stats()
    assert st["retries"] == 1
    assert st["breaker"]["state"] == "closed"
    assert st["breaker"]["consecutive_failures"] == 0
    assert fi.count("dispatch") == 2


def test_transient_chaos_every_accepted_future_resolves(engine):
    fi = FaultInjector().fail("dispatch", 1, 4, 5)
    with MicroBatcher(engine, max_batch=1, window_ms=1.0, faults=fi,
                      retry=FAST_RETRY) as b:
        futs = [(i, b.submit(_img(i))) for i in range(6)]
        outs = [(i, f.result(WAIT)) for i, f in futs]
    for i, out in outs:
        assert torch.equal(out, engine.run(_img(i))), i
    assert b.stats()["retries"] == 3


def test_retry_exhaustion_surfaces_the_transient_error(engine):
    fi = FaultInjector().fail("dispatch", 0, 1, 2)
    with MicroBatcher(engine, max_batch=1, window_ms=1.0, faults=fi,
                      retry=FAST_RETRY) as b:
        fut = b.submit(_img())
        with pytest.raises(TransientFailure):
            fut.result(WAIT)
    assert b.stats()["retries"] == 2


@pytest.mark.parametrize("attempt, seconds", [(0, 0.001), (1, 0.002),
                                               (5, 0.032), (6, 0.05),
                                               (20, 0.05)])
def test_retry_backoff_doubles_to_its_cap(attempt, seconds):
    assert RetryPolicy().delay(attempt) == pytest.approx(seconds)


# ----------------------------------------------------------------------
# persistent faults: breaker, degraded mode


def test_persistent_fault_trips_breaker_then_sheds_circuit_open(engine):
    fi = FaultInjector().fail_from("dispatch", 0, error=RuntimeError,
                                   message="sick tuned kernel")
    with MicroBatcher(engine, max_batch=1, window_ms=1.0, faults=fi,
                      retry=RetryPolicy(max_retries=0),
                      breaker=CircuitBreaker(threshold=3,
                                             reset_s=3600.0)) as b:
        errs = []
        for i in range(5):
            with pytest.raises(RuntimeError) as ei:
                b.submit(_img(i)).result(WAIT)
            errs.append(ei.value)
    assert all(not isinstance(e, CircuitOpen) for e in errs[:3])
    assert all(isinstance(e, CircuitOpen) for e in errs[3:])
    st = b.stats()
    assert st["breaker"] == {"state": "open", "consecutive_failures": 3,
                             "threshold": 3, "trips": 1}
    assert st["shed"]["breaker"] == 2
    assert fi.count("dispatch") == 3


def test_breaker_half_open_probe_cycle():
    t = [0.0]
    br = CircuitBreaker(threshold=2, reset_s=10.0, clock=lambda: t[0])
    assert br.allow() and br.state == "closed"
    assert br.record_failure() is False
    assert br.record_failure() is True  # second failure trips
    assert br.state == "open" and not br.allow()
    t[0] = 10.0  # cooldown elapsed
    assert br.state == "half_open"
    assert br.allow()          # exactly one probe
    assert not br.allow()
    assert br.record_failure() is True  # probe failed: re-open
    assert br.state == "open" and not br.allow()
    t[0] = 20.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()
    assert br.trips == 1
    assert br.stats() == {"state": "closed", "consecutive_failures": 0,
                          "threshold": 2, "trips": 1}


def test_server_persistent_fault_degrades_to_xla_and_keeps_serving():
    """Persistent dispatch faults trip the breaker, the batcher swaps in
    the cache's xla-fallback rebuild, and the answers stay within
    tolerance of the tuned engine's on the same weights."""
    fi = FaultInjector().fail_from("dispatch", 0, error=RuntimeError,
                                   message="persistent kernel fault")
    with Server(tiny=True, device="cpu", options=ServingOptions(
            max_batch=1, window_ms=1.0, faults=fi, breaker_threshold=3,
            retry=RetryPolicy(max_retries=0))) as server:
        server.warm("resnet18")
        tuned = server.engines.get(RESNET)
        ref = tuned.run(_img())
        outs, failures = [], 0
        for _ in range(4):
            try:
                outs.append(server.run("resnet18", _img(), timeout=WAIT))
            except RuntimeError:
                failures += 1
        st = server.stats()
        (key,) = server._batchers
        plan = server._batchers[key].engine.plan
    assert failures == 2 and len(outs) == 2
    assert st["degraded"] == 1 and st["cache"]["degraded_keys"]
    (bs,) = st["networks"].values()
    assert bs["degraded"] == 1 and bs["breaker"]["state"] == "closed"
    assert plan.choices and {c.algorithm for c in plan.choices.values()} \
        == {"xla"}
    for out in outs:
        assert ((out - ref).abs().max() / ref.abs().max()).item() \
            <= tolerance("float32")


def test_engine_cache_build_transient_fault_is_retried():
    fi = FaultInjector().fail("build", 0)
    cache = EngineCache(capacity=2, faults=fi, retry=FAST_RETRY,
                        device="cpu")
    eng = cache.get(RESNET)
    assert eng.run(_img()).dim() == 1
    assert cache.build_retries == 1 and cache.degraded == 0
    assert fi.count("build") == 2


def test_engine_cache_persistent_build_fault_raises_without_a_plan():
    fi = FaultInjector().fail_from("build", 0, error=RuntimeError,
                                   message="no build")
    cache = EngineCache(capacity=2, faults=fi, retry=FAST_RETRY,
                        device="cpu")
    with pytest.raises(RuntimeError, match="no build"):
        cache.get(RESNET)
    assert len(cache) == 0


def test_engine_cache_plan_deploy_failure_falls_back_to_xla():
    fi = FaultInjector()
    cache = EngineCache(capacity=1, faults=fi,
                        retry=RetryPolicy(max_retries=1, backoff_s=1e-4),
                        device="cpu")
    cache.get(RESNET)        # tunes and caches the plan
    cache.get(MOBILENET)     # capacity 1: evicts the resnet engine
    assert cache.evictions == 1
    fi.fail_from("plan_deploy", 0, error=RuntimeError,
                 message="deploy rejected")
    eng = cache.get(RESNET)  # the rebuild deploys the cached plan: fault
    assert {c.algorithm for c in eng.plan.choices.values()} == {"xla"}
    assert eng.run(_img()).dim() == 1
    assert cache.degraded == 1 and cache.stats()["degraded_keys"]


# ----------------------------------------------------------------------
# overload: typed shedding, accepted requests stay correct


def test_overload_sheds_typed_and_accepted_stay_bitwise(engine):
    want = [engine.run(_img(i)) for i in range(10)]
    with Gate(engine) as gate, MicroBatcher(
            engine, max_batch=1, window_ms=0.5, max_queue=2) as b:
        accepted = [(0, b.submit(_img(0)))]
        assert gate.entered.wait(WAIT)  # request 0 holds the loop
        rejected = 0
        for i in range(1, 10):
            try:
                accepted.append((i, b.submit(_img(i))))
            except Overloaded:
                rejected += 1
        gate.open.set()
        results = [(i, f.result(WAIT)) for i, f in accepted]
    assert (len(accepted), rejected) == (3, 7)
    assert b.stats()["shed"]["overload"] == rejected
    for i, out in results:
        assert torch.equal(out, want[i]), i


def test_expired_requests_shed_at_dequeue_before_compute(engine):
    fi = FaultInjector()
    with Gate(engine) as gate, MicroBatcher(
            engine, max_batch=1, window_ms=0.5, faults=fi) as b:
        first = b.submit(_img(0))
        assert gate.entered.wait(WAIT)
        late = [b.submit_request(_img(i), deadline_ms=1e-3)
                for i in (1, 2)]  # expire while queued behind request 0
        gate.open.set()
        assert first.result(WAIT) is not None
        for r in late:
            with pytest.raises(DeadlineExceeded, match="shed at dequeue"):
                r.future.result(WAIT)
    assert b.stats()["shed"]["deadline"] == 2
    assert fi.count("dispatch") == 1  # the shed never reached dispatch


def test_cancelled_request_sheds_at_dequeue(engine):
    fi = FaultInjector()
    with Gate(engine) as gate, MicroBatcher(
            engine, max_batch=1, window_ms=0.5, faults=fi) as b:
        first = b.submit(_img(0))
        assert gate.entered.wait(WAIT)
        req = b.submit_request(_img(1))
        req.cancel()
        gate.open.set()
        first.result(WAIT)
        with pytest.raises(DeadlineExceeded, match="cancelled"):
            req.future.result(WAIT)
    assert b.stats()["shed"]["cancelled"] == 1
    assert fi.count("dispatch") == 1


def test_server_run_timeout_cancels_the_queued_request():
    fi = FaultInjector()
    with Server(tiny=True, device="cpu", options=ServingOptions(
            max_batch=1, window_ms=0.5, faults=fi)) as server:
        server.warm("resnet18")
        with Gate(server.engines.get(RESNET)) as gate:
            blocker = server.submit("resnet18", _img(0))
            assert gate.entered.wait(WAIT)
            with pytest.raises(FutureTimeoutError):
                server.run("resnet18", _img(1), timeout=0.02)
            gate.open.set()
            blocker.result(WAIT)
            server.run("resnet18", _img(2), timeout=WAIT)  # after the shed
        (bs,) = server.stats()["networks"].values()
    assert bs["shed"]["cancelled"] == 1
    assert fi.count("dispatch") == 2  # never dispatched the dead one


# ----------------------------------------------------------------------
# streams under chaos (simulated clock: exact, repeatable accounting)


def _sim_stream(cache, faults, n_frames=6, sim_compute_s=0.008):
    session = StreamSession(cache.lease(RESNET), fps=30.0,
                            sim_compute_s=sim_compute_s, name="chaos",
                            faults=faults)
    frames = [session.submit_frame(_img(i)) for i in range(n_frames)]
    session.close()
    return session, frames


def test_stream_frame_fault_settles_frame_and_stream_survives():
    cache = EngineCache(capacity=2, device="cpu")
    fi = FaultInjector().fail("frame", 1, error=RuntimeError,
                              message="frame executor fault")
    session, frames = _sim_stream(cache, fi)
    with pytest.raises(RuntimeError, match="frame executor fault"):
        frames[1].future.result(WAIT)
    assert frames[1].missed and not frames[1].dropped
    engine = cache.get(RESNET)
    for f in frames[:1] + frames[2:]:
        assert torch.equal(f.future.result(WAIT), engine.run(_img(f.seq)))
    st = session.stats()
    assert st["frames"] == len(frames) and st["deadline_misses"] == 1
    assert cache.stats()["pinned"] == []  # close released the lease


def test_stream_injected_latency_spike_misses_deterministically():
    """A scripted spike joins the simulated compute charge as pure
    arithmetic: the same script, the same done-times and misses."""
    def run():
        cache = EngineCache(capacity=2, device="cpu")
        fi = FaultInjector().delay("frame", 2, seconds=0.05)
        session, frames = _sim_stream(cache, fi)
        return session.stats(), [(f.done, f.missed) for f in frames]

    stats_a, ledger_a = run()
    stats_b, ledger_b = run()
    assert ledger_a == ledger_b
    assert stats_a["deadline_misses"] == stats_b["deadline_misses"] == 1
    done, missed = ledger_a[2]
    assert missed
    period = 1.0 / 30.0
    assert done == pytest.approx(2 * period + 0.008 + 0.05, abs=1e-12)
    assert all(not m for (_, m) in ledger_a[:2] + ledger_a[3:])
