"""The port's front door on the CPU (ported from ``tests/test_frontdoor.py``
and ``tests/test_serving.py``): the cross-network ``DeviceScheduler``, the
options objects and their deprecation shim, the ``Server``'s
``submit``/``run``/``warm``/``stats``/``close``, and the public surface.

Scheduler order is driven by a job that holds the device thread on a
``threading.Event``, not by sleeps."""
import threading
import warnings

import numpy as np
import pytest
import torch

import repro_torch.serving as serving
from repro_torch.configs import get, tiny_variant
from repro_torch.serving import (
    DeviceScheduler,
    MicroBatcher,
    Overloaded,
    Rejected,
    RequestOptions,
    Server,
    ServingOptions,
    Ticket,
)
from repro_torch.serving.server import Server as ServerClass

WAIT = 60


def _image(seed):
    return np.random.default_rng(seed).standard_normal(
        (32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_server():
    with Server(tiny=True, device="cpu", options=ServingOptions(
            max_batch=4, window_ms=2.0)) as server:
        yield server


# ---------------------------------------------------------------------------
# device scheduler


def test_scheduler_runs_jobs_and_relays_errors():
    with DeviceScheduler() as sched:
        assert sched.run(lambda: 42, urgency=0.0) == 42
        with pytest.raises(ValueError, match="boom"):
            sched.run(lambda: (_ for _ in ()).throw(ValueError("boom")),
                      urgency=0.0)
    with pytest.raises(RuntimeError, match="closed"):
        sched.run(lambda: 1, urgency=0.0)


def test_scheduler_orders_by_urgency_then_priority():
    """Queued jobs leave the heap oldest-deadline-first; priority sorts
    above the time key."""
    order = []
    gate, release = threading.Event(), threading.Event()

    def job(tag, wait=False):
        def fn():
            if wait:
                gate.set()
                assert release.wait(WAIT)
            order.append(tag)
        return fn

    with DeviceScheduler() as sched:
        threads = [threading.Thread(target=lambda: sched.run(
            job("hold", wait=True), urgency=0.0), daemon=True)]
        threads[0].start()
        assert gate.wait(WAIT)  # the device thread is inside "hold"
        for tag, urg, pri in (("late", 3.0, 0), ("soon", 1.0, 0),
                              ("mid", 2.0, 0), ("vip", 9.0, 1)):
            t = threading.Thread(
                target=lambda tag=tag, urg=urg, pri=pri: sched.run(
                    job(tag), urgency=urg, priority=pri, network=tag),
                daemon=True)
            t.start()
            threads.append(t)
        queued = threading.Event()
        for _ in range(WAIT * 100):  # until all four are in the heap
            if sched.stats()["queued"] == 4:
                queued.set()
                break
            queued.wait(0.01)
        assert queued.is_set()
        release.set()
        for t in threads:
            t.join(WAIT)
        stats = sched.stats()
    assert order == ["hold", "vip", "soon", "mid", "late"]
    assert stats["completed"]["vip"] == 1
    assert stats["depth_high_water"] == 4


def test_scheduler_fairness_one_dispatch_in_flight_a_network():
    """A slow network with a deep queue and a fast one share the device.
    Each batcher has at most one job queued, so once a fast job is queued
    only the slow job queued beside it (its older arrival sorts first)
    runs before it, and another only where the slow batcher requeues
    between two heap pops; never the rest of the slow queue."""
    log = []

    class Logged:
        def __init__(self, tag):
            self.tag = tag

        def run(self, image):
            log.append(("ran", self.tag))
            return torch.zeros(1)

    class LoggedScheduler(DeviceScheduler):
        def run(self, fn, **kw):
            log.append(("queued", kw["network"]))
            return super().run(fn, **kw)

    with LoggedScheduler() as sched:
        with MicroBatcher(Logged("slow"), max_batch=1, window_ms=0.0,
                          scheduler=sched, name="slow") as slow, \
                MicroBatcher(Logged("fast"), max_batch=1, window_ms=0.0,
                             scheduler=sched, name="fast") as fast:
            slow_tickets = [slow.submit(np.zeros(1)) for _ in range(40)]
            for _ in range(10):
                fast.submit(np.zeros(1)).result(timeout=WAIT)
            for t in slow_tickets:
                t.result(timeout=WAIT)
        stats = sched.stats()
    waits, waiting = [], None
    for event, tag in log:
        if (event, tag) == ("queued", "fast"):
            waiting = 0
        elif (event, tag) == ("ran", "fast"):
            waits.append(waiting)
        elif (event, tag) == ("ran", "slow") and waiting is not None:
            waiting += 1
    assert len(waits) == 10 and max(waits) <= 3, waits
    assert stats["jobs"] == 50
    assert stats["completed"] == {"fast": 10, "slow": 40}


# ---------------------------------------------------------------------------
# options objects + deprecation shim


def test_legacy_kwargs_warn_and_build_identical_server():
    new = Server(tiny=True, device="cpu", options=ServingOptions(
        max_batch=4, window_ms=3.0, deadline_ms=50.0, max_queue=7,
        breaker_threshold=2, breaker_reset_s=1.5))
    with pytest.warns(DeprecationWarning, match="ServingOptions"):
        old = Server(tiny=True, device="cpu", max_batch=4, window_ms=3.0,
                     deadline_ms=50.0, max_queue=7, breaker_threshold=2,
                     breaker_reset_s=1.5)
    try:
        assert old.options == new.options
        assert (old.max_batch, old.window_ms, old.deadline_ms,
                old.max_queue) == (4, 3.0, 50.0, 7)
    finally:
        old.close()
        new.close()


def test_legacy_kwargs_conflict_with_options_raises():
    with pytest.raises(ValueError, match="not both"):
        Server(tiny=True, device="cpu", options=ServingOptions(),
               max_queue=3)


def test_unknown_server_kwarg_is_a_typeerror():
    with pytest.raises(TypeError, match="max_qeue"):
        Server(tiny=True, device="cpu", max_qeue=3)


def test_conflicting_dtypes_raise():
    opts = RequestOptions(dtype="bfloat16")
    with pytest.raises(ValueError, match="conflicting"):
        opts.merged_dtype("float16")
    assert opts.merged_dtype("bfloat16") is opts
    assert opts.merged_dtype(None) is opts


def test_per_call_dtype_kwarg_warns_and_matches_options(tiny_server):
    img = _image(3)
    via_options = tiny_server.run(
        "resnet18", img, timeout=WAIT,
        options=RequestOptions(dtype="bfloat16"))
    with pytest.warns(DeprecationWarning, match="RequestOptions"):
        via_kwarg = tiny_server.run("resnet18", img, timeout=WAIT,
                                    dtype="bfloat16")
    assert torch.equal(via_options, via_kwarg)
    bf16 = tiny_server.engines.get(
        tiny_variant(get("resnet18")).replace(dtype="bfloat16",
                                              param_dtype="bfloat16"))
    assert torch.equal(via_options, bf16.run(img))


# ---------------------------------------------------------------------------
# the Server


def test_submit_returns_ticket_with_latency_stamps(tiny_server):
    img = _image(4)
    ticket = tiny_server.submit("resnet18", img)
    assert isinstance(ticket, Ticket)
    out = ticket.result(timeout=WAIT)
    assert ticket.done() and out.shape == (256,)
    assert ticket.latency is not None and ticket.latency > 0
    assert ticket.done_at > ticket.arrival
    assert torch.equal(out, tiny_server.run("resnet18", img, timeout=WAIT))


def test_server_concurrent_two_networks_bitwise():
    """Concurrent single-image submissions for two networks on one
    shared-cache server: every answer bitwise equal to the cached
    engine's ``run`` (the reference fails its own version of this)."""
    imgs = [_image(10 + i) for i in range(5)]
    nets = ("resnet18", "mobilenet_v2")
    with Server(tiny=True, device="cpu", options=ServingOptions(
            max_batch=4, window_ms=100.0)) as server:
        for net in nets:
            server.warm(net)
        engines = {net: server.engines.get(tiny_variant(get(net)))
                   for net in nets}
        truth = {net: [engines[net].run(im) for im in imgs] for net in nets}
        tickets = {net: [None] * len(imgs) for net in nets}

        def client(net):
            for i, im in enumerate(imgs):
                tickets[net][i] = server.submit(net, im)

        threads = [threading.Thread(target=client, args=(net,), daemon=True)
                   for net in nets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        outs = {net: [t.result(timeout=WAIT) for t in ts]
                for net, ts in tickets.items()}
        stats = server.stats()
    for net in nets:
        for s, o in zip(truth[net], outs[net]):
            assert torch.equal(s, o)
    assert stats["cache"]["misses"] == 2  # one engine build per network
    assert len(stats["networks"]) == 2
    for b in stats["networks"].values():
        assert b["requests"] == len(imgs)
    assert stats["scheduler"]["jobs"] == sum(
        b["dispatches"] for b in stats["networks"].values())


def test_warm_builds_ahead_of_traffic():
    with Server(tiny=True, device="cpu") as server:
        server.warm("mobilenet_v2")
        st = server.stats()
        assert st["cache"]["misses"] == 1 and st["cache"]["size"] == 1
        assert list(st["networks"]) == ["mobilenet_v2-tiny/32/float32"]
        assert st["networks"]["mobilenet_v2-tiny/32/float32"][
            "requests"] == 0


def test_server_close_is_idempotent_and_rejects_typed():
    server = Server(tiny=True, device="cpu")
    server.close()
    server.close()  # no-op, no deadlock
    with pytest.raises(Overloaded):
        server.submit("resnet18", _image(0))
    with pytest.raises(Rejected):
        server.open_stream("resnet18", sim_compute_s=0.01)
    with pytest.raises(RuntimeError):  # Overloaded is a RuntimeError
        server.run("resnet18", _image(0))


def test_stats_key_includes_dtype():
    key32 = ("resnet18-tiny", 32, "cpu", "float32", "float32")
    key16 = ("resnet18-tiny", 32, "cpu", "bfloat16", "bfloat16")
    mixed = ("resnet18-tiny", 32, "cpu", "float32", "bfloat16")
    assert ServerClass._stats_key(key32) == "resnet18-tiny/32/float32"
    assert ServerClass._stats_key(key16) == "resnet18-tiny/32/bfloat16"
    assert ServerClass._stats_key(mixed) == \
        "resnet18-tiny/32/float32/params=bfloat16"


# ---------------------------------------------------------------------------
# public surface


def test_public_surface_exports_the_front_door():
    for name in ("Server", "ServingOptions", "RequestOptions", "Ticket",
                 "DeviceScheduler", "EngineCache", "MicroBatcher",
                 "StreamSession", "FaultInjector", "Rejected", "Overloaded",
                 "DeadlineExceeded", "CircuitOpen", "TransientFailure",
                 "xla_fallback_plan"):
        assert hasattr(serving, name), f"repro_torch.serving.{name}"
        assert name in serving.__all__
    assert sorted(serving.__all__) == serving.__all__
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for name in serving.__all__:
            getattr(serving, name)
