"""The port's ``MicroBatcher`` on the CPU (ported from
``tests/test_serving.py`` and ``tests/test_frontdoor.py``): padded
buckets, the single-image path, mid-flight admission, admission bounds,
tickets, and the contract the reference's own run fails: a batched
dispatch is bitwise equal to sequential ``engine.run``.

Dispatch timing is driven by a gated stub engine (a ``threading.Event``
holds a dispatch open), not by sleeps; the real tiny engines check the
numerics."""
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np
import pytest
import torch

from repro_torch.configs import get, tiny_variant
from repro_torch.core import InferenceEngine
from repro_torch.serving import (
    MicroBatcher,
    Overloaded,
    Ticket,
    bucket,
)

RESNET = tiny_variant(get("resnet18"))
WAIT = 60  # seconds: no result is awaited longer


def _images(n, seed=7):
    return list(np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32))


class GatedEngine:
    """Engine stub: each dispatch records its batch size, announces that
    it started (``entered``) and waits for ``gate`` when ``hold`` is set;
    results are each image's sum, so they are checkable."""

    def __init__(self, hold=False):
        self.batches = []
        self.entered = threading.Semaphore(0)
        self.gate = threading.Event()
        if not hold:
            self.gate.set()

    def _serve(self, n):
        self.batches.append(n)
        self.entered.release()
        assert self.gate.wait(WAIT)

    def run(self, image):
        self._serve(1)
        return torch.as_tensor(image).sum().reshape(1)

    def run_batch(self, images):
        self._serve(images.shape[0])
        return images.sum(dim=(1, 2, 3)).reshape(-1, 1)


def _img(v):
    return np.full((4, 4, 3), float(v), dtype=np.float32)


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(RESNET, device="cpu")


def test_bucket_powers_of_two():
    assert [bucket(n, 8) for n in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    assert bucket(3, 3) == 3  # cap wins over the power of two


@pytest.mark.parametrize("asked, got", [(6, 4), (8, 8), (1, 1), (7, 4)])
def test_max_batch_rounds_down_to_power_of_two(asked, got):
    with MicroBatcher(GatedEngine(), max_batch=asked, window_ms=1.0) as b:
        assert b.max_batch == got


def test_batcher_matches_sequential_bitwise_with_ragged_tail(engine):
    """6 requests, max_batch 4, held behind a gated first dispatch so they
    coalesce: every answer bitwise equal to sequential engine.run."""
    imgs = _images(6)
    seq = [engine.run(im) for im in imgs]
    with MicroBatcher(engine, max_batch=4, window_ms=250.0) as b:
        futs = [b.submit(im) for im in imgs]
        outs = [f.result(timeout=WAIT) for f in futs]
    for s, o in zip(seq, outs):
        assert torch.equal(s, o)  # bitwise, not allclose
    sizes = sorted(d["batch"] for d in b.dispatches)
    assert sum(sizes) == 6 and sizes[-1] > 1
    for d in b.dispatches:
        assert d["padded"] == bucket(d["batch"], 4)


def test_batcher_single_request_takes_fast_path(engine, monkeypatch):
    calls = []
    real_run, real_run_batch = engine.run, engine.run_batch
    monkeypatch.setattr(engine, "run",
                        lambda im: calls.append("run") or real_run(im))
    monkeypatch.setattr(engine, "run_batch",
                        lambda ims: calls.append("batch") or real_run_batch(ims))
    with MicroBatcher(engine, max_batch=4, window_ms=1.0) as b:
        out = b.submit(_images(1)[0]).result(timeout=WAIT)
    assert calls == ["run"]
    assert out.shape == (RESNET.vocab_size,)


def test_batcher_padding_bounds_traces():
    """Ragged bursts pad to power-of-two buckets, so the engine prepares
    one batch shape a bucket, not one a batch size."""
    engine = InferenceEngine(RESNET, device="cpu")
    with MicroBatcher(engine, max_batch=4, window_ms=250.0) as b:
        for n in (3, 2, 3):
            futs = [b.submit(im) for im in _images(n)]
            for f in futs:
                f.result(timeout=WAIT)
    padded = {d["padded"] for d in b.dispatches if d["batch"] > 1}
    assert padded <= {2, 4}
    assert engine.trace_count() == len(padded) <= 2


def test_batcher_dispatch_error_resolves_futures(engine):
    """A failing dispatch surfaces on its future, not in the loop."""
    with MicroBatcher(engine, max_batch=2, window_ms=1.0) as b:
        bad = b.submit(np.zeros((5, 5, 5, 5), np.float32))
        with pytest.raises(ValueError, match="images of shape"):
            bad.result(timeout=WAIT)
        ok = b.submit(_images(1)[0])  # the loop keeps serving
        assert ok.result(timeout=WAIT).shape == (RESNET.vocab_size,)


def test_requests_join_forming_batch_during_dispatch():
    """Requests arriving while a dispatch holds the loop coalesce into ONE
    next batch (mid-flight admission)."""
    engine = GatedEngine(hold=True)
    with MicroBatcher(engine, max_batch=8, window_ms=0.0) as b:
        t0 = b.submit(_img(0))
        assert engine.entered.acquire(timeout=WAIT)  # dispatch 1 is open
        rest = [b.submit(_img(i + 1)) for i in range(3)]
        engine.gate.set()
        t0.result(timeout=WAIT)
        outs = [t.result(timeout=WAIT) for t in rest]
    assert engine.batches == [1, 4]  # 3 coalesced, padded to the 4-bucket
    assert [d["batch"] for d in b.dispatches] == [1, 3]
    assert b.stats()["joined_forming"] == 2
    assert outs[1].item() == 4 * 4 * 3 * 2.0


def test_mid_flight_batch_respects_max_batch():
    engine = GatedEngine(hold=True)
    with MicroBatcher(engine, max_batch=2, window_ms=0.0) as b:
        first = b.submit(_img(0))
        assert engine.entered.acquire(timeout=WAIT)
        rest = [b.submit(_img(i)) for i in range(3)]
        engine.gate.set()
        for t in [first, *rest]:
            t.result(timeout=WAIT)
    assert engine.batches == [1, 2, 1]


def test_window_anchored_at_oldest_arrival():
    """The window runs from the OLDEST pending request's arrival: a late
    joiner rides out the first request's window instead of restarting
    it."""
    engine = GatedEngine()
    window = 1.0
    with MicroBatcher(engine, max_batch=8, window_ms=window * 1e3) as b:
        first = b.submit(_img(1))
        time.sleep(window / 2)  # join mid-window
        late = b.submit(_img(2))
        first.result(timeout=WAIT)
        late.result(timeout=WAIT)
    assert engine.batches == [2]
    wait = late.done_at - first.arrival
    assert window <= wait < window * 1.4, f"window restarted: {wait:.3f}s"
    assert b.stats()["dispatch_causes"]["window"] == 1
    assert b.stats()["joined_forming"] == 1


def test_bitwise_equal_to_sequential_with_mid_flight_admission(engine):
    """Requests that joined a forming batch mid-flight still get logits
    bitwise equal to sequential engine.run (the reference fails its own
    version of this check)."""
    imgs = _images(5, seed=8)
    seq = [engine.run(im) for im in imgs]
    gate = threading.Event()
    entered = threading.Event()
    real_run = engine.run

    def held_run(im):  # the first dispatch waits for the others to queue
        entered.set()
        assert gate.wait(WAIT)
        return real_run(im)

    with MicroBatcher(engine, max_batch=4, window_ms=0.0) as b:
        engine.run = held_run
        try:
            tickets = [b.submit(imgs[0])]
            assert entered.wait(WAIT)
            tickets += [b.submit(im) for im in imgs[1:]]
            gate.set()
            got = [t.result(timeout=WAIT) for t in tickets]
        finally:
            del engine.run
    for g, s in zip(got, seq):
        assert torch.equal(g, s)
    assert [d["batch"] for d in b.dispatches] == [1, 4]
    assert b.stats()["joined_forming"] == 3


def test_bounded_queue_sheds_at_admission_mid_flight():
    engine = GatedEngine(hold=True)
    with MicroBatcher(engine, max_batch=1, window_ms=0.0, max_queue=2) as b:
        first = b.submit(_img(0))
        assert engine.entered.acquire(timeout=WAIT)  # queue empty again
        ok = [b.submit(_img(1)), b.submit(_img(2))]
        with pytest.raises(Overloaded, match="queue full"):
            b.submit(_img(3))
        engine.gate.set()
        for t in [first, *ok]:
            t.result(timeout=WAIT)
    assert b.stats()["shed"]["overload"] == 1


def test_closed_batcher_rejects_typed():
    b = MicroBatcher(GatedEngine(), max_batch=1, window_ms=0.0)
    b.close()
    b.close()  # idempotent
    with pytest.raises(Overloaded, match="closed"):
        b.submit(_img(0))


def test_priority_and_deadline_ride_to_the_request():
    with MicroBatcher(GatedEngine(), max_batch=1, window_ms=0.0) as b:
        req = b.submit_request(_img(0), deadline_ms=5000.0, priority=3)
        assert req.priority == 3
        assert req.deadline is not None and req.urgency == req.deadline
        Ticket(req).result(timeout=WAIT)
        no_dl = b.submit_request(_img(1))
        assert no_dl.deadline is None and no_dl.urgency == no_dl.arrival
        Ticket(no_dl).result(timeout=WAIT)


def test_ticket_result_timeout_cancels():
    """A timed-out wait cancels the request, so the batcher sheds it at
    dequeue instead of computing it."""
    engine = GatedEngine(hold=True)
    with MicroBatcher(engine, max_batch=1, window_ms=0.0) as b:
        hold = b.submit(_img(0))
        assert engine.entered.acquire(timeout=WAIT)
        queued = b.submit(_img(1))
        with pytest.raises(FutureTimeoutError):
            queued.result(timeout=0.01)
        engine.gate.set()
        hold.result(timeout=WAIT)
    assert b.stats()["shed"]["cancelled"] == 1
    assert engine.batches == [1]  # the cancelled request never dispatched


def test_ticket_done_callback_and_stamps():
    seen = []
    with MicroBatcher(GatedEngine(), max_batch=1, window_ms=0.0) as b:
        t = b.submit(_img(2))
        t.add_done_callback(lambda ticket: seen.append(ticket.id))
        assert t.result(timeout=WAIT).item() == 4 * 4 * 3 * 2.0
    assert seen == [t.id]
    assert t.done() and t.exception() is None
    assert t.latency > 0 and t.done_at > t.arrival


def test_batcher_stats_concurrent_with_traffic(engine):
    """stats() snapshots the dispatch log under a lock while a poller
    hammers it during live traffic."""
    errors = []
    with MicroBatcher(engine, max_batch=4, window_ms=5.0,
                      deadline_ms=60_000.0) as b:
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                try:
                    b.stats()
                except Exception as e:  # pragma: no cover - the regression
                    errors.append(e)
                    return

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        futs = [b.submit(im) for im in _images(6)]
        for f in futs:
            f.result(timeout=WAIT)
        stop.set()
        poller.join(WAIT)
        st = b.stats()
    assert errors == [] and not poller.is_alive()
    assert st["requests"] == 6 and st["queue_depth"] == 0
    assert sum(st["dispatch_causes"].values()) == st["dispatches"]
    assert st["deadline_ms"] == 60_000.0
    assert st["deadline_misses"] == 0 and st["deadline_miss_rate"] == 0.0
