"""The port's span recorder (``repro_torch.runtime.trace``) on the CPU,
with the tiny ResNet-18 (32 × 32 images): off unless a ``torch.profiler``
session or ``recording()`` is active where a root is entered; the
engine's spans nested under their root; a served request's decision
carried into the batcher's threads, each dispatch timing its copy-in
once; the spans on the profiler's clock through the anchor; a full log
counting what it drops; and logits bitwise the same traced or not."""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get, tiny_variant
from repro_torch.core import InferenceEngine
from repro_torch.runtime import trace
from repro_torch.serving import Server

RESNET = tiny_variant(get("resnet18"))
WAIT = 60  # seconds: no result is awaited longer
SLACK_NS = 50_000  # a span against the profiler's marker around it


def _images(n, seed=11):
    return list(np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(RESNET, device="cpu")


@pytest.fixture(scope="module")
def server():
    with Server(capacity=1, device="cpu") as srv:
        srv.run(RESNET, _images(1)[0], WAIT)  # the batcher's threads run
        yield srv


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    trace.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _named(snap, suffix):
    return [s for s in snap["spans"] if s["name"] == f"repro_torch.{suffix}"]


def test_nothing_recorded_when_off(engine, server):
    img = _images(1)[0]
    engine.run(img)
    engine.run_batch(np.stack(_images(2)))
    server.run(RESNET, img, WAIT)
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["totals"] == {}
    assert snap["dropped"] == 0


@pytest.mark.parametrize("on", [_profiled, trace.recording],
                         ids=["profiler", "recording"])
def test_engine_run_holds_its_copy_in(engine, on):
    with on():
        engine.run(_images(1)[0])
    snap = trace.snapshot()
    (run,), (copy,) = _named(snap, "engine.run"), _named(snap, "engine.copy_in")
    assert run["parent"] == 0 and run["group"] == run["id"]
    assert copy["parent"] == run["id"] and copy["group"] == run["id"]
    assert run["start_ns"] <= copy["start_ns"] < copy["end_ns"] \
        <= run["end_ns"]
    assert run["thread"] == copy["thread"] == threading.get_ident()
    assert snap["totals"]["repro_torch.engine.run"]["count"] == 1
    assert snap["totals"]["repro_torch.engine.copy_in"]["total_ns"] == \
        copy["end_ns"] - copy["start_ns"]


def test_served_requests_traced_only_inside_the_session(server):
    imgs = _images(7)
    with _profiled():
        alone = server.submit(RESNET, imgs[0])  # a dispatch of one
        alone.result(WAIT)
        inside = [alone] + [server.submit(RESNET, im) for im in imgs[1:5]]
        for t in inside:
            t.result(WAIT)
    outside = [server.submit(RESNET, im) for im in imgs[5:]]
    for t in outside:
        t.result(WAIT)
    snap = trace.snapshot()
    requests = {s["group"]: s for s in _named(snap, "request")}
    assert set(requests) == {t.id for t in inside}
    dispatches = _named(snap, "dispatch")
    assert sorted(i for d in dispatches for i in d["requests"]) == \
        sorted(requests)
    assert [alone.id] in [d["requests"] for d in dispatches]
    me = threading.get_ident()
    for d in dispatches:
        assert d["thread"] != me and d["parent"] == 0
        assert d["padded"] >= len(d["requests"])
        # the engine's spans join the dispatch that runs them; the batcher
        # copies the images in, the batch-1 fast path's too, so the engine
        # is handed them on the device and times no copy of its own
        children = [s for s in snap["spans"] if s["parent"] == d["id"]]
        (eng,) = [s for s in children
                  if s["name"].startswith("repro_torch.engine.")]
        assert eng["group"] == d["id"] and eng["thread"] == d["thread"]
        assert [s["name"] for s in children].count(
            "repro_torch.dispatch.copy_in") == 1
        for rid in d["requests"]:
            r = requests[rid]
            assert r["thread"] != me
            assert r["start_ns"] <= r["dispatch_ns"] == d["start_ns"] \
                <= d["end_ns"] <= r["end_ns"]
    assert _named(snap, "engine.copy_in") == []


def test_span_lies_inside_the_profilers_marker(engine):
    with _profiled() as prof:
        with record_function("test.marker"):
            engine.run(_images(1)[0])
    snap = trace.snapshot()
    (marker,) = [e for e in prof.profiler.kineto_results.events()
                 if e.name() == "test.marker"]
    (run,) = _named(snap, "engine.run")
    shift = snap["anchor"]["time_ns"] - snap["anchor"]["perf_counter_ns"]
    assert marker.start_ns() - SLACK_NS <= run["start_ns"] + shift
    assert run["end_ns"] + shift <= \
        marker.start_ns() + marker.duration_ns() + SLACK_NS


def test_full_log_counts_what_it_drops(engine, monkeypatch):
    monkeypatch.setattr(trace, "_recorder", trace._Recorder(capacity=3))
    with trace.recording():
        engine.run(_images(1)[0])
        engine.run(_images(1)[0])
    snap = trace.snapshot()
    assert len(snap["spans"]) == 3 and snap["dropped"] == 1
    assert snap["totals"]["repro_torch.engine.run"]["count"] == 2
    assert snap["totals"]["repro_torch.engine.copy_in"]["count"] == 2


def test_logits_bitwise_the_same_traced_or_not(engine):
    img, batch = _images(1)[0], np.stack(_images(3))
    off = engine.run(img), engine.run_batch(batch)
    with trace.recording():
        rec = engine.run(img), engine.run_batch(batch)
    with _profiled():
        prof = engine.run(img), engine.run_batch(batch)
    for a, b, c in zip(off, rec, prof):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert len(_named(trace.snapshot(), "engine.run_batch")) == 2
