"""The port's ``StreamSession`` on the CPU (ported from
``tests/test_streaming.py``): simulated-clock pacing (``sim_compute_s``)
with exact deadline accounting, skip-to-latest drops, the threaded
deployment shape, four streams sharing one cache with classify traffic,
and the cross-package check: the port's ``Server`` against ``repro``'s
``InferenceEngine.run`` on carried-across parameters."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.core import InferenceEngine as JEngine
from repro.models.registry import cnn_module as jcnn_module
from repro.models.spec import init_params as jinit
from repro_torch.configs import get, tiny_variant
from repro_torch.convert import params_from_reference
from repro_torch.core.dtypes import tolerance
from repro_torch.serving import (
    EngineCache,
    FrameDropped,
    Server,
    ServingOptions,
    StreamScheduler,
    StreamSession,
)

RESNET = tiny_variant(get("resnet18"))
MOBILENET = tiny_variant(get("mobilenet_v2"))
WAIT = 60


def _images(n, seed=11):
    return list(np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def cache():
    """One shared cache for the session tests (engines build once)."""
    return EngineCache(capacity=4, device="cpu")


def test_stream_sim_fast_compute_zero_misses_bitwise(cache):
    eng = cache.get(RESNET)
    imgs = _images(8)
    truth = [eng.run(im) for im in imgs]
    with StreamSession(cache.lease(RESNET), fps=30.0, sim_compute_s=0.005,
                       name="fast") as s:
        frames = [s.submit_frame(im) for im in imgs]
        s.flush()
        outs = [f.future.result(timeout=WAIT) for f in frames]
    st = s.stats()
    assert st["frames"] == 8 and st["completed"] == 8 and st["dropped"] == 0
    assert st["deadline_misses"] == 0 and st["deadline_miss_rate"] == 0.0
    assert st["fps_target"] == 30.0 and st["dtype"] == "float32"
    for t, o in zip(truth, outs):
        assert torch.equal(t, o)
    for k, f in enumerate(frames):  # auto-paced arrivals, exact stamps
        assert f.arrival == pytest.approx(k / 30.0)
        assert f.dispatch == f.arrival
        assert f.done == f.dispatch + 0.005
        assert f.missed is False


def test_stream_sim_slow_compute_drops_and_misses(cache):
    eng = cache.get(RESNET)
    imgs = _images(10)
    truth = [eng.run(im) for im in imgs]
    s = StreamSession(cache.lease(RESNET), fps=30.0, sim_compute_s=0.08,
                      name="slow")
    frames = [s.submit_frame(im) for im in imgs]
    s.close()  # flushes the pending slot
    st = s.stats()
    assert st["frames"] == 10 and st["dropped"] > 0
    assert st["deadline_misses"] > 0 and st["deadline_miss_rate"] > 0
    assert st["completed"] + st["dropped"] == 10
    assert not frames[-1].dropped  # the freshest frame always survives
    for f in frames:
        if f.dropped:
            with pytest.raises(FrameDropped):
                f.future.result(timeout=WAIT)
        else:
            assert f.done > f.deadline  # 80 ms compute, 33 ms deadline
            assert torch.equal(truth[f.seq], f.future.result(timeout=WAIT))


def test_stream_sim_schedule_is_exact(cache):
    """30 fps with 70 ms of simulated compute: frame 0 runs at 0; frame 1
    waits and is replaced by frame 2, which runs when the device frees at
    70 ms; frame 3 is replaced by frame 4, which runs at 140 ms. The
    stamps are pure arithmetic."""
    s = StreamSession(cache.lease(RESNET), fps=30.0, sim_compute_s=0.07)
    frames = [s.submit_frame(im) for im in _images(5)]
    s.close()
    assert [f.dropped for f in frames] == [False, True, False, True, False]
    assert frames[0].done == pytest.approx(0.07)
    assert frames[2].dispatch == pytest.approx(0.07)
    assert frames[2].done == pytest.approx(0.14)
    assert frames[4].dispatch == pytest.approx(0.14)
    assert s.stats()["deadline_misses"] == 5  # two dropped, three late


def test_stream_submit_after_close_raises(cache):
    s = StreamSession(cache.lease(RESNET), fps=30.0, sim_compute_s=0.005)
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.submit_frame(_images(1)[0])


def test_stream_threaded_completes_bitwise(cache):
    eng = cache.get(RESNET)
    imgs = _images(3)
    truth = [eng.run(im) for im in imgs]
    with StreamSession(cache.lease(RESNET), fps=5.0, deadline_ms=60_000.0,
                       name="rt") as s:
        frames = []
        for im in imgs:
            frames.append(s.submit_frame(im))
            s.flush()  # pace the producer: wait out each frame's compute
        outs = [f.future.result(timeout=WAIT) for f in frames]
    st = s.stats()
    assert st["completed"] == 3 and st["dropped"] == 0
    assert st["deadline_misses"] == 0
    for t, o in zip(truth, outs):
        assert torch.equal(t, o)


def test_stream_threaded_skip_to_latest_when_held(cache, monkeypatch):
    """Frames queued behind a held compute are dropped except the
    newest."""
    lease = cache.lease(RESNET)
    real = lease.engine.run_stream
    entered, gate = threading.Event(), threading.Event()

    def held(buf):
        if not entered.is_set():
            entered.set()
            assert gate.wait(WAIT)
        return real(buf)

    monkeypatch.setattr(lease.engine, "run_stream", held)
    imgs = _images(5)
    with StreamSession(lease, fps=60.0, name="rt-held") as s:
        frames = [s.submit_frame(imgs[0])]
        assert entered.wait(WAIT)  # frame 0 computes; the rest queue
        frames += [s.submit_frame(im) for im in imgs[1:]]
        gate.set()
        s.flush()
    st = s.stats()
    assert [f.dropped for f in frames] == [False, True, True, True, False]
    assert st["dropped"] == 3 and st["deadline_misses"] >= 3
    assert torch.equal(frames[-1].future.result(timeout=WAIT),
                       lease.engine.run(imgs[4]))


def test_lease_held_classify_for_other_network_progresses(cache):
    """A held stream lease never blocks classify for other networks."""
    with cache.lease(RESNET):
        img = _images(1)[0]
        with Server(cache=cache, tiny=True, options=ServingOptions(
                window_ms=1.0)) as server:
            out = server.run("mobilenet_v2", img, timeout=WAIT)
        assert torch.equal(cache.get(MOBILENET).run(img), out)


def test_four_streams_30fps_share_cache_with_classify():
    """Four simulated 30 fps streams (two networks, phase-staggered, one
    lease each) share one cache with classify traffic: every frame and
    every classify answer bitwise equal to the engine's ``run``, zero
    deadline misses (the reference fails its own version of this)."""
    imgs = _images(6, seed=12)
    nets = ["resnet18", "mobilenet_v2", "resnet18", "mobilenet_v2"]
    with Server(tiny=True, device="cpu", options=ServingOptions(
            max_batch=4, window_ms=5.0, deadline_ms=60_000.0)) as server:
        for net in set(nets):
            server.warm(net)
        truth = {net: [server.engines.get(tiny_variant(get(net))).run(im)
                       for im in imgs] for net in set(nets)}
        streams = [server.open_stream(net, fps=30.0, sim_compute_s=0.002,
                                      phase_s=0.002 * i)
                   for i, net in enumerate(nets)]
        classify = []

        def classify_client():
            for i, im in enumerate(imgs):
                for net in ("resnet18", "mobilenet_v2"):
                    classify.append((net, i, server.submit(net, im)))

        client = threading.Thread(target=classify_client, daemon=True)
        client.start()
        frames = StreamScheduler(streams).run(len(imgs),
                                              lambda i, k: imgs[k])
        client.join(WAIT)
        assert not client.is_alive()
        for i, per_stream in enumerate(frames):
            st = streams[i].stats()
            assert st["frames"] == len(imgs) and st["dropped"] == 0
            assert st["deadline_misses"] == 0
            for k, f in enumerate(per_stream):
                assert torch.equal(truth[nets[i]][k],
                                   f.future.result(timeout=WAIT))
        for net, i, ticket in classify:
            assert torch.equal(truth[net][i], ticket.result(timeout=WAIT))
        stats = server.stats()
        assert stats["cache"]["misses"] == 2
        assert len(stats["streams"]) == 4
        assert set(stats["cache"]["pinned"]) == {
            server.engines.key(tiny_variant(get(n))) for n in set(nets)}
        for b in stats["networks"].values():
            assert b["queue_depth"] == 0
            assert sum(b["dispatch_causes"].values()) == b["dispatches"]
            assert b["deadline_misses"] == 0
    assert server.engines.stats()["pinned"] == []  # close released leases


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v2"])
def test_server_answers_match_reference(name):
    """The port's Server, on parameters carried across from ``repro``,
    answers within tolerance(fp32) of ``repro``'s engine.run."""
    jcfg = jtiny(jget(name))
    params = jinit(jcnn_module(jcfg).model_specs(jcfg), 0, jcfg.param_dtype)
    imgs = _images(3, seed=13)
    ref = JEngine(jcfg, params=params)
    want = [np.asarray(ref.run(im)) for im in imgs]
    cache = EngineCache(device="cpu")
    cache.get(tiny_variant(get(name)), params=params_from_reference(
        jax.tree.map(np.asarray, params)))
    with Server(cache=cache, tiny=True, options=ServingOptions(
            max_batch=4, window_ms=50.0)) as server:
        tickets = [server.submit(name, im) for im in imgs]
        got = [t.result(timeout=WAIT).numpy() for t in tickets]
        with server.open_stream(name, sim_compute_s=0.001) as stream:
            frames = [stream.submit_frame(im) for im in imgs]
        streamed = [f.future.result(timeout=WAIT).numpy() for f in frames]
    for g, s, w in zip(got, streamed, want):
        assert np.abs(g - w).max() / np.abs(w).max() <= tolerance("float32")
        assert np.array_equal(g, s)
