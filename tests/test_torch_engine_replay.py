"""The port's engine entry points that the serving tier calls, on the CPU
(eager: CUDA graphs run on the card only, ``chip_smoke.py``): ``run_batch``
bitwise equal to ``run``, ``trace_count``, ``device_put_frame`` ->
``run_stream``, a bad image raising before any work, threads sharing one
engine, ``tune``'s keywords, and ``run`` against ``repro``'s
``InferenceEngine.run`` on carried-across parameters within
``tolerance(fp32)``."""
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
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core import autotune as tat
from repro_torch.core.dtypes import tolerance
from repro_torch.core.engine import DeviceFrame

NETS = ["resnet18", "mobilenet_v2"]


def _images(n, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=NETS)
def engine(request):
    return TEngine(ttiny(tget(request.param)), device="cpu")


@pytest.mark.parametrize("batch", [1, 2, 3, 4])
def test_run_batch_is_bitwise_equal_to_run(engine, batch):
    images = _images(batch)
    batched = engine.run_batch(images)
    assert batched.shape == (batch, engine.cfg.vocab_size)
    assert torch.equal(batched, torch.stack([engine.run(im)
                                             for im in images]))


def test_trace_count_counts_distinct_batch_shapes():
    engine = TEngine(ttiny(tget("resnet18")), device="cpu")
    assert engine.trace_count() == 0
    engine.run(_images(1)[0])  # run prepares no batch shape
    assert engine.trace_count() == 0
    for n in (2, 4, 2, 4, 3):
        engine.run_batch(_images(n))
    assert engine.trace_count() == 3
    assert engine.graphs == 0  # no graph off the card
    assert engine.replay is False


def test_stream_frame_is_bitwise_equal_to_run(engine):
    images = _images(3, seed=5)
    for im in images:
        frame = engine.device_put_frame(im)
        assert isinstance(frame, DeviceFrame)
        assert frame.x.shape == (1, 32, 32, 3) and frame.ready is None
        assert torch.equal(engine.run_stream(frame), engine.run(im))
    # a (1, H, W, C) frame is taken as is; the host copy is the engine's
    first = images[0].copy()
    frame = engine.device_put_frame(images[:1])
    images[0] += 1.0
    assert torch.equal(engine.run_stream(frame), engine.run(first))


def test_run_stream_consumes_its_frame(engine):
    frame = engine.device_put_frame(_images(1)[0])
    engine.run_stream(frame)
    assert frame.consumed and frame.x is None
    with pytest.raises(ValueError, match="consumed"):
        engine.run_stream(frame)


@pytest.mark.parametrize("bad", [
    np.zeros((5, 5, 5, 5), np.float32),  # rank and size
    np.zeros((16, 16, 3), np.float32),   # another size
    np.zeros((32, 32, 4), np.float32),   # another channel count
    np.zeros((32, 32, 3), np.int32),     # not floating point
])
def test_bad_image_raises_and_engine_keeps_serving(engine, bad):
    image = _images(1)[0]
    before = engine.run(image)
    traces = engine.trace_count()
    with pytest.raises(ValueError, match="images of shape"):
        engine.run(bad)
    with pytest.raises(ValueError, match="images of shape"):
        engine.run_batch(bad[None])
    with pytest.raises(ValueError, match="images of shape"):
        engine.device_put_frame(bad)
    assert engine.trace_count() == traces
    assert torch.equal(engine.run(image), before)


def test_replay_needs_the_card():
    with pytest.raises(ValueError, match="replay=False"):
        TEngine(ttiny(tget("resnet18")), device="cpu", replay=True)


def test_threads_share_one_engine_bitwise():
    """Eight threads, two calls each, on one engine: every thread gets its
    own image's logits, bitwise those of a call made alone."""
    engine = TEngine(ttiny(tget("mobilenet_v2")), device="cpu")
    images = _images(8, seed=9)
    alone = [engine.run(im) for im in images]
    got = [[] for _ in images]

    def client(k):
        got[k].append(engine.run(images[k]))
        got[k].append(engine.run_batch(images[k:k + 1])[0])

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for k, outs in enumerate(got):
        assert len(outs) == 2
        assert all(torch.equal(o, alone[k]) for o in outs)


def test_tune_passes_measurement_settings(monkeypatch):
    engine = TEngine(ttiny(tget("resnet18")), device="cpu")
    seen = {}
    real = tat.build_plan

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tat, "build_plan", spy)
    plan = engine.tune(mode="cost_model", repeats=7, noise_floor=0.0)
    assert (seen["repeats"], seen["noise_floor"]) == (7, 0.0)
    assert seen["measure_on"] == torch.device("cpu")
    assert plan.to_json() == engine.plan.to_json()


@pytest.mark.parametrize("name", NETS)
def test_run_matches_reference(name):
    jcfg = jtiny(jget(name))
    params = jinit(jcnn_module(jcfg).model_specs(jcfg), 0, jcfg.param_dtype)
    images = _images(2, seed=11)
    ref = JEngine(jcfg, params=params)
    want = np.stack([np.asarray(ref.run(im)) for im in images])
    port = TEngine(ttiny(tget(name)), device="cpu",
                   params=params_from_reference(
                       jax.tree.map(np.asarray, params)))
    got = port.run_batch(images).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() \
        <= tolerance("float32")
