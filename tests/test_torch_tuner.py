"""The port's measured tuner on the CPU with a scripted timer (which pick
wins, the noise floor, a failing candidate, the cache key), its real run
on tiny specs over the plain versions (which proves nothing about a
kernel), and the degraded-mode plan against ``repro``'s."""
import logging

import pytest
import torch

from repro.configs import get as jget
from repro.core import autotune as jat
from repro.models.registry import cnn_module as jcnn_module
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core import autotune as tat
from repro_torch.core.convspec import ConvSpec
from repro_torch.models.registry import cnn_module

SPEC = ConvSpec(h=8, w=8, c=8, k=8)  # 3x3/1: ilpm, direct, im2col,
#                                       libdnn and winograd all compete


def _timer(script, calls=None):
    """A timer that returns ``script[algorithm]`` (a list of seconds, one a
    repeat, or an exception to raise) and logs each call's candidate."""
    def timer(call, repeats, algorithm, params):
        if calls is not None:
            calls.append((algorithm, params, repeats))
        times = script[algorithm]
        if isinstance(times, Exception):
            raise times
        return list(times)[:repeats]
    return timer


def _script(default=(1.0, 1.0, 1.0), **times):
    algos = {a for a, *_ in tat._candidates(SPEC)}
    return {a: times.get(a, default) for a in algos}


def _measured(script, **kw):
    return tat.measured_select(SPEC, measure_on="cpu",
                               timer=_timer(script), **kw)


def test_cost_model_pick_of_the_spec_is_ilpm():
    assert tat.cost_model_select(SPEC).algorithm == "ilpm"


def test_the_minimum_of_the_repeats_decides():
    # direct's best repeat beats ilpm's best, though its mean is worse
    script = _script(ilpm=(0.5, 0.5, 0.5), direct=(5.0, 0.1, 5.0))
    pick = _measured(script, noise_floor=0.0)
    assert pick.algorithm == "direct"
    assert pick.est_time == 0.1


def test_within_the_noise_floor_the_model_pick_stays():
    script = _script(ilpm=(0.14, 0.15, 0.16), winograd=(0.10, 0.11, 0.12))
    pick = _measured(script, noise_floor=0.5)  # 0.14 <= 0.10 * 1.5
    model = tat.cost_model_select(SPEC)
    assert (pick.algorithm, pick.params) == (model.algorithm, model.params)
    assert pick.est_time == 0.14  # the measured time, the model's bytes
    assert (pick.est_bytes, pick.vmem) == (model.est_bytes, model.vmem)


def test_beyond_the_noise_floor_the_measured_pick_wins():
    script = _script(ilpm=(0.16, 0.17, 0.18), winograd=(0.10, 0.11, 0.12))
    pick = _measured(script, noise_floor=0.5)  # 0.16 > 0.10 * 1.5
    assert pick.algorithm == "winograd" and pick.est_time == 0.10
    assert _measured(script, noise_floor=0.0).algorithm == "winograd"


def test_a_failing_candidate_is_logged_and_skipped(caplog):
    script = _script(ilpm=RuntimeError("launch failed"),
                     libdnn=(0.2, 0.3, 0.4))
    with caplog.at_level(logging.WARNING, logger=tat.log.name):
        pick = _measured(script, noise_floor=0.5)
    assert pick.algorithm == "libdnn"  # no model time to keep: ilpm failed
    assert any("candidate ilpm" in r.getMessage() and "launch failed"
               in r.getMessage() for r in caplog.records)


def test_every_candidate_failing_raises():
    script = _script(default=RuntimeError("no card"))
    with pytest.raises(RuntimeError, match="every candidate failed"):
        _measured(script)


def test_repeats_reach_the_timer():
    calls = []
    tat.measured_select(SPEC, measure_on="cpu", repeats=5,
                        timer=_timer(_script(), calls))
    assert calls and {r for _, _, r in calls} == {5}
    assert {a for a, _, _ in calls} == {a for a, *_ in
                                        tat._candidates(SPEC)}


def test_non_tunable_spec_takes_xla_untimed():
    spec = ConvSpec(h=8, w=8, c=8, k=8, stride=3)
    calls = []
    pick = tat.measured_select(spec, measure_on="cpu",
                               timer=_timer({}, calls))
    assert pick.algorithm == "xla" and not calls


def test_repeats_and_noise_floor_key_the_cache(monkeypatch):
    seen = []

    def fake(spec, **kw):
        seen.append((kw["repeats"], kw["noise_floor"], kw["measure_on"]))
        return tat.cost_model_select(spec)

    monkeypatch.setattr(tat, "measured_select", fake)
    spec = ConvSpec(h=6, w=6, c=4, k=4)  # no other test keys this spec
    for _ in range(2):
        tat.select(spec, "measured", measure_on="cpu")
        tat.select(spec, "measured", repeats=10, measure_on="cpu")
        tat.select(spec, "measured", noise_floor=0.0, measure_on="cpu")
    cpu = torch.device("cpu")
    assert seen == [(3, 0.5, cpu), (10, 0.5, cpu), (3, 0.0, cpu)]
    tat.select(spec, "cost_model", repeats=10, noise_floor=0.0)
    assert len(seen) == 3  # the cost model never measures


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown tuning mode"):
        tat.select(SPEC, "guess")


def test_measured_without_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tat.measured_select(SPEC, timer=_timer(_script()))


def test_synth_inputs_are_seeded_and_shaped():
    spec = ConvSpec(h=9, w=7, c=6, k=12, stride=2, groups=6, dtype="bfloat16")
    x, w = tat._synth_inputs(spec, torch.device("cpu"))
    # 5x4 outputs at stride 2: (5 - 1) * 2 + 3 by (4 - 1) * 2 + 3 padded
    assert x.shape == (1, 11, 9, 6) and w.shape == (3, 3, 1, 12)
    assert x.dtype == w.dtype == torch.bfloat16
    x2, w2 = tat._synth_inputs(spec, torch.device("cpu"))
    assert torch.equal(x, x2) and torch.equal(w, w2)
    ref = torch.randn((1, 11, 9, 6), dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(x, ref)


@pytest.mark.parametrize("spec", [
    ConvSpec(h=8, w=8, c=8, k=8),
    ConvSpec(h=8, w=8, c=8, k=16, r=1, s=1, stride=2),
    ConvSpec(h=8, w=8, c=8, k=8, groups=8, stride=2),
])
def test_measured_select_runs_the_plain_versions(spec):
    """A real CPU measurement: every candidate runs, one is picked; the
    pick proves nothing about a kernel."""
    pick = tat.measured_select(spec, measure_on="cpu", repeats=1)
    assert pick.algorithm in {a for a, *_ in tat._candidates(spec)}
    assert pick.est_time > 0


def test_measured_plan_deploys_on_a_cpu_engine():
    cfg = ttiny(tget("mobilenet_v2"))
    engine = TEngine(cfg, device="cpu")
    plan = engine.tune(mode="measured", repeats=1, noise_floor=0.0)
    assert plan.mode == "measured"
    assert plan.specs == engine.plan.specs
    assert plan.block_choices == engine.plan.block_choices  # cost model
    measured = TEngine(cfg, params=engine.model, plan=plan, device="cpu")
    image = torch.zeros(32, 32, 3)
    assert measured.run(image).shape == (cfg.vocab_size,)


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v2"])
def test_xla_fallback_plan_json_equals_reference(name):
    tcfg, jcfg = tget(name), jget(name)
    tplan = tat.xla_fallback_plan(cnn_module(tcfg).conv_specs(tcfg))
    jplan = jat.xla_fallback_plan(jcnn_module(jcfg).conv_specs(jcfg))
    assert tplan.to_json() == jplan.to_json()
    assert set(tplan.algorithms().values()) == {"xla"}
    assert not tplan.block_choices
