"""A whole run of each kind of cell on the CPU at a small size, with the
timed path sound, replaced by the TF32 control, or broken underneath:
``correct`` has to come out true only for the sound run. The faults a
cell on one chip can have: a step that returns its state unchanged (the
engine answers every image with the first image's logits), an answer
altered where it is produced, and, where batches form, half of the batch
left out with the mean of the rest in its place."""
import time

import pytest
import torch

from bench.harness import manifest
from bench.harness.runner import run_cell

SMALL = {"config": {"image_size": 32}, "mix": {"pool": 4}}
SERVE = {"config": {"image_size": 32}, "mix": {"pool": 4, "outstanding": 8}}


def _run(cell, system=None, overrides=SMALL, seconds=0.3):
    return run_cell(cell, 2 ** 31 + 99, seconds, False,
                    t_start=time.perf_counter(), device="cpu",
                    overrides=overrides, system=system)


def _program(wrap):
    def make(cfg, mix, weights, device):
        system = manifest.system(mix).build(cfg, mix, weights, device)
        wrap(system)
        return system
    return make


def _stale(system):
    """Every answer is the logits the engine held before the window."""
    held = system.run(torch.zeros(32, 32, 3))
    system.run = lambda image: held


def _altered(system):
    """The window's first answer has one logit moved by 1e-3 of its
    scale."""
    calls = []
    run = system.run

    def altered(image):
        out = run(image)
        calls.append(1)
        if len(calls) == 1:
            out = out.clone()
            out[0] += 1e-3 * out.abs().max()
        return out
    system.run = altered


def _half_batch(system):
    engine = system.engine
    run_batch = engine.run_batch

    def half(images):
        n = len(images)
        if n == 1:
            return run_batch(images)
        kept = run_batch(images[:n // 2])
        return torch.cat([kept, kept.mean(0, keepdim=True)
                          .expand(n - n // 2, -1)])
    engine.run_batch = half


def test_sound_single_run_is_correct():
    r = _run("resnet18.single")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r["checks"]) == ["logit_rel_err", "failed_answers"]
    assert list(r)[-1] == "checks"
    assert {"image_ms", "image_p95_ms", "setup_s"} <= set(r["metrics"])


def test_control_is_not_correct():
    def control(cfg, mix, weights, device):
        return manifest.load("systems", "control").build(
            cfg, mix, weights, device, precision="tf32")
    r = _run("mobilenet_v2.single", control)
    c = r["checks"]["logit_rel_err"]
    assert not r["correct"] and c["value"] > c["limit"]


@pytest.mark.parametrize("fault", [_stale, _altered],
                         ids=["state_unchanged", "answer_altered"])
def test_planted_fault_is_not_correct(fault):
    r = _run("resnet18.single", _program(fault))
    assert not r["correct"] and r["failed"] > 0


def test_served_cell_sound_then_half_batch():
    r = _run("resnet18.serve_closed", overrides=SERVE)
    assert r["correct"], r["checks"]
    assert r["info"]["counters"]["batch_histogram"]
    r = _run("resnet18.serve_closed", _program(_half_batch),
             overrides=SERVE)
    assert not r["correct"] and r["failed"] > 0
