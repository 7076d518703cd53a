"""The port's MobileNetV2 on the CPU against the JAX package's
``InferenceEngine.run``, on the tiny variant (img 32, one block a stage)
with the same parameters carried across by ``repro_torch.convert``: the
tuned plan (all four blocks fused) and the per-layer plan (blocks
stripped), a plan JSON saved by the reference, and the dispatch counts of
both plans. The folded-BN vectors are drawn anew from a numpy seed, so
that biases are non-zero. Bound: tolerance("float32") of max|logits|."""
import copy
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.core import InferenceEngine as JEngine
from repro.core import autotune as jat
from repro.models import mobilenet as jmobilenet
from repro.models.spec import init_params as jinit
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core import autotune as tat
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import ops
from repro_torch.models import mobilenet as tmobilenet
from repro_torch.models.spec import flatten

NAME = "mobilenet_v2"


def _rel(y, ref):
    y = np.asarray(y, dtype=np.float32)
    r = np.asarray(ref, dtype=np.float32)
    assert y.shape == r.shape
    return float(np.abs(y - r).max() / np.abs(r).max())


def _perturb_bn(tree, rng):
    """Every folded-BN ``scale`` from U(0.5, 1.5) and ``bias`` from
    N(0, 0.1), in sorted-key order, as chip_smoke.py draws them."""
    out = {}
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out[key] = _perturb_bn(v, rng)
        elif key == "scale":
            out[key] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif key == "bias":
            out[key] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        else:
            out[key] = v
    return out


def _strip_blocks(plan):
    plan = copy.deepcopy(plan)
    plan.block_choices.clear()
    plan.block_specs.clear()
    return plan


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).standard_normal((32, 32, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def ref(image, tmp_path_factory):
    """The JAX engines (tuned and per-layer) on numpy params with
    perturbed BN, their logits on ``image`` and the saved tuned plan."""
    jcfg = jtiny(jget(NAME))
    params = jax.tree.map(np.asarray,
                          jinit(jmobilenet.model_specs(jcfg), 0,
                                jcfg.param_dtype))
    params = _perturb_bn(params, np.random.default_rng(1))
    tuned = JEngine(jcfg, params=params)
    per_layer = JEngine(jcfg, params=params,
                        plan=_strip_blocks(tuned.plan))
    path = tmp_path_factory.mktemp("plans") / f"{NAME}.json"
    tuned.save_plan(path)
    return {"jcfg": jcfg, "params": params,
            "tuned": np.asarray(tuned.run(image)),
            "per_layer": np.asarray(per_layer.run(image)),
            "plan_json": tuned.plan.to_json(), "plan_path": path}


def _engine(ref, **kw):
    return TEngine(ttiny(tget(NAME)),
                   params=params_from_reference(ref["params"]),
                   device="cpu", **kw)


def test_tiny_variant_matches_reference():
    t, j = ttiny(tget(NAME)), jtiny(jget(NAME))
    assert t.extra == j.extra
    assert (t.name, t.vocab_size, t.dtype) == (j.name, j.vocab_size, j.dtype)
    assert tget(NAME).extra == jget(NAME).extra
    assert tget(NAME).num_layers == jget(NAME).num_layers


@pytest.mark.parametrize("tiny", [False, True])
def test_specs_and_plan_json_equal_reference(tiny):
    t, j = tget(NAME), jget(NAME)
    if tiny:
        t, j = ttiny(t), jtiny(j)
    for fn in ("conv_specs", "block_specs"):
        assert [(n, dataclasses.asdict(s))
                for n, s in getattr(tmobilenet, fn)(t)] == \
            [(n, dataclasses.asdict(s))
             for n, s in getattr(jmobilenet, fn)(j)]
    tplan = tat.build_plan(tmobilenet.conv_specs(t), epilogue=True,
                           block_specs=tmobilenet.block_specs(t))
    jplan = jat.build_plan(jmobilenet.conv_specs(j), epilogue=True,
                           block_specs=jmobilenet.block_specs(j))
    assert tplan.to_json() == jplan.to_json()
    assert set(tplan.block_algorithms().values()) == {
        "fused_inverted_residual"}
    assert len(tplan.block_choices) == (4 if tiny else 17)


def test_tuned_plan_matches_reference(ref, image):
    engine = _engine(ref)
    assert engine.plan.to_json() == ref["plan_json"]
    assert len(engine.plan.block_choices) == 4
    assert _rel(engine.run(image), ref["tuned"]) <= tolerance("float32")


def test_per_layer_plan_matches_reference(ref, image):
    engine = _engine(ref)
    per_layer = _engine(ref, plan=_strip_blocks(engine.plan))
    assert not per_layer.plan.block_choices
    assert _rel(per_layer.run(image), ref["per_layer"]) \
        <= tolerance("float32")


def test_reference_plan_json_deploys(ref, image):
    engine = _engine(ref, plan=str(ref["plan_path"]))
    assert engine.plan.to_json() == ref["plan_path"].read_text()
    assert _rel(engine.run(image), ref["tuned"]) <= tolerance("float32")
    blocks = json.loads(ref["plan_json"])["blocks"]
    assert {b["choice"]["algorithm"] for b in blocks.values()} == {
        "fused_inverted_residual"}


def test_state_dict_keys_are_reference_paths(ref):
    engine = _engine(ref)
    keys = set(engine.model.state_dict())
    assert keys == set(flatten(ref["params"]))
    assert {"stem.w", "s0b0.dw.w", "s1b0.pw1.scale", "head.w",
            "fc.b"} <= keys
    assert "s0b0.pw1.w" not in keys  # t == 1: no expansion conv


def test_run_batch_is_bitwise_equal_to_run(ref):
    engine = _engine(ref)
    images = np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    batched = engine.run_batch(images)
    assert batched.shape == (3, 256)
    assert torch.equal(batched, torch.stack([engine.run(im)
                                             for im in images]))


def test_fused_and_per_layer_logits_are_bitwise_equal(ref, image):
    """The plain fused block is composed of the per-layer plain functions,
    so the two plans agree to the bit on the CPU."""
    engine = _engine(ref)
    per_layer = _engine(ref, plan=_strip_blocks(engine.plan))
    assert torch.equal(engine.run(image), per_layer.run(image))


def _spy(monkeypatch):
    """Record each dispatch by algorithm name; ``functools.wraps`` keeps
    the wrapped signature, so dispatch still filters the plan's params."""
    calls = []
    for table in (ops.ALGORITHMS, ops.BLOCK_ALGORITHMS):
        for name, fn in dict(table).items():
            @functools.wraps(fn)
            def wrapper(*args, _name=name, _fn=fn, **kw):
                calls.append(_name)
                return _fn(*args, **kw)
            monkeypatch.setitem(table, name, wrapper)
    return calls


@pytest.mark.parametrize("plan,expected", [
    ("tuned", {"ilpm": 1, "fused_inverted_residual": 4, "pointwise": 1}),
    ("per_layer", {"ilpm": 1, "depthwise": 4, "pointwise": 8}),
])
def test_dispatch_counts(ref, image, plan, expected, monkeypatch):
    engine = _engine(ref)
    if plan == "per_layer":
        engine = _engine(ref, plan=_strip_blocks(engine.plan))
    calls = _spy(monkeypatch)
    engine.run(image)
    counts = {name: calls.count(name) for name in set(calls)}
    assert counts == expected
