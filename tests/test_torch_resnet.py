"""The port's ResNet engine on the CPU against the JAX package's
``InferenceEngine.run`` on the same parameters, carried across with
``repro_torch.convert``: forced ilpm, the tuned plan (blocks fused), and
a plan JSON saved by the reference. Bound: tolerance("float32") of
max|logits|."""
import copy
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.core import InferenceEngine as JEngine
from repro.models import resnet as jresnet
from repro.models.spec import init_params as jinit
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core.dtypes import tolerance
from repro_torch.models import resnet as tresnet
from repro_torch.models.spec import flatten, init_params

NAMES = ["resnet18", "resnet50"]


def _rel(y, ref):
    y = np.asarray(y, dtype=np.float32)
    r = np.asarray(ref, dtype=np.float32)
    assert y.shape == r.shape
    return float(np.abs(y - r).max() / np.abs(r).max())


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).standard_normal((32, 32, 3)).astype(
        np.float32)


@pytest.fixture(scope="module", params=NAMES)
def pair(request, tmp_path_factory):
    """The JAX tuned engine, its params as numpy, its logits on ``image``
    for forced-ilpm and tuned runs, and its saved plan."""
    name = request.param
    jcfg = jtiny(jget(name))
    params = jinit(jresnet.model_specs(jcfg), 0, jcfg.param_dtype)
    img = np.random.default_rng(0).standard_normal((32, 32, 3)).astype(
        np.float32)
    tuned = JEngine(jcfg, params=params)
    forced = JEngine(jcfg, params=params, algorithm="ilpm")
    path = tmp_path_factory.mktemp("plans") / f"{name}.json"
    tuned.save_plan(path)
    return {"name": name, "tcfg": ttiny(tget(name)),
            "params": jax.tree.map(np.asarray, params),
            "forced": np.asarray(forced.run(img)),
            "tuned": np.asarray(tuned.run(img)),
            "plan_json": tuned.plan.to_json(), "plan_path": path}


def _engine(pair, **kw):
    sd = params_from_reference(pair["params"])
    return TEngine(pair["tcfg"], params=sd, device="cpu", **kw)


def test_forced_ilpm_matches_reference(pair, image):
    engine = _engine(pair, algorithm="ilpm")
    assert engine.plan is None
    assert _rel(engine.run(image), pair["forced"]) <= tolerance("float32")


def test_tuned_plan_matches_reference(pair, image):
    engine = _engine(pair)
    assert engine.plan.to_json() == pair["plan_json"]
    assert set(engine.plan.block_algorithms().values()) == {
        "fused_residual_conv"}
    assert _rel(engine.run(image), pair["tuned"]) <= tolerance("float32")


def test_reference_plan_json_deploys(pair, image):
    engine = _engine(pair, plan=str(pair["plan_path"]))
    assert engine.plan.to_json() == pair["plan_json"]
    assert _rel(engine.run(image), pair["tuned"]) <= tolerance("float32")


def _strip_blocks(plan):
    plan = copy.deepcopy(plan)
    plan.block_choices.clear()
    plan.block_specs.clear()
    return plan


def test_fused_and_per_layer_logits_are_bitwise_equal(pair, image):
    """At fp32 the tuned plan (``fused_residual_conv`` blocks) and the
    per-layer plan (ilpm -> add -> ReLU) give bitwise equal logits, the
    reference's contract; on the card both plan through
    ``ilpm_conv.plan`` and chip_smoke.py's ``resnet18/per_layer`` holds
    them to it."""
    engine = _engine(pair)
    per_layer = _engine(pair, plan=_strip_blocks(engine.plan))
    assert engine.plan.block_choices and not per_layer.plan.block_choices
    assert torch.equal(engine.run(image), per_layer.run(image))


def test_state_dict_keys_are_reference_paths(pair):
    engine = _engine(pair)
    assert set(engine.model.state_dict()) == set(flatten(pair["params"]))
    assert {"stem.w", "fc.b"} <= set(engine.model.state_dict())


def test_run_batch_is_bitwise_equal_to_run():
    engine = TEngine(ttiny(tget("resnet18")), device="cpu")
    images = np.random.default_rng(1).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    batched = engine.run_batch(images)
    assert batched.shape == (3, 256)
    assert torch.equal(batched, torch.stack([engine.run(im)
                                             for im in images]))


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TEngine(ttiny(tget("resnet18")))


def test_bf16_params_cross_exactly():
    tree = {"a": {"w": np.asarray(
        jax.numpy.asarray([1.5, -2.0, 3.140625], jax.numpy.bfloat16))}}
    sd = params_from_reference(tree)
    assert sd["a.w"].dtype == torch.bfloat16
    assert sd["a.w"].float().tolist() == [1.5, -2.0, 3.140625]


def test_init_params_is_stable_across_processes():
    """Seeds come from a CRC of the leaf path, not Python's salted hash."""
    cfg = ttiny(tget("resnet18"))
    specs = tresnet.model_specs(cfg)
    a = init_params(specs, 0, "float32")
    assert all(torch.equal(x, y) for x, y in zip(
        flatten(a).values(), flatten(init_params(specs, 0, "float32"))
        .values()))
    assert not torch.equal(a["stem"]["w"],
                           init_params(specs, 1, "float32")["stem"]["w"])
    code = ("from repro_torch.configs import get, tiny_variant;"
            "from repro_torch.models import resnet;"
            "from repro_torch.models.spec import init_params;"
            "cfg = tiny_variant(get('resnet18'));"
            "p = init_params(resnet.model_specs(cfg), 0, 'float32');"
            "print(repr(float(p['s1b0']['c1']['w'].sum())))")
    env = {**os.environ, "PYTHONHASHSEED": "12345",
           "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert float(out.stdout) == float(a["s1b0"]["c1"]["w"].sum())
