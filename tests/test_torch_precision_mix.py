"""Storage-only precision variants (``param_dtype`` ≠ ``dtype``) in the
port, on the CPU, against the JAX package's ``InferenceEngine`` on the
same config, weights carried across with ``params_from_reference`` and
images from a numpy seed.

Both mixes: fp32 compute over bf16 weights, bf16 compute over fp32
weights. Tiny ResNet-18 tuned, forced onto ilpm, im2col and winograd, and
on a plan pinning its Winograd sites (U cached); tiny MobileNetV2 tuned.
The port casts each conv filter to the compute dtype once at build (exact
where storage is narrower; one rounding where it is wider, where the
reference's kernels promote the site to fp32 instead) and its classifier
head promotes as jnp does, so the logits have the reference's dtype.
Bound: max|y - ref| / max|ref| <= tolerance(cfg.dtype).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.core import InferenceEngine as JEngine
from repro.core import TuningPlan as JPlan
from repro.models import mobilenet as jmobilenet
from repro.models import resnet as jresnet
from repro.models.spec import init_params as jinit
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core import Choice
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core.dtypes import tolerance

# (compute dtype, storage dtype)
MIXES = [("float32", "bfloat16"), ("bfloat16", "float32")]
MODULES = {"resnet18": jresnet, "mobilenet_v2": jmobilenet}
# tiny ResNet-18's even stride-1 3x3 sites and one odd one (1², on ilpm)
PINNED = ("s0b0.c1", "s0b0.c2", "s1b0.c2", "s2b0.c2", "s3b0.c2")


def _configs(arch, mix):
    dtype, param_dtype = mix
    return tuple(dataclasses.replace(tiny(get(arch)), dtype=dtype,
                                     param_dtype=param_dtype)
                 for get, tiny in ((jget, jtiny), (tget, ttiny)))


@functools.lru_cache(maxsize=None)
def _reference_params(arch, mix):
    jcfg, _ = _configs(arch, mix)
    return jinit(MODULES[arch].model_specs(jcfg), 0, jcfg.param_dtype)


def _image(arch):
    img = _configs(arch, MIXES[0])[0].extra["img"]
    return np.random.default_rng(7).standard_normal(
        (img, img, 3)).astype(np.float32)


def _port(arch, mix, **kw):
    _, tcfg = _configs(arch, mix)
    params = params_from_reference(
        jax.tree.map(np.asarray, _reference_params(arch, mix)))
    return TEngine(tcfg, params=params, device="cpu", **kw)


def _reference(arch, mix, **kw):
    jcfg, _ = _configs(arch, mix)
    return JEngine(jcfg, params=_reference_params(arch, mix), **kw)


def _pinned_plan(mix):
    """The port's tuned tiny plan without its fused blocks, PINNED on
    winograd."""
    plan = _port("resnet18", mix).plan
    plan.block_choices.clear()
    plan.block_specs.clear()
    for name in PINNED:
        ch = plan.choices[name]
        plan.choices[name] = Choice("winograd", (), ch.est_time,
                                    ch.est_bytes, ch.est_flops, ch.vmem)
    return plan


def _check(port_engine, ref_engine, arch, dtype):
    y_ref = ref_engine.run(_image(arch))
    y = port_engine.run(_image(arch))
    assert str(y.dtype).removeprefix("torch.") == str(y_ref.dtype)
    r = np.asarray(y_ref, np.float32)
    rel = np.abs(y.float().numpy() - r).max() / np.abs(r).max()
    assert rel <= tolerance(dtype), rel


@pytest.mark.parametrize("algorithm", ["auto", "ilpm", "im2col", "winograd"])
@pytest.mark.parametrize("mix", MIXES, ids=["fp32_over_bf16", "bf16_over_fp32"])
def test_resnet18_matches_reference(mix, algorithm):
    _check(_port("resnet18", mix, algorithm=algorithm),
           _reference("resnet18", mix, algorithm=algorithm), "resnet18",
           mix[0])


@pytest.mark.parametrize("mix", MIXES, ids=["fp32_over_bf16", "bf16_over_fp32"])
def test_resnet18_pinned_winograd_plan_matches_reference(mix):
    plan = _pinned_plan(mix)
    port = _port("resnet18", mix, plan=plan)
    assert sorted(port.winograd_u) == sorted(PINNED)
    _check(port, _reference("resnet18", mix,
                            plan=JPlan.from_json(plan.to_json())),
           "resnet18", mix[0])


@pytest.mark.parametrize("mix", MIXES, ids=["fp32_over_bf16", "bf16_over_fp32"])
def test_mobilenet_v2_matches_reference(mix):
    _check(_port("mobilenet_v2", mix), _reference("mobilenet_v2", mix),
           "mobilenet_v2", mix[0])


@pytest.mark.parametrize("mix", MIXES, ids=["fp32_over_bf16", "bf16_over_fp32"])
def test_engine_casts_conv_filters_once_and_keeps_the_rest_as_stored(mix):
    dtype, param_dtype = (getattr(torch, d) for d in mix)
    engine = _port("resnet18", mix)
    stored = engine.model.state_dict()
    assert {v.dtype for v in stored.values()} == {param_dtype}
    site = engine.params["s0b0"]["c1"]
    assert site["w"].dtype == dtype
    assert torch.equal(site["w"], stored["s0b0.c1.w"].to(dtype))
    assert site["scale"].dtype == site["bias"].dtype == param_dtype
    assert engine.params["fc"]["w"].dtype == param_dtype


@pytest.mark.parametrize("mix", MIXES, ids=["fp32_over_bf16", "bf16_over_fp32"])
def test_winograd_u_cache_is_computed_from_the_stored_weights(mix):
    """Under fp32 compute over bf16 weights the reference rounds U to
    bf16; computing U from the widened filter would leave it unrounded,
    ~2e-3 away. Under bf16 compute over fp32 weights U stays fp32."""
    plan = _pinned_plan(mix)
    port = _port("resnet18", mix, plan=plan)
    ref = _reference("resnet18", mix, plan=JPlan.from_json(plan.to_json()))
    assert sorted(port.winograd_u) == sorted(ref.winograd_u)
    for name, u in port.winograd_u.items():
        assert u.dtype == torch.float32
        u_ref = np.asarray(ref.winograd_u[name], np.float32)
        assert np.abs(u.numpy() - u_ref).max() <= 2e-5 * np.abs(u_ref).max()
        if mix[1] == "bfloat16":
            assert torch.equal(u, u.to(torch.bfloat16).float())
