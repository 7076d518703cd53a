"""The port's pure-Python twins against the JAX package: dtype rules,
ConvSpec/FusedBlockSpec properties, and tuned plans (JSON-equal, and
plans saved by the reference deploy in the port)."""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.core import InferenceEngine as JEngine
from repro.core import autotune as jat
from repro.core import convspec as jcs
from repro.core import dtypes as jdt
from repro.models import resnet as jresnet
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core import autotune as tat
from repro_torch.core import convspec as tcs
from repro_torch.core import dtypes as tdt
from repro_torch.models import resnet as tresnet

DTYPE_NAMES = ["float64", "float32", "int32", "bfloat16", "float16", "int8",
               "uint8"]


@pytest.mark.parametrize("name", DTYPE_NAMES)
def test_element_size_matches_reference(name):
    assert tdt.element_size(name) == jdt.element_size(name)
    assert tdt.canonical(getattr(torch, name)) == name
    assert tdt.element_size(getattr(torch, name)) == jdt.element_size(name)


def test_dtype_rules_match_reference():
    assert tdt.ACC_BYTES == jdt.ACC_BYTES
    assert tdt.ACC_DTYPE == jdt.ACC_DTYPE
    assert tdt.KERNEL_DTYPES == jdt.KERNEL_DTYPES
    for name in jdt.KERNEL_DTYPES:
        assert tdt.tolerance(name) == jdt.tolerance(name)
        assert tdt.tolerance(getattr(torch, name)) == jdt.tolerance(name)
    assert tdt.canonical(np.dtype("float16")) == "float16"
    with pytest.raises(ValueError):
        tdt.element_size("complex64")


def test_with_precision_matches_reference():
    t = tdt.with_precision(tget("resnet18"), "bfloat16")
    j = jdt.with_precision(jget("resnet18"), "bfloat16")
    assert (t.dtype, t.param_dtype) == (j.dtype, j.param_dtype)
    assert tdt.with_precision(t, torch.bfloat16) is t
    with pytest.raises(ValueError):
        tdt.with_precision(t, "int8")


def _conv_sweep():
    for h, c, k, r, stride, dtype, groups in itertools.product(
            (7, 14, 32), (3, 8, 64), (8, 64), (1, 3, 7), (1, 2),
            ("float32", "bfloat16"), (1, 8)):
        if c % groups or k % groups:
            continue
        yield dict(h=h, w=h + 1, c=c, k=k, r=r, s=r, stride=stride,
                   batch=2, dtype=dtype, groups=groups)


CONV_PROPS = ("c_per_group", "depthwise", "out_h", "out_w", "flops",
              "element_size", "bytes_min", "epilogue_bytes")


def test_convspec_properties_match_reference():
    n = 0
    for kw in _conv_sweep():
        t, j = tcs.ConvSpec(**kw), jcs.ConvSpec(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in CONV_PROPS:
            assert getattr(t, prop) == getattr(j, prop), (kw, prop)
        if j.depthwise:
            assert t.channel_multiplier == j.channel_multiplier
        n += 1
    assert n > 100


def _block_sweep():
    for h, mid, cout, r, dtype in itertools.product(
            (7, 14, 56), (16, 64), (64, 256), (1, 3), ("float32", "float16")):
        yield dict(kind="residual_conv", h=h, w=h, cin=mid, mid=mid,
                   cout=cout, r=r, s=r, residual=True, dtype=dtype)
        for cin, stride in ((16, 1), (24, 2)):
            residual = stride == 1 and cin == cout
            yield dict(kind="inverted_residual", h=h, w=h, cin=cin, mid=mid,
                       cout=cout, r=3, s=3, stride=stride,
                       residual=residual, dtype=dtype)


def test_fused_block_spec_properties_match_reference():
    for kw in _block_sweep():
        t, j = tcs.FusedBlockSpec(**kw), jcs.FusedBlockSpec(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("expanded", "out_h", "out_w", "element_size",
                     "saved_bytes", "residual_pass_bytes"):
            assert getattr(t, prop) == getattr(j, prop), (kw, prop)
        assert [(n, dataclasses.asdict(s)) for n, s in t.conv_specs()] \
            == [(n, dataclasses.asdict(s)) for n, s in j.conv_specs()]


def test_convspec_from_torch_tensors():
    x = torch.zeros(2, 10, 12, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 1, 8, dtype=torch.bfloat16)
    spec = tcs.ConvSpec.from_tensors(x, w, 2)
    assert spec == tcs.ConvSpec(h=10, w=12, c=8, k=8, r=3, s=3, stride=2,
                                batch=2, dtype="bfloat16", groups=8)
    assert spec.depthwise


def _cfgs(name, tiny, dtype):
    t, j = tget(name), jget(name)
    if tiny:
        t, j = ttiny(t), jtiny(j)
    return tdt.with_precision(t, dtype), jdt.with_precision(j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_tuned_plan_json_equals_reference(name, tiny, dtype):
    tcfg, jcfg = _cfgs(name, tiny, dtype)
    tspecs = [(n, dataclasses.asdict(s)) for n, s in tresnet.conv_specs(tcfg)]
    jspecs = [(n, dataclasses.asdict(s)) for n, s in jresnet.conv_specs(jcfg)]
    assert tspecs == jspecs
    tplan = tat.build_plan(tresnet.conv_specs(tcfg), epilogue=True,
                           block_specs=tresnet.block_specs(tcfg))
    jplan = jat.build_plan(jresnet.conv_specs(jcfg), epilogue=True,
                           block_specs=jresnet.block_specs(jcfg))
    assert json.loads(tplan.to_json()) == json.loads(jplan.to_json())
    assert tplan.to_json() == jplan.to_json()
    assert set(tplan.algorithms().values()) <= {"ilpm", "pointwise"}
    assert len(tplan.block_choices) == len(tresnet.block_specs(tcfg))


@pytest.fixture(scope="module")
def reference_plan_path(tmp_path_factory):
    """A plan tuned and saved by the JAX engine for resnet18-tiny."""
    path = tmp_path_factory.mktemp("plans") / "resnet18_tiny.json"
    JEngine(jtiny(jget("resnet18"))).save_plan(path)
    return path


def test_reference_plan_deploys_in_port(reference_plan_path):
    engine = TEngine(ttiny(tget("resnet18")), plan=str(reference_plan_path),
                     device="cpu")
    assert engine.plan.to_json() == reference_plan_path.read_text()
    assert engine.plan.block_algorithms() == {
        f"s{i}b0.block": "fused_residual_conv" for i in range(4)}


def test_cross_dtype_plan_is_refused(reference_plan_path):
    cfg = tdt.with_precision(ttiny(tget("resnet18")), "bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        TEngine(cfg, plan=str(reference_plan_path), device="cpu")


def test_cross_geometry_plan_is_refused(reference_plan_path):
    cfg = ttiny(tget("resnet18"))
    cfg = cfg.replace(extra={**cfg.extra, "img": 64})
    with pytest.raises(ValueError, match="different network"):
        TEngine(cfg, plan=str(reference_plan_path), device="cpu")


def test_v1_plan_is_readable():
    plan = tat.build_plan(tresnet.conv_specs(ttiny(tget("resnet18"))),
                          epilogue=True)
    d = json.loads(plan.to_json())
    d["version"] = 1
    del d["blocks"]
    back = tat.TuningPlan.from_json(json.dumps(d))
    assert back.choices == plan.choices and not back.block_choices
    d["version"] = 3
    with pytest.raises(ValueError, match="version"):
        tat.TuningPlan.from_json(json.dumps(d))


def test_measured_mode_is_not_ported():
    spec = tcs.ConvSpec(h=8, w=8, c=8, k=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tat.select(spec, "measured")
    with pytest.raises(ValueError):
        tat.select(spec, "guess")


def test_device_model_is_an_explicit_argument():
    spec = tcs.ConvSpec(h=56, w=56, c=64, k=64)
    ref = tat.cost_model_select(spec, epilogue=True)
    assert ref == tat.select(spec, epilogue=True,
                             device=tat.REFERENCE_DEVICE)
    slow = tat.DeviceModel(peak_flops=1e12, mem_bw=1e12,
                           onchip_bytes=tat.REFERENCE_DEVICE.onchip_bytes)
    other = tat.cost_model_select(spec, epilogue=True, device=slow)
    assert other.est_time > ref.est_time
