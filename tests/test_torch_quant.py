"""The port's ``quant.py`` on the CPU against the JAX package's
``repro.quant`` on the same numpy-seeded inputs: int8 codes bit for bit
(both round half to even), scales and errors within fp32 rounding, and
tiny ResNet-18 on quantized weights against ``repro``'s engine on the
same weights within tolerance("float32")."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.core import InferenceEngine as JEngine
from repro.models import resnet as jresnet
from repro.models.spec import init_params as jinit
from repro_torch import quant as tquant
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core.dtypes import tolerance
from repro_torch.models.spec import flatten

FP32_ULP = float(np.finfo(np.float32).eps)


def _data(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(y, ref):
    y = np.asarray(y, dtype=np.float32)
    r = np.asarray(ref, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    return float(np.abs(y - r).max() / np.abs(r).max())


def _close(y, ref):
    np.testing.assert_allclose(np.asarray(y, np.float32),
                               np.asarray(ref, np.float32), rtol=FP32_ULP,
                               atol=0)


def _ties(seed):
    """Values with exact .5 quotients: half to even decides their codes."""
    a = _data(seed, 64)
    a[:8] = np.array([127, -127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5],
                     np.float32)
    return a


@pytest.mark.parametrize("case", ["normal", "ties", "zeros"])
def test_quantize_matches_reference(case):
    a = {"normal": _data(80, 5, 7), "ties": _ties(81),
         "zeros": np.zeros((3, 4), np.float32)}[case]
    codes, scale = tquant.quantize(torch.from_numpy(a))
    jcodes, jscale = jquant.quantize(jnp.asarray(a))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _close(scale.numpy(), jscale)
    _close(tquant.dequantize(codes, scale).numpy(),
           jquant.dequantize(jcodes, jscale))


@pytest.mark.parametrize("axis", [-1, 0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_per_channel_matches_reference(axis, dtype):
    a = _data(82, 3, 3, 5, 8)
    a[0, 0, 0, 1] = 0.0  # one channel's max may land on a tie
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    j = jnp.asarray(a, dtype=getattr(jnp, dtype))
    codes, scales = tquant.quantize_per_channel(t, axis=axis)
    jcodes, jscales = jquant.quantize_per_channel(j, axis=axis)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert scales.shape == (a.shape[axis],)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _close(scales.numpy(), jscales)


def test_quantized_conv_storage_bytes():
    codes, scales = tquant.quantize_per_channel(
        torch.from_numpy(_data(83, 3, 3, 4, 8)))
    q = tquant.QuantizedConv(codes, scales)
    jq = jquant.QuantizedConv(*jquant.quantize_per_channel(
        jnp.asarray(_data(83, 3, 3, 4, 8))))
    assert q.storage_bytes == jq.storage_bytes == 3 * 3 * 4 * 8 + 4 * 8


# ---- the network -------------------------------------------------------

def _image():
    return np.random.default_rng(0).standard_normal((32, 32, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _reference():
    """repro's tiny ResNet-18 params as numpy, its quantized tree and
    report as numpy, the quantization errors, and the quantized engine's
    logits on its tuned plan."""
    cfg = jtiny(jget("resnet18"))
    params = jinit(jresnet.model_specs(cfg), 0, cfg.param_dtype)
    qparams, report = jquant.quantize_params(params)
    logits = JEngine(cfg, params=qparams).run(_image())
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (to_np(params), to_np(qparams),
            {k: (np.asarray(q.codes), np.asarray(q.scales))
             for k, q in report.items()},
            jquant.quantization_error(params, report),
            np.asarray(logits, np.float32))


def _port_params():
    return TEngine(ttiny(tget("resnet18")),
                   params=params_from_reference(_reference()[0]),
                   device="cpu").params


def test_quantize_params_matches_reference():
    _, jq, jreport, _, _ = _reference()
    qparams, report = tquant.quantize_params(_port_params())
    assert sorted(report) == sorted(jreport)
    for name, q in report.items():
        np.testing.assert_array_equal(q.codes.numpy(), jreport[name][0])
        _close(q.scales.numpy(), jreport[name][1])
    flat, jflat = flatten(qparams), flatten(jq)
    assert sorted(flat) == sorted(jflat)
    for key, leaf in flat.items():
        assert leaf.dtype == torch.float32, key
        if key.endswith(".w") and key != "fc.w":  # exact integer codes
            np.testing.assert_array_equal(leaf.numpy(), jflat[key])
        else:
            _close(leaf.detach().numpy(), jflat[key])


def test_quantize_params_compute_dtype():
    qparams, report = tquant.quantize_params(_port_params(),
                                             compute_dtype="bfloat16")
    site = qparams["s1b0"]["c1"]
    assert site["w"].dtype == torch.bfloat16
    assert site["scale"].dtype == torch.float32
    assert torch.equal(site["w"].float(),
                       report["s1b0.c1"].codes.float())
    assert qparams["fc"]["w"].dtype == torch.float32  # the head stays


def test_quantization_error_matches_reference():
    _, _, _, jerr, _ = _reference()
    params = _port_params()
    err = tquant.quantization_error(params,
                                    tquant.quantize_params(params)[1])
    assert sorted(err) == sorted(jerr)
    for name, e in err.items():
        assert e == pytest.approx(jerr[name], rel=4 * FP32_ULP)
    assert max(err.values()) < 0.02


def test_quantized_engine_matches_reference():
    """The unchanged forward on int8 weights, the scales riding in the
    epilogue, against repro's engine on its own quantized weights."""
    *_, ref = _reference()
    qparams, _ = tquant.quantize_params(_port_params())
    engine = TEngine(ttiny(tget("resnet18")), params=qparams, device="cpu")
    assert _rel(engine.run(_image()), ref) <= tolerance("float32")
    fp32 = TEngine(ttiny(tget("resnet18")), params=_port_params(),
                   device="cpu")
    assert engine.plan.to_json() == fp32.plan.to_json()
    assert _rel(engine.run(_image()), fp32.run(_image())) < 0.05
