"""The paper's baselines in the port, on the CPU: the plain versions of
``direct_conv``, ``im2col_unroll``, ``gemm``, ``im2col_conv`` and
``libdnn_conv`` against the JAX package's kernels (Pallas in interpret
mode, and the jnp path), and tiny ResNet-18 forced onto direct, im2col and
libdnn against ``repro``'s ``InferenceEngine(cfg, algorithm=X)``, on the
same numpy-seeded inputs.

Bound: max|y - ref| / max|ref| <= tolerance(dtype); the unroll, a copy, is
held bitwise. The CUDA kernels cannot run here; chip_smoke.py holds them
against these plain versions on the card.
"""
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import resnet as jresnet_cfg
from repro.configs import tiny_variant as jtiny
from repro.core import InferenceEngine as JEngine
from repro.kernels import gemm as jgemm
from repro.kernels import im2col_conv as jim2col
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import resnet as jresnet
from repro.models.spec import init_params as jinit
from repro_torch.configs import get as tget
from repro_torch.configs import resnet as tresnet_cfg
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core import algorithms as talg
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import (_build, direct_conv, gemm, im2col_conv,
                                 libdnn_conv, ops)
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ACTS = (None, "relu", "relu6")
KERNELS = {"direct_conv": direct_conv.direct_conv,
           "libdnn_conv": libdnn_conv.libdnn_conv,
           "im2col_unroll": im2col_conv.im2col_unroll,
           "gemm": gemm.gemm}
CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"


def _data(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, dtype=jdt)


def _rel(y, ref):
    y = y.float().numpy()
    r = np.asarray(ref, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    return float(np.abs(y - r).max() / np.abs(r).max())


def _epilogue(seed, k):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    bias = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return (torch.from_numpy(scale), torch.from_numpy(bias),
            jnp.asarray(scale), jnp.asarray(bias))


def _conv_inputs(seed, h, r, c, k, stride, dtype):
    """Both packages' SAME-padded image (h x h+1), filters and epilogue."""
    x_t, x_j = _both(_data(seed, 1, h, h + 1, c), dtype)
    w_t, w_j = _both(_data(seed + 1, r, r, c, k,
                           scale=(r * r * c) ** -0.5), dtype)
    xp_t = tref.pad_same(x_t, r, r, stride)
    xp_j = jref.pad_same(x_j, r, r, stride)
    return xp_t, w_t, xp_j, w_j, _epilogue(seed + 2, k)


# H not a multiple of block_h (8) clamps the JAX kernel's last band
DIRECT_CASES = [(stride, r, h) for stride in (1, 2) for r in (1, 3, 7)
                for h in (9, 20)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride,r,h", DIRECT_CASES)
def test_direct_matches_reference(stride, r, h, dtype):
    act = ACTS[(stride + r + h) % 3]
    xp_t, w_t, xp_j, w_j, (sc_t, bi_t, sc_j, bi_j) = _conv_inputs(
        40, h, r, 3 if r == 7 else 4, 8, stride, dtype)
    y = ops.dispatch("direct", xp_t, w_t, stride=stride, scale=sc_t,
                     bias=bi_t, act=act, block_h=8)
    assert y.dtype == DTYPES[dtype][0]
    assert y.shape == (1, -(-h // stride), -(-(h + 1) // stride), 8)
    assert torch.equal(y, direct_conv.direct_conv(
        xp_t, w_t, stride=stride, scale=sc_t, bias=bi_t, act=act))
    for impl in ("pallas", "jnp"):
        ref = jops.direct(xp_j, w_j, impl=impl, stride=stride, block_h=8,
                          scale=sc_j, bias=bi_j, act=act)
        assert _rel(y, ref) <= tolerance(dtype), impl


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r,h,c", [(1, 9, 4), (3, 9, 4), (3, 10, 3),
                                   (7, 8, 3)])
def test_im2col_unroll_is_bitwise_the_reference(r, h, c, dtype):
    x_t, x_j = _both(_data(43, 2, h, h + 1, c), dtype)
    xp_t, xp_j = tref.pad_same(x_t, r, r), jref.pad_same(x_j, r, r)
    y = im2col_conv.im2col_unroll(xp_t, r, r)
    assert y.shape == (2, h * (h + 1), r * r * c)
    ref = jim2col.im2col_unroll(xp_j, r=r, s=r, interpret=True)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(ref, np.float32))
    np.testing.assert_array_equal(
        y.float().numpy(), np.asarray(jref.im2col_unroll(xp_j, r, r),
                                      np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,kc,n", [(70, 200, 40), (33, 300, 130),
                                    (64, 128, 64)])
def test_gemm_matches_reference(m, kc, n, dtype):
    """Ragged M and N, and a contraction above 128 that the TPU kernel
    zero-pads to its tile."""
    a_t, a_j = _both(_data(44, m, kc, scale=kc ** -0.5), dtype)
    b_t, b_j = _both(_data(45, kc, n), dtype)
    y = ops.gemm(a_t, b_t)
    assert y.dtype == DTYPES[dtype][0] and y.shape == (m, n)
    batched = ops.gemm(torch.stack([a_t, -a_t]), b_t)
    assert torch.equal(batched[0], y) and torch.equal(batched[1], -y)
    for ref in (jgemm.gemm(a_j, b_j, interpret=True), jref.gemm(a_j, b_j)):
        assert _rel(y, ref) <= tolerance(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("algorithm", ["im2col", "libdnn"])
@pytest.mark.parametrize("r,h", [(1, 9), (3, 9), (3, 10)])
def test_fused_im2col_family_matches_reference(algorithm, r, h, dtype):
    act = ACTS[(r + h) % 3]
    xp_t, w_t, xp_j, w_j, (sc_t, bi_t, sc_j, bi_j) = _conv_inputs(
        46, h, r, 6, 8, 1, dtype)
    y = ops.dispatch(algorithm, xp_t, w_t, stride=1, scale=sc_t, bias=bi_t,
                     act=act, block_k=128)
    assert y.dtype == DTYPES[dtype][0]
    assert y.shape == (1, h, h + 1, 8)
    for impl in ("pallas", "jnp"):
        ref = getattr(jops, algorithm)(xp_j, w_j, impl=impl, scale=sc_j,
                                       bias=bi_j, act=act)
        assert _rel(y, ref) <= tolerance(dtype), impl


def test_im2col_rounds_where_its_kernels_write():
    """The GEMM writes the compute dtype and the epilogue pass rounds
    again, as the JAX package's im2col does; one rounding of the same
    fp32 product differs."""
    x = torch.from_numpy(_data(47, 1, 6, 6, 8)).to(torch.bfloat16)
    w = torch.from_numpy(_data(48, 3, 3, 8, 8, scale=0.2)).to(torch.bfloat16)
    scale = torch.full((8,), 1.37)
    xp = tref.pad_same(x, 3, 3)
    y = ops.im2col(xp, w, scale=scale)
    acc = tref.im2col_unroll(xp, 3, 3).float() @ w.reshape(72, 8).float()
    twice = (acc.to(torch.bfloat16).float() * scale).to(torch.bfloat16)
    once = (acc * scale).to(torch.bfloat16)
    assert torch.equal(y, twice.reshape(1, 6, 6, 8))
    assert not torch.equal(twice, once)


def test_paper_conv_layers_equal_reference():
    assert [dataclasses.asdict(s) for s in tresnet_cfg.PAPER_CONV_LAYERS] \
        == [dataclasses.asdict(s) for s in jresnet_cfg.PAPER_CONV_LAYERS]
    assert [f.name for f in dataclasses.fields(tresnet_cfg.ConvLayerSpec)] \
        == [f.name for f in dataclasses.fields(jresnet_cfg.ConvLayerSpec)]


# ---- the forced-algorithm engines ------------------------------------

FORCED = ("direct", "im2col", "libdnn")


@functools.lru_cache(maxsize=None)
def _reference(algorithm):
    """repro's tiny ResNet-18 forced onto ``algorithm``: its params as
    numpy and its logits on one image."""
    cfg = jtiny(jget("resnet18"))
    params = jinit(jresnet.model_specs(cfg), 0, cfg.param_dtype)
    logits = JEngine(cfg, params=params, algorithm=algorithm).run(_image())
    return jax.tree.map(np.asarray, params), np.asarray(logits)


def _image():
    return np.random.default_rng(0).standard_normal((32, 32, 3)).astype(
        np.float32)


def _forced(algorithm):
    params, _ = _reference(algorithm)
    return TEngine(ttiny(tget("resnet18")),
                   params=params_from_reference(params),
                   algorithm=algorithm, device="cpu")


@pytest.mark.parametrize("algorithm", FORCED)
def test_forced_engine_matches_reference(algorithm):
    engine = _forced(algorithm)
    assert engine.plan is None
    _, ref = _reference(algorithm)
    assert _rel(engine.run(_image()), ref) <= tolerance("float32")


@pytest.mark.parametrize("algorithm,expected", [
    ("direct", {"direct": 12}),
    ("im2col", {"im2col": 5, "ilpm": 7}),
    ("libdnn", {"libdnn": 5, "ilpm": 7}),
])
def test_forced_dispatch_counts(algorithm, expected, monkeypatch):
    """The strided sites (the stem, three 3x3/2 stage entries, three 1x1/2
    projections) go to ilpm, which has a strided kernel; direct takes them
    all."""
    engine = _forced(algorithm)
    calls = []
    for name, fn in dict(ops.ALGORITHMS).items():
        @functools.wraps(fn)
        def spy(*args, _name=name, _fn=fn, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setitem(ops.ALGORITHMS, name, spy)
    engine.run(_image())
    assert {n: calls.count(n) for n in set(calls)} == expected


@pytest.mark.parametrize("algorithm", FORCED)
def test_forced_run_batch_is_bitwise_equal_to_run(algorithm):
    engine = _forced(algorithm)
    images = np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    assert torch.equal(engine.run_batch(images),
                       torch.stack([engine.run(im) for im in images]))


@pytest.mark.parametrize("algorithm", FORCED)
def test_forced_engine_agrees_with_tuned_engine(algorithm):
    """Every algorithm computes the same conv: the forced engines stay
    within the fp32 bound of the tuned one on the same weights."""
    engine = _forced(algorithm)
    tuned = TEngine(engine.cfg, params=engine.model, device="cpu")
    a, b = tuned.run(_image()), engine.run(_image())
    assert _rel(b, a.numpy()) <= tolerance("float32")


# ---- wrappers, routing and build -------------------------------------

def test_kernel_params_of_the_baselines():
    params = {"block_k": 128, "block_h": 8, "stride": 2, "act": "relu",
              "u": None}
    assert ops.kernel_params("direct", params) == {"stride": 2,
                                                   "act": "relu"}
    assert ops.kernel_params("im2col", params) == {"act": "relu"}
    assert ops.kernel_params("libdnn", params) == {"act": "relu"}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wrappers_raise_on_a_device_without_a_kernel(kernel):
    x = torch.empty(1, 8, 8, 4, device="meta")
    w = torch.empty(3, 3, 4, 4, device="meta")
    args = {"direct_conv": (x, w), "libdnn_conv": (x, w),
            "im2col_unroll": (x, 3, 3),
            "gemm": (torch.empty(8, 4, device="meta"),
                     torch.empty(4, 4, device="meta"))}[kernel]
    with pytest.raises(ValueError, match="no kernel for meta"):
        KERNELS[kernel](*args)


@pytest.mark.parametrize("algorithm", ["direct", "im2col", "libdnn"])
def test_impl_cuda_on_cpu_tensor_raises(algorithm):
    x = tref.pad_same(torch.from_numpy(_data(52, 1, 8, 8, 4)), 3, 3)
    w = torch.from_numpy(_data(53, 3, 3, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.dispatch(algorithm, x, w, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gemm(x[0, 0], w[0, 0], impl="cuda")


def test_auto_on_cpu_launches_no_kernel():
    for fn in KERNELS.values():
        fn.launches = 0
    x = torch.from_numpy(_data(54, 1, 8, 8, 4))
    w = torch.from_numpy(_data(55, 3, 3, 4, 8))
    xp = tref.pad_same(x, 3, 3)
    for algorithm in ("direct", "im2col", "libdnn"):
        assert torch.equal(ops.dispatch(algorithm, xp, w),
                           getattr(tref, f"{algorithm}_conv")(xp, w))
    assert torch.equal(ops.dispatch("direct", tref.pad_same(x, 3, 3, 2), w,
                                    stride=2),
                       tref.direct_conv(tref.pad_same(x, 3, 3, 2), w,
                                        stride=2))
    assert {n: fn.launches for n, fn in KERNELS.items()} == dict.fromkeys(
        KERNELS, 0)


@pytest.mark.parametrize("algorithm", ["im2col", "libdnn"])
def test_strided_sites_fall_back_to_ilpm_and_direct_keeps_them(algorithm):
    x = torch.from_numpy(_data(56, 1, 8, 8, 4))
    w = torch.from_numpy(_data(57, 1, 1, 4, 8))
    y = talg.conv2d(x, w, stride=2, algorithm=algorithm)
    assert torch.equal(y, talg.conv2d(x, w, stride=2, algorithm="ilpm"))
    d = talg.conv2d(x, w, stride=2, algorithm="direct")
    assert torch.equal(d, tref.direct_conv(x, w, stride=2))  # 1x1/2: no pad


def test_new_kernels_build_from_their_own_sources():
    """Each kernel has its own source and exported entry point; direct is
    not the halo'd-tile kernel of ilpm under another name."""
    for name in ("direct_conv", "libdnn_conv", "im2col_unroll", "gemm"):
        src = (CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in src
        assert f"{name}_launch" in _build.SIGNATURES
        assert CSRC / f"{name}.cu" in _build._sources()
    assert "conv_tile.cuh" not in (CSRC / "direct_conv.cu").read_text()
