"""Winograd F(2x2,3x3) in the port, on the CPU: the plain transforms, the
batched ``gemm`` and ``winograd_conv`` against the JAX package's Pallas
kernels (interpret mode), its jnp path and its ``ref`` functions; the
routing of ``u``; tiny ResNet-18 forced onto Winograd and on a plan that
pins sites to Winograd against ``repro``'s ``InferenceEngine``, on the
same numpy-seeded inputs.

Bound: max|y - ref| / max|ref| <= tolerance(dtype). H != W and H = W = 2
(one tile) catch a swapped tile axis. The CUDA kernels cannot run here;
chip_smoke.py holds them against these plain versions on the card.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.core import InferenceEngine as JEngine
from repro.core import TuningPlan as JPlan
from repro.core import with_precision as jprecision
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import winograd_conv as jwg
from repro.models import resnet as jresnet
from repro.models.spec import init_params as jinit
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core import Choice
from repro_torch.core import InferenceEngine as TEngine
from repro_torch.core import algorithms as talg
from repro_torch.core import with_precision as tprecision
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import _build, gemm, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import winograd_conv as twg

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ACTS = (None, "relu", "relu6")
# (H, W) of the conv output: H != W both ways, one tile, a square
SIZES = [(6, 4), (4, 10), (2, 2), (8, 8)]
KERNELS = {"winograd_input_transform": twg.winograd_input_transform,
           "winograd_output_transform": twg.winograd_output_transform}
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


def _padded(seed, h, w, c, dtype, batch=2):
    x_t, x_j = _both(_data(seed, batch, h, w, c), dtype)
    return tref.pad_same(x_t, 3, 3), jref.pad_same(x_j, 3, 3)


# ---- the three phases --------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_filter_transform_matches_reference(dtype):
    """U is computed in fp32 and returned in fp32, bf16 filters too (jnp
    promotes against its fp32 G)."""
    w_t, w_j = _both(_data(60, 3, 3, 5, 7), dtype)
    u = tref.winograd_filter_transform(w_t)
    ref = jref.winograd_filter_transform(w_j)
    assert u.dtype == torch.float32 and ref.dtype == jnp.float32
    assert u.shape == (4, 4, 5, 7)
    assert _rel(u, ref) <= tolerance("float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,w", SIZES)
def test_input_transform_matches_reference(h, w, dtype):
    xp_t, xp_j = _padded(61, h, w, 6, dtype)
    v = twg.winograd_input_transform(xp_t, h, w)
    assert v.dtype == DTYPES[dtype][0]
    assert v.shape == (2, 4, 4, (h // 2) * (w // 2), 6)
    assert torch.equal(v, tref.winograd_input_transform(xp_t, h, w))
    for ref in (jwg.winograd_input_transform(xp_j, interpret=True),
                jref.winograd_input_transform(xp_j, h, w)):
        assert _rel(v, ref) <= tolerance(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("fused", [False, True])
def test_output_transform_matches_reference(h, w, fused, dtype):
    nt, k = (h // 2) * (w // 2), 8
    m_t, m_j = _both(_data(62, 2, 4, 4, nt, k), dtype)
    act = ACTS[(h + w) % 3] if fused else None
    sc_t, bi_t, sc_j, bi_j = _epilogue(63, k) if fused \
        else (None, None, None, None)
    y = twg.winograd_output_transform(m_t, h, w, scale=sc_t, bias=bi_t,
                                      act=act)
    assert y.dtype == DTYPES[dtype][0] and y.shape == (2, h, w, k)
    pallas = jwg.winograd_output_transform(m_j, H=h, W=w, scale=sc_j,
                                           bias=bi_j, act=act,
                                           interpret=True)
    jnp_path = jref.apply_epilogue(jref.winograd_output_transform(m_j, h, w),
                                   scale=sc_j, bias=bi_j, act=act)
    for ref in (pallas, jnp_path):
        assert _rel(y, ref) <= tolerance(dtype)


def test_output_transform_scatters_tiles_row_major():
    """Tile t = i*(W/2) + j writes the 2x2 block at (2i, 2j): a single
    non-zero M value per tile lands in that tile's top-left pixel."""
    h, w = 4, 6
    m = torch.zeros(1, 4, 4, 6, 1)
    m[0, 0, 0, :, 0] = torch.arange(1.0, 7.0)  # A^T e00 A = [[1,0],[0,0]]
    y = tref.winograd_output_transform(m, h, w)[0, :, :, 0]
    want = torch.zeros(h, w)
    want[0::2, 0::2] = torch.arange(1.0, 7.0).reshape(2, 3)
    assert torch.equal(y, want)


@pytest.mark.parametrize("a_dtype,b_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
@pytest.mark.parametrize("batch_b", [1, 3])
def test_batched_gemm_matches_per_matrix_products(batch_b, a_dtype,
                                                  b_dtype):
    """Element z of a reads b[z % batch_b]; an fp32 b under a bf16 a
    multiplies in fp32 and writes a's dtype."""
    a = torch.from_numpy(_data(64, 6, 9, 20)).to(DTYPES[a_dtype][0])
    b = torch.from_numpy(_data(65, batch_b, 20, 7)).to(DTYPES[b_dtype][0])
    y = ops.gemm(a, b)
    assert y.dtype == a.dtype and y.shape == (6, 9, 7)
    for z in range(6):
        want = (a[z].float() @ b[z % batch_b].float()).to(a.dtype)
        assert torch.equal(y[z], want)
    if batch_b == 1 and a_dtype == b_dtype:  # im2col's shared b
        assert torch.equal(y, gemm.gemm(a, b[0]))
    a_j = jnp.asarray(a.float().numpy(), DTYPES[a_dtype][1])
    b_j = jnp.asarray(b.float().numpy(), DTYPES[b_dtype][1])
    for z in range(6):
        ref = jops.gemm(a_j[z], b_j[z % batch_b], interpret=True)
        assert _rel(y[z], ref) <= tolerance(a_dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("u_kind", [None, "float32", "w.dtype"])
def test_winograd_conv_matches_reference(h, w, u_kind, dtype):
    """With no U (computed per call, fp32), U in fp32 (the forced path)
    and U in the filters' dtype (the engine's cache), with the epilogue."""
    act = ACTS[(h + w) % 3]
    xp_t, xp_j = _padded(66, h, w, 6, dtype, batch=1)
    w_t, w_j = _both(_data(67, 3, 3, 6, 8, scale=54 ** -0.5), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(68, 8)
    u_t = u_j = None
    if u_kind is not None:
        u_t = tref.winograd_filter_transform(w_t)
        u_j = jref.winograd_filter_transform(w_j)
        if u_kind == "w.dtype":
            u_t, u_j = u_t.to(w_t.dtype), u_j.astype(w_j.dtype)
    y = ops.dispatch("winograd", xp_t, w_t, u=u_t, scale=sc_t, bias=bi_t,
                     act=act, block_k=128)
    assert y.dtype == DTYPES[dtype][0] and y.shape == (1, h, w, 8)
    assert torch.equal(y, tref.winograd_conv(xp_t, w_t, u=u_t, scale=sc_t,
                                             bias=bi_t, act=act))
    for impl in ("pallas", "jnp"):
        ref = jops.winograd(xp_j, w_j, impl=impl, u=u_j, scale=sc_j,
                            bias=bi_j, act=act)
        assert _rel(y, ref) <= tolerance(dtype), impl
    ref = jref.apply_epilogue(jref.winograd_conv(xp_j, w_j, u=u_j),
                              scale=sc_j, bias=bi_j, act=act)
    assert _rel(y, ref) <= tolerance(dtype)


def test_winograd_conv_is_the_convolution():
    x = torch.from_numpy(_data(69, 1, 6, 4, 5))
    w = torch.from_numpy(_data(70, 3, 3, 5, 7))
    y = tref.winograd_conv(tref.pad_same(x, 3, 3), w)
    ref = tref.conv2d_reference(x, w)
    assert _rel(y, ref.numpy()) <= tolerance("float32")


@pytest.mark.parametrize("r,h", [(1, 8), (3, 7), (3, 1)])
def test_winograd_conv_refuses_what_f23_cannot_run(r, h):
    xp = torch.zeros(1, h + r - 1, h + r - 1, 4)
    w = torch.zeros(r, r, 4, 4)
    for fn in (tref.winograd_conv, twg.winograd_conv):
        with pytest.raises(ValueError, match="winograd"):
            fn(xp, w)


# ---- routing -----------------------------------------------------------

def _spy(monkeypatch):
    calls = []
    for name, fn in dict(ops.ALGORITHMS).items():
        @functools.wraps(fn)
        def spy(*args, _name=name, _fn=fn, **kw):
            calls.append((_name, "u" in kw))
            return _fn(*args, **kw)
        monkeypatch.setitem(ops.ALGORITHMS, name, spy)
    return calls


@pytest.mark.parametrize("algorithm,stride,h,r,want", [
    ("winograd", 1, 8, 3, ("winograd", True)),
    ("winograd", 1, 7, 3, ("ilpm", False)),   # odd output size
    ("winograd", 2, 8, 3, ("ilpm", False)),   # strided
    ("winograd", 1, 8, 1, ("ilpm", False)),   # not 3x3
    ("ilpm", 1, 8, 3, ("ilpm", False)),
    ("libdnn", 1, 8, 3, ("libdnn", False)),
])
def test_conv2d_passes_u_only_where_winograd_runs(algorithm, stride, h, r,
                                                 want, monkeypatch):
    calls = _spy(monkeypatch)
    x = torch.from_numpy(_data(71, 1, h, h, 4))
    w = torch.from_numpy(_data(72, r, r, 4, 8))
    u = tref.winograd_filter_transform(torch.zeros(3, 3, 4, 8))
    talg.conv2d(x, w, stride=stride, algorithm=algorithm, u=u)
    assert calls == [want]


def test_conv2d_uses_the_u_it_is_given():
    """A U that is not the filters' transform changes the result: the
    cached U, not ``w``, feeds the products."""
    x = torch.from_numpy(_data(73, 1, 6, 6, 4))
    w = torch.from_numpy(_data(74, 3, 3, 4, 8))
    u = tref.winograd_filter_transform(w)
    y = talg.conv2d(x, w, algorithm="winograd", u=u)
    assert torch.equal(y, talg.conv2d(x, w, algorithm="winograd"))
    z = talg.conv2d(x, w, algorithm="winograd", u=2 * u)
    assert torch.allclose(z, 2 * y, rtol=1e-6, atol=1e-6)


def test_kernel_params_keep_u_for_winograd_only():
    params = {"block_k": 128, "u": "U", "stride": 1, "act": "relu"}
    assert ops.kernel_params("winograd", params) == {"u": "U",
                                                     "act": "relu"}
    for algorithm in ("ilpm", "direct", "im2col", "libdnn", "pointwise",
                      "depthwise"):
        assert "u" not in ops.kernel_params(algorithm, params)


# ---- engines -----------------------------------------------------------

def _image(seed=0):
    return np.random.default_rng(seed).standard_normal((32, 32, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _reference_params(dtype="float32"):
    cfg = jprecision(jtiny(jget("resnet18")), dtype)
    params = jinit(jresnet.model_specs(cfg), 0, cfg.param_dtype)
    return cfg, params


@functools.lru_cache(maxsize=None)
def _reference_forced(dtype="float32"):
    cfg, params = _reference_params(dtype)
    logits = JEngine(cfg, params=params, algorithm="winograd").run(_image())
    return np.asarray(logits, np.float32)


def _port_params(dtype="float32"):
    _, params = _reference_params(dtype)
    return params_from_reference(jax.tree.map(np.asarray, params))


def _forced(dtype="float32"):
    return TEngine(tprecision(ttiny(tget("resnet18")), dtype),
                   params=_port_params(dtype), algorithm="winograd",
                   device="cpu")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forced_engine_matches_reference(dtype):
    engine = _forced(dtype)
    assert engine.plan is None and engine.winograd_u == {}
    assert _rel(engine.run(_image()), _reference_forced(dtype)) \
        <= tolerance(dtype)


def test_forced_dispatch_counts(monkeypatch):
    """Tiny ResNet-18's even stride-1 3x3 sites (8², 4², 2²) run Winograd;
    the stem, the strided c1s, the 1x1/2 projections and the 1² site run
    ilpm."""
    engine = _forced()
    calls = _spy(monkeypatch)
    engine.run(_image())
    names = [name for name, _ in calls]
    assert {n: names.count(n) for n in set(names)} == {"winograd": 4,
                                                       "ilpm": 8}
    assert not any(has_u for _, has_u in calls)  # no plan, no cache


def test_forced_bf16_path_multiplies_by_fp32_u(monkeypatch):
    """Without a cache U is the fp32 transform, as the reference's jnp
    promotion has it; the products still write bf16."""
    seen = []
    inner = gemm.gemm

    def spy(a, b):
        seen.append((a.dtype, b.dtype))
        return inner(a, b)
    monkeypatch.setattr(twg, "gemm", spy)
    _forced("bfloat16").run(_image())
    assert seen == [(torch.bfloat16, torch.float32)] * 4


def test_forced_run_batch_is_bitwise_equal_to_run():
    engine = _forced()
    images = np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    assert torch.equal(engine.run_batch(images),
                       torch.stack([engine.run(im) for im in images]))


def test_forced_engine_agrees_with_tuned_engine():
    engine = _forced()
    tuned = TEngine(engine.cfg, params=engine.model, device="cpu")
    assert _rel(engine.run(_image()), tuned.run(_image()).numpy()) \
        <= tolerance("float32")


# the four even stride-1 3x3 sites and one odd one (1², routed to ilpm)
PINNED = ("s0b0.c1", "s0b0.c2", "s1b0.c2", "s2b0.c2", "s3b0.c2")


def _pinned_plan(dtype="float32"):
    """The tuned tiny plan without its fused blocks, PINNED on winograd."""
    plan = TEngine(tprecision(ttiny(tget("resnet18")), dtype),
                   params=_port_params(dtype), device="cpu").plan
    plan.block_choices.clear()
    plan.block_specs.clear()
    for name in PINNED:
        ch = plan.choices[name]
        plan.choices[name] = Choice("winograd", (), ch.est_time,
                                    ch.est_bytes, ch.est_flops, ch.vmem)
    return plan


@functools.lru_cache(maxsize=None)
def _reference_pinned(plan_json, dtype="float32"):
    cfg, params = _reference_params(dtype)
    engine = JEngine(cfg, params=params, plan=JPlan.from_json(plan_json))
    return sorted(engine.winograd_u), np.asarray(engine.run(_image()),
                                                 np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pinned_plan_matches_reference(dtype, monkeypatch):
    """U is computed once per pinned site at build and never per forward;
    the cache holds the reference's keys, in the filters' dtype."""
    calls = []
    inner = tref.winograd_filter_transform

    def counting(w):
        calls.append(tuple(w.shape))
        return inner(w)
    monkeypatch.setattr(tref, "winograd_filter_transform", counting)
    plan = _pinned_plan(dtype)
    engine = TEngine(tprecision(ttiny(tget("resnet18")), dtype),
                     params=_port_params(dtype), plan=plan, device="cpu")
    assert len(calls) == len(PINNED)
    keys, ref = _reference_pinned(plan.to_json(), dtype)
    assert sorted(engine.winograd_u) == keys == sorted(PINNED)
    assert {u.dtype for u in engine.winograd_u.values()} == {
        DTYPES[dtype][0]}
    y = engine.run(_image())
    engine.run_batch(np.stack([_image(1), _image(2)]))
    assert len(calls) == len(PINNED)  # forwards reuse the cache
    assert _rel(y, ref) <= tolerance(dtype)


def test_pinned_plan_dispatches_with_the_cache(monkeypatch):
    engine = TEngine(ttiny(tget("resnet18")), params=_port_params(),
                     plan=_pinned_plan(), device="cpu")
    calls = _spy(monkeypatch)
    y = engine.run(_image())
    names = [name for name, _ in calls]
    assert {n: names.count(n) for n in set(names)} == {
        "winograd": 4, "ilpm": 5, "pointwise": 3}
    assert {c for c in calls if c[0] == "winograd"} == {("winograd", True)}
    assert torch.equal(engine.run_batch(_image()[None])[0], y)


# ---- wrappers and build ------------------------------------------------

@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wrappers_raise_on_a_device_without_a_kernel(kernel):
    args = {"winograd_input_transform":
            (torch.empty(1, 8, 6, 4, device="meta"), 6, 4),
            "winograd_output_transform":
            (torch.empty(1, 4, 4, 6, 8, device="meta"), 6, 4)}[kernel]
    with pytest.raises(ValueError, match="no kernel for meta"):
        KERNELS[kernel](*args)


def test_impl_cuda_on_cpu_tensor_raises():
    x = tref.pad_same(torch.from_numpy(_data(75, 1, 8, 8, 4)), 3, 3)
    w = torch.from_numpy(_data(76, 3, 3, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.dispatch("winograd", x, w, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gemm(torch.zeros(2, 3, 4), torch.zeros(2, 4, 5), impl="cuda")


def test_auto_on_cpu_launches_no_kernel():
    counters = [*KERNELS.values(), gemm.gemm]
    for fn in counters:
        fn.launches = 0
    xp = tref.pad_same(torch.from_numpy(_data(77, 1, 8, 6, 4)), 3, 3)
    w = torch.from_numpy(_data(78, 3, 3, 4, 8))
    assert torch.equal(ops.dispatch("winograd", xp, w),
                       tref.winograd_conv(xp, w))
    assert [fn.launches for fn in counters] == [0, 0, 0]


def test_kernels_build_from_their_own_sources():
    for name in KERNELS:
        src = (CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in src
        assert f"{name}_launch" in _build.SIGNATURES
        assert CSRC / f"{name}.cu" in _build._sources()
    gemm_src = (CSRC / "gemm.cu").read_text()
    assert "batch_b" in gemm_src and "b_fp32" in gemm_src
    # dtype, b_fp32; a, b, c; batch, batch_b, M, N, Kc, tile, split;
    # workspace, stream
    assert len(_build.SIGNATURES["gemm_launch"]) == 14
