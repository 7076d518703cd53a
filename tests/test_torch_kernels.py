"""The port's kernel functions on the CPU (their plain versions) against
the JAX package's kernels: ``repro.kernels.ops.<x>(impl="pallas")`` in
interpret mode and ``impl="jnp"``, on the same numpy-seeded inputs.

Bound: max|y - ref| / max|ref| <= tolerance(dtype). The port casts the
fused epilogue's result once, as the Pallas kernels do; the jnp path casts
the conv output before its unfused epilogue, a second rounding that only
the bf16 cases see and that stays far inside the bf16 bound.

The CUDA kernels cannot run here; chip_smoke.py holds them against these
plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import algorithms as talg
from repro_torch.core.dtypes import tolerance
from repro_torch.configs import get as tget
from repro_torch.kernels import (depthwise_conv, fused_block, ilpm_conv, ops,
                                 pointwise_conv)
from repro_torch.kernels import ref as tref
from repro_torch.models import mobilenet as tmobilenet
from repro_torch.models.resnet import max_pool_same

ACTS = (None, "relu", "relu6")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
KERNELS = {"ilpm_conv": ilpm_conv.ilpm_conv,
           "pointwise_conv": pointwise_conv.pointwise_conv,
           "fused_residual_conv": fused_block.fused_residual_conv,
           "depthwise_conv": depthwise_conv.depthwise_conv,
           "fused_inverted_residual": fused_block.fused_inverted_residual}


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
    scale = _data(seed, k) * 0.2 + 1.0
    bias = _data(seed + 1, k) * 0.1
    return (torch.from_numpy(scale), torch.from_numpy(bias),
            jnp.asarray(scale), jnp.asarray(bias))


ILPM_CASES = [(stride, r, h) for stride in (1, 2) for r in (1, 3, 7)
              for h in (9, 10)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride,r,h", ILPM_CASES)
def test_ilpm_matches_reference(stride, r, h, dtype):
    act = ACTS[(stride + r + h) % 3]
    c, k = 4, 8
    x_t, x_j = _both(_data(0, 1, h, h + 1, c), dtype)
    w_t, w_j = _both(_data(1, r, r, c, k, scale=(r * r * c) ** -0.5), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(2, k)
    xp_t = tref.pad_same(x_t, r, r, stride)
    xp_j = jref.pad_same(x_j, r, r, stride)
    np.testing.assert_array_equal(xp_t.float().numpy(),
                                  np.asarray(xp_j, np.float32))
    y = ops.dispatch("ilpm", xp_t, w_t, stride=stride, scale=sc_t,
                     bias=bi_t, act=act, block_k=128)
    assert y.dtype == DTYPES[dtype][0]
    assert torch.equal(y, ilpm_conv.ilpm_conv(xp_t, w_t, stride=stride,
                                              scale=sc_t, bias=bi_t, act=act))
    for impl in ("pallas", "jnp"):
        ref = jops.ilpm(xp_j, w_j, impl=impl, stride=stride, scale=sc_j,
                        bias=bi_j, act=act)
        assert _rel(y, ref) <= tolerance(dtype), impl


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride,h", [(1, 9), (1, 10), (2, 9), (2, 10)])
def test_pointwise_matches_reference(stride, h, dtype):
    act = ACTS[(stride + h) % 3]
    c, k = 8, 16
    x_t, x_j = _both(_data(3, 1, h, h, c), dtype)
    w_t, w_j = _both(_data(4, 1, 1, c, k, scale=c ** -0.5), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(5, k)
    y = ops.dispatch("pointwise", x_t, w_t, stride=stride, scale=sc_t,
                     bias=bi_t, act=act)
    assert y.shape == (1, -(-h // stride), -(-h // stride), k)
    for impl in ("pallas", "jnp"):
        ref = jops.pointwise(x_j, w_j, impl=impl, stride=stride, scale=sc_j,
                             bias=bi_j, act=act)
        assert _rel(y, ref) <= tolerance(dtype), impl


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r,h", [(1, 9), (1, 10), (3, 9), (3, 10)])
def test_fused_residual_conv_matches_reference(r, h, dtype):
    act = ("relu", "relu6", None)[(r + h) % 3]
    c = k = 8
    x_t, x_j = _both(_data(6, 1, h, h, c), dtype)
    w_t, w_j = _both(_data(7, r, r, c, k, scale=(r * r * c) ** -0.5), dtype)
    res_t, res_j = _both(_data(8, 1, h, h, k), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(9, k)
    xp_t, xp_j = tref.pad_same(x_t, r, r), jref.pad_same(x_j, r, r)
    y = ops.dispatch_block(
        "fused_residual_conv", xp_t, {"w": w_t, "scale": sc_t, "bias": bi_t},
        res=res_t, act=act, block_k=128)
    for impl in ("pallas", "jnp"):
        ref = jops.fused_residual_conv(
            xp_j, {"w": w_j, "scale": sc_j, "bias": bi_j}, impl=impl,
            res=res_j, act=act)
        assert _rel(y, ref) <= tolerance(dtype), impl


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("stride,h", [(1, 9), (1, 10), (2, 9), (2, 10)])
def test_depthwise_matches_reference(stride, h, mult, dtype):
    c, r = 6, 3
    k = mult * c
    x_t, x_j = _both(_data(27, 1, h, h + 1, c), dtype)
    w_t, w_j = _both(_data(28, r, r, 1, k, scale=1 / r), dtype)
    sc_t, bi_t, sc_j, bi_j = _epilogue(29, k)
    xp_t = tref.pad_same(x_t, r, r, stride)
    xp_j = jref.pad_same(x_j, r, r, stride)
    y = ops.dispatch("depthwise", xp_t, w_t, stride=stride, scale=sc_t,
                     bias=bi_t, act="relu6", block_c=128)
    assert y.shape == (1, -(-h // stride), -(-(h + 1) // stride), k)
    assert torch.equal(y, depthwise_conv.depthwise_conv(
        xp_t, w_t, stride=stride, scale=sc_t, bias=bi_t, act="relu6"))
    for impl in ("pallas", "jnp"):
        ref = jops.depthwise(xp_j, w_j, impl=impl, stride=stride,
                             scale=sc_j, bias=bi_j, act="relu6")
        assert _rel(y, ref) <= tolerance(dtype), impl


def _ir_weights(seed, cin, mid, cout, dtype):
    """Inverted-residual weights for both packages, with expand and
    depthwise biases > 0: SAME padding of the expanded tensor must be an
    exact 0 after the activation, not relu6(bias)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = {"wdw": normal(3, 3, 1, mid, scale=1 / 3),
              "sdw": rng.uniform(0.5, 1.5, mid).astype(np.float32),
              "bdw": rng.uniform(0.1, 0.5, mid).astype(np.float32),
              "w2": normal(1, 1, mid, cout, scale=mid ** -0.5),
              "s2": rng.uniform(0.5, 1.5, cout).astype(np.float32),
              "b2": normal(cout, scale=0.1)}
    if mid != cin:
        arrays.update(w1=normal(1, 1, cin, mid, scale=cin ** -0.5),
                      s1=rng.uniform(0.5, 1.5, mid).astype(np.float32),
                      b1=rng.uniform(0.1, 0.5, mid).astype(np.float32))
    tdt, jdt = DTYPES[dtype]
    wt = {k: torch.from_numpy(v).to(tdt) if k[0] == "w"
          else torch.from_numpy(v) for k, v in arrays.items()}
    wj = {k: jnp.asarray(v, dtype=jdt) if k[0] == "w" else jnp.asarray(v)
          for k, v in arrays.items()}
    return wt, wj


IR_CASES = [  # (h, cin, mid, cout, stride, residual, block_m)
    (9, 8, 8, 8, 1, False, 512),    # t = 1, stride 1
    (9, 4, 24, 4, 1, True, 512),    # t = 6 with the identity add
    (10, 4, 24, 8, 2, False, 8),    # t = 6, stride 2, even H (pads 0, 1);
                                    # block_m 8 splits mid into 3 slabs
    (9, 4, 24, 8, 2, False, 512),   # t = 6, stride 2, odd H (pads 1, 1)
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,cin,mid,cout,stride,residual,block_m", IR_CASES)
def test_fused_inverted_residual_matches_reference(h, cin, mid, cout, stride,
                                                   residual, block_m, dtype):
    x_t, x_j = _both(_data(30, 1, h, h, cin), dtype)
    wt, wj = _ir_weights(31, cin, mid, cout, dtype)
    y = ops.dispatch_block("fused_inverted_residual", x_t, wt, stride=stride,
                           residual=residual, act="relu6", out_act=None,
                           block_m=block_m)
    assert y.shape == (1, -(-h // stride), -(-h // stride), cout)
    assert torch.equal(y, fused_block.fused_inverted_residual(
        x_t, wt, stride=stride, residual=residual))
    for impl in ("pallas", "jnp"):
        ref = jops.fused_inverted_residual(
            x_j, wj, impl=impl, stride=stride, block_m=block_m,
            residual=residual, act="relu6", out_act=None)
        assert _rel(y, ref) <= tolerance(dtype), impl


@pytest.mark.parametrize("name", ["mobilenet_v2", "mobilenet_v2-tiny"])
def test_inverted_residual_tiles_fit_shared_memory(name):
    from repro_torch.configs import tiny_variant
    cfg = tget("mobilenet_v2")
    if name.endswith("tiny"):
        cfg = tiny_variant(cfg)
    plans = []
    for _, b in tmobilenet.block_specs(cfg):
        for dt in (torch.float32, torch.bfloat16):
            p = fused_block.plan(b.h, b.w, b.cin, b.mid, b.cout, b.r, b.s,
                                 b.stride, b.expanded, dt)
            assert p.parts == -(-b.mid // fused_block.IR_SLAB)
            assert fused_block.ir_smem_bytes(
                p.path, torch.empty(0, dtype=dt).element_size(), p.tile,
                b.stride, b.r, b.s, b.cin, b.cout, b.expanded) \
                <= fused_block.MAX_SMEM
            plans.append(p)
    assert {p.tile for p in plans} <= set(fused_block.IR_TILES)
    if name == "mobilenet_v2":  # the 7x7 blocks split the mid width
        assert plans[-1].parts > 1 and plans[-1].tile >= 2


def test_choose_tile_respects_shared_memory():
    """The plan that replaced ``choose_tile`` sizes a CTA as the kernel
    lays it out: s6b0 (160 -> 960 -> 320, 7x7) at tile 8 in fp32 needs
    154,880 bytes, inside the limit; a 480-channel input is not, and the
    plan picks a smaller tile that fits; no tile fits a 16000-channel
    input."""
    assert fused_block.ir_smem_bytes("fp32", 4, 8, 1, 3, 3, 160, 320,
                                     True) == 154880
    assert fused_block.ir_smem_bytes("fp32", 4, 8, 1, 3, 3, 480, 320,
                                     True) > fused_block.MAX_SMEM
    p = fused_block.plan(64, 64, 480, 960, 320, 3, 3, 1, True, torch.float32)
    assert p.tile < 8
    assert fused_block.ir_smem_bytes("fp32", 4, p.tile, 1, 3, 3, 480, 320,
                                     True) <= fused_block.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        fused_block.plan(8, 8, 16000, 32, 16, 3, 3, 1, True, torch.float32)


@pytest.mark.parametrize("h,r,stride,pads", [
    (32, 7, 2, (2, 3)),   # the tiny stem
    (224, 7, 2, (2, 3)),  # the full stem
    (16, 3, 2, (0, 1)),   # the tiny max-pool
    (15, 3, 2, (1, 1)),
    (9, 3, 1, (1, 1)),
])
def test_pad_same_splits_low_first(h, r, stride, pads):
    x_t, x_j = _both(_data(10, 1, h, h, 2), "float32")
    xp_t = tref.pad_same(x_t, r, r, stride)
    np.testing.assert_array_equal(xp_t.numpy(),
                                  np.asarray(jref.pad_same(x_j, r, r, stride)))
    lo, hi = pads
    assert xp_t.shape[1] == h + lo + hi
    assert torch.equal(xp_t[:, lo:lo + h, lo:lo + h], x_t)


@pytest.mark.parametrize("h", [16, 15, 112])
def test_max_pool_same_matches_reference(h):
    x_t, x_j = _both(_data(11, 1, h, h, 3), "float32")
    ref = jax.lax.reduce_window(x_j, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                (1, 2, 2, 1), "SAME")
    np.testing.assert_array_equal(max_pool_same(x_t).numpy(),
                                  np.asarray(ref))


def test_conv2d_escape_hatch_matches_reference():
    x_t, x_j = _both(_data(12, 1, 10, 10, 4), "float32")
    w_t, w_j = _both(_data(13, 3, 3, 4, 8, scale=0.2), "float32")
    sc_t, bi_t, sc_j, bi_j = _epilogue(14, 8)
    for stride in (1, 2, 3):
        y = talg.conv2d(x_t, w_t, stride=stride, algorithm="xla",
                        scale=sc_t, bias=bi_t, act="relu")
        ref = jalg.conv2d(x_j, w_j, stride=stride, algorithm="xla",
                          scale=sc_j, bias=bi_j, act="relu")
        assert _rel(y, ref) <= tolerance("float32")
        tuned = talg.conv2d(x_t, w_t, stride=stride, scale=sc_t,
                            bias=bi_t, act="relu")  # stride 3: tuner punts
        assert _rel(tuned, ref) <= tolerance("float32")


def test_conv2d_patch_embed_matches_reference():
    x_t, x_j = _both(_data(15, 1, 8, 8, 3), "float32")
    w_t, w_j = _both(_data(16, 4, 4, 3, 8), "float32")
    y = talg.conv2d(x_t, w_t, stride=4, padding="VALID")
    ref = jalg.conv2d(x_j, w_j, stride=4, padding="VALID")
    assert _rel(y, ref) <= tolerance("float32")


@pytest.mark.parametrize("algorithm,stride,h", [
    ("im2col", 2, 8), ("libdnn", 2, 8), ("winograd", 2, 8),
    ("winograd", 1, 9), ("pointwise", 1, 8)])
def test_conv2d_falls_back_to_ilpm(algorithm, stride, h):
    x = torch.from_numpy(_data(17, 1, h, h, 4))
    w = torch.from_numpy(_data(18, 3, 3, 4, 8))
    y = talg.conv2d(x, w, stride=stride, algorithm=algorithm)
    assert torch.equal(y, talg.conv2d(x, w, stride=stride,
                                      algorithm="ilpm"))


@pytest.mark.parametrize("algorithm", ["nope", "Winograd"])
def test_unknown_algorithm_raises_key_error(algorithm):
    x = torch.from_numpy(_data(19, 1, 8, 8, 4))
    w = torch.from_numpy(_data(20, 3, 3, 4, 8))
    with pytest.raises(KeyError, match="unknown algorithm"):
        talg.conv2d(x, w, algorithm=algorithm)
    with pytest.raises(KeyError, match="unknown algorithm"):
        ops.kernel_params(algorithm, {})


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_auto_routes_depthwise_site_to_depthwise(stride,
                                                        monkeypatch):
    x_t, x_j = _both(_data(21, 1, 8, 8, 4), "float32")
    w_t, w_j = _both(_data(22, 3, 3, 1, 4), "float32")
    sc_t, bi_t, sc_j, bi_j = _epilogue(34, 4)
    seen = []
    real = ops.ALGORITHMS["depthwise"]

    def spy(x, w, **kw):
        seen.append(sorted(kw))
        return real(x, w, **{k: v for k, v in kw.items() if k != "block_c"})
    monkeypatch.setitem(ops.ALGORITHMS, "depthwise", spy)
    y = talg.conv2d(x_t, w_t, stride=stride, algorithm="auto", scale=sc_t,
                    bias=bi_t, act="relu6")
    assert seen == [["act", "bias", "block_c", "impl", "scale", "stride"]]
    ref = jalg.conv2d(x_j, w_j, stride=stride, algorithm="xla", scale=sc_j,
                      bias=bi_j, act="relu6")
    assert _rel(y, ref) <= tolerance("float32")


def test_grouped_conv_that_is_not_depthwise_takes_the_escape_hatch(
        monkeypatch):
    x = torch.from_numpy(_data(35, 1, 8, 8, 8))
    w = torch.from_numpy(_data(36, 3, 3, 4, 8, scale=0.2))  # 2 groups
    monkeypatch.setitem(ops.ALGORITHMS, "depthwise", None)  # never reached
    for algorithm in ("auto", "depthwise", "ilpm"):
        y = talg.conv2d(x, w, algorithm=algorithm)
        assert torch.equal(y, tref.conv2d_reference(x, w, groups=2))
    with pytest.raises(KeyError):
        ops.dispatch("no_such_algorithm", x, w)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wrappers_raise_on_a_device_without_a_kernel(kernel):
    """A wrapper runs its plain version only for a CPU tensor; any other
    device without its CUDA kernel raises instead of falling back."""
    x = torch.empty(1, 8, 8, 4, device="meta")
    w = torch.empty(3, 3, 4, 4, device="meta")
    args = {"ilpm_conv": (x, w), "pointwise_conv": (x, w),
            "depthwise_conv": (x, w),
            "fused_residual_conv": (x, {"w": w}),
            "fused_inverted_residual": (x, {"wdw": w, "w2": w})}[kernel]
    kw = {"res": x} if kernel == "fused_residual_conv" else {}
    with pytest.raises(ValueError, match="no kernel for meta"):
        KERNELS[kernel](*args, **kw)


def test_impl_cuda_on_cpu_tensor_raises():
    x = torch.from_numpy(_data(23, 1, 8, 8, 4))
    w = torch.from_numpy(_data(24, 3, 3, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.dispatch("ilpm", tref.pad_same(x, 3, 3), w, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.dispatch("ilpm", tref.pad_same(x, 3, 3), w, impl="pallas")


def test_auto_on_cpu_launches_no_kernel():
    for fn in KERNELS.values():
        fn.launches = 0
    x = torch.from_numpy(_data(25, 1, 8, 8, 4))
    w = torch.from_numpy(_data(26, 3, 3, 4, 4))
    xp = tref.pad_same(x, 3, 3)
    a = ops.dispatch("ilpm", xp, w)
    b = ops.dispatch("pointwise", x, w[1:2, 1:2].contiguous(), stride=2)
    c = ops.dispatch_block("fused_residual_conv", xp, {"w": w}, res=x)
    wdw = w[:, :, :1].contiguous()
    d = ops.dispatch("depthwise", xp, wdw, stride=2)
    ir = {"wdw": wdw, "w2": w[1:2, 1:2].contiguous()}
    e = ops.dispatch_block("fused_inverted_residual", x, ir, residual=True)
    assert torch.equal(a, tref.ilpm_conv(xp, w))
    assert torch.equal(b, tref.pointwise_conv(x, w[1:2, 1:2], stride=2))
    assert torch.equal(c, tref.fused_residual_conv(xp, {"w": w}, res=x))
    assert torch.equal(d, tref.depthwise_conv(xp, wdw, stride=2))
    assert torch.equal(e, tref.fused_inverted_residual(x, ir, residual=True))
    assert {name: fn.launches for name, fn in KERNELS.items()} == {
        name: 0 for name in KERNELS}


def test_kernel_params_filter_and_kwargs_opt_out(monkeypatch):
    params = {"block_k": 128, "block_c": 64, "block_m": 96, "stride": 2,
              "act": "relu", "u": None}
    assert ops.kernel_params("ilpm", params) == {"stride": 2, "act": "relu"}
    assert ops.kernel_params("depthwise", params) == {"stride": 2,
                                                      "act": "relu"}
    assert ops.block_kernel_params("fused_residual_conv", params) == {
        "act": "relu"}
    assert ops.block_kernel_params("fused_inverted_residual", params) == {
        "stride": 2, "act": "relu"}
    seen = {}

    def spy(x, w, *, impl="auto", **kw):
        seen.update(kw)
        return x

    monkeypatch.setitem(ops.ALGORITHMS, "ilpm", spy)
    ops.dispatch("ilpm", torch.zeros(1), None, **params)
    assert seen == params
