"""The Winograd output transform's Hopper kernel on the CPU: its plain
version against the JAX package's Pallas kernel, its launch plan, a Python
mirror of its launch, and its source.

- **Reference.** ``ref.winograd_output_transform`` equals the Pallas
  ``winograd_output_transform`` (interpret mode) bitwise in fp32, bf16 and
  fp16, with no epilogue, with a scale and a bias (together and alone) and
  with relu and relu6, at H != W and a ragged K. The Pallas epilogue
  ``y * scale + bias`` compiles to one fused multiply-add, so it rounds
  once; the plain version rounds once too (``ref.fma_f32``: an exact
  product in fp64, a sum rounded to odd, one cast), as the CUDA kernel's
  ``fmaf`` does. A plain version that rounded the product and then the sum
  differs from the Pallas kernel in fp32 at these inputs.
- **Plan.** ``winograd_conv.plan`` is a function of shape and dtype alone
  (one image and four plan alike; ``_plan`` takes no number of images),
  picks one of its ``options``, and meets ``MIN_CTAS`` CTAs an image
  wherever an option of ``MIN_THREADS`` threads a CTA can, with the widest
  unit that does, at ResNet-18's three
  Winograd classes and chip_smoke.py's ragged one (10x14, K = 10: 40- and
  20-byte channel runs), in fp32, bf16 and fp16.
- **Mirror.** ``output_mirror`` walks the CTAs of
  ``csrc/winograd_output_transform.cu`` as the kernel does: the unit (the
  plan's, or a narrower one where an address does not allow it, which
  loops over the group), each CTA's tile block, channel group and image,
  each thread's tile and channel unit, its 16 loads and 4 stores at their
  offsets in units, Aᵀ m A in fp32 rows then columns, the epilogue rounded
  once and one cast. It writes every output exactly once and equals the
  plain version bitwise at every option, for one and two images.
- **Source.** No grid-stride loop (``gridDim``) and no 64-bit division;
  no shared memory; one ``fmaf`` an output; the launcher's trailing
  parameters are the plan's fields, in the source and in
  ``_build.SIGNATURES``.

The CUDA kernel cannot run here; chip_smoke.py holds it against the plain
version on the card, bitwise, at every class in fp32, bf16 and fp16 and at
the ragged class in fp32 and bf16.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import winograd_conv as jwg
from repro_torch.kernels import _build, winograd_conv
from repro_torch.kernels import ref as tref

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# (H, W, K): ResNet-18's three even 3x3/1 layers and chip_smoke.py's ragged
# class
CLASSES = [(56, 56, 64), (28, 28, 128), (14, 14, 256), (10, 14, 10)]
# (H, W, K, epilogue, act) against the Pallas kernel: H != W both ways, a
# ragged K, every epilogue operand and activation
PALLAS_CASES = [(6, 10, 12, "none", None), (6, 10, 12, "both", None),
                (8, 4, 10, "both", "relu"), (4, 6, 33, "both", "relu6"),
                (6, 4, 12, "scale", "relu"), (4, 8, 10, "bias", None)]
# small shapes for the mirror: (H, W, K)
MIRROR_SMALL = [(6, 10, 12), (4, 6, 10), (8, 4, 64), (2, 2, 5),
                (10, 14, 10)]


def _data(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(seed, b, h, w, k, dtype):
    """M ~ 3·N(0, 1) in ``dtype`` (torch and jnp), fp32 scale U(0.5, 1.5)
    and bias 0.1·N(0, 1)."""
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((b, 4, 4, (h // 2) * (w // 2), k)) * 3).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    bias = (rng.standard_normal(k) * 0.1).astype(np.float32)
    t, j = DTYPES[dtype]
    return (torch.from_numpy(m).to(t), jnp.asarray(m).astype(j),
            torch.from_numpy(scale), torch.from_numpy(bias))


# ---- the plain version against the Pallas kernel ----------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,K,epilogue,act", PALLAS_CASES)
def test_plain_output_transform_is_bitwise_the_pallas_kernel(
        H, W, K, epilogue, act, dtype):
    m_t, m_j, sc, bi = _inputs(80, 2, H, W, K, dtype)
    sc = sc if epilogue in ("both", "scale") else None
    bi = bi if epilogue in ("both", "bias") else None
    y = tref.winograd_output_transform(m_t, H, W, scale=sc, bias=bi, act=act)
    assert y.dtype == m_t.dtype and y.shape == (2, H, W, K)
    ref = jwg.winograd_output_transform(
        m_j, H=H, W=W, scale=None if sc is None else jnp.asarray(sc.numpy()),
        bias=None if bi is None else jnp.asarray(bi.numpy()), act=act,
        interpret=True)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_two_roundings_are_not_the_pallas_kernel():
    """The fault the one-rounding epilogue repairs: ``y*scale`` rounded to
    fp32 and then ``+ bias`` rounded again differs from the Pallas kernel
    in fp32 at these inputs."""
    H, W, K = 6, 10, 12
    m_t, m_j, sc, bi = _inputs(80, 2, H, W, K, "float32")
    y = tref.winograd_output_transform(m_t, H, W)
    twice = y * sc + bi
    ref = np.asarray(jwg.winograd_output_transform(
        m_j, H=H, W=W, scale=jnp.asarray(sc.numpy()),
        bias=jnp.asarray(bi.numpy()), interpret=True))
    assert (twice.numpy() != ref).any()
    once = tref.winograd_output_transform(m_t, H, W, scale=sc, bias=bi)
    np.testing.assert_array_equal(once.numpy(), ref)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fma_rounds_once_where_an_fp64_sum_would_round_twice(sign):
    """(1 + 2^-12)² = 1 + 2^-11 + 2^-24 lies exactly halfway between two
    fp32 values; a bias of ±2^-80 decides the rounding. An fp64 sum loses
    the bias and a cast then ties to even; the sum rounded to odd keeps
    its sign: the result is the neighbour on the bias's side."""
    y = torch.tensor([1 + 2.0 ** -12], dtype=torch.float32)
    bias = torch.tensor([sign * 2.0 ** -80], dtype=torch.float32)
    lo = torch.tensor([1 + 2.0 ** -11], dtype=torch.float32)
    hi = torch.nextafter(lo, torch.tensor([2.0]))
    got = tref.fma_f32(y, y, bias)
    assert torch.equal(got, hi if sign > 0 else lo)
    # the fp64 sum and cast ties to the even neighbour, lo, either way
    assert torch.equal((y.double() * y.double() + bias.double()).float(),
                       lo)


def test_fma_is_exact_where_nothing_rounds():
    y = torch.tensor([1.5, -2.0, 0.0, 3.0])
    assert torch.equal(tref.fma_f32(y, torch.ones(4), torch.zeros(4)), y)
    assert torch.equal(tref.fma_f32(y, torch.full((4,), 2.0),
                                    torch.full((4,), 0.25)),
                       torch.tensor([3.25, -3.75, 0.25, 6.25]))


def test_no_epilogue_keeps_the_transform_as_it_is():
    m, _, _, _ = _inputs(81, 1, 6, 10, 12, "float32")
    y = tref.winograd_output_transform(m, 6, 10)
    ones = tref.winograd_output_transform(m, 6, 10, scale=torch.ones(12),
                                          bias=torch.zeros(12))
    assert torch.equal(y, ones)


# ---- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,K", CLASSES)
def test_plan_is_batch_blind_an_option_and_fills_the_card(H, W, K, dtype):
    t = DTYPES[dtype][0]
    nt = (H // 2) * (W // 2)
    plans = {winograd_conv.plan(torch.empty(b, 4, 4, nt, K, dtype=t), H, W)
             for b in (1, 4)}
    assert len(plans) == 1
    p = plans.pop()
    opts = winograd_conv.options(H, W, K, t)
    assert p in opts
    size = torch.empty(0, dtype=t).element_size()
    assert p.unit >= size and K * size % p.unit == 0
    assert K % p.channels == 0
    assert winograd_conv.threads(p, t) <= winograd_conv.MAX_THREADS
    big = [o for o in opts
           if winograd_conv.threads(o, t) >= winograd_conv.MIN_THREADS]
    if big:
        assert winograd_conv.threads(p, t) >= winograd_conv.MIN_THREADS
    least = min(winograd_conv.MIN_CTAS,
                max(winograd_conv.ctas(o, H, W, K) for o in big or opts))
    assert winograd_conv.ctas(p, H, W, K) >= least
    # no option that fills the card as well has a wider unit
    assert all(o.unit <= p.unit for o in big or opts
               if winograd_conv.ctas(o, H, W, K) >= least)


def test_plan_takes_no_number_of_images():
    assert winograd_conv._plan.__wrapped__.__code__.co_varnames[:4] == (
        "h", "w", "k", "dtype")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_k_takes_no_16_byte_unit(dtype):
    t = DTYPES[dtype][0]
    assert {o.unit for o in winograd_conv.options(10, 14, 10, t)} == (
        {8, 4} if t == torch.float32 else {4, 2})


# ---- a mirror of the kernel's launch ---------------------------------------

def output_mirror(m, H, W, p, scale=None, bias=None, act=None, unit=None):
    """The output of ``csrc/winograd_output_transform.cu`` under plan
    ``p`` (with ``unit`` the launch's unit where an address narrows it
    below the plan's), CTA by CTA and thread by thread, in units, and how
    often each output unit was written."""
    B, K = m.shape[0], m.shape[-1]
    size = m.element_size()
    u = unit or p.unit
    n = u // size  # elements a unit
    tw, nt = W // 2, (H // 2) * (W // 2)
    Ku, cg = K // n, p.channels * size // u
    bx = min(p.channels * size // p.unit, winograd_conv.MAX_THREADS)
    plane = nt * Ku
    mu = m.reshape(-1, n).float()
    sc = torch.ones(K) if scale is None else scale.float()
    bi = torch.zeros(K) if bias is None else bias.float()
    out = torch.full((B * H * W * Ku, n), float("nan"), dtype=m.dtype)
    written = torch.zeros(out.shape[0], dtype=torch.int64)
    for bz in range(B):  # blockIdx.z: the image
        for by in range(K // p.channels):  # blockIdx.y: the channel group
            for bxi in range(-(-nt // p.tiles)):  # blockIdx.x: tile block
                for ty in range(p.tiles):  # threadIdx.y: the tile
                    t = bxi * p.tiles + ty
                    if t >= nt:
                        continue
                    mb = bz * 16 * plane + t * Ku
                    i, j = t // tw, t - (t // tw) * tw
                    yb = bz * H * W * Ku + (2 * i * W + 2 * j) * Ku
                    # threadIdx.x: its channel units, blockDim.x apart
                    c = torch.cat([torch.arange(by * cg + tx, (by + 1) * cg,
                                                bx) for tx in range(bx)])
                    mv = [[mu[mb + (x * 4 + e) * plane + c] for e in range(4)]
                          for x in range(4)]
                    k = (c[:, None] * n + torch.arange(n)).reshape(-1)
                    s_k, b_k = sc[k].reshape(-1, n), bi[k].reshape(-1, n)
                    for a in range(2):
                        r = [mv[0][e] + mv[1][e] + mv[2][e] if a == 0
                             else mv[1][e] - mv[2][e] - mv[3][e]
                             for e in range(4)]
                        for e, o in enumerate((r[0] + r[1] + r[2],
                                               r[1] - r[2] - r[3])):
                            if scale is not None or bias is not None:
                                o = tref.fma_f32(o, s_k, b_k)
                            at = yb + (a * W + e) * Ku + c
                            out[at] = tref.apply_act(o, act).to(m.dtype)
                            written.index_add_(0, at, torch.ones_like(at))
    return out.reshape(B, H, W, K), written


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W,K", MIRROR_SMALL)
def test_mirror_is_the_plain_version_at_every_option(H, W, K, dtype):
    t = DTYPES[dtype][0]
    opts = winograd_conv.options(H, W, K, t)
    for b in (1, 2):
        m, _, sc, bi = _inputs(82 + b, b, H, W, K, dtype)
        assert winograd_conv.plan(m, H, W) in opts
        plain = tref.winograd_output_transform(m, H, W, scale=sc, bias=bi,
                                               act="relu6")
        for p in opts:
            y, written = output_mirror(m, H, W, p, sc, bi, "relu6")
            assert written.eq(1).all(), p
            assert torch.equal(y, plain), p


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mirror_with_a_narrowed_unit_loops_over_the_group(dtype):
    """An address that is not a multiple of the plan's unit narrows it to
    the element: the CTA keeps the plan's threads and each loops over the
    group's units; every output is still written once, bitwise."""
    t = DTYPES[dtype][0]
    H, W, K = 6, 10, 64
    m, _, sc, bi = _inputs(85, 2, H, W, K, dtype)
    size = m.element_size()
    plain = tref.winograd_output_transform(m, H, W, scale=sc, bias=bi)
    wide = [o for o in winograd_conv.options(H, W, K, t) if o.unit == 16]
    assert wide
    for p in wide:
        y, written = output_mirror(m, H, W, p, sc, bi, unit=size)
        assert written.eq(1).all(), p
        assert torch.equal(y, plain), p


def test_wrapper_runs_the_plain_version_on_the_cpu():
    m, _, sc, bi = _inputs(86, 2, 6, 10, 12, "bfloat16")
    winograd_conv.winograd_output_transform.launches = 0
    y = winograd_conv.winograd_output_transform(m, 6, 10, scale=sc, bias=bi,
                                                act="relu")
    assert torch.equal(y, tref.winograd_output_transform(
        m, 6, 10, scale=sc, bias=bi, act="relu"))
    assert winograd_conv.winograd_output_transform.launches == 0


# ---- the source ---------------------------------------------------------------

def _launch_params(name):
    """The parameter names of ``extern "C" int <name>_launch(...)``."""
    src = " ".join((CSRC / f"{name}.cu").read_text().split())
    args = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src)[1]
    return [a.split()[-1].lstrip("*") for a in args.split(",")]


def test_launcher_takes_the_plan():
    params = _launch_params("winograd_output_transform")
    fields = winograd_conv.OutputTransformPlan._fields
    assert params[-1] == "stream"
    assert tuple(params[-1 - len(fields):-1]) == fields
    assert params[:-1 - len(fields)] == ["dtype", "m", "scale", "bias", "y",
                                         "B", "H", "W", "K", "act"]
    _I, _P = _build.SIGNATURES["gemm_launch"][0], _build.SIGNATURES[
        "gemm_launch"][3]
    assert _build.SIGNATURES["winograd_output_transform_launch"] == \
        [_I] + [_P] * 4 + [_I] * (5 + len(fields)) + [_P]
    assert len(params) == len(
        _build.SIGNATURES["winograd_output_transform_launch"])


def test_source_has_no_grid_stride_loop_no_64_bit_division_no_smem():
    src = (CSRC / "winograd_output_transform.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "gridDim" not in code
    assert "__shared__" not in code
    # 64-bit values are only casts: the image's base offset (size_t,
    # multiplied) and the launcher's size checks; no 64-bit variable, and
    # no cast's term is divided
    assert not re.search(r"long long(?!\))", code)
    assert not re.search(r"(long long|size_t)\)[^;|&,<>=]*[/%]", code)
    assert code.count("fmaf(") == 2  # the two outputs of a row, once each
    for unit in ("uint4", "uint2", "uint32_t", "uint16_t"):
        assert f"f({unit}{{}})" in code
