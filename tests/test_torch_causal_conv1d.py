"""The port's ``causal_conv1d`` (the Mamba-2 conv stem) on the CPU, where
the wrapper runs its plain version, against the JAX package's Pallas
kernel in interpret mode and its jnp reference, on the same numpy-seeded
inputs.

Bound: max|y - ref| / max|ref| <= tolerance(dtype) (2e-5 fp32, 3e-2
bf16). Both sides accumulate the K taps in fp32 and cast once.

The backward's plain version (``ref.causal_conv1d_bwd``, the backward
kernel's order) against ``jax.grad`` of the reference's
``ref.causal_conv1d`` (2e-5 in fp32), its dx bitwise the forward run on the
reversed dy, its dw and db across tiles; the launch plan as pure Python;
the source's entry points.

The CUDA kernels cannot run here; chip_smoke.py holds them against these
plain versions on the card, bitwise, at the model's shapes, the edge
lengths and a ragged class.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import causal_conv1d as cc

CSRC = Path(cc.__file__).resolve().parent.parent / "csrc"

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, B, L, C, K):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, C)).astype(np.float32),
            (rng.standard_normal((K, C)) * K ** -0.5).astype(np.float32),
            (rng.standard_normal(C) * 0.1).astype(np.float32))


def _rel(y, r):
    y = y.float().numpy()
    r = np.asarray(r, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    return float(np.abs(y - r).max() / np.abs(r).max())


def _port_and_jax(arrays, dtype):
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, dtype=jdt) for a in arrays])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("block_l", [16, 64, 512])
def test_plain_matches_pallas_kernel(block_l, K, dtype):
    (x, w, b), (jx, jw, jb) = _port_and_jax(_inputs(0, 2, 75, 24, K), dtype)
    y = ops.causal_conv1d(x, w, b, block_l=block_l)
    r = jops.causal_conv1d(jx, jw, jb, impl="pallas", block_l=block_l)
    assert y.dtype == DTYPES[dtype][0]
    assert _rel(y, r) <= tolerance(dtype)


@pytest.mark.parametrize("L", [3, 5])
def test_plain_matches_pallas_kernel_at_short_lengths(L):
    (x, w, b), (jx, jw, jb) = _port_and_jax(_inputs(1, 2, L, 24, 4),
                                            "float32")
    r = jops.causal_conv1d(jx, jw, jb, impl="pallas", block_l=16)
    assert _rel(ops.causal_conv1d(x, w, b), r) <= tolerance("float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L", [1, 2])
def test_lengths_below_the_halo_match_the_jnp_reference(L, dtype):
    # The Pallas kernel cannot run here: with K = 4 its halo slice
    # xprev[TL-(K-1):] is negative for a tile of TL < K-1 steps, and it
    # raises (L = 1: "Invalid shape for swap"; L = 2: "add got
    # incompatible shapes"). The port follows ref.causal_conv1d, which
    # takes any L.
    (x, w, b), (jx, jw, jb) = _port_and_jax(_inputs(2, 2, L, 24, 4), dtype)
    r = jops.causal_conv1d(jx, jw, jb, impl="jnp")
    assert _rel(ops.causal_conv1d(x, w, b), r) <= tolerance(dtype)


def test_no_bias_matches_the_jnp_reference():
    (x, w, _), (jx, jw, _) = _port_and_jax(_inputs(3, 2, 40, 24, 4),
                                           "float32")
    r = jops.causal_conv1d(jx, jw, None, impl="jnp")
    assert _rel(ops.causal_conv1d(x, w), r) <= tolerance("float32")


def test_output_at_t_reads_no_later_input():
    x, w, b = (torch.from_numpy(a) for a in _inputs(4, 2, 50, 24, 4))
    y = ref.causal_conv1d(x, w, b)
    t0 = 31
    x2 = x.clone()
    x2[:, t0:] = torch.randn(2, 50 - t0, 24, generator=torch.Generator()
                             .manual_seed(9))
    y2 = ref.causal_conv1d(x2, w, b)
    assert torch.equal(y[:, :t0], y2[:, :t0])
    assert not torch.equal(y[:, t0:], y2[:, t0:])
    # and the first K-1 steps see zeros before t = 0
    lead = (x[:, 0:1] * w[3] + b)
    assert torch.allclose(y[:, 0:1], lead, rtol=0, atol=1e-6)


def test_strided_view_reads_its_own_channels():
    """The xBC slice of the in-projection: a view whose rows are strided,
    whose neighbours (the z and dt parts) are not zero."""
    rng = np.random.default_rng(5)
    d_in_proj, lo, C = 70, 16, 24
    big = rng.standard_normal((2, 33, d_in_proj)).astype(np.float32)
    _, w, b = _inputs(6, 2, 33, C, 4)
    xt = torch.from_numpy(big)[..., lo:lo + C]
    assert not xt.is_contiguous() and xt.stride(1) == d_in_proj
    y = ops.causal_conv1d(xt, torch.from_numpy(w), torch.from_numpy(b))
    r = jops.causal_conv1d(jnp.asarray(big)[..., lo:lo + C], jnp.asarray(w),
                           jnp.asarray(b), impl="pallas", block_l=16)
    assert _rel(y, r) <= tolerance("float32")
    assert torch.equal(y, ref.causal_conv1d(xt.contiguous(),
                                            torch.from_numpy(w),
                                            torch.from_numpy(b)))


def test_impl_policy_and_launch_counter():
    x, w, b = (torch.from_numpy(a) for a in _inputs(7, 1, 9, 8, 4))
    before = cc.causal_conv1d.launches
    expected = ref.causal_conv1d(x, w, b)
    for impl in ("auto", "torch"):
        assert torch.equal(ops.causal_conv1d(x, w, b, impl=impl), expected)
    # a CPU tensor runs the plain version and launches nothing
    assert torch.equal(cc.causal_conv1d(x, w, b), expected)
    assert cc.causal_conv1d.launches == before
    with pytest.raises(ValueError, match="impl='cuda' needs a CUDA tensor"):
        ops.causal_conv1d(x, w, b, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.causal_conv1d(x, w, b, impl="pallas")


def test_wrapper_raises_on_a_device_without_a_kernel():
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        cc.causal_conv1d(x, torch.empty((4, 8), device="meta"))


# ---- the backward's plain version -------------------------------------------


def _bwd_inputs(seed, B, L, C, K, width=None, lo=3):
    """x as the xBC view of a wider buffer (rows ``width`` apart, a
    non-zero neighbour), w, b and dy, as numpy fp32 (the buffer whole)."""
    rng = np.random.default_rng(seed)
    width = width or C + 7
    buf = rng.standard_normal((B, L, width)).astype(np.float32)
    w = (rng.standard_normal((K, C)) * K ** -0.5).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    dy = rng.standard_normal((B, L, C)).astype(np.float32)
    return buf, w, b, dy


@functools.lru_cache(maxsize=None)
def _jax_grad(bias):
    def f(x, w, dy, *bb):
        return jnp.vdot(jref.causal_conv1d(x, w, *bb), dy)
    argnums = (0, 1, 3) if bias else (0, 1)
    return jax.jit(jax.grad(f, argnums=argnums))


@pytest.mark.parametrize("L, K, bias, tile", [
    (1, 4, True, 8),     # one step
    (2, 4, False, 8),    # L < K - 1: the halo reaches before 0
    (7, 3, True, 8),     # one tile, shorter than it
    (16, 2, False, 8),   # two whole tiles
    (37, 4, True, 8),    # several tiles, a ragged tail
    (37, 1, False, 8),   # one tap
    (29, 3, True, 4),    # the shortest tile
])
def test_plain_backward_matches_jax_grad(L, K, bias, tile):
    """dx, dw and db of ``ref.causal_conv1d_bwd`` on the strided view
    against ``jax.grad`` of the reference's ``ref.causal_conv1d``."""
    C, lo = 12, 3
    buf, w, b, dy = _bwd_inputs(L * 10 + K, 2, L, C, K, lo=lo)
    x = torch.from_numpy(buf)[..., lo:lo + C]
    assert not x.is_contiguous()
    got = ref.causal_conv1d_bwd(torch.from_numpy(dy), x, torch.from_numpy(w),
                                bias, tile)
    args = (jnp.asarray(buf[..., lo:lo + C]), jnp.asarray(w),
            jnp.asarray(dy)) + ((jnp.asarray(b),) if bias else ())
    want = _jax_grad(bias)(*args)
    assert (got[2] is None) == (not bias)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, r) <= tolerance("float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L, K", [(2, 4), (45, 4), (30, 3)])
def test_plain_backward_dx_is_the_flip_path(L, K, dtype):
    """dx bitwise the forward's plain version on the reversed dy, as the
    backward computed it before it had a kernel."""
    buf, w, _, dy = _bwd_inputs(7 + L, 2, L, 10, K)
    x = torch.from_numpy(buf)[..., 3:13].to(dtype)
    w, dy = torch.from_numpy(w).to(dtype), torch.from_numpy(dy).to(dtype)
    dx, _, _ = ref.causal_conv1d_bwd(dy, x, w, True, 8)
    flip = torch.flip(ref.causal_conv1d(torch.flip(dy, (1,)), w), (1,))
    assert dx.dtype == dtype and torch.equal(dx, flip)


def test_plain_backward_dw_db_do_not_depend_on_the_tile():
    """The tile only changes the order of dw's and db's fp32 sums."""
    buf, w, _, dy = _bwd_inputs(11, 3, 70, 16, 4)
    args = (torch.from_numpy(dy), torch.from_numpy(buf)[..., 3:19],
            torch.from_numpy(w), True)
    _, dw0, db0 = ref.causal_conv1d_bwd(*args, 4)
    for tile in (8, 16, 64, 128):
        dx, dw, db = ref.causal_conv1d_bwd(*args, tile)
        assert torch.equal(dx, ref.causal_conv1d_bwd(*args, 4)[0])
        assert _rel(dw, dw0.numpy()) <= tolerance("float32")
        assert _rel(db, db0.numpy()) <= tolerance("float32")


@pytest.mark.parametrize("needs", ["all", "x", "w"])
def test_function_runs_the_plain_backward_on_the_cpu(needs):
    """``CausalConv1d`` on CPU tensors: its backward is
    ``ref.causal_conv1d_bwd`` at the tile ``plan`` picks, bitwise, with
    None for an input that needs no gradient, and neither counter moves."""
    buf, w, b, dy = _bwd_inputs(13, 2, 41, 12, 4)
    tbuf = torch.from_numpy(buf).requires_grad_(needs in ("all", "x"))
    tw = torch.from_numpy(w).requires_grad_(needs in ("all", "w"))
    tb = torch.from_numpy(b).requires_grad_(needs == "all")
    before = (cc.causal_conv1d.launches, cc.causal_conv1d_bwd.launches)
    x = tbuf[..., 3:15]
    y = cc.CausalConv1d.apply(x, tw, tb)
    assert torch.equal(y, ref.causal_conv1d(x, tw, tb))
    wrt = [t for t in (x, tw, tb) if t.requires_grad]
    got = torch.autograd.grad(y, wrt, torch.from_numpy(dy))
    tile = cc.plan(2, 41, 12, 4, torch.float32, cc.align_bytes(x, tw),
                   backward=True).steps
    want = ref.causal_conv1d_bwd(torch.from_numpy(dy), x.detach(),
                                 tw.detach(), True, tile)
    want = [g for g, t in zip(want, (x, tw, tb)) if t.requires_grad]
    assert len(got) == len(want)
    assert all(map(torch.equal, got, want))
    assert (cc.causal_conv1d.launches,
            cc.causal_conv1d_bwd.launches) == before


def test_backward_wrapper_runs_its_plain_version_on_the_cpu():
    buf, w, _, dy = _bwd_inputs(17, 1, 9, 8, 4)
    args = (torch.from_numpy(dy), torch.from_numpy(buf)[..., 3:11],
            torch.from_numpy(w))
    tile = cc.plan(1, 9, 8, 4, torch.float32, cc.align_bytes(*args),
                   backward=True).steps
    got = cc.causal_conv1d_bwd(*args, False)
    want = ref.causal_conv1d_bwd(*args, False, tile)
    assert got[2] is None and all(map(torch.equal, got[:2], want[:2]))
    meta = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        cc.causal_conv1d_bwd(meta, meta, torch.empty((4, 8), device="meta"),
                             True)


# ---- the launch plan ----------------------------------------------------------


def _xbc_view(dtype, lo=2048, L=4):
    """mamba2-370m's xBC slice of its in-projection output: 2304 channels
    at offset ``lo`` of rows 4384 elements apart."""
    return torch.zeros((2, L, 4384), dtype=dtype)[..., lo:lo + 2304]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("backward", [False, True])
def test_plan_takes_4_channels_on_the_aligned_xbc_view(dtype, backward):
    """The view is aligned for 16 bytes; a thread takes ``MAX_VEC`` = 4
    channels (16 bytes in fp32, 8 in 16 bits: 8 bf16 channels measured
    3-12% slower at this width, ``gemm_sweep.py conv1d``), at any tap
    count."""
    x = _xbc_view(dtype)
    w = torch.zeros((4, 2304), dtype=dtype)
    align = cc.align_bytes(x, w)
    assert align == 16
    for K in (1, 4, 8):
        assert cc.plan(4, 1024, 2304, K, dtype, align,
                       backward=backward).vec == cc.MAX_VEC == 4


@pytest.mark.parametrize("case", ["odd C", "odd offset", "offset 2",
                                  "odd row stride"])
def test_plan_narrows_the_vector_where_the_operands_are_not_aligned(case):
    dtype = torch.bfloat16
    if case == "odd C":
        assert cc.plan(4, 1024, 2305, 4, dtype,
                       cc.align_bytes(_xbc_view(dtype))).vec == 1
        return
    if case == "odd row stride":
        x = torch.zeros((2, 4, 4385), dtype=dtype)[..., 2048:2048 + 2304]
        want = 1
    else:
        x = _xbc_view(dtype, lo=2049 if case == "odd offset" else 2050)
        want = 1 if case == "odd offset" else 2
    assert cc.plan(4, 1024, 2304, 4, dtype, cc.align_bytes(x)).vec == want


def test_plan_fills_the_card_at_the_fp32_serving_prefill():
    """1 x 300 x 2304 fp32: at least two blocks an SM."""
    p = cc.plan(1, 300, 2304, 4, torch.float32)
    assert p.blocks >= 2 * cc.SMS
    walkers = 2304 // p.vec * -(-300 // p.steps)
    assert p.blocks == -(-walkers // p.threads)


@pytest.mark.parametrize("shape, dtype", [
    ((4, 1024, 2304), torch.float32),     # T, fp32
    ((4, 1024, 2304), torch.bfloat16),    # S and T
    ((4, 1024, 17408), torch.bfloat16),   # J
])
def test_plan_rereads_under_5_percent_at_the_long_classes(shape, dtype):
    """The backward walks 64 steps at the long classes, so its halo
    re-reads are under 5% of its loads; the forward walks 16 (measured
    faster than 64: more threads), re-reading 3 rows of every 19."""
    B, L, C = shape
    p = cc.plan(B, L, C, 4, dtype, backward=True)
    assert p.steps == 64 and cc.halo_share(p, L, 4) < 0.05
    f = cc.plan(B, L, C, 4, dtype)
    assert f.steps == 16 and cc.halo_share(f, L, 4) < 3 / 19


@pytest.mark.parametrize("backward", [False, True])
def test_plan_walks_and_blocks_are_the_kernels(backward):
    """Walks from the plan's list, blocks of whole warps up to 128
    threads, a vector that divides C: every L and C gets a plan."""
    walks = cc.BWD_STEPS if backward else cc.STEPS
    for L in (1, 2, 3, 7, 300, 513, 1024, 4096):
        for C in (1, 12, 2304, 2310):
            for dtype in (torch.float32, torch.bfloat16):
                p = cc.plan(2, L, C, 4, dtype, backward=backward)
                assert p.steps in walks and p.threads in cc.THREADS
                assert C % p.vec == 0 and p.vec <= cc.MAX_VEC


# ---- the source ---------------------------------------------------------------


def _launch_params(name):
    src = " ".join((CSRC / "causal_conv1d.cu").read_text().split())
    args = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src)[1]
    return [a.split()[-1].lstrip("*") for a in args.split(",")]


@pytest.mark.parametrize("name", ["causal_conv1d", "causal_conv1d_bwd"])
def test_entry_points_match_their_signatures(name):
    params = _launch_params(name)
    sig = _build.SIGNATURES[f"{name}_launch"]
    assert len(params) == len(sig)
    assert params[0] == "dtype" and params[-1] == "stream"
    assert params[-4:-1] == ["vec", "steps", "threads"]


def test_backward_source_has_no_atomics():
    src = re.sub(r"//[^\n]*", "", (CSRC / "causal_conv1d.cu").read_text())
    assert "atomic" not in src
    assert "causal_conv1d_bwd_reduce" in src
