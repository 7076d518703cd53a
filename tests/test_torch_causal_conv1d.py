"""The port's ``causal_conv1d`` (the Mamba-2 conv stem) on the CPU, where
the wrapper runs its plain version, against the JAX package's Pallas
kernel in interpret mode and its jnp reference, on the same numpy-seeded
inputs.

Bound: max|y - ref| / max|ref| <= tolerance(dtype) (2e-5 fp32, 3e-2
bf16). Both sides accumulate the K taps in fp32 and cast once.

The CUDA kernel cannot run here; chip_smoke.py holds it against this plain
version on the card, at the model's shapes and at the edge lengths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import causal_conv1d as cc
from repro_torch.kernels import ops, ref

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
