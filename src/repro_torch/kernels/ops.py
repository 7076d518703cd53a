"""Public wrappers over the kernels, with dispatch (``repro/kernels/ops.py``).

The ``impl`` policy:
  * ``"auto"`` runs the CUDA kernel for CUDA tensors and the plain
    version for CPU tensors;
  * ``"cuda"`` runs the CUDA kernel and raises for a CPU tensor;
  * ``"torch"`` runs the plain version wherever the tensors are.
A kernel that fails to build or launch raises; nothing falls back.

Every conv wrapper takes optional ``scale``/``bias`` ((K,) folded-BN
vectors) and ``act`` ('relu' | 'relu6' | None), applied in the kernel's
output write (im2col applies it as a separate pass after its GEMM).
``winograd`` also takes ``u``, the cached filter transform. The
TPU tile sizes a plan carries (``block_k``, ``block_h``, ``block_c``,
``block_m``) are not in any signature, so ``kernel_params`` drops them:
the Hopper kernels choose their own tiles. ``causal_conv1d``, the Mamba
conv stem, takes ``block_l`` and drops it for the same reason.
"""
from __future__ import annotations

import inspect

from repro_torch.kernels import causal_conv1d as _cc
from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import direct_conv as _dc
from repro_torch.kernels import fused_block as _fb
from repro_torch.kernels import gemm as _gm
from repro_torch.kernels import ilpm_conv as _il
from repro_torch.kernels import im2col_conv as _im
from repro_torch.kernels import libdnn_conv as _lib
from repro_torch.kernels import pointwise_conv as _pw
from repro_torch.kernels import ref
from repro_torch.kernels import winograd_conv as _wg

IMPLS = ("auto", "cuda", "torch")


def _use_kernel(impl: str, x) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; want one of {IMPLS}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on "
                         f"{x.device}")
    return impl != "torch"


def ilpm(x_padded, w, *, impl="auto", stride=1, scale=None, bias=None,
         act=None):
    """ILP-M dense conv on a SAME-padded NHWC image, stride 1 or 2."""
    fn = _il.ilpm_conv if _use_kernel(impl, x_padded) else ref.ilpm_conv
    return fn(x_padded, w, stride=stride, scale=scale, bias=bias, act=act)


def direct(x_padded, w, *, impl="auto", stride=1, scale=None, bias=None,
           act=None):
    """Direct conv (filter bank on chip, pixel row bands) on a SAME-padded
    NHWC image, stride 1 or 2."""
    fn = _dc.direct_conv if _use_kernel(impl, x_padded) else ref.direct_conv
    return fn(x_padded, w, stride=stride, scale=scale, bias=bias, act=act)


def im2col(x_padded, w, *, impl="auto", scale=None, bias=None, act=None):
    """Stride-1 im2col: the unroll kernel, the ``gemm`` kernel, then the
    epilogue as a separate pass."""
    fn = _im.im2col_conv if _use_kernel(impl, x_padded) \
        else ref.im2col_conv
    return fn(x_padded, w, scale=scale, bias=bias, act=act)


def libdnn(x_padded, w, *, impl="auto", scale=None, bias=None, act=None):
    """Stride-1 fused im2col: the patch tile built on chip per K tile."""
    fn = _lib.libdnn_conv if _use_kernel(impl, x_padded) \
        else ref.libdnn_conv
    return fn(x_padded, w, scale=scale, bias=bias, act=act)


def winograd(x_padded, w, *, impl="auto", u=None, scale=None, bias=None,
             act=None):
    """Winograd F(2x2,3x3), stride 1, even H and W: the input-transform
    kernel, the 16 products in one ``gemm`` launch, the output-transform
    kernel with the epilogue. ``u`` is the cached filter transform
    U = G g Gᵀ (4,4,C,K); without it U is computed per call."""
    fn = _wg.winograd_conv if _use_kernel(impl, x_padded) \
        else ref.winograd_conv
    return fn(x_padded, w, u=u, scale=scale, bias=bias, act=act)


def gemm(a, b, *, impl="auto"):
    """a (M, Kc) or (batch, M, Kc) @ b (Kc, N) or (batch_b, Kc, N), fp32
    accumulation, in ``a.dtype``."""
    fn = _gm.gemm if _use_kernel(impl, a) else ref.gemm
    return fn(a, b)


def pointwise(x, w, *, impl="auto", stride=1, scale=None, bias=None,
              act=None):
    """1x1 conv: x (B,H,W,C) *unpadded*, w (1,1,C,K) -> (B,H',W',K)."""
    fn = _pw.pointwise_conv if _use_kernel(impl, x) else ref.pointwise_conv
    return fn(x, w, stride=stride, scale=scale, bias=bias, act=act)


def depthwise(x_padded, w, *, impl="auto", stride=1, scale=None, bias=None,
              act=None):
    """Depthwise conv: x (B,Hp,Wp,C) pre-padded, w (R,S,1,M·C)
    -> (B,H,W,M·C), stride 1 or 2; output channel k reads input k // M."""
    fn = _dw.depthwise_conv if _use_kernel(impl, x_padded) \
        else ref.depthwise_conv
    return fn(x_padded, w, stride=stride, scale=scale, bias=bias, act=act)


def fused_inverted_residual(x, weights, *, impl="auto", stride=1,
                            residual=False, act="relu6", out_act=None):
    """MobileNetV2 expand -> depthwise -> project in one launch. ``x``
    (B,H,W,Cin) unpadded; ``weights``: optional ``w1``/``s1``/``b1``
    (absent for t == 1 blocks), ``wdw``/``sdw``/``bdw``, ``w2``/``s2``/
    ``b2``; ``residual`` adds ``x`` (stride 1, Cin == Cout)."""
    fn = _fb.fused_inverted_residual if _use_kernel(impl, x) \
        else ref.fused_inverted_residual
    return fn(x, weights, stride=stride, residual=residual, act=act,
              out_act=out_act)


def fused_residual_conv(x_padded, weights, *, impl="auto", res, act="relu"):
    """ResNet block tail: the stride-1 conv with the shortcut add and the
    outer activation fused into its output write."""
    fn = _fb.fused_residual_conv if _use_kernel(impl, x_padded) \
        else ref.fused_residual_conv
    return fn(x_padded, weights, res=res, act=act)


def causal_conv1d(x, w, b=None, *, impl="auto", block_l=None):
    """Depthwise causal 1-D conv (the Mamba stem): x (B, L, C), w (K, C),
    b (C,) or None -> (B, L, C). ``x`` may be a view with strided rows.
    ``block_l``, the TPU kernel's sequence tile, is accepted and
    dropped."""
    del block_l
    fn = _cc.causal_conv1d if _use_kernel(impl, x) else ref.causal_conv1d
    return fn(x, w, b)


def conv1d_dense(x, w, b=None, *, stride=1):
    """Dense 1-D conv, SAME padding (the audio stem): x (B, L, Cin), w
    (K, Cin, Cout), b (Cout,) or None. The reference computes it with an
    XLA conv, no Pallas kernel, so it has no kernel here either."""
    return ref.conv1d_dense(x, w, b, stride=stride)


ALGORITHMS = {"ilpm": ilpm, "direct": direct, "im2col": im2col,
              "libdnn": libdnn, "winograd": winograd,
              "pointwise": pointwise, "depthwise": depthwise}

BLOCK_ALGORITHMS = {"fused_inverted_residual": fused_inverted_residual,
                    "fused_residual_conv": fused_residual_conv}


def _lookup(table, algorithm):
    """Look ``algorithm`` up at call time, so tests can replace entries."""
    if algorithm in table:
        return table[algorithm]
    raise KeyError(f"unknown algorithm {algorithm!r}")


def _accepted(fn, params: dict) -> dict:
    """Keep the params ``fn``'s signature accepts; a ``**kwargs`` in the
    signature opts out and receives everything."""
    accepted = inspect.signature(fn).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in accepted.values()):
        return dict(params)
    return {k: v for k, v in params.items() if k in accepted}


def kernel_params(algorithm: str, params: dict) -> dict:
    """The params this algorithm's wrapper accepts; the rest are dropped."""
    return _accepted(_lookup(ALGORITHMS, algorithm), params)


def block_kernel_params(algorithm: str, params: dict) -> dict:
    """``kernel_params`` for the block-level table."""
    return _accepted(_lookup(BLOCK_ALGORITHMS, algorithm), params)


def dispatch(algorithm: str, x_padded, w, *, impl="auto", **params):
    """Run one conv algorithm by name with its (filtered) parameters.
    ``x_padded`` carries the algorithm's padding: pointwise takes the raw
    image, every other algorithm a SAME-padded one."""
    fn = _lookup(ALGORITHMS, algorithm)
    return fn(x_padded, w, impl=impl, **kernel_params(algorithm, params))


def dispatch_block(algorithm: str, x, weights, *, impl="auto", **params):
    """Block-level twin of ``dispatch``: one call runs one fused block."""
    fn = _lookup(BLOCK_ALGORITHMS, algorithm)
    return fn(x, weights, impl=impl,
              **block_kernel_params(algorithm, params))
