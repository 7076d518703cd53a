"""Public convolution entry point with algorithm selection
(``repro/core/algorithms.py``).

``conv2d(x, w, algorithm=...)`` routes one conv site: 'ilpm', 'direct',
'im2col' (unroll and gemm kernels, then the epilogue pass), 'libdnn',
'winograd' (input transform, gemm and output transform kernels),
'pointwise' and 'depthwise' run their CUDA kernels; 'auto' asks the
autotuner; an explicit ``choice`` (a plan's ``Choice``) pins the
algorithm. 'xla' keeps the reference's name so plan JSON stays
compatible: it is the escape hatch, ``ref.conv2d_reference`` plus
``ref.apply_epilogue``. As in the reference, strided sites forced onto
im2col/libdnn/winograd fall back to ilpm, an inapplicable winograd site
(not 3x3, or an odd output size) does too, and a grouped conv that is not
depthwise takes the escape hatch. ``u=`` carries a Winograd site's cached
filter transform and reaches the kernel only where Winograd runs.

The optional fused epilogue (``scale``/``bias``/``act``) rides into the
kernel's output write. Layouts: NHWC images, HWIO filters.
"""
from __future__ import annotations

from repro_torch.core import autotune
from repro_torch.core.convspec import ConvSpec
from repro_torch.kernels import ops, ref

# kernels that downsample in-kernel (strided tap windows / subsampling)
STRIDED_DENSE = ("ilpm", "direct")


def _auto(x, w, stride, epilogue=False):
    tuned = autotune.select(ConvSpec.from_tensors(x, w, stride),
                            epilogue=epilogue)
    return tuned.algorithm, dict(tuned.params)


def _escape_hatch(x, w, stride, padding, groups, ep):
    return ref.apply_epilogue(
        ref.conv2d_reference(x, w, stride=stride, padding=padding,
                             groups=groups), **ep)


def conv2d(x, w, *, stride=1, padding="SAME", algorithm="auto", impl="auto",
           choice=None, scale=None, bias=None, act=None, u=None):
    """x: (B,H,W,C) NHWC; w: (R,S,C/groups,K) HWIO -> (B,H',W',K)."""
    R, S, Cg, K = w.shape
    C = x.shape[-1]
    if C % Cg:
        raise ValueError(f"image channels {C} vs filter depth {Cg}")
    groups = C // Cg
    ep = dict(scale=scale, bias=bias, act=act)
    ep_on = scale is not None or bias is not None or act is not None
    if choice is not None:
        algorithm, params = choice.algorithm, dict(choice.params)
    else:
        params = {}
    if algorithm == "xla":
        return _escape_hatch(x, w, stride, padding, groups, ep)

    if groups > 1:
        if algorithm == "auto":
            algorithm, params = _auto(x, w, stride, epilogue=ep_on)
        depthwise_ok = groups == C and K % C == 0 and stride in (1, 2)
        if algorithm != "depthwise" or not depthwise_ok:
            # the tuner punted, or a grouped-but-not-depthwise conv
            return _escape_hatch(x, w, stride, padding, groups, ep)
        xp = ref.pad_same(x, R, S, stride=stride) if padding == "SAME" \
            else x
        return ops.dispatch("depthwise", xp, w, impl=impl, stride=stride,
                            **ep, **params)

    if stride != 1 and (R, S) == (stride, stride) and padding == "VALID":
        # non-overlapping patch conv (ViT patch embed): reshape + matmul
        B, H, W, _ = x.shape
        hp, wp = H // stride, W // stride
        xr = x[:, :hp * stride, :wp * stride].reshape(
            B, hp, stride, wp, stride, C).permute(0, 1, 3, 2, 4, 5)
        xr = xr.reshape(B, hp * wp, stride * stride * C)
        y = (xr.float() @ w.reshape(-1, K).float()).to(x.dtype)
        return ref.apply_epilogue(y.reshape(B, hp, wp, K), **ep)

    if algorithm == "auto":
        algorithm, params = _auto(x, w, stride, epilogue=ep_on)
        if algorithm == "xla":  # tuner punted (e.g. stride > 2)
            return _escape_hatch(x, w, stride, padding, 1, ep)

    if algorithm == "pointwise":
        if (R, S) != (1, 1):
            algorithm = "ilpm"  # pointwise kernel is 1x1-only
        else:
            return ops.dispatch("pointwise", x, w, impl=impl, stride=stride,
                                **ep, **params)

    if stride != 1 and algorithm not in STRIDED_DENSE:
        algorithm = "ilpm"  # im2col/libdnn/winograd have no strided kernels

    if padding == "SAME":
        xp = ref.pad_same(x, R, S, stride=stride)
    elif padding == "VALID":
        xp = x
    else:
        raise ValueError(padding)

    if algorithm == "winograd":
        H, W = xp.shape[1] - R + 1, xp.shape[2] - S + 1
        if (R, S) != (3, 3) or H % 2 or W % 2:
            algorithm = "ilpm"  # winograd F(2,3) inapplicable
        elif u is not None:
            params["u"] = u
    return ops.dispatch(algorithm, xp, w, impl=impl, stride=stride,
                        **ep, **params)


def block_inverted_residual(x, p, choice, *, stride=1, residual=False,
                            impl="auto"):
    """A whole MobileNetV2 inverted-residual block as one fused dispatch.
    ``p`` is the block's params, an optional ``pw1`` plus ``dw`` and
    ``pw2``, each ``{"w", "scale", "bias"}``, flattened here into the
    stage-keyed weights the block kernel takes; the activations are
    MobileNetV2's ReLU6 and linear projection."""
    weights = {"wdw": p["dw"]["w"], "sdw": p["dw"]["scale"],
               "bdw": p["dw"]["bias"],
               "w2": p["pw2"]["w"], "s2": p["pw2"]["scale"],
               "b2": p["pw2"]["bias"]}
    if "pw1" in p:
        weights.update({"w1": p["pw1"]["w"], "s1": p["pw1"]["scale"],
                        "b1": p["pw1"]["bias"]})
    return ops.dispatch_block(choice.algorithm, x, weights, impl=impl,
                              stride=stride, residual=residual, act="relu6",
                              out_act=None, **dict(choice.params))


def block_residual_conv(x, p, choice, *, res, impl="auto"):
    """A ResNet block's last conv with the shortcut add and the outer ReLU
    fused into its output write. ``p`` is the conv's ``{"w", "scale",
    "bias"}`` site, ``res`` the identity/projection branch; SAME padding
    is applied here (the fused kernel is stride 1)."""
    w = p["w"]
    xp = ref.pad_same(x, w.shape[0], w.shape[1])
    weights = {"w": w, "scale": p["scale"], "bias": p["bias"]}
    return ops.dispatch_block(choice.algorithm, xp, weights, impl=impl,
                              res=res, act="relu", **dict(choice.params))
