"""Plain PyTorch versions of the kernels (``repro/kernels/ref.py``).

``conv2d_reference`` is the ground truth and the escape hatch; the
structural references mirror each kernel's arithmetic: fp32 accumulation
(over an R×S tap loop, or one product against the patch matrix), the
epilogue ``acc*scale + bias`` then the activation on the fp32 accumulator,
and one cast on the write, as the kernels' output writes do (the JAX
package's ``ops.<algo>(impl='jnp')`` casts the conv output before its
unfused epilogue, which differs only in the low-precision dtypes). im2col
is the exception by its own contract: its GEMM writes the compute dtype
and the epilogue is a separate pass, so it rounds twice; Winograd writes
its transformed input and its 16 products in the compute dtype, as the
Pallas composition does, and its output transform rounds the epilogue's
multiply-add once (``fma_f32``), as the Pallas kernel's compiles. They
are what a CPU tensor runs and what the CUDA kernels are held against on
the card.

Layouts: activations NHWC, filters HWIO (R, S, C, K); the causal 1-D
conv of the Mamba stem takes (B, L, C) and (K, C), the dense 1-D conv of
the audio stem (B, L, Cin) and (K, Cin, Cout).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def pad_same(x, r, s, stride=1, value=0.0):
    """Explicit SAME padding of an NHWC tensor, split low first: the total
    pad ``(out-1)*stride + r - h`` gives its smaller half to the top/left,
    as XLA does (torch's symmetric ``padding=`` would shift the windows by
    one pixel at stride 2 and even H)."""
    h, w = x.shape[1], x.shape[2]
    ph = max((-(-h // stride) - 1) * stride + r - h, 0)
    pw = max((-(-w // stride) - 1) * stride + s - w, 0)
    return F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                 value=value)


def conv2d_reference(x, w, *, stride=1, padding="SAME", groups=1):
    """Ground truth. x: (B,H,W,C), w: (R,S,C/groups,K) -> (B,H',W',K),
    computed in fp32 and cast to ``x.dtype``. On the card an fp32 result
    is IEEE fp32 only with ``torch.backends.cudnn.allow_tf32 = False``."""
    R, S = w.shape[0], w.shape[1]
    if padding == "SAME":
        x = pad_same(x, R, S, stride)
    elif padding != "VALID":
        raise ValueError(padding)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def apply_act(y, act):
    """Apply a named activation ('relu' | 'relu6' | None)."""
    if act is None:
        return y
    if act == "relu":
        return torch.clamp_min(y, 0)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    raise ValueError(f"unknown activation {act!r}")


def apply_epilogue(y, scale=None, bias=None, act=None):
    """Unfused epilogue: y*scale + bias, then the activation, in fp32,
    cast once back to ``y.dtype``."""
    if scale is None and bias is None and act is None:
        return y
    return _epilogue(y.float(), scale, bias, act).to(y.dtype)


def _epilogue(acc, scale, bias, act):
    """The kernels' epilogue on an fp32 accumulator (stays fp32)."""
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    return apply_act(acc, act)


def _tap_loop(x_padded, w, stride):
    """fp32 accumulator of the R×S tap loop: one (pixels, C) @ (C, K)
    product per tap over a strided window of the padded image."""
    R, S, _, K = w.shape
    B, Hp, Wp, _ = x_padded.shape
    H = (Hp - R) // stride + 1
    W = (Wp - S) // stride + 1
    xf, wf = x_padded.float(), w.float()
    acc = torch.zeros((B, H, W, K), dtype=torch.float32,
                      device=x_padded.device)
    for r in range(R):
        for s in range(S):
            xs = xf[:, r:r + (H - 1) * stride + 1:stride,
                    s:s + (W - 1) * stride + 1:stride, :]
            acc += xs @ wf[r, s]
    return acc


def ilpm_conv(x_padded, w, *, stride=1, scale=None, bias=None, act=None):
    """x_padded: (B, (H-1)*stride+R, (W-1)*stride+S, C); w: (R,S,C,K)
    -> (B,H,W,K), with the fused epilogue."""
    acc = _tap_loop(x_padded, w, stride)
    return _epilogue(acc, scale, bias, act).to(x_padded.dtype)


def _patches(x_padded, r, s, stride=1):
    """(B, H, W, R*S*C): each output pixel's receptive field, columns
    ordered ``(r*S + s)*C + c`` to match ``w.reshape(R*S*C, K)``."""
    Hp, Wp = x_padded.shape[1], x_padded.shape[2]
    H = (Hp - r) // stride + 1
    W = (Wp - s) // stride + 1
    return torch.cat([x_padded[:, i:i + (H - 1) * stride + 1:stride,
                               j:j + (W - 1) * stride + 1:stride, :]
                      for i in range(r) for j in range(s)], dim=-1)


def _patch_product(x_padded, w, stride):
    """fp32 (B, H, W, K): the patches against the flattened filter bank."""
    R, S, C, K = w.shape
    return (_patches(x_padded, R, S, stride).float()
            @ w.reshape(R * S * C, K).float())


def direct_conv(x_padded, w, *, stride=1, scale=None, bias=None, act=None):
    """Direct conv: every output pixel against the whole filter bank,
    stride 1 or 2; x_padded (B, (H-1)*stride+R, (W-1)*stride+S, C), w
    (R,S,C,K) -> (B,H,W,K) with the fused epilogue, one cast."""
    acc = _patch_product(x_padded, w, stride)
    return _epilogue(acc, scale, bias, act).to(x_padded.dtype)


def im2col_unroll(x_padded, r, s):
    """The patch matrix (B, H*W, R*S*C) of a stride-1 conv, in
    ``x_padded.dtype`` (a copy: no arithmetic)."""
    p = _patches(x_padded, r, s)
    return p.reshape(p.shape[0], -1, p.shape[-1])


def gemm(a, b):
    """a (..., M, Kc) @ b (Kc, N), accumulated in fp32, cast to
    ``a.dtype``. A batched ``b`` (batch_b, Kc, N) pairs with a
    (batch, M, Kc) whose element z reads ``b[z % batch_b]``; ``b`` may be
    fp32 under a low-precision ``a``."""
    if b.dim() == 3:
        batch, M, Kc = a.shape
        out = a.float().reshape(-1, b.shape[0], M, Kc) @ b.float()
        return out.reshape(batch, M, -1).to(a.dtype)
    return (a.float() @ b.float()).to(a.dtype)


def im2col_conv(x_padded, w, *, scale=None, bias=None, act=None):
    """Stride-1 im2col: unroll, then ``gemm`` (cast to the compute dtype),
    then ``apply_epilogue`` as a separate pass (a second cast)."""
    R, S, C, K = w.shape
    B, Hp, Wp, _ = x_padded.shape
    out = gemm(im2col_unroll(x_padded, R, S), w.reshape(R * S * C, K))
    return apply_epilogue(out.reshape(B, Hp - R + 1, Wp - S + 1, K), scale,
                          bias, act)


def libdnn_conv(x_padded, w, *, scale=None, bias=None, act=None):
    """Stride-1 fused im2col: the patches contracted at once, with the
    fused epilogue and one cast."""
    acc = _patch_product(x_padded, w, 1)
    return _epilogue(acc, scale, bias, act).to(x_padded.dtype)


# Winograd F(2x2, 3x3): V = Bᵀ d B over stride-2 4x4 windows, 16 products
# M = V U against U = G g Gᵀ, Y = Aᵀ M A scattered as 2x2 output tiles.

_BT = torch.tensor([[1, 0, -1, 0],
                    [0, 1, 1, 0],
                    [0, -1, 1, 0],
                    [0, 1, 0, -1]], dtype=torch.float32)
_G = torch.tensor([[1, 0, 0],
                   [0.5, 0.5, 0.5],
                   [0.5, -0.5, 0.5],
                   [0, 0, 1]], dtype=torch.float32)
_AT = torch.tensor([[1, 1, 1, 0],
                    [0, 1, -1, -1]], dtype=torch.float32)


def _bt_combine(d0, d1, d2, d3):
    """One axis of Bᵀ d B: add/sub only, in this order."""
    return [d0 - d2, d1 + d2, d2 - d1, d1 - d3]


def _at_combine(m0, m1, m2, m3):
    """One axis of Aᵀ m A: add/sub only, left to right."""
    return [m0 + m1 + m2, m1 - m2 - m3]


@functools.lru_cache(maxsize=None)
def _g_on(device):
    return _G.to(device)


def winograd_filter_transform(w):
    """(3,3,C,K) -> U (4,4,C,K), computed in fp32 and returned in fp32
    (the JAX package's einsum against fp32 G promotes a bf16 ``w``)."""
    g = _g_on(w.device)
    return torch.einsum("ar,rsck,bs->abck", g, w.float(), g)


def winograd_input_transform(x_padded, H, W):
    """x_padded (B, H+2, W+2, C) -> V (B, 4, 4, nt, C) with nt =
    (H/2)(W/2) tiles, row-major over (tile row, tile column): Bᵀ d B of
    each stride-2 4x4 window, rows then columns, in ``x_padded.dtype`` as
    the Pallas kernel computes it: each add or subtract rounded to the
    dtype."""
    B, C = x_padded.shape[0], x_padded.shape[-1]
    th, tw = H // 2, W // 2
    # (B, th, tw, C, r, s): window (i, j) is x_padded[:, 2i+r, 2j+s]
    d = x_padded.unfold(1, 4, 2).unfold(2, 4, 2)
    rows = _bt_combine(*(d[..., r, :] for r in range(4)))
    v = torch.stack([torch.stack(_bt_combine(*(t[..., s] for s in range(4))))
                     for t in rows])  # (4, 4, B, th, tw, C)
    return v.permute(2, 0, 1, 3, 4, 5).reshape(B, 4, 4, th * tw, C)


def fma_f32(y, scale, bias):
    """``y * scale + bias`` on fp32 tensors rounded once, as a fused
    multiply-add (CUDA's ``fmaf``) rounds it. The product of two fp32
    values is exact in fp64; the fp64 sum is rounded to odd (TwoSum gives
    its exact error, and an inexact sum whose last bit is even moves one
    ulp toward it), and a value rounded to odd at 53 bits rounds to fp32
    correctly (Boldo and Melquiond, 2008)."""
    p = y.double() * scale.double()
    b = bias.double().expand_as(p)
    s = p + b
    bv = s - p
    err = (p - (s - bv)) + (b - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def winograd_output_transform(m, H, W, *, scale=None, bias=None, act=None):
    """m (B, 4, 4, nt, K), read as fp32 -> (B, H, W, K) in ``m.dtype``:
    Aᵀ m A per tile, rows then columns, then ``act(y*scale + bias)`` in
    fp32 with one rounding (a fused multiply-add, as the Pallas kernel's
    epilogue compiles and as the CUDA kernel computes it; a missing scale
    is ones, a missing bias zeros, and with neither ``y`` is kept as it
    is), and one cast; tile t = i*(W/2) + j writes the 2x2 block at (2i,
    2j)."""
    B, K = m.shape[0], m.shape[-1]
    th, tw = H // 2, W // 2
    mf = m.float()
    rows = _at_combine(*(mf[:, i] for i in range(4)))  # 2 x (B, 4, nt, K)
    y = torch.stack([torch.stack(_at_combine(*(t[:, j] for j in range(4))))
                     for t in rows])  # (2a, 2b, B, nt, K)
    y = y.permute(2, 3, 0, 1, 4).reshape(B, th, tw, 2, 2, K)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, K)
    if scale is not None or bias is not None:
        kw = dict(dtype=torch.float32, device=y.device)
        y = fma_f32(y, torch.ones(K, **kw) if scale is None else scale.float(),
                    torch.zeros(K, **kw) if bias is None else bias.float())
    return apply_act(y, act).to(m.dtype)


def winograd_conv(x_padded, w, *, u=None, scale=None, bias=None, act=None):
    """F(2x2,3x3) on x_padded (B, H+2, W+2, C), w (3,3,C,K), even H and
    W -> (B, H, W, K), at the cast points of the JAX package's Pallas
    composition: V computed in the input dtype (each add rounded), the
    16 products accumulated in
    fp32 and written in V's dtype, the output transform reading M as fp32
    with the epilogue fused and one cast. (Its jnp path casts M, then
    applies the epilogue as a second pass: the difference shows only in
    the low-precision dtypes.) ``u`` is the cached U; without it U is
    computed here, in fp32."""
    R, S, C, K = w.shape
    if (R, S) != (3, 3):
        raise ValueError(f"winograd F(2,3) is 3x3-only, got {R}x{S}")
    B, Hp, Wp, _ = x_padded.shape
    H, W = Hp - 2, Wp - 2
    if H % 2 or W % 2 or H < 2 or W < 2:
        raise ValueError(f"winograd F(2,3) needs even output dims, got "
                         f"{H}x{W}")
    if u is None:
        u = winograd_filter_transform(w)
    v = winograd_input_transform(x_padded, H, W)
    m = gemm(v.reshape(B * 16, -1, C), u.reshape(16, C, K))
    return winograd_output_transform(m.reshape(B, 4, 4, -1, K), H, W,
                                     scale=scale, bias=bias, act=act)


def pointwise_conv(x, w, *, stride=1, scale=None, bias=None, act=None):
    """x: (B,H,W,C) unpadded; w: (1,1,C,K) -> (B,ceil(H/s),ceil(W/s),K).
    A strided 1x1 reads ``x[:, ::s, ::s]``."""
    acc = x[:, ::stride, ::stride, :].float() @ w[0, 0].float()
    return _epilogue(acc, scale, bias, act).to(x.dtype)


def fused_residual_conv(x_padded, weights, *, res, act="relu"):
    """Stride-1 conv on ``x_padded`` with weights ``w``/``scale``/
    ``bias``: the folded-BN result is cast to the compute dtype first,
    then ``res`` is added in that dtype, then the activation."""
    acc = _tap_loop(x_padded, weights["w"], 1)
    y = _epilogue(acc, weights.get("scale"), weights.get("bias"), None)
    return apply_act(y.to(x_padded.dtype) + res, act)


def depthwise_conv(x_padded, w, *, stride=1, scale=None, bias=None,
                   act=None):
    """x_padded: (B, Hp, Wp, C) pre-padded; w: (R, S, 1, M*C)
    -> (B, H, W, M*C), with the fused epilogue. Each tap is a strided
    window times one per-channel filter row; output channel k reads input
    channel k // M (lax's HWIO convention for a channel multiplier)."""
    R, S, _, K = w.shape
    B, Hp, Wp, C = x_padded.shape
    if K % C:
        raise ValueError(f"depthwise filters {tuple(w.shape)} for {C} "
                         "input channels")
    H = (Hp - R) // stride + 1
    W = (Wp - S) // stride + 1
    xf, wf = x_padded.float(), w.float()
    if K != C:
        xf = xf.repeat_interleave(K // C, dim=-1)
    acc = torch.zeros((B, H, W, K), dtype=torch.float32,
                      device=x_padded.device)
    for r in range(R):
        for s in range(S):
            acc += xf[:, r:r + (H - 1) * stride + 1:stride,
                      s:s + (W - 1) * stride + 1:stride, :] * wf[r, s, 0]
    return _epilogue(acc, scale, bias, act).to(x_padded.dtype)


def fused_inverted_residual(x, weights, *, stride=1, residual=False,
                            act="relu6", out_act=None):
    """MobileNetV2's inverted residual composed stage by stage: expand
    (1x1 + ``s1``/``b1`` + act, absent for t == 1 blocks) -> SAME pad, low
    first -> depthwise (+ ``sdw``/``bdw`` + act) -> project (1x1 +
    ``s2``/``b2`` + ``out_act``) -> optional ``+ x``. Each stage casts once
    to the compute dtype, where the per-layer kernels' writes cast; the
    identity add runs in the compute dtype."""
    h = x
    if weights.get("w1") is not None:
        h = pointwise_conv(h, weights["w1"], scale=weights.get("s1"),
                           bias=weights.get("b1"), act=act)
    wdw = weights["wdw"]
    h = depthwise_conv(pad_same(h, wdw.shape[0], wdw.shape[1], stride), wdw,
                       stride=stride, scale=weights.get("sdw"),
                       bias=weights.get("bdw"), act=act)
    h = pointwise_conv(h, weights["w2"], scale=weights.get("s2"),
                       bias=weights.get("b2"), act=out_act)
    return h + x if residual else h


def causal_conv1d(x, w, b=None):
    """Depthwise causal 1-D conv: x (B, L, C), w (K, C), b (C,) or None
    -> (B, L, C) in ``x.dtype``. Output t sums ``x[t-K+1+j] * w[j]`` over
    the K taps in order, zeros before t = 0, as separate fp32 multiplies
    and adds, then the bias, then one cast. Any L, and ``x`` may be a view
    whose rows are strided (the slice of the in-projection)."""
    k, L = w.shape[0], x.shape[1]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        shift = k - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :L]
        acc = acc + xs.float() * w[j].float()
    if b is not None:
        acc = acc + b.float()
    return acc.to(x.dtype)


def causal_conv1d_bwd(dy, x, w, has_bias, tile):
    """The gradient of ``causal_conv1d`` in the backward kernel's order:
    dy (B, L, C), x (B, L, C) (rows may be strided), w (K, C) -> (dx (B,
    L, C) in ``x.dtype``, dw (K, C) and db (C,) or None in ``w.dtype``).

    ``dx[t] = sum_j w[j] dy[t + K - 1 - j]`` as fp32 multiplies and adds in
    tap order from 0, zeros past L, then one cast: the forward's chain on
    the reversed ``dy``. ``dw[j] = sum dy[t] x[t - K + 1 + j]`` and ``db =
    sum dy`` as one fp32 chain a (batch, ``tile``-step tile) in time order
    (past L, dy is zero), then the (B, tiles) partials added in index order
    from zero, then one cast."""
    k, (B, L, C) = w.shape[0], x.shape
    tiles = -(-L // tile)
    span = tiles * tile
    g = torch.zeros((B, span + k - 1, C), dtype=torch.float32,
                    device=x.device)
    g[:, :L] = dy.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        acc = acc + g[:, k - 1 - j:k - 1 - j + L] * w[j].float()
    dx = acc.to(x.dtype)
    # xs[:, k - 1 + t] = x[t]: zeros before 0 and past L
    xs = torch.zeros((B, span + k - 1, C), dtype=torch.float32,
                     device=x.device)
    xs[:, k - 1:k - 1 + L] = x.float()
    part = torch.zeros((B, tiles, k + 1, C), dtype=torch.float32,
                       device=x.device)
    for u in range(tile):  # step u of every tile at once
        d = g[:, u:span:tile]
        for j in range(k):
            part[:, :, j] = part[:, :, j] + d * xs[:, u + j:u + j + span:tile]
        part[:, :, k] = part[:, :, k] + d
    total = torch.zeros((k + 1, C), dtype=torch.float32, device=x.device)
    for p in part.reshape(B * tiles, k + 1, C):
        total = total + p
    dw = total[:k].to(w.dtype)
    return dx, dw, total[k].to(w.dtype) if has_bias else None


def conv1d_dense(x, w, b=None, *, stride=1):
    """Dense 1-D conv with SAME padding: x (B, L, Cin), w (K, Cin, Cout),
    b (Cout,) or None -> (B, ceil(L / stride), Cout), the bias added
    after the conv (promoting as the reference's add does). The reference
    runs it as an XLA conv, not a Pallas kernel, so this is the port's
    only version. The total pad ``(out-1)*stride + K - L`` gives
    its smaller half to the start, as XLA does (at stride 2 and even L
    the single pad goes at the end); ``F.conv1d(padding="same")`` refuses
    stride > 1 and would split it the other way."""
    K, L = w.shape[0], x.shape[1]
    pad = max((-(-L // stride) - 1) * stride + K - L, 0)
    xp = F.pad(x, (0, 0, pad // 2, pad - pad // 2)).transpose(1, 2)
    y = F.conv1d(xp, w.permute(2, 1, 0), stride=stride)
    y = y.transpose(1, 2)
    return y if b is None else y + b
