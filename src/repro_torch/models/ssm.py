"""Mamba-2 blocks (SSD, state-space duality), as in ``repro/models/ssm.py``.

Prefill and training use the chunked SSD algorithm (an intra-chunk
quadratic form plus an inter-chunk state pass, arXiv:2405.21060 §6);
decode is the O(1) recurrent update. The depthwise causal conv of the
full-sequence path runs through ``kernels.ops.causal_conv1d``, on the
xBC slice of the in-projection as it lies (a view with strided rows);
decode convolves its (B, k, C) window with an einsum, as the reference
does. The cast points are the reference's: cumsums and exponents in
fp32, the decay and score tensors and the states in the compute dtype.
One departure, in training only: the SSD's decays above the diagonal
are masked before their ``exp`` (``_below``), where the reference's
overflow and give NaN gradients at the published chunk length; the
forward's values are the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dtypes import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.layers import norm_spec, rms_norm, stationary
from repro_torch.models.spec import ParamSpec
from repro_torch.sharding.rules import (axis_size, constrain, current_mesh,
                                        run_local)


# a decode cache's logical axes: the conv window (B, k - 1, conv_ch) and
# the state (B, G, Hg, P, N)
CONV_CACHE = ("batch", None, "ssm_inner")
STATE_CACHE = ("batch", None, "ssm_heads", None, None)


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_head_dim
    H = d_inner // P
    Hg = H // G
    conv_ch = d_inner + 2 * G * N
    return d_inner, G, N, P, H, Hg, conv_ch


def mamba_specs(cfg):
    E = cfg.d_model
    d_inner, G, N, P, H, Hg, conv_ch = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return {
        "in_proj": ParamSpec((E, d_in_proj), ("embed_fsdp", "ssm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv_k, conv_ch), ("conv_k", "ssm_inner"),
                            scale=cfg.ssm_conv_k ** -0.5),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), "zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), "zeros"),  # A = -exp(0) = -1
        "D": ParamSpec((H,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), "zeros"),
        "norm": norm_spec(d_inner),
        "out_proj": ParamSpec((d_inner, E), ("ssm_inner", "embed_fsdp")),
    }


def _split_proj(cfg, zxbcdt):
    """z, xBC, dt: views into the in-projection's output."""
    d_inner, G, N, P, H, Hg, conv_ch = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xBC, dt


def _softplus(v):
    """log(1 + exp(v)), as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))


def _below(expo, keep):
    """``expo`` with -inf where ``keep`` is false when autograd records
    it, else ``expo``; the caller zeroes the dropped entries of its
    ``exp``. Above the diagonal the exponents are sums of positive
    decays, which overflow fp32 once a sequence is long (at
    mamba2-370m's 256-step chunk), and the backward of the zeroing
    ``where`` multiplies a zero gradient by the infinite ``exp``: NaN, as
    the reference's gradient is. Masked, the kept values are the same and
    the gradient finite; a forward without autograd (serving) skips the
    extra pass over the (Q, Q) decays."""
    if not expo.requires_grad:
        return expo
    return expo.masked_fill(~keep, float("-inf"))


def ssd_chunked(x, dt, A, Bm, C, chunk):
    """Chunked SSD scan.

    x: (B,L,G,Hg,P)  dt: (B,L,G,Hg)  A: (G,Hg) (negative)
    Bm, C: (B,L,G,N).  Returns (y (B,L,G,Hg,P), final_state (B,G,Hg,P,N)).
    """
    Bsz, L, G, Hg, P = x.shape
    N = Bm.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L
    if pad:  # zeros at the end of the sequence axis
        x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    Q, xdt = chunk, x.dtype
    xc = x.reshape(Bsz, nc, Q, G, Hg, P)
    dtc = dt.reshape(Bsz, nc, Q, G, Hg).float()
    Bc = Bm.reshape(Bsz, nc, Q, G, N)
    Cc = C.reshape(Bsz, nc, Q, G, N)

    dA = dtc * A.float()                      # (B,nc,Q,G,Hg), <= 0
    cum = torch.cumsum(dA, dim=2)             # running log-decay in chunk

    # intra-chunk (quadratic, attention-like) form: cumsums and exponents
    # in fp32, the decay and score tensors in the compute dtype
    CB = torch.einsum("bcign,bcjgn->bcijg", Cc.float(), Bc.float()).to(xdt)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(_below(cum[:, :, :, None] - cum[:, :, None],
                             tri[None, None, :, :, None, None])).to(xdt)
    W = torch.where(tri[None, None, :, :, None, None],
                    CB[..., None] * decay * dtc[:, :, None].to(xdt),
                    torch.zeros((), dtype=xdt, device=x.device))
    y_intra = torch.einsum("bcijgh,bcjghp->bcighp", W, xc)

    # per-chunk end states
    decay_end = torch.exp(cum[:, :, -1:] - cum)             # (B,nc,Q,G,Hg)
    S = torch.einsum("bcjgh,bcjgn,bcjghp->bcghpn",
                     (decay_end * dtc).to(xdt), Bc, xc)

    # inter-chunk state pass as a lower-triangular (nc x nc) chunk-decay
    # matrix contraction
    a = torch.cumsum(cum[:, :, -1], dim=1)                   # (B,nc,G,Hg)
    ld = cum[:, :, -1]
    tri_c = torch.tril(torch.ones((nc, nc), dtype=torch.bool,
                                  device=x.device), diagonal=-1)
    expo = a[:, :, None] - ld[:, :, None] - a[:, None]       # (B,nc,nc,G,Hg)
    keep = tri_c[None, :, :, None, None]
    T_s = torch.where(keep, torch.exp(_below(expo, keep)),
                      torch.zeros((), device=x.device))
    s_start = torch.einsum("bcdgh,bdghpn->bcghpn", T_s.to(xdt), S)
    # final state: inclusive decay to the end of the last chunk
    T_f = torch.exp(a[:, -1:] - a)                           # (B,nc,G,Hg)
    s_final = torch.einsum("bdgh,bdghpn->bghpn", T_f.to(xdt), S)

    y_inter = torch.einsum("bcign,bcghpn,bcigh->bcighp",
                           Cc, s_start, torch.exp(cum).to(xdt))
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, G, Hg, P)
    return y[:, :L], s_final


def _ssd_heads(cfg, x, dt, A_log, dt_bias, D, Bm, C):
    """The SSD of heads x (B,L,H,P) with their time steps dt (B,L,H)
    before the softplus, A_log, dt_bias and D (H,), over groups Bm, C
    (B,L,G,N) of H / G heads each -> (y (B,L,H,P) with the D skip,
    final state (B,G,H/G,P,N))."""
    B_, L, H, P = x.shape
    G = Bm.shape[2]
    Hg = H // G
    x = x.reshape(B_, L, G, Hg, P)
    dt = _softplus(dt.float() + dt_bias.float()).reshape(B_, L, G, Hg)
    A = -torch.exp(A_log.float()).reshape(G, Hg)
    y, s_final = ssd_chunked(x, dt, A, Bm, C, cfg.ssd_chunk)
    y = y + D.to(x.dtype).reshape(G, Hg)[..., None] * x
    return y.reshape(B_, L, H, P), s_final


def mamba_forward(p, cfg, xres, *, want_cache=False, impl="auto"):
    """Full-sequence Mamba-2 mixer. xres: (B,L,E), already normed.
    ``impl`` is the causal conv's (``ops.causal_conv1d``)."""
    dt_ = torch_dtype(cfg.dtype)
    d_inner, G, N, P, H, Hg, conv_ch = _dims(cfg)
    B_, L, E = xres.shape
    # under a mesh the projection's channels are gathered once: z, xBC
    # and dt do not fall on its shard boundaries
    zxbcdt = constrain(xres @ p["in_proj"].to(dt_), ("batch", None, None))
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    ch = ("batch", None, "ssm_inner")
    xBC = run_local(lambda x, w, b: ops.causal_conv1d(x, w, b, impl=impl),
                    (xBC, p["conv_w"].to(dt_), p["conv_b"].to(dt_)),
                    (ch, ("conv_k", "ssm_inner"), ("ssm_inner",)),
                    [(ch, tuple(xBC.shape))])
    xBC = constrain(F.silu(xBC), ("batch", None, None))
    x = xBC[..., :d_inner].reshape(B_, L, H, P)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B_, L, G, N)
    C = xBC[..., d_inner + G * N:].reshape(B_, L, G, N)
    # a rank's heads are whole groups, or a slice of the one group;
    # otherwise every rank runs them all
    hd = "ssm_heads" if G == 1 or G % axis_size(current_mesh(), "model") == 0 \
        else None
    hx, grp = ("batch", None, hd, None), ("batch", None, hd if G > 1
                                          else None, None)
    state = ("batch", hd, None, None, None) if G > 1 \
        else ("batch", None, hd, None, None)
    y, s_final = run_local(
        lambda *a: _ssd_heads(cfg, *a),
        (x, dt, p["A_log"], p["dt_bias"], p["D"], Bm, C),
        (hx, ("batch", None, hd), (hd,), (hd,), (hd,), grp, grp),
        [(hx, (B_, L, H, P)), (state, (B_, G, Hg, P, N))])
    # the heads' split held on both sides of the view (see layers.merged)
    y = constrain(y.reshape(B_, L, d_inner), ("batch", None, hd),
                  (B_, L, H))
    y = rms_norm(y * F.silu(z), p["norm"]["w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    if want_cache:
        tail = xBC_raw_tail(cfg, xres, p)  # conv window tail, pre-activation
        return out, {"conv": tail, "state": s_final}
    return out, None


def xBC_raw_tail(cfg, xres, p):
    """Last (k-1) pre-conv xBC values: the decode conv window."""
    k = cfg.ssm_conv_k
    tail_in = xres[:, -(k - 1):]
    # under a mesh the channels gathered, as ``mamba_forward`` gathers them
    zxbcdt = constrain(tail_in @ p["in_proj"].to(torch_dtype(cfg.dtype)),
                       ("batch", None, None))
    _, xBC, _ = _split_proj(cfg, zxbcdt)
    pad = (k - 1) - tail_in.shape[1]
    if pad > 0:
        xBC = F.pad(xBC, (0, 0, pad, 0))
    return xBC


def mamba_decode(p, cfg, xres, cache, pos):
    """One-token recurrent update. xres: (B,1,E); cache: {conv:
    (B,k-1,conv_ch), state: (B,G,Hg,P,N)}. ``pos`` is unused, as in the
    reference: the state carries the position.

    Under a mesh, as ``mamba_forward``: the in-projection's channels
    gathered once (its z, xBC and dt slices cross the shard boundaries),
    the conv window updated on each rank's block of the channels and the
    state on its block of the heads (``run_local``), each cache kept on
    its placements (``CONV_CACHE``, ``STATE_CACHE``)."""
    dt_ = torch_dtype(cfg.dtype)
    d_inner, G, N, P, H, Hg, conv_ch = _dims(cfg)
    B_ = xres.shape[0]
    w = p["in_proj"].to(dt_)
    zx = stationary("bse,ef->bsf", xres, w, ("embed_fsdp", "ssm_inner"),
                    ("batch", None, None), (B_, 1, w.shape[1]))
    zxbcdt = constrain(xres[:, 0] @ w, ("batch", None)) if zx is None \
        else zx[:, 0]                                       # (B, d_in_proj)
    z, xBC_new, dt = _split_proj(cfg, zxbcdt)

    def conv(c, x_new, w, b):
        window = torch.cat([c, x_new[:, None]], dim=1)       # (B,k,ch)
        return window[:, 1:], torch.einsum("bkc,kc->bc", window, w) + b
    ch = ("batch", "ssm_inner")
    conv_cache, conv_out = run_local(
        conv, (cache["conv"], xBC_new, p["conv_w"].to(dt_),
               p["conv_b"].to(dt_)),
        (CONV_CACHE, ch, ("conv_k", "ssm_inner"), ("ssm_inner",)),
        [(CONV_CACHE, tuple(cache["conv"].shape)), (ch, (B_, conv_ch))])
    xBC = constrain(F.silu(conv_out), ("batch", None))
    x = xBC[..., :d_inner].reshape(B_, G, Hg, P)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B_, G, N)
    C = xBC[..., d_inner + G * N:].reshape(B_, G, N)

    def whole(v):  # a per-head leaf gathered before its (G, Hg) view
        return constrain(v, (None,))
    dt = _softplus(dt.float() + whole(p["dt_bias"]).float()).reshape(
        B_, G, Hg)
    A = -torch.exp(whole(p["A_log"]).float()).reshape(G, Hg)
    D = whole(p["D"]).to(dt_).reshape(G, Hg)

    def update(s, x, dt, A, D, Bm, C):
        dA = torch.exp(dt * A)[..., None, None].to(s.dtype)  # (B,G,Hg,1,1)
        upd = torch.einsum("bgh,bgn,bghp->bghpn", dt.to(dt_), Bm, x)
        s = s * dA + upd
        return s, torch.einsum("bgn,bghpn->bghp", C, s) + D[..., None] * x
    hs, grp = ("batch", None, "ssm_heads"), ("batch", None, None)
    s, y = run_local(update, (cache["state"], x, dt, A, D, Bm, C),
                     (STATE_CACHE, hs + (None,), hs, hs[1:], hs[1:], grp,
                      grp),
                     [(STATE_CACHE, tuple(cache["state"].shape)),
                      (hs + (None,), (B_, G, Hg, P))])
    y = constrain(y, ("batch", None, None, None)).reshape(B_, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"]["w"], cfg.norm_eps)
    w = p["out_proj"].to(dt_)
    out = stationary("bsk,ke->bse", y[:, None], w,
                     ("ssm_inner", "embed_fsdp"), ("batch", None, None),
                     (B_, 1, w.shape[1]))
    if out is None:
        out = (y @ w)[:, None]                              # (B,1,E)
    return out, {"conv": conv_cache, "state": s}
