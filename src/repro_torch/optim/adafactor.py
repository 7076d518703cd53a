"""Adafactor: a factored second moment and momentum in a chosen dtype
(``repro/optim/adafactor.py``; Shazeer & Stern, arXiv:1804.04235).

A leaf of two or more dimensions keeps row and column statistics of its
last two axes (``vr``, ``vc``) instead of a full second moment; a
segment's stacked (layers, ...) leaves keep the leading axis, so a
(48, 1024) norm scale is factored, as in the reference. An unfactored
leaf keeps a full ``vr`` and a ``(0,)`` placeholder ``vc``. The update's
RMS clip runs in fp32; ``torch.rsqrt`` stands for ``jax.lax.rsqrt``.
"""
from __future__ import annotations

import torch

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models.spec import ParamSpec, flatten, tree_map
from repro_torch.optim.schedule import const


def _factored(shape) -> bool:
    return len(shape) >= 2


def init(params, state_dtype="bfloat16"):
    """Zero momentum in ``state_dtype``, zero fp32 statistics and an int32
    step on the params' device."""
    dt = torch_dtype(state_dtype)
    f32 = torch.float32

    def vrow(p):
        shape = p.shape[:-1] if _factored(p.shape) else p.shape
        return torch.zeros(shape, dtype=f32, device=p.device)

    def vcol(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p.shape) else (0,)
        return torch.zeros(shape, dtype=f32, device=p.device)

    device = next(iter(flatten(params).values())).device
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "vr": tree_map(vrow, params), "vc": tree_map(vcol, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def update(grads, state, params, *, lr, b1=0.9, decay=0.99, eps=1e-30,
           weight_decay=0.0, clip_threshold=1.0):
    """One step -> (new params, new state); ``lr`` an fp32 0-d tensor."""
    step = state["step"] + 1
    k = {name: const(v, lr) for name, v in (
        ("b1", b1), ("1-b1", 1 - b1), ("decay", decay),
        ("1-decay", 1 - decay), ("eps", eps), ("wd", weight_decay),
        ("one", 1.0), ("clip", clip_threshold), ("tiny", 1e-30))}

    def upd(g, m, vr, vc, p):
        # the reference's expression, each temporary updated in place
        # (the same roundings, fewer leaf-sized buffers alive at once)
        g32, p32 = g.float(), p.float()
        g2 = g32 * g32
        g2 += k["eps"]
        if _factored(p.shape):
            vr32 = k["decay"] * vr + k["1-decay"] * g2.mean(dim=-1)
            vc32 = k["decay"] * vc + k["1-decay"] * g2.mean(dim=-2)
            del g2
            rfac = torch.rsqrt(vr32 / torch.maximum(
                vr32.mean(dim=-1, keepdim=True), k["eps"]))
            cfac = torch.rsqrt(vc32)
            u = g32 * rfac[..., None]
            u *= cfac[..., None, :]
        else:
            g2 *= k["1-decay"]
            vr32 = k["decay"] * vr
            vr32 += g2
            del g2
            vc32 = vc
            u = torch.rsqrt(vr32)
            u *= g32
        rms = torch.sqrt(torch.mean(u * u) + k["tiny"])
        u /= torch.maximum(k["one"], rms / k["clip"])
        m32 = k["b1"] * m.float()
        u *= k["1-b1"]
        m32 += u
        del u
        t = k["wd"] * p32
        t += m32
        t *= lr
        newp = p32 - t
        return newp.to(p.dtype), m32.to(m.dtype), vr32, vc32

    out = tree_map(upd, grads, state["m"], state["vr"], state["vc"], params)
    pick = [tree_map(lambda o, i=i: o[i], out) for i in range(4)]
    return pick[0], {"m": pick[1], "vr": pick[2], "vc": pick[3],
                     "step": step}


def state_specs(param_specs, state_dtype="bfloat16"):
    """The state's ParamSpec tree: the momentum shaped as the params, the
    row and column statistics in fp32."""
    def mom(s):
        return ParamSpec(s.shape, s.axes, "zeros", dtype=state_dtype)

    def vrow(s):
        if _factored(s.shape):
            return ParamSpec(s.shape[:-1], s.axes[:-1], "zeros",
                             dtype="float32")
        return ParamSpec(s.shape, s.axes, "zeros", dtype="float32")

    def vcol(s):
        if _factored(s.shape):
            return ParamSpec(s.shape[:-2] + s.shape[-1:],
                             s.axes[:-2] + s.axes[-1:], "zeros",
                             dtype="float32")
        return ParamSpec((0,), (None,), "zeros", dtype="float32")

    return {"m": tree_map(mom, param_specs),
            "vr": tree_map(vrow, param_specs),
            "vc": tree_map(vcol, param_specs),
            "step": ParamSpec((), (), "zeros", dtype="int32")}
