"""AdamW with moments in a chosen dtype (``repro/optim/adamw.py``).

The reference's formula, operation for operation: the moments in fp32,
``u = (m / c1) / (sqrt(v / c2) + eps) + wd * p``, then ``p - lr * u``,
each result cast to its leaf's dtype. ``torch.optim.AdamW`` would decay
the weights before the step and add ``eps`` after ``sqrt(v) /
sqrt(c2)``, which round differently. Every constant meets the arrays as
fp32 (``schedule.const``).
"""
from __future__ import annotations

import torch

from repro_torch.core.dtypes import torch_dtype
from repro_torch.models.spec import ParamSpec, flatten, tree_map
from repro_torch.optim.schedule import const


def init(params, state_dtype="float32"):
    """Zero moments in ``state_dtype`` and an int32 step on the params'
    device."""
    dt = torch_dtype(state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    device = next(iter(flatten(params).values())).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
           weight_decay=0.1):
    """One step -> (new params, new state); ``lr`` an fp32 0-d tensor."""
    step = state["step"] + 1
    t = step.float()
    c1 = const(1.0, t) - torch.pow(const(b1, t), t)
    c2 = const(1.0, t) - torch.pow(const(b2, t), t)
    k = {name: const(v, t) for name, v in (
        ("b1", b1), ("1-b1", 1 - b1), ("b2", b2), ("1-b2", 1 - b2),
        ("eps", eps), ("wd", weight_decay))}

    def upd(g, m, v, p):
        # the reference's expression, each temporary updated in place
        # (the same roundings, fewer leaf-sized buffers alive at once)
        g32, p32 = g.float(), p.float()
        m32 = k["b1"] * m.float()
        m32 += k["1-b1"] * g32
        t = k["1-b2"] * g32
        t *= g32
        v32 = k["b2"] * v.float()
        v32 += t
        den = v32 / c2
        den.sqrt_()
        den += k["eps"]
        u = m32 / c1
        u /= den
        del den
        t = k["wd"] * p32
        u += t
        u *= lr
        newp = p32 - u
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, grads, state["m"], state["v"], params)
    pick = [tree_map(lambda o, i=i: o[i], out) for i in range(3)]
    return pick[0], {"m": pick[1], "v": pick[2], "step": step}


def state_specs(param_specs, state_dtype="float32"):
    """The state's ParamSpec tree (the moments shaped as the params)."""
    def mom(s):
        return ParamSpec(s.shape, s.axes, "zeros", dtype=state_dtype)
    return {"m": tree_map(mom, param_specs),
            "v": tree_map(mom, param_specs),
            "step": ParamSpec((), (), "zeros", dtype="int32")}
