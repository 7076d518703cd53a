"""The ``nn.Module`` every network of the port is.

Its parameters mirror the family's spec tree, so ``state_dict()`` keys are
the JAX parameter paths joined with '.' (``stem.w``, ``s1b0.dw.scale``,
``seg0.sub0.mamba.in_proj``) and plan keys and parameters map one to one.
A family subclasses ``SpecNetwork`` and names its ``model_specs`` and
``forward``.
"""
from __future__ import annotations

from torch import nn

from repro_torch.models.spec import flatten, unflatten, walk


def _add_tree(m: nn.Module, tree) -> nn.Module:
    """Add a nested dict of tensors to ``m``: a submodule a dict, a
    parameter a tensor."""
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _add_tree(nn.Module(), v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


class SpecNetwork(nn.Module):
    """The network as a module. ``params`` is a nested dict of tensors or
    a flat ``state_dict`` with dotted keys; it must hold exactly the
    family's parameter paths."""

    model_specs = None  # cfg -> spec tree
    forward_fn = None  # (params, cfg, inputs, **kw) -> outputs

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = cfg
        tree = unflatten(params) if any("." in k for k in params) \
            else params
        expected = {".".join(p) for p, _ in walk(self.model_specs(cfg))}
        got = set(flatten(tree))
        if got != expected:
            raise ValueError(f"params do not match {cfg.name}: missing "
                             f"{sorted(expected - got)}, extra "
                             f"{sorted(got - expected)}")
        _add_tree(self, tree)

    def params(self) -> dict:
        """The parameters as the nested dict ``forward`` takes."""
        return unflatten(dict(self.named_parameters()))

    def forward(self, inputs, **kw):
        return self.forward_fn(self.params(), self.cfg, inputs, **kw)
