"""Logical-axis sharding rules over a ``DeviceMesh``
(``repro/sharding``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES,
    Rules,
    axis_rules,
    constrain,
    logical_sharding,
    logical_spec,
    placements,
    rules_for,
    with_logical_constraint,
)
