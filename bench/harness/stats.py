"""Statistics the metrics share."""
from __future__ import annotations

import math


def percentile(values, q):
    """The nearest-rank ``q``-th percentile of ``values``: the smallest
    value with at least q% of them at or below it; None when empty."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(len(s) * q / 100) - 1)]
