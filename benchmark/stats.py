"""The arithmetic of the end-to-end metrics."""
from __future__ import annotations

import math


def percentile(values: list, q: float) -> float | None:
    """The q-th percentile (0 < q < 100) by nearest rank: the smallest value
    that at least q % of the values do not exceed. None for no values."""
    if not values:
        return None
    ranked = sorted(values)
    return ranked[max(0, math.ceil(q / 100 * len(ranked)) - 1)]


def rate(total: float | None, seconds: float) -> float | None:
    """``total`` over ``seconds``: all the work over all the time."""
    if total is None or seconds <= 0:
        return None
    return total / seconds
