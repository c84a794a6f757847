"""Order statistics over samples where a failure sorts last."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank ``q`` percentile (0 < q <= 100) of ``values``; a
    missing or failed sample is ``math.inf`` and sorts last."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]
