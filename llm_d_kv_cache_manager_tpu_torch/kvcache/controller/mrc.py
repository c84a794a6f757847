"""Fleet-level miss-ratio-curve aggregation.

Each pod's ``ReuseDistanceEstimator`` (``OBS_LIFECYCLE``) measures its own
access stream and answers ``P[reuse distance < C]`` on the shared
power-of-two capacity grid. The fleet controller (and the scorer's
fleet-wide ``/debug/mrc``) needs ONE curve for the whole fleet: with the
router spreading disjoint working sets across pods, the fleet's access
stream is the union of the per-pod streams, so the fleet hit rate at
capacity ``C`` is the *sampled-weighted* average of per-pod hit rates —
each pod's curve contributes in proportion to the accesses it actually
measured. That identity (aggregate == per-pod sum of sampled hits over
the sum of samples) is pinned by a unit test on a synthetic stream.

The inputs are ``/debug/mrc`` payload dicts (``debug_mrc_payload``'s
shape: ``curve`` rows + ``sampled``/``cold``/``accesses`` counters), so
the same function serves in-process estimators and payloads scraped over
HTTP; pods whose estimator has sampled nothing (or with the knob off,
``enabled: false``) contribute nothing, exactly as an empty stream would.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ...obs.lifecycle import REUSE_DISTANCE_BUCKETS


def aggregate_mrc(per_pod: dict[str, Optional[dict]]) -> dict:
    """Merge per-pod ``/debug/mrc`` payloads into one fleet curve.

    Returns the same payload shape (``enabled``, ``curve`` rows with
    ``capacity_blocks`` / ``predicted_hit_rate`` / ``miss_ratio``, plus
    summed ``accesses``/``sampled``/``cold`` counters and a ``pods``
    count), evaluated on the shared power-of-two grid. A capacity at
    which NO reporting pod has data yields ``None`` rates, same as a
    single empty estimator.
    """
    curves: list[tuple[int, dict[int, float]]] = []  # (sampled, cap -> hit)
    accesses = sampled = cold = 0
    reporting = 0
    for payload in per_pod.values():
        if not payload or not payload.get("enabled", True):
            continue
        weight = int(payload.get("sampled") or 0)
        if weight <= 0:
            continue
        by_cap: dict[int, float] = {}
        for row in payload.get("curve") or []:
            hit = row.get("predicted_hit_rate")
            if hit is not None:
                by_cap[int(row["capacity_blocks"])] = float(hit)
        reporting += 1
        accesses += int(payload.get("accesses") or 0)
        sampled += weight
        cold += int(payload.get("cold") or 0)
        curves.append((weight, by_cap))

    rows = []
    for cap in REUSE_DISTANCE_BUCKETS:
        num = den = 0.0
        for weight, by_cap in curves:
            hit = by_cap.get(cap)
            if hit is not None:
                num += weight * hit
                den += weight
        hit_rate = num / den if den else None
        rows.append(
            {
                "capacity_blocks": cap,
                "predicted_hit_rate": (
                    round(hit_rate, 4) if hit_rate is not None else None
                ),
                "miss_ratio": (
                    round(1.0 - hit_rate, 4) if hit_rate is not None else None
                ),
            }
        )
    return {
        "enabled": reporting > 0,
        "pods": reporting,
        "curve": rows,
        "accesses": accesses,
        "sampled": sampled,
        "cold": cold,
    }


def hit_rate_at(curve: Sequence[dict], capacity_blocks: int) -> Optional[float]:
    """Read a curve (aggregate or per-pod rows) at an arbitrary capacity.

    The grid is power-of-two; between grid points the hit rate is
    interpolated linearly in capacity — MRCs are concave enough over one
    octave that this stays within the estimator's own sampling noise, and
    the controller only compares DIFFERENCES of nearby reads against its
    headroom threshold. Below the first measured point the first value is
    returned, past the last the last value; None when the curve holds no
    data at all (the controller must not scale on an unmeasured fleet).
    """
    pts = [
        (int(r["capacity_blocks"]), float(r["predicted_hit_rate"]))
        for r in curve
        if r.get("predicted_hit_rate") is not None
    ]
    if not pts:
        return None
    pts.sort()
    if capacity_blocks <= pts[0][0]:
        return pts[0][1]
    for (c0, h0), (c1, h1) in zip(pts, pts[1:]):
        if capacity_blocks <= c1:
            frac = (capacity_blocks - c0) / (c1 - c0)
            return h0 + frac * (h1 - h0)
    return pts[-1][1]
