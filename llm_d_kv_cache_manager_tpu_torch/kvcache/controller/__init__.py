"""Fleet controller: MRC-driven cache-aware autoscaling + live migration.

The ROADMAP item-2 autoscaler: a reconcile loop that reads the fleet's
SLO burn rates (``OBS_SLO``) and its aggregated miss-ratio curve
(``OBS_LIFECYCLE``) and resizes the pod fleet — scaling up only when the
MRC says more cache will actually absorb the burn (and reviving the new
pod warm over the transfer fabric), scaling down instantly by
live-migrating in-flight decode sequences to survivors. Off by default
behind ``FLEET_CONTROLLER``; unset, nothing here is constructed and the
fleet behaves bit-identically to legacy.

- ``fleet``: ``FleetController`` (decide + act + hysteresis),
  ``FleetControllerConfig`` (the ``FLEET_*`` knobs), ``PodSignals`` /
  ``FleetAdapter`` (the environment surface), ``FleetDecision``;
- ``mrc``: per-pod → fleet miss-ratio-curve aggregation (also the
  scorer's fleet-wide ``/debug/mrc``);
- ``inprocess``: the adapter over real in-process ``PodServer``s.
"""

from .fleet import (
    FleetAdapter,
    FleetController,
    FleetControllerConfig,
    FleetDecision,
    PodSignals,
    fleet_burn,
)
from .inprocess import InProcessFleet
from .mrc import aggregate_mrc, hit_rate_at

__all__ = [
    "FleetAdapter",
    "FleetController",
    "FleetControllerConfig",
    "FleetDecision",
    "InProcessFleet",
    "PodSignals",
    "aggregate_mrc",
    "fleet_burn",
    "hit_rate_at",
]
