"""Disaggregated prefill/decode serving over the KV-transfer fabric.

Composes the pieces built — chunked prefill, verified cross-pod
KV transfer with async-pull overlap, admission control + graceful drain,
and end-to-end tracing — into the deployment mode DistServe (OSDI '24)
and Splitwise (ISCA '24) showed removes prefill/decode interference
beyond what chunking alone delivers: dedicated prefill pods run ingest
at full batch width and stop at the first token; dedicated decode pods
pull the finished chain over the transfer fabric and stream tokens.

Everything is off by default: a fleet of ``POD_ROLE=mixed`` pods (the
default) behaves — and speaks on every wire — bit-identically to the
legacy single-tier fleet.
"""

from ..router import DisaggPlan, PlanError, PodView, TwoHopPlanner
from .coordinator import (
    DisaggConfig,
    DisaggCoordinator,
    DisaggResult,
    views_from_pods,
)

__all__ = [
    "DisaggConfig",
    "DisaggCoordinator",
    "DisaggPlan",
    "DisaggResult",
    "PlanError",
    "PodView",
    "TwoHopPlanner",
    "views_from_pods",
]
