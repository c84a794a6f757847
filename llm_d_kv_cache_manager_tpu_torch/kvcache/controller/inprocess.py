"""``FleetAdapter`` over real in-process ``PodServer``s.

The deployment surface the chaos tests and the bench co-sim drive — and
the single-host answer for real: one process owns N pods (one per
accelerator slice), and the controller resizes that set. Everything the
controller needs already exists on ``PodServer``: signals come from the
pod's own SLO recorder and reuse-distance estimator, migration is
``migrate_out`` over the transfer fabric, revival is ``revive_chain``,
and retirement is the graceful drain (which also publishes the
``PodDrained`` goodbye, so the scorer-side ``FleetHealth`` unroutes the
pod and the TTL sweeper reclaims its index entries — pod add/remove
needs no new fleet-health surface, the event plane already carries it).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ...obs.lifecycle import debug_mrc_payload
from ...utils import get_logger
from .fleet import PodSignals

log = get_logger("kvcache.controller.inprocess")


class InProcessFleet:
    """Wire a ``FleetController`` to live ``PodServer`` objects.

    ``make_pod(pod_id) -> (started PodServer, transfer_endpoint | None)``
    is the provisioning hook — the environment decides config, ports, and
    event-plane wiring; this adapter only tracks membership. Retired pods
    are drained (live migration already moved what it could; stragglers
    finish under the drain), shut down, and kept in ``retired`` so
    harnesses can assert on their final state.
    """

    def __init__(
        self,
        make_pod: Optional[Callable[[str], tuple]] = None,
        drain_timeout_s: Optional[float] = None,
        fleet_health=None,
    ):
        """``fleet_health`` (a ``kvevents.FleetHealth``, optional): told
        about membership changes immediately — ``observe_pod_added`` on
        scale-up (routable before the first heartbeat),
        ``observe_pod_removed`` on scale-down (unrouted before the drain
        starts)."""
        self._make_pod = make_pod
        self._drain_timeout_s = drain_timeout_s
        self._fleet_health = fleet_health
        self._mu = threading.Lock()
        #: pod_id -> (PodServer, transfer_endpoint | None)
        self._pods: dict[str, tuple] = {}  # guarded_by: _mu
        self._spawned = 0  # guarded_by: _mu
        self.retired: list = []  # guarded_by: _mu

    # -- membership ----------------------------------------------------------
    def register(self, pod_id: str, server, endpoint: Optional[str]) -> None:
        """Add an already-running pod to the controller's view."""
        with self._mu:
            self._pods[pod_id] = (server, endpoint)

    def server(self, pod_id: str):
        with self._mu:
            entry = self._pods.get(pod_id)
        return entry[0] if entry else None

    def pod_ids(self) -> list[str]:
        with self._mu:
            return list(self._pods)

    # -- FleetAdapter --------------------------------------------------------
    def observe(self) -> list[PodSignals]:
        with self._mu:
            pods = list(self._pods.items())
        out = []
        for pod_id, (server, endpoint) in pods:
            out.append(
                PodSignals(
                    pod_id=pod_id,
                    transfer_endpoint=endpoint,
                    capacity_blocks=(
                        server.config.engine.block_manager.total_pages - 1
                    ),
                    burn_rates=(
                        server.slo.burn_rates()
                        if server.slo is not None
                        else None
                    ),
                    mrc=(
                        debug_mrc_payload(server.mrc)[1]
                        if server.mrc is not None
                        else None
                    ),
                    live_requests=server.live_requests(),
                    draining=server.is_draining,
                )
            )
        return out

    def add_pod(self) -> Optional[PodSignals]:
        if self._make_pod is None:
            return None
        with self._mu:
            self._spawned += 1
            pod_id = f"fleet-{self._spawned}"
        try:
            server, endpoint = self._make_pod(pod_id)
        except Exception:
            log.exception("pod provisioning failed", pod=pod_id)
            return None
        self.register(pod_id, server, endpoint)
        if self._fleet_health is not None:
            self._fleet_health.observe_pod_added(pod_id)
        return PodSignals(
            pod_id=pod_id,
            transfer_endpoint=endpoint,
            capacity_blocks=server.config.engine.block_manager.total_pages - 1,
        )

    def migrate(
        self, pod_id: str, request_id: str, target_endpoint: str
    ) -> bool:
        server = self.server(pod_id)
        if server is None:
            return False
        return server.migrate_out(request_id, target_endpoint)

    def retire(self, pod_id: str) -> None:
        with self._mu:
            entry = self._pods.pop(pod_id, None)
        if entry is None:
            return
        server, _ = entry
        if self._fleet_health is not None:
            self._fleet_health.observe_pod_removed(pod_id)
        try:
            server.drain(timeout_s=self._drain_timeout_s)
        finally:
            server.shutdown()
        with self._mu:
            self.retired.append(server)

    def warm_sets(self, limit: int) -> list[tuple[str, list[int]]]:
        with self._mu:
            pods = list(self._pods.values())
        rows: list[tuple[str, list[int]]] = []
        for server, endpoint in pods:
            if not endpoint:
                continue  # nothing can be pulled from this pod
            for chain in server.warm_chains(limit):
                rows.append((endpoint, chain))
        # Hottest first = longest resident chains: the revival budget goes
        # to the prefixes whose recompute would cost the most.
        rows.sort(key=lambda r: len(r[1]), reverse=True)
        return rows[:limit]

    def revive(
        self, pod_id: str, source_endpoint: str, chain_hashes: list[int]
    ) -> int:
        server = self.server(pod_id)
        if server is None:
            return 0
        return server.revive_chain(chain_hashes, source_endpoint)
