"""MRC-driven cache-aware fleet autoscaling with live KV migration.

The reconcile loop reads two fleet signals the observability planes
already export — SLO burn rates (``kvcache_slo_burn_rate``, the
``OBS_SLO`` recorder) and the fleet-aggregated miss-ratio curve (the
``OBS_LIFECYCLE`` reuse-distance estimator, merged by
``aggregate_mrc``) — and decides pod count:

- **scale up** when the burn rate crosses ``burn_threshold`` AND the MRC
  predicts real hit-rate headroom at one more pod's capacity: latency is
  burning *and* more cache would actually absorb it. A burning fleet
  whose curve is flat is compute-bound, not cache-bound — the controller
  records the blocked decision (the operator's cue to scale compute or
  shed load) instead of buying pages that cannot help. The new pod is
  revived warm: the survivors' ``IndexSnapshot`` digests name their hot
  chains, and targeted pulls over the transfer fabric seed the newcomer
  before the router starts counting on its hit rate.
- **scale down** when the burn rate is comfortably idle (a quarter of
  the threshold) and the curve is flat at current capacity — the last
  pod's pages are not earning their keep. The victim's in-flight decode
  sequences are LIVE-MIGRATED to survivors (``PodServer.migrate_out``:
  full KV chain + decode state over the transfer fabric, resumed
  mid-sequence with greedy-parity output), so scale-down completes in
  transfer time instead of a drain's worth of decode tail; any failed
  migration falls back to finishing locally under the normal drain.

Both directions share one hysteresis clock: after ANY scaling action the
controller holds for ``hysteresis_s`` — a burst that triggers scale-up
the moment a scale-down finishes cannot flap the fleet.

Everything is off by default: ``FLEET_CONTROLLER`` unset builds no
controller, starts no thread, and every pod behaves — and speaks on
every wire — bit-identically to the legacy fleet. The controller talks
to its fleet through the small ``FleetAdapter`` surface below, so the
decision logic is identical whether the pods are in-process
(``InProcessFleet``: tests, bench, single-host) or a deployment
environment's replica set.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

from ...utils import get_logger
from .mrc import aggregate_mrc, hit_rate_at

log = get_logger("kvcache.controller.fleet")


@dataclass
class PodSignals:
    """One pod's controller-relevant state, as the adapter observed it."""

    pod_id: str
    #: the pod's transfer endpoint (migration/revival target), None when
    #: the pod exports nothing — it can still be scaled away, but nothing
    #: can be migrated or revived *to* it
    transfer_endpoint: Optional[str] = None
    #: usable HBM page capacity (total_pages - 1, the allocator's view)
    capacity_blocks: int = 0
    #: ``SLORecorder.burn_rates()`` shape, None when OBS_SLO is off
    burn_rates: Optional[dict] = None
    #: ``/debug/mrc`` payload shape, None when OBS_LIFECYCLE is off
    mrc: Optional[dict] = None
    #: request ids of live (admitted, unfinished) sequences
    live_requests: list[str] = field(default_factory=list)
    #: pod is already draining — never a migration target, never a victim
    draining: bool = False


class FleetAdapter(Protocol):
    """What the controller needs from its deployment environment."""

    def observe(self) -> list[PodSignals]:
        """Current signals for every active pod."""

    def add_pod(self) -> Optional[PodSignals]:
        """Provision one pod; None when the environment cannot."""

    def migrate(
        self, pod_id: str, request_id: str, target_endpoint: str
    ) -> bool:
        """Live-migrate one request off ``pod_id``; True when the target
        resumed it (False = it resumes locally and drains out)."""

    def retire(self, pod_id: str) -> None:
        """Drain and decommission ``pod_id`` (stragglers the migrations
        missed finish under the pod's own drain)."""

    def warm_sets(self, limit: int) -> list[tuple[str, list[int]]]:
        """Hot chains to revive on a new pod: ``(donor transfer endpoint,
        chain block hashes)`` rows, hottest first."""

    def revive(
        self, pod_id: str, source_endpoint: str, chain_hashes: list[int]
    ) -> int:
        """Pull one chain onto ``pod_id`` from a donor; blocks imported."""


@dataclass
class FleetControllerConfig:
    #: master switch (``FLEET_CONTROLLER``); off = nothing constructed
    enabled: bool = False
    #: reconcile cadence (``FLEET_RECONCILE_INTERVAL_S``)
    reconcile_interval_s: float = 5.0
    #: fleet-max burn rate (any objective, any window) at or over which
    #: the fleet is burning (``FLEET_BURN_THRESHOLD``); scale-down
    #: requires calm — burn under a quarter of this
    burn_threshold: float = 2.0
    #: minimum predicted hit-rate gain (scale-up) or loss (scale-down)
    #: one pod's capacity must make on the fleet MRC
    #: (``FLEET_MRC_HEADROOM``)
    mrc_headroom: float = 0.02
    #: hold-down after ANY scaling action (``FLEET_HYSTERESIS_S``)
    hysteresis_s: float = 60.0
    #: pod-count floor/ceiling (``FLEET_MIN_PODS``/``FLEET_MAX_PODS``)
    min_pods: int = 1
    max_pods: int = 8
    #: warm-revival budget per scale-up: at most this many chains pulled
    revive_chains: int = 8

    @classmethod
    def from_env(cls) -> "FleetControllerConfig":
        cfg = cls()
        cfg.enabled = os.environ.get("FLEET_CONTROLLER", "0").lower() in (
            "1",
            "true",
            "yes",
        )
        cfg.reconcile_interval_s = float(
            os.environ.get("FLEET_RECONCILE_INTERVAL_S", cfg.reconcile_interval_s)
        )
        cfg.burn_threshold = float(
            os.environ.get("FLEET_BURN_THRESHOLD", cfg.burn_threshold)
        )
        cfg.mrc_headroom = float(
            os.environ.get("FLEET_MRC_HEADROOM", cfg.mrc_headroom)
        )
        cfg.hysteresis_s = float(
            os.environ.get("FLEET_HYSTERESIS_S", cfg.hysteresis_s)
        )
        cfg.min_pods = int(os.environ.get("FLEET_MIN_PODS", cfg.min_pods))
        cfg.max_pods = int(os.environ.get("FLEET_MAX_PODS", cfg.max_pods))
        return cfg


@dataclass
class FleetDecision:
    """One reconcile pass's verdict — also the flight-recorder row."""

    action: str  # "scale_up" | "scale_down" | "hold"
    reason: str
    pods: int
    burn: Optional[float] = None
    #: predicted fleet hit rate at current capacity / one pod more / less
    hit_now: Optional[float] = None
    hit_up: Optional[float] = None
    hit_down: Optional[float] = None
    #: scale-down victim / scale-up newcomer
    pod_id: Optional[str] = None
    migrated: int = 0
    migration_fallbacks: int = 0
    revived_blocks: int = 0

    def as_attrs(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if v is not None}


def fleet_burn(pods: list[PodSignals]) -> Optional[float]:
    """The fleet's burn rate: max over pods, objectives, and windows —
    one pod burning IS the fleet burning (the router sent it that
    traffic). None when no pod reports any measured window."""
    worst: Optional[float] = None
    for pod in pods:
        for windows in (pod.burn_rates or {}).values():
            for rate in windows.values():
                if rate is not None and (worst is None or rate > worst):
                    worst = rate
    return worst


class FleetController:
    """The reconcile loop: observe → decide → act, with hysteresis.

    ``reconcile()`` is one synchronous pass (what the tests and the bench
    co-sim drive directly); ``start()`` runs it on a daemon thread every
    ``reconcile_interval_s``. ``flight`` (an ``obs.flight.FlightRecorder``,
    optional) receives one ``scale_up``/``scale_down`` event per scaling
    action — the postmortem trail for "why did the fleet resize".
    """

    def __init__(
        self,
        config: FleetControllerConfig,
        adapter: FleetAdapter,
        flight=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config
        self.adapter = adapter
        self.flight = flight
        self._clock = clock
        self._mu = threading.Lock()
        self._last_action_t: Optional[float] = None  # guarded_by: _mu
        self.decisions: deque = deque(maxlen=256)  # guarded_by: _mu
        self.reconciles = 0  # guarded_by: _mu
        self.scale_ups = 0  # guarded_by: _mu
        self.scale_downs = 0  # guarded_by: _mu
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the decision --------------------------------------------------------
    def _decide(self, pods: list[PodSignals]) -> FleetDecision:
        """Pure decision over one observation (no side effects): what the
        flap test pins. Capacities are evaluated per pod-quantum — the
        mean pod's usable pages — because that is the unit a scaling
        action actually adds or removes."""
        cfg = self.config
        n = len(pods)
        burn = fleet_burn(pods)
        agg = aggregate_mrc({p.pod_id: p.mrc for p in pods})
        cap_now = sum(p.capacity_blocks for p in pods)
        quantum = cap_now // n if n else 0
        hit_now = hit_rate_at(agg["curve"], cap_now) if cap_now else None
        hit_up = (
            hit_rate_at(agg["curve"], cap_now + quantum) if quantum else None
        )
        hit_down = (
            hit_rate_at(agg["curve"], cap_now - quantum)
            if quantum and n > 1
            else None
        )
        base = dict(
            pods=n, burn=burn, hit_now=hit_now, hit_up=hit_up,
            hit_down=hit_down,
        )

        with self._mu:
            held = (
                self._last_action_t is not None
                and self._clock() - self._last_action_t < cfg.hysteresis_s
            )
        if held:
            return FleetDecision("hold", "hysteresis", **base)

        burning = burn is not None and burn >= cfg.burn_threshold
        if burning:
            if n >= cfg.max_pods:
                return FleetDecision("hold", "burning_at_max_pods", **base)
            if hit_now is None or hit_up is None:
                return FleetDecision("hold", "burning_no_mrc", **base)
            if hit_up - hit_now < cfg.mrc_headroom:
                # Latency burns but the curve is flat: more cache cannot
                # absorb it — compute-bound, the operator's call.
                return FleetDecision("hold", "burning_mrc_flat", **base)
            return FleetDecision("scale_up", "burn_with_mrc_headroom", **base)

        calm = burn is None or burn <= cfg.burn_threshold / 4.0
        if (
            calm
            and n > cfg.min_pods
            and hit_now is not None
            and hit_down is not None
            and hit_now - hit_down < cfg.mrc_headroom
        ):
            return FleetDecision("scale_down", "idle_mrc_flat", **base)
        return FleetDecision("hold", "steady", **base)

    # -- the actions ---------------------------------------------------------
    def _pick_victim(self, pods: list[PodSignals]) -> Optional[PodSignals]:
        """Cheapest pod to remove: fewest live sequences to migrate (ties
        to the smallest capacity — evicting the least cache)."""
        candidates = [p for p in pods if not p.draining]
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda p: (len(p.live_requests), p.capacity_blocks),
        )

    def _scale_down(
        self, pods: list[PodSignals], decision: FleetDecision
    ) -> FleetDecision:
        victim = self._pick_victim(pods)
        if victim is None:
            decision.action, decision.reason = "hold", "no_victim"
            return decision
        decision.pod_id = victim.pod_id
        survivors = [
            p
            for p in pods
            if p.pod_id != victim.pod_id
            and not p.draining
            and p.transfer_endpoint
        ]
        # Spread the victim's sequences across survivors, least-loaded
        # first; a survivor that refuses (draining, admission caps) just
        # means that sequence finishes locally under the drain.
        load = {p.pod_id: len(p.live_requests) for p in survivors}
        for rid in victim.live_requests:
            if not survivors:
                decision.migration_fallbacks += 1
                continue
            target = min(survivors, key=lambda p: load[p.pod_id])
            ok = False
            try:
                ok = self.adapter.migrate(
                    victim.pod_id, rid, target.transfer_endpoint
                )
            except Exception:
                log.exception(
                    "migration failed", request=rid, victim=victim.pod_id
                )
            if ok:
                decision.migrated += 1
                load[target.pod_id] += 1
            else:
                decision.migration_fallbacks += 1
        try:
            self.adapter.retire(victim.pod_id)
        except Exception:
            log.exception("retire failed", victim=victim.pod_id)
            decision.action, decision.reason = "hold", "retire_failed"
            return decision
        with self._mu:
            self.scale_downs += 1
        return decision

    def _scale_up(
        self, pods: list[PodSignals], decision: FleetDecision
    ) -> FleetDecision:
        try:
            newcomer = self.adapter.add_pod()
        except Exception:
            log.exception("add_pod failed")
            newcomer = None
        if newcomer is None:
            decision.action, decision.reason = "hold", "add_pod_failed"
            return decision
        decision.pod_id = newcomer.pod_id
        # Warm revival: seed the newcomer with the fleet's hot chains so
        # the router's next MRC read shows the capacity actually earning
        # hits instead of a cold pod dragging the aggregate down.
        try:
            sets = self.adapter.warm_sets(self.config.revive_chains)
        except Exception:
            log.exception("warm_sets failed; new pod starts cold")
            sets = []
        for source_endpoint, hashes in sets[: self.config.revive_chains]:
            if not hashes:
                continue
            try:
                decision.revived_blocks += self.adapter.revive(
                    newcomer.pod_id, source_endpoint, list(hashes)
                )
            except Exception:
                log.exception(
                    "warm revival pull failed", source=source_endpoint
                )
        with self._mu:
            self.scale_ups += 1
        return decision

    # -- the loop ------------------------------------------------------------
    def reconcile(self) -> FleetDecision:
        """One observe → decide → act pass."""
        pods = [p for p in self.adapter.observe() if not p.draining]
        decision = self._decide(pods)
        if decision.action == "scale_down":
            decision = self._scale_down(pods, decision)
        elif decision.action == "scale_up":
            decision = self._scale_up(pods, decision)
        now = self._clock()
        with self._mu:
            self.reconciles += 1
            if decision.action in ("scale_up", "scale_down"):
                self._last_action_t = now
            self.decisions.append(decision)
        if decision.action in ("scale_up", "scale_down"):
            log.info("fleet scaling action", **decision.as_attrs())
            if self.flight is not None:
                self.flight.record_event(
                    decision.action, **decision.as_attrs()
                )
                self.flight.trigger(decision.action)
        return decision

    def start(self) -> None:
        if not self.config.enabled:
            return
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-controller", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.config.reconcile_interval_s):
            try:
                self.reconcile()
            except Exception:
                # The loop must survive any adapter fault: a controller
                # that dies silently leaves the fleet stuck at whatever
                # size the fault found it.
                log.exception("reconcile pass failed")

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "reconciles": self.reconciles,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "last_decision": (
                    self.decisions[-1].as_attrs() if self.decisions else None
                ),
            }
