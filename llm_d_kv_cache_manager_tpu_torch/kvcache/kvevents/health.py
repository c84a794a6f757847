"""Fleet health: sequence-gap detection, liveness tracking, dead-pod sweep.

The indexer's view of the fleet is event-sourced and therefore only as
truthful as the event stream. Three failure modes rot it:

1. **Dropped events** — the publisher's bounded send retry drops batches on
   overflow; a lost ``BlockRemoved`` leaves phantom locality, a lost
   ``BlockStored`` hides real warmth. Every message carries a per-publisher
   ``seq``; this module tracks last-seen seq per (pod, model) and flags a
   *gap* whenever the stream skips forward — the pod's view is then
   **suspect** until an ``IndexSnapshot`` resync replaces it wholesale.
2. **Crashed pods** — a dead pod never emits its evictions, so its
   ``BlockStored`` entries would live in the index forever. Pods publish
   ``Heartbeat`` events; after ``pod_ttl_s`` of silence the sweeper evicts
   the pod from the index (``Index.evict_pod``) and the scorer filter stops
   returning it even before the sweep lands.
3. **Silent publisher drops** — a dropped batch with no later traffic never
   produces a detectable seq gap. Heartbeats carry the publisher's monotone
   ``dropped_batches`` count, so loss is detected even across idle periods.
4. **Draining/drained pods** — a pod mid-drain advertises
   ``draining`` in its heartbeats (routing should stop sending it new
   prefixes immediately) and publishes a ``PodDrained`` goodbye when the
   drain completes; the goodbye evicts the pod's entries at once instead of
   waiting out ``pod_ttl_s`` — a rolling restart must not serve stale
   locality for a TTL, nor does it need to.

All tracking is observation-only until configured: ``pod_ttl_s=0`` (the
default) disables expiry/sweeping entirely, and a pool without an attached
``FleetHealth`` behaves bit-identically to previous rounds.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ...utils import get_logger
from ..kvblock import Index
from ..metrics import collector

log = get_logger("kvcache.kvevents.health")


@dataclass
class FleetHealthConfig:
    #: seconds of silence after which a pod is expired and swept from the
    #: index. 0 (default) disables liveness expiry — observation only.
    pod_ttl_s: float = 0.0
    #: sweeper cadence; clamped to pod_ttl_s/4 when a TTL is set so expiry
    #: is detected well within one TTL.
    sweep_interval_s: float = 1.0


@dataclass
class _PodState:
    #: wall-clock time of the last message seen from this pod (any event)
    last_seen: float = 0.0
    #: last-seen publisher seq per model topic
    last_seq: dict[str, int] = field(default_factory=dict)
    #: gap (or reported drop) observed and not yet repaired by a resync
    suspect: bool = False
    #: swept from the index by the TTL sweeper; clears on any new message
    swept: bool = False
    #: last publisher-reported dropped_batches count (from Heartbeat)
    reported_drops: int = 0
    #: pod advertised draining via heartbeat — routable no longer, but its
    #: entries stay until the PodDrained goodbye (or TTL) evicts them
    draining: bool = False
    #: pod published its PodDrained goodbye; treated as expired immediately.
    #: Clears on any new message (the pod restarted under the same identity).
    drained: bool = False
    #: serving role advertised via heartbeat ("prefill"/"decode"/
    #: "kvstore"); None = mixed/unknown — eligible for every placement
    #: (observation-only default). Set AND cleared by heartbeats, the
    #: authoritative carrier. ``kvstore`` pods are excluded from EVERY
    #: serving placement: they hold demoted blocks, they never serve.
    role: Optional[str] = None
    #: remote-tier headroom the pod last advertised (pages its remote
    #: store will still accept); None = never advertised (REMOTE_TIER off)
    headroom: Optional[int] = None
    #: blocks revoked from this pod by BadBlock events (KV_INTEGRITY) —
    #: a climbing count is the bad-block-storm signal the runbook keys on
    bad_blocks: int = 0


class FleetHealth:
    """Per-pod liveness + stream-integrity tracker shared by the ingestion
    pool (writer), the sweeper thread, and the scorer read path (filter)."""

    def __init__(
        self,
        config: Optional[FleetHealthConfig] = None,
        *,
        clock=time.monotonic,
    ):
        self.config = config or FleetHealthConfig()
        self._clock = clock
        self._mu = threading.Lock()
        self._pods: dict[str, _PodState] = {}  # guarded_by: _mu
        # Monotone counters (mirrored into the metrics collector).
        self.gaps_detected = 0  # guarded_by: _mu
        self.resyncs_applied = 0  # guarded_by: _mu
        self.pods_swept = 0  # guarded_by: _mu
        self.heartbeats_seen = 0  # guarded_by: _mu
        self.publisher_drops_reported = 0  # guarded_by: _mu
        self.pods_drained = 0  # guarded_by: _mu
        self.prefills_completed = 0  # guarded_by: _mu
        #: total blocks revoked by BadBlock events (KV_INTEGRITY)
        self.bad_blocks_reported = 0  # guarded_by: _mu
        #: fleet-controller membership changes (observe_pod_added/_removed)
        self.pods_added = 0  # guarded_by: _mu
        self.pods_removed = 0  # guarded_by: _mu
        #: sticky "a kvstore role has ever been advertised" latch: lets the
        #: role-blind (placement=None) filter keep its zero-lookup fast
        #: path on fleets with no remote tier — the overwhelmingly common
        #: case — while kvstore fleets pay the role cut they need.
        self._any_kvstore = False  # guarded_by: _mu
        self._sweep_thread: Optional[threading.Thread] = None
        self._sweep_stop = threading.Event()
        #: optional observer ``(pod) -> None`` fired after a dead pod is
        #: swept from the index (the OBS_LIFECYCLE ledger ends the pod's
        #: tracked residencies through it). Called OUTSIDE the lock; a
        #: raising observer must not break the sweep.
        self.on_pod_swept = None

    # -- ingestion-side observations (called from pool workers) -------------
    def observe_message(self, pod: str, model: str, seq: int) -> bool:
        """Record a message arrival; returns True when a seq gap was
        detected (caller marks the pod's view suspect → resync repairs)."""
        now = self._clock()
        gap = False
        with self._mu:
            st = self._pods.setdefault(pod, _PodState())
            st.last_seen = now
            st.swept = False  # pod is alive again — revive it
            if st.drained:
                # Traffic after a PodDrained goodbye = the pod restarted
                # under the same identity: fully resurrect it (a sticky
                # draining flag would otherwise unroute the new pod until
                # its first non-draining heartbeat — forever, when
                # heartbeats are disabled).
                st.drained = False
                st.draining = False
            last = st.last_seq.get(model)
            if last is not None and seq > last + 1:
                gap = True
                st.suspect = True
                self.gaps_detected += 1
            elif last is not None and seq < last and seq > 0:
                # Regression: a publisher restart whose seq-0 message was
                # itself lost (the loss case this module exists for), or
                # out-of-order redelivery. Flag ONE gap and REBASE to the
                # new stream — keeping the old high-water mark would flag
                # every subsequent message of a restarted stream as a
                # fresh gap until it passed the old count (a WARN storm
                # that re-marks the pod suspect after every resync).
                # Rebasing costs at most one extra catch-up gap if the
                # regression was a genuine straggler; both paths end in
                # the same repair (suspect → resync).
                gap = True
                st.suspect = True
                self.gaps_detected += 1
            st.last_seq[model] = seq
        if gap:
            collector.bump("fleet_gaps")
            collector.fleet_gaps.inc()
            log.warning(
                "event seq gap detected; pod view suspect until resync",
                pod=pod, model=model, seq=seq,
            )
        return gap

    def observe_heartbeat(
        self,
        pod: str,
        dropped_batches: int,
        draining: bool = False,
        role: Optional[str] = None,
        headroom: Optional[int] = None,
    ) -> None:
        """A heartbeat proves liveness and reports the publisher's drop
        count; an increase means batches were lost even if no later seq
        ever reveals the gap. ``draining`` advertises a mid-drain pod —
        the scorer stops returning it immediately (set AND cleared here:
        heartbeats are the authoritative carrier of drain intent).
        ``role`` advertises the pod's serving tier for the placement
        filter; None (mixed/legacy heartbeats) clears it. ``headroom``
        advertises remote-store acceptance capacity (demotion-target
        selection + observability); None leaves the last value — a legacy
        heartbeat from a pod that flipped the knob off mid-run is
        indistinguishable from one that predates it, and zeroing on
        absence would erase real advertisements under mixed fleets."""
        with self._mu:
            st = self._pods.setdefault(pod, _PodState())
            st.last_seen = self._clock()
            st.swept = False
            st.draining = draining
            st.role = role if role in ("prefill", "decode", "kvstore") else None
            if st.role == "kvstore":
                self._any_kvstore = True
            if headroom is not None:
                st.headroom = max(int(headroom), 0)
            self.heartbeats_seen += 1
            if dropped_batches < st.reported_drops:
                # Publisher restart: its drop counter restarted too. Rebase
                # the baseline or the new publisher's first drops (up to
                # the old total) would be silently masked. Drops that
                # happened before this first post-restart heartbeat still
                # surface as seq gaps via observe_message.
                st.reported_drops = dropped_batches
            new_drops = dropped_batches - st.reported_drops
            if new_drops:
                st.reported_drops = dropped_batches
                st.suspect = True
                self.publisher_drops_reported += new_drops
        if new_drops:
            collector.bump("fleet_publisher_drops", new_drops)
            collector.fleet_publisher_drops.inc(new_drops)
            log.warning(
                "publisher reported dropped batches; pod view suspect",
                pod=pod, new_drops=new_drops, total=dropped_batches,
            )

    def observe_resync(self, pod: str) -> None:
        """An ``IndexSnapshot`` replaced the pod's view — clear suspicion."""
        with self._mu:
            st = self._pods.setdefault(pod, _PodState())
            st.last_seen = self._clock()
            st.suspect = False
            st.swept = False
            self.resyncs_applied += 1
        collector.bump("fleet_resyncs")
        collector.fleet_resyncs.inc()

    def observe_drained(self, pod: str) -> None:
        """A ``PodDrained`` goodbye: the pod finished draining and its
        entries have been evicted — treat it as expired immediately (no
        ``pod_ttl_s`` wait) until it is heard from again."""
        with self._mu:
            st = self._pods.setdefault(pod, _PodState())
            st.last_seen = self._clock()
            st.drained = True
            st.draining = False  # the drain completed; drained supersedes
            st.suspect = False  # its view is now empty, nothing to repair
            self.pods_drained += 1
        collector.bump("fleet_pods_drained")
        collector.fleet_pods_drained.inc()
        log.warning("pod drained; evicted from routing immediately", pod=pod)

    # -- fleet-controller membership (kvcache/controller) -------------------
    def observe_pod_added(self, pod: str) -> None:
        """A fleet-controller scale-up provisioned this pod: register it
        live immediately, so routing can count on it before its first
        heartbeat lands (a cold TTL wait on a pod the controller just
        revived warm would waste exactly the revival)."""
        with self._mu:
            st = self._pods.setdefault(pod, _PodState())
            st.last_seen = self._clock()
            st.swept = False
            st.drained = False
            st.draining = False
            self.pods_added += 1

    def observe_pod_removed(self, pod: str) -> None:
        """A fleet-controller scale-down is retiring this pod: unroute it
        NOW, before its drain even starts — the live migrations moving its
        sequences must not race fresh placements onto the victim. The
        ``PodDrained`` goodbye (or the TTL) finishes the eviction."""
        with self._mu:
            st = self._pods.setdefault(pod, _PodState())
            st.last_seen = self._clock()
            st.draining = True
            self.pods_removed += 1

    def observe_bad_block(self, pod: str, count: int = 1) -> None:
        """A ``BadBlock`` revocation named ``pod`` as the holder of
        ``count`` corrupt copies (KV_INTEGRITY). Pure observation — the
        ingestion pool already evicted the index entries; this keeps the
        per-pod tally the bad-block-storm runbook reads. Deliberately does
        NOT touch liveness: the event proves the DETECTOR is alive, not
        the holder."""
        with self._mu:
            st = self._pods.setdefault(pod, _PodState())
            st.bad_blocks += count
            self.bad_blocks_reported += count

    def observe_prefill_complete(self, pod: str) -> None:
        """A ``PrefillComplete`` event: a prefill-role pod finished a
        request's ingest and its chain is exportable — handoff supply for
        disaggregated serving (counted; the chain's own BlockStored events
        carry the locality)."""
        with self._mu:
            st = self._pods.setdefault(pod, _PodState())
            st.last_seen = self._clock()
            st.swept = False
            self.prefills_completed += 1

    # -- read-side queries ---------------------------------------------------
    def is_expired(self, pod: str) -> bool:
        """True when the pod passed its TTL (or was swept, or said its
        ``PodDrained`` goodbye) and has not been heard from since. Unknown
        pods are NOT expired: entries may predate this monitor's
        attachment, and expiring them would break the observation-only
        default."""
        ttl = self.config.pod_ttl_s
        with self._mu:
            st = self._pods.get(pod)
            if st is None:
                return False
            if st.swept or st.drained:
                return True
            if ttl <= 0:
                return False
            return (self._clock() - st.last_seen) > ttl

    def is_suspect(self, pod: str) -> bool:
        with self._mu:
            st = self._pods.get(pod)
            return bool(st and st.suspect)

    def is_draining(self, pod: str) -> bool:
        with self._mu:
            st = self._pods.get(pod)
            return bool(st and (st.draining or st.drained))

    def is_routable(self, pod: str) -> bool:
        """Should routing consider this pod at all? Excludes expired pods
        (TTL/swept/drained) and pods advertising a drain in progress —
        sending a new prefix to a pod that will evict it in seconds just
        burns the transfer and the client's retry. One lock acquisition
        (not is_expired + is_draining): this runs per pod on the scoring
        hot path, contended with the ingestion workers."""
        ttl = self.config.pod_ttl_s
        with self._mu:
            st = self._pods.get(pod)
            if st is None:
                return True  # unknown pods stay routable (observation-only)
            if st.swept or st.drained or st.draining:
                return False
            if ttl <= 0:
                return True
            return (self._clock() - st.last_seen) <= ttl

    def signal_views(
        self, pods: Optional[Sequence[str]] = None
    ) -> dict[str, dict]:
        """Predictor-facing snapshot in ONE locked cut: per-pod signal
        age (the staleness gate's input — signals older than 2x the
        heartbeat cadence decay to conservative defaults), draining/
        expired state, and advertised role — the HTTP-deployment hook
        for assembling ``predictor.PodSignals`` (queue depth and the
        prefill-rate EMA ride the serving plane's own telemetry; this
        carries the heartbeat-derived half). ``pods`` scopes the locked
        walk to the named pods (the per-request path names a handful;
        an O(fleet) cut per scoring request would scale lock-hold time
        with fleet size); None walks everything (selection cadence).
        Like ``pod_views``, a point-in-time read."""
        ttl = self.config.pod_ttl_s
        now = self._clock()
        with self._mu:
            items = (
                [(p, self._pods[p]) for p in pods if p in self._pods]
                if pods is not None
                else list(self._pods.items())
            )
            return {
                pod: {
                    "age_s": (
                        max(now - st.last_seen, 0.0)
                        if st.last_seen > 0
                        else None
                    ),
                    "draining": st.draining or st.drained,
                    "expired": bool(
                        st.swept
                        or st.drained
                        or (ttl > 0 and (now - st.last_seen) > ttl)
                    ),
                    "role": st.role,
                }
                for pod, st in items
            }

    def role_of(self, pod: str) -> Optional[str]:
        """The pod's heartbeat-advertised role ("prefill"/"decode"/
        "kvstore"), or None for mixed/unknown pods."""
        with self._mu:
            st = self._pods.get(pod)
            return st.role if st is not None else None

    def headroom_of(self, pod: str) -> Optional[int]:
        """Remote-store headroom the pod last advertised (pages), or None
        when it never has (REMOTE_TIER off / pre-knob fleet)."""
        with self._mu:
            st = self._pods.get(pod)
            return st.headroom if st is not None else None

    def remote_targets(self) -> dict[str, int]:
        """Demotion-target view: every routable-alive pod that has
        advertised remote headroom, with the last advertised value —
        kvstore pods first-class, but serving peers with headroom count
        too. Like ``pod_views``, this is the HTTP-deployment hook (a
        control plane assembling ``REMOTE_PEERS`` for the fleet from
        heartbeat state); the in-process pusher ranks its static peer
        list by push-ack headroom instead. One locked cut
        (scrape/selection cadence, not per event)."""
        ttl = self.config.pod_ttl_s
        now = self._clock()
        with self._mu:
            return {
                pod: st.headroom
                for pod, st in self._pods.items()
                if st.headroom is not None
                and not (st.swept or st.drained or st.draining)
                and not (ttl > 0 and (now - st.last_seen) > ttl)
            }

    def filter_scores(
        self, scores: dict[str, int], placement: Optional[str] = None
    ) -> dict[str, int]:
        """Drop expired and draining pods from a score map — the guarantee
        that routing never targets a pod past its TTL (even before the
        sweeper lands) nor one that advertised a drain in progress.
        ``placement`` ("prefill"/"decode"; None = legacy, role-blind)
        additionally excludes pods whose advertised role cannot serve that
        tier — a prefill-only pod must never win decode placement. A
        ``kvstore`` pod (remote-tier holder) serves NOTHING and is
        excluded from every SERVING placement, including the role-blind
        legacy one — its warmth is reachable only as a pull source.
        ``placement="pull_source"`` is that read path: no role exclusion
        at all (any pod may export its chains over the transfer fabric),
        only the liveness gate — a remote-arm query for the holders'
        warmth must not be blanked by the very filter that keeps them out
        of serving."""
        if not scores:
            return scores
        if placement == "pull_source":
            wrong: set = set()
            roles: dict[str, Optional[str]] = {}
        elif placement is None:
            # One locked cut for the latch AND (when needed) the roles —
            # this runs per scoring request, and a second acquisition
            # would double the lock churn is_routable already pays.
            with self._mu:
                roles = (
                    {
                        p: (st.role if (st := self._pods.get(p)) else None)
                        for p in scores
                    }
                    if self._any_kvstore
                    else {}
                )
            wrong = {"kvstore"}
        else:
            with self._mu:
                roles = {
                    p: (st.role if (st := self._pods.get(p)) else None)
                    for p in scores
                }
            wrong = {
                "kvstore",
                "prefill" if placement == "decode" else "decode",
            }
        out = {
            p: s
            for p, s in scores.items()
            if roles.get(p) not in wrong and self.is_routable(p)
        }
        return out if len(out) != len(scores) else scores

    def pod_views(self) -> dict[str, dict]:
        """Planner-facing snapshot: per-pod role/draining/expired state in
        one locked cut. This (with ``role_of``) is the HTTP-deployment
        hook for assembling ``router.PodView``s from heartbeat state at a
        scorer-embedded planner; the in-process coordinator builds its
        views from live ``PodServer`` attributes instead
        (``disagg.views_from_pods``)."""
        ttl = self.config.pod_ttl_s
        now = self._clock()
        with self._mu:
            return {
                pod: {
                    "role": st.role,
                    "draining": st.draining or st.drained,
                    "expired": bool(
                        st.swept
                        or st.drained
                        or (ttl > 0 and (now - st.last_seen) > ttl)
                    ),
                }
                for pod, st in self._pods.items()
            }

    def scrape_views(self, pods: Sequence[str]) -> dict[str, dict]:
        """Federator-facing liveness cut (``OBS_FED``): per registered
        scrape target, is the pod worth polling at all? ONE locked walk
        over the named pods — a fleet scrape must not pay N ``is_expired``
        acquisitions against the ingestion workers. Unlike ``pod_views``
        this covers pods the monitor has never heard from (``known:
        False``, not expired — the observation-only default: a target the
        operator registered but no event has named yet still gets
        scraped). An ``expired`` pod is skipped by the scrape outright,
        so a dead pod costs one skip, not one timeout per surface."""
        ttl = self.config.pod_ttl_s
        now = self._clock()
        with self._mu:
            out = {}
            for pod in pods:
                st = self._pods.get(pod)
                if st is None:
                    out[pod] = {
                        "known": False,
                        "expired": False,
                        "suspect": False,
                        "draining": False,
                        "age_s": None,
                    }
                    continue
                out[pod] = {
                    "known": True,
                    "expired": bool(
                        st.swept
                        or st.drained
                        or (ttl > 0 and (now - st.last_seen) > ttl)
                    ),
                    "suspect": st.suspect,
                    "draining": st.draining or st.drained,
                    "age_s": (
                        round(max(now - st.last_seen, 0.0), 3)
                        if st.last_seen > 0
                        else None
                    ),
                }
            return out

    def snapshot(self) -> dict:
        """Counters + per-pod state for ``/stats``."""
        with self._mu:
            pods = {
                pod: {
                    "suspect": st.suspect,
                    "swept": st.swept,
                    "draining": st.draining,
                    "drained": st.drained,
                    "age_s": round(self._clock() - st.last_seen, 3),
                    # Role/headroom keys only for advertising pods: a
                    # knob-less fleet's snapshot payload stays bit-identical
                    # legacy.
                    **({"role": st.role} if st.role is not None else {}),
                    **(
                        {"headroom": st.headroom}
                        if st.headroom is not None
                        else {}
                    ),
                    # Key only for pods with revoked blocks: knob-less
                    # fleets keep bit-identical snapshot payloads.
                    **(
                        {"bad_blocks": st.bad_blocks}
                        if st.bad_blocks
                        else {}
                    ),
                }
                for pod, st in self._pods.items()
            }
            # Counters read under the same lock as the per-pod state so one
            # scrape is a consistent cut (found by kvlint lock-discipline:
            # the unguarded reads could pair a new counter with old state).
            return {
                "pod_ttl_s": self.config.pod_ttl_s,
                "gaps_detected": self.gaps_detected,
                "resyncs_applied": self.resyncs_applied,
                "pods_swept": self.pods_swept,
                "heartbeats_seen": self.heartbeats_seen,
                "publisher_drops_reported": self.publisher_drops_reported,
                "pods_drained": self.pods_drained,
                # Key appears only once disagg traffic exists: the no-knobs
                # /stats payload keeps its legacy field set.
                **(
                    {"prefills_completed": self.prefills_completed}
                    if self.prefills_completed
                    else {}
                ),
                # Same rule: key appears only once a BadBlock landed.
                **(
                    {"bad_blocks_reported": self.bad_blocks_reported}
                    if self.bad_blocks_reported
                    else {}
                ),
                # Same rule: keys appear only once a fleet controller has
                # actually resized the fleet.
                **(
                    {"pods_added": self.pods_added} if self.pods_added else {}
                ),
                **(
                    {"pods_removed": self.pods_removed}
                    if self.pods_removed
                    else {}
                ),
                "pods": pods,
            }

    # -- dead-pod sweeper ----------------------------------------------------
    def sweep(self, index: Index) -> list[str]:
        """Evict every TTL-expired pod from the index (one shot). Returns
        the pods swept. Safe to call concurrently with ingestion: a revived
        pod's later events re-add its entries, same eventual-consistency
        contract as normal eviction."""
        ttl = self.config.pod_ttl_s
        if ttl <= 0:
            return []
        now = self._clock()
        with self._mu:
            stale = [
                pod
                for pod, st in self._pods.items()
                if not st.swept and (now - st.last_seen) > ttl
            ]
            for pod in stale:
                self._pods[pod].swept = True
        swept = []
        for pod in stale:
            try:
                index.evict_pod(pod)
            except Exception:
                # Un-mark so the next sweep retries; routing stays safe
                # meanwhile because is_expired() is true via the TTL check
                # regardless of the swept flag.
                log.exception("dead-pod sweep failed", pod=pod)
                with self._mu:
                    st = self._pods.get(pod)
                    if st is not None:
                        st.swept = False
                continue
            swept.append(pod)
            with self._mu:
                self.pods_swept += 1
            collector.bump("fleet_pods_swept")
            collector.fleet_pods_swept.inc()
            cb = self.on_pod_swept
            if cb is not None:
                try:
                    cb(pod)
                except Exception:
                    log.exception("on_pod_swept observer failed", pod=pod)
            log.warning("swept dead pod from index", pod=pod, ttl_s=ttl)
        return swept

    def start_sweeper(self, index: Index) -> None:
        """Background TTL sweeper (idempotent; no-op when pod_ttl_s == 0)."""
        if self.config.pod_ttl_s <= 0:
            return
        if self._sweep_thread is not None and self._sweep_thread.is_alive():
            return
        interval = min(
            self.config.sweep_interval_s, max(self.config.pod_ttl_s / 4, 0.01)
        )
        self._sweep_stop.clear()

        def run():
            while not self._sweep_stop.wait(interval):
                self.sweep(index)

        self._sweep_thread = threading.Thread(
            target=run, name="fleet-health-sweeper", daemon=True
        )
        self._sweep_thread.start()

    def stop_sweeper(self) -> None:
        self._sweep_stop.set()
        if self._sweep_thread is not None:
            self._sweep_thread.join(timeout=5)
            self._sweep_thread = None
