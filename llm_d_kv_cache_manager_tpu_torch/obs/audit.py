"""Routing-quality observability: index staleness + predicted-vs-realized.

The system's value proposition rests on two claims nothing measured until
this module existed: the global block index is *fresh enough* (KV events
become index-visible fast enough that scores reflect reality), and the
scorer's longest-prefix prediction is *accurate enough* (the pod really
serves the cache hits the scoreboard promised). Two trackers close the
loop, both off by default (``OBS_AUDIT``) with bit-identical legacy
behavior when unattached:

- ``StalenessTracker`` — event-plane lag. Every ``EventBatch`` carries its
  publish timestamp; on ingest the tracker records publish→apply lag per
  (pod, event type) (``kvcache_index_staleness_seconds``) and, from the
  subscriber's per-publisher seq numbers, how many events each pod's
  stream is behind (received-but-not-applied,
  ``kvcache_index_events_behind``).
- ``RouteAuditor`` — prediction vs reality. The router records each
  decision's predicted matched-block count and scoreboard keyed by
  request id; the pod reports the realized prefix-cache hit count back (a
  trailing-append ``RequestAudit`` KV event, or a direct call in-process).
  The join yields the realized/predicted ratio histogram
  (``kvcache_route_predicted_vs_realized_blocks``), a per-decision regret
  counterfactual (best scoreboard entry minus chosen,
  ``kvcache_route_regret_blocks``), and — when realized < predicted — a
  miss attribution (``kvcache_route_miss_attributed_total{cause}``):

  * ``dead_pod_reroute`` — the request landed on (or the fleet now
    considers) a different/unroutable pod than the one scored;
  * ``never_stored``    — the index never claimed the chain on that pod
    (the prediction came from affinity memory, not stored blocks);
  * ``stale_index``     — the scored entries are gone from the index now:
    the blocks were evicted after scoring and the prediction aged out;
  * ``evicted_on_pod``  — the index still claims the blocks but the pod's
    ground truth disagrees: the pod evicted them locally and the index
    has not caught up (phantom locality, repaired by events/resync);
  * ``quarantined``     — (KV_INTEGRITY) a block in the scored
    chain was revoked by a ``BadBlock`` event since the decision: the
    miss is the integrity plane doing its job (the pod refused to serve
    a corrupt page and recomputed), not index staleness — attributing it
    as ``evicted_on_pod`` would send an operator chasing phantom
    locality during a bad-block storm.

The join also carries the predicted-TTFT loop: decisions
made by the ROUTE_PREDICT latency model record their modeled TTFT, joins
from in-process callers carry the realized TTFT, and the resulting
realized/predicted ratio is observed
(``kvcache_route_ttft_realized_over_predicted``) and fed to the model's
``PredictionCorrector`` — the audit plane acting as an actuator, not
just a dashboard.

Wall clock on purpose throughout: event publish timestamps cross the wire
and are compared across hosts, so the comparison clock must be the same
wall clock (injectable for tests and the bench's virtual clocks).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..kvcache.metrics import collector
from ..utils import get_logger

log = get_logger("obs.audit")

#: shared histogram bucket upper bounds for staleness seconds (the last
#: implicit bucket is +Inf) — ZMQ-hop lag is ms-scale when healthy,
#: seconds-scale when the ingest pool is drowning.
STALENESS_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

MISS_CAUSES = (
    "stale_index",
    "evicted_on_pod",
    "never_stored",
    "dead_pod_reroute",
    "quarantined",
)


def _percentile(samples: Sequence[float], q: float) -> Optional[float]:
    if not samples:
        return None
    s = sorted(samples)
    idx = min(int(q * len(s)), len(s) - 1)
    return s[idx]


class _LagHist:
    """Fixed-bucket histogram + count/sum/max (one per (pod, event))."""

    __slots__ = ("counts", "count", "sum", "max")

    def __init__(self):
        self.counts = [0] * (len(STALENESS_BUCKETS) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        for i, ub in enumerate(STALENESS_BUCKETS):
            if v <= ub:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.count += 1
        self.sum += v
        self.max = max(self.max, v)


class StalenessTracker:
    """Publish→index-visibility lag + events-behind, per pod.

    Attached to a ``KVEventsPool``: ``observe_received`` runs at enqueue
    (the subscriber-facing edge), ``observe_batch`` when a worker applies
    the batch. Unattached (the default) the pool touches nothing here.
    ``clock`` must be the same wall clock the publishers stamp batches
    with (``time.time`` in production; the bench injects its virtual
    clock).
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        max_samples: int = 8192,
        shard: str = "",
    ):
        """``shard`` labels every metric observation this tracker makes:
        "" (the default) on a single index; the sharded control plane runs
        one tracker per scorer shard so a drowning ingest lane is visible
        per shard."""
        self._clock = clock
        self.shard = shard
        self._mu = threading.Lock()
        #: (pod, event_tag) -> _LagHist
        self._hists: dict[tuple[str, str], _LagHist] = {}  # guarded_by: _mu
        #: recent lag samples (bounded) for percentile summaries
        self._samples: deque = deque(maxlen=max_samples)  # guarded_by: _mu
        self._received: dict[str, int] = {}  # pod -> last seq enqueued  # guarded_by: _mu
        self._applied: dict[str, int] = {}  # pod -> last seq applied  # guarded_by: _mu
        self.events_observed = 0  # guarded_by: _mu
        self.max_lag_s = 0.0  # guarded_by: _mu

    # -- pool-side observations ---------------------------------------------
    def observe_received(self, pod: str, seq: int) -> None:
        with self._mu:
            prev = self._received.get(pod)
            if prev is None:
                # Seed the applied high-water one below the first seq seen,
                # so enqueued-but-never-applied batches read as behind from
                # the start — a cold-start backlog (subscriber enqueuing a
                # storm the shard worker hasn't touched) must not read 0.
                self._applied.setdefault(pod, seq - 1)
            if prev is None or seq > prev:
                self._received[pod] = seq

    def observe_batch(
        self, pod: str, seq: int, publish_ts: float, event_tags: Sequence[str]
    ) -> None:
        """One decoded batch applied to the index: record publish→apply
        lag once per contained event, labeled by event type. ``ts <= 0``
        (legacy publishers that stamp nothing) records nothing — a bogus
        epoch delta would bury every real sample."""
        lag = self._clock() - publish_ts if publish_ts > 0 else None
        with self._mu:
            prev = self._applied.get(pod)
            if prev is None or seq > prev:
                self._applied[pod] = seq
            if lag is None:
                return
            lag = max(lag, 0.0)
            for tag in event_tags:
                self._hists.setdefault((pod, tag), _LagHist()).observe(lag)
                self.events_observed += 1
            self._samples.append(lag)
            self.max_lag_s = max(self.max_lag_s, lag)
        for tag in event_tags:
            collector.observe_staleness(pod, tag, lag, self.shard)

    # -- read side -----------------------------------------------------------
    def events_behind(self) -> dict[str, int]:
        """Per pod: events enqueued but not yet applied (subscriber seq
        high-water minus worker high-water). Mirrored into the
        ``kvcache_index_events_behind`` gauge by the caller's scrape."""
        with self._mu:
            out = {
                pod: max(seq - self._applied.get(pod, seq), 0)
                for pod, seq in self._received.items()
            }
        for pod, behind in out.items():
            collector.set_events_behind(pod, behind, self.shard)
        return out

    def percentiles(self, qs=(0.5, 0.99)) -> dict[str, Optional[float]]:
        with self._mu:
            samples = list(self._samples)
        return {f"p{int(q * 100)}": _percentile(samples, q) for q in qs}

    def snapshot(self) -> dict:
        """Compact summary for ``/stats``."""
        with self._mu:
            events = self.events_observed
            max_lag = self.max_lag_s
            samples = list(self._samples)
        return {
            "events_observed": events,
            "max_lag_s": round(max_lag, 6),
            "p50_lag_s": _percentile(samples, 0.5),
            "p99_lag_s": _percentile(samples, 0.99),
            "events_behind": self.events_behind(),
        }

    def detail(self) -> dict:
        """Full per-(pod, event) histograms for ``/debug/staleness``."""
        with self._mu:
            per = {
                f"{pod}/{tag}": {
                    "count": h.count,
                    "sum_s": round(h.sum, 6),
                    "max_s": round(h.max, 6),
                    "buckets": dict(
                        zip([str(b) for b in STALENESS_BUCKETS] + ["+Inf"], h.counts)
                    ),
                }
                for (pod, tag), h in self._hists.items()
            }
        return {
            "bucket_bounds_s": list(STALENESS_BUCKETS),
            "per_pod_event": per,
            **self.snapshot(),
        }


class MergedStaleness:
    """Read-side view over the sharded plane's per-shard trackers: the
    same ``events_behind``/``percentiles``/``snapshot``/``detail`` surface
    a single ``StalenessTracker`` offers, aggregated. Per-pod events-behind
    is the MAX across shard lanes (one event pending on three shards is
    one event behind, on the worst lane) PLUS the plane's admission-edge
    backlog (``admission``: batches admitted but not yet decoded/split —
    a lane's received high-water only advances at dispatch, so a drowning
    decode stage would otherwise read as quiet lanes); lag percentiles
    pool every shard's samples."""

    def __init__(
        self,
        trackers: Sequence[StalenessTracker],
        admission: Optional[Callable[[], dict]] = None,
    ):
        self.trackers = list(trackers)
        self.admission = admission

    def events_behind(self) -> dict[str, int]:
        merged: dict[str, int] = {}
        for t in self.trackers:
            for pod, behind in t.events_behind().items():
                merged[pod] = max(merged.get(pod, 0), behind)
        if self.admission is not None:
            for pod, behind in self.admission().items():
                merged[pod] = merged.get(pod, 0) + behind
                # the plane-level total rides the "" shard series (the
                # per-lane series carry their own shard labels)
                collector.set_events_behind(pod, merged[pod], "")
        return merged

    def _all_samples(self) -> list[float]:
        samples: list[float] = []
        for t in self.trackers:
            with t._mu:
                samples.extend(t._samples)
        return samples

    def percentiles(self, qs=(0.5, 0.99)) -> dict[str, Optional[float]]:
        samples = self._all_samples()
        return {f"p{int(q * 100)}": _percentile(samples, q) for q in qs}

    def snapshot(self) -> dict:
        samples = self._all_samples()
        return {
            "events_observed": sum(t.events_observed for t in self.trackers),
            "max_lag_s": round(max((t.max_lag_s for t in self.trackers), default=0.0), 6),
            "p50_lag_s": _percentile(samples, 0.5),
            "p99_lag_s": _percentile(samples, 0.99),
            "events_behind": self.events_behind(),
        }

    def detail(self) -> dict:
        return {
            "shards": {t.shard: t.detail() for t in self.trackers},
            **self.snapshot(),
        }


@dataclass
class AuditRecord:
    """One joined decision/outcome pair (the ``/debug/audit`` row)."""

    request_id: str
    chosen_pod: str
    realized_pod: str
    predicted_blocks: int
    realized_blocks: int
    decision: str
    regret_blocks: int
    #: realized/predicted; None when predicted == 0 (nothing promised)
    ratio: Optional[float]
    #: miss attribution; None when realized >= predicted
    cause: Optional[str]
    trace_id: Optional[str] = None
    #: wall-clock timestamps (decision / join) — display only
    decided_at: float = 0.0
    joined_at: float = 0.0
    #: predicted-TTFT routing (ROUTE_PREDICT): the latency model's
    #: per-decision claim, the realized TTFT the pod measured, and their
    #: realized/predicted ratio — None on legacy (score-max) decisions,
    #: and the row keys are then absent so knobs-off /debug/audit rows
    #: stay bit-identical
    predicted_ttft_s: Optional[float] = None
    realized_ttft_s: Optional[float] = None
    ttft_ratio: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "chosen_pod": self.chosen_pod,
            "realized_pod": self.realized_pod,
            "predicted_blocks": self.predicted_blocks,
            "realized_blocks": self.realized_blocks,
            "decision": self.decision,
            "regret_blocks": self.regret_blocks,
            "ratio": self.ratio,
            "cause": self.cause,
            "trace_id": self.trace_id,
            "decided_at": self.decided_at,
            "joined_at": self.joined_at,
            **(
                {
                    "predicted_ttft_s": self.predicted_ttft_s,
                    "realized_ttft_s": self.realized_ttft_s,
                    "ttft_ratio": self.ttft_ratio,
                }
                if self.predicted_ttft_s is not None
                else {}
            ),
        }


@dataclass
class _Pending:
    chosen_pod: str
    predicted_blocks: int
    #: the index's own claim at decision time (0 = prediction came from
    #: affinity memory — the ``never_stored`` discriminator)
    index_blocks: int
    scoreboard: dict
    decision: str
    regret_blocks: int
    chain_hashes: tuple
    model: str
    trace_id: Optional[str]
    decided_at: float
    #: the latency model's TTFT claim (ROUTE_PREDICT); None = legacy
    predicted_ttft_s: Optional[float] = None


class RouteAuditor:
    """Joins routing decisions with realized prefix-cache hits.

    ``index``/``fleet_health`` (both optional) power the miss attribution:
    the index is re-probed at join time for the chain the decision scored,
    and fleet health answers "was the pod even routable". Without them the
    attribution degrades gracefully (every eviction-flavored miss reads
    ``stale_index``).
    """

    def __init__(
        self,
        index=None,
        fleet_health=None,
        model_name: str = "",
        ring: int = 2048,
        pending_cap: int = 4096,
        max_chain_hashes: int = 512,
        clock: Callable[[], float] = time.time,
        ttft_corrector=None,
    ):
        """``ttft_corrector`` (optional, a
        ``kvcache.predictor.PredictionCorrector`` — wired by
        ``ROUTE_PREDICT``): joins that carry BOTH a predicted and a
        realized TTFT feed it the outcome, closing the routing model's
        feedback loop — the audit plane acting as an actuator. The feed
        is skipped when the request landed on a different pod than the
        one predicted for (the outcome is not that pod's model error).
        None (default) = observation-only, legacy behavior."""
        self.index = index
        self.fleet_health = fleet_health
        self.model_name = model_name
        self.ttft_corrector = ttft_corrector
        self.max_chain_hashes = max_chain_hashes
        self._clock = clock
        self._mu = threading.Lock()
        self._pending: "OrderedDict[str, _Pending]" = OrderedDict()  # guarded_by: _mu
        self._pending_cap = pending_cap
        self._ring: deque = deque(maxlen=max(ring, 1))  # guarded_by: _mu
        self.decisions_recorded = 0  # guarded_by: _mu
        self.joined = 0  # guarded_by: _mu
        self.unmatched_realized = 0  # guarded_by: _mu
        self.pending_evicted = 0  # guarded_by: _mu
        self.miss_causes = dict.fromkeys(MISS_CAUSES, 0)  # guarded_by: _mu
        #: recently revoked block hashes (BadBlock events; bounded — the
        #: attribution window only needs "was this chain hit by a recent
        #: revocation", not a durable ledger)
        self._bad_blocks: "OrderedDict[int, None]" = OrderedDict()  # guarded_by: _mu
        self._bad_blocks_cap = 4096

    # -- decision side (router/scorer) ---------------------------------------
    def record_decision(
        self,
        request_id: str,
        *,
        chosen_pod: str,
        predicted_blocks: int,
        scoreboard: Optional[dict] = None,
        index_blocks: Optional[int] = None,
        decision: str = "route_warm",
        chain_hashes: Sequence[int] = (),
        model: Optional[str] = None,
        trace_id: Optional[str] = None,
        predicted_ttft_s: Optional[float] = None,
    ) -> None:
        """Record what the scorer promised for ``request_id``. ``scoreboard``
        is the top-k pod→score map the decision saw; regret = the best
        entry minus the chosen entry (how much warmth the placement left
        on the table, 0 when the warmest pod was picked)."""
        scoreboard = dict(scoreboard or {})
        best = max(scoreboard.values(), default=0)
        regret = max(best - scoreboard.get(chosen_pod, 0), 0)
        rec = _Pending(
            chosen_pod=chosen_pod,
            predicted_blocks=int(predicted_blocks),
            index_blocks=(
                int(index_blocks)
                if index_blocks is not None
                else int(predicted_blocks)
            ),
            scoreboard=scoreboard,
            decision=decision,
            regret_blocks=regret,
            chain_hashes=tuple(chain_hashes)[: self.max_chain_hashes],
            model=model if model is not None else self.model_name,
            trace_id=trace_id,
            decided_at=self._clock(),
            predicted_ttft_s=predicted_ttft_s,
        )
        with self._mu:
            self._pending[request_id] = rec
            self._pending.move_to_end(request_id)
            self.decisions_recorded += 1
            while len(self._pending) > self._pending_cap:
                self._pending.popitem(last=False)
                self.pending_evicted += 1
        collector.observe_route_regret(decision, regret)

    # -- realized side (pod report via RequestAudit event or in-process) ----
    def record_realized(
        self,
        request_id: str,
        pod: str,
        realized_blocks: int,
        realized_ttft_s: Optional[float] = None,
    ) -> Optional[AuditRecord]:
        """Join the pod's ground truth with the pending decision. Returns
        the joined record (also ring-buffered for ``/debug/audit``), or
        None when no decision was recorded for this request id.
        ``realized_ttft_s`` (in-process callers only — the RequestAudit
        wire event carries blocks, not latency) additionally joins the
        predicted-TTFT claim: the realized/predicted latency ratio is
        observed and, when a corrector is attached, fed back to the
        routing model."""
        with self._mu:
            rec = self._pending.pop(request_id, None)
            if rec is None:
                self.unmatched_realized += 1
                return None
        realized_blocks = int(realized_blocks)
        predicted = rec.predicted_blocks
        ratio = (realized_blocks / predicted) if predicted > 0 else None
        cause = None
        if predicted > 0 and realized_blocks < predicted:
            cause = self._attribute(rec, pod)
            collector.observe_miss_cause(cause)
        if ratio is not None:
            collector.observe_predicted_vs_realized(ratio)
        ttft_ratio = None
        if (
            rec.predicted_ttft_s is not None
            and rec.predicted_ttft_s > 0
            and realized_ttft_s is not None
            and pod == rec.chosen_pod
        ):
            # Only the pod the model predicted FOR can judge the model:
            # a rerouted request's latency has another pod's denominator
            # and would pollute the honesty histogram exactly when the
            # prediction was never followed. (The row still records
            # realized_ttft_s for the reroute, just no ratio.)
            ttft_ratio = realized_ttft_s / rec.predicted_ttft_s
            collector.observe_ttft_ratio(ttft_ratio)
            if self.ttft_corrector is not None:
                self.ttft_corrector.observe(
                    pod, rec.predicted_ttft_s, realized_ttft_s
                )
        audit = AuditRecord(
            request_id=request_id,
            chosen_pod=rec.chosen_pod,
            realized_pod=pod,
            predicted_blocks=predicted,
            realized_blocks=realized_blocks,
            decision=rec.decision,
            regret_blocks=rec.regret_blocks,
            ratio=round(ratio, 4) if ratio is not None else None,
            cause=cause,
            trace_id=rec.trace_id,
            decided_at=rec.decided_at,
            joined_at=self._clock(),
            predicted_ttft_s=rec.predicted_ttft_s,
            realized_ttft_s=realized_ttft_s,
            ttft_ratio=(
                round(ttft_ratio, 4) if ttft_ratio is not None else None
            ),
        )
        with self._mu:
            self.joined += 1
            if cause is not None:
                self.miss_causes[cause] += 1
            self._ring.append(audit)
        return audit

    def observe_bad_block(self, block_hashes: Sequence[int]) -> None:
        """A ``BadBlock`` revocation reached the scorer: remember the
        hashes (bounded FIFO) so a subsequent realized-miss on a chain
        containing one attributes as ``quarantined`` rather than
        ``evicted_on_pod`` — the eviction was deliberate poison control,
        not index rot."""
        with self._mu:
            for h in block_hashes:
                self._bad_blocks[int(h)] = None
            while len(self._bad_blocks) > self._bad_blocks_cap:
                self._bad_blocks.popitem(last=False)

    def _attribute(self, rec: _Pending, realized_pod: str) -> str:
        """Classify one miss using current index + fleet-health state (see
        the module docstring for the causes)."""
        fh = self.fleet_health
        if realized_pod != rec.chosen_pod or (
            fh is not None and not fh.is_routable(rec.chosen_pod)
        ):
            return "dead_pod_reroute"
        if rec.chain_hashes:
            with self._mu:
                if any(h in self._bad_blocks for h in rec.chain_hashes):
                    # A revocation hit the scored chain after the decision:
                    # the pod quarantined a corrupt copy and recomputed —
                    # checked before the index probes because the BadBlock
                    # eviction makes those read as stale/evicted too.
                    return "quarantined"
        if rec.index_blocks <= 0:
            # The index never claimed the chain on this pod — the
            # prediction came from affinity memory (or a wiped index).
            return "never_stored"
        current = self._probe(rec)
        if current is None or current < rec.index_blocks:
            # The scored entries are gone from the index too: evicted
            # after scoring — the prediction was honest when made.
            return "stale_index"
        # The index STILL advertises the blocks the pod says it lacks:
        # the pod evicted locally and the index has not caught up.
        return "evicted_on_pod"

    def _probe(self, rec: _Pending) -> Optional[int]:
        """Longest consecutive prefix of the decision's chain the index
        currently holds for the chosen pod; None when unprobeable (no
        index attached / no stored hashes / probe error)."""
        if self.index is None or not rec.chain_hashes:
            return None
        try:
            from ..kvcache.kvblock.keys import Key

            keys = [Key(rec.model, h) for h in rec.chain_hashes]
            hits = self.index.lookup(keys, {rec.chosen_pod})
            n = 0
            for key in keys:
                if rec.chosen_pod not in (hits.get(key) or []):
                    break
                n += 1
            return n
        except Exception:
            log.exception("audit index probe failed")
            return None

    # -- read side -----------------------------------------------------------
    def recent(
        self,
        limit: int = 50,
        request_id: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> list[dict]:
        with self._mu:
            rows = list(self._ring)
        if request_id is not None:
            rows = [r for r in rows if r.request_id == request_id]
        if trace_id is not None:
            rows = [r for r in rows if r.trace_id == trace_id]
        # The Tracer limit contract: limit <= 0 returns nothing. (The old
        # `rows[-max(limit, 0):]` slice returned EVERYTHING at limit=0 —
        # the one debug surface that inverted the contract.)
        if limit <= 0:
            return []
        return [r.to_dict() for r in rows[-limit:]]

    def snapshot(self) -> dict:
        with self._mu:
            ratios = [r.ratio for r in self._ring if r.ratio is not None]
            ttft_ratios = [
                r.ttft_ratio for r in self._ring if r.ttft_ratio is not None
            ]
            return {
                "decisions_recorded": self.decisions_recorded,
                "joined": self.joined,
                "pending": len(self._pending),
                "pending_evicted": self.pending_evicted,
                "unmatched_realized": self.unmatched_realized,
                "miss_causes": dict(self.miss_causes),
                "recent_ratio_p50": _percentile(ratios, 0.5),
                # Key appears only once a predicted-TTFT join happened:
                # knobs-off audit snapshots keep their legacy field set.
                **(
                    {"ttft_ratio_p50": _percentile(ttft_ratios, 0.5)}
                    if ttft_ratios
                    else {}
                ),
            }


def _cap_per_pod_event(detail: dict, limit: int) -> dict:
    """Apply the Tracer limit contract to a ``detail()`` payload: cap the
    per-(pod, event) histogram rows (the only unbounded-in-fleet-size
    part) at ``limit``, recursing into per-shard details for the merged
    view. Sorted keys so the same limit always keeps the same rows."""
    out = dict(detail)
    if "per_pod_event" in out:
        rows = out["per_pod_event"]
        out["per_pod_event"] = {
            k: rows[k] for k in sorted(rows)[: max(limit, 0)]
        }
    if "shards" in out:
        out["shards"] = {
            shard: _cap_per_pod_event(d, limit)
            for shard, d in out["shards"].items()
        }
    return out


def debug_staleness_payload(
    tracker: Optional[StalenessTracker], query
) -> tuple[int, dict]:
    """``GET /debug/staleness`` body (the endpoint is always routable;
    with the knob off it reports itself disabled, like /debug/traces).
    ``?limit=`` caps the per-(pod, event) histogram rows with the Tracer
    contract (``limit <= 0`` returns nothing); tolerant 400 on a bad
    limit."""
    if tracker is None:
        return 200, {"enabled": False}
    try:
        limit = int(query.get("limit", "50"))
    except ValueError:
        return 400, {"error": "invalid limit (want an int)"}
    return 200, {
        "enabled": True,
        **_cap_per_pod_event(tracker.detail(), limit),
    }


def debug_audit_payload(
    auditor: Optional[RouteAuditor], query
) -> tuple[int, dict]:
    """``GET /debug/audit`` body: recent joined audits, filterable by
    ``?request_id=`` / ``?trace_id=``; tolerant 400 on a bad limit."""
    if auditor is None:
        return 200, {"enabled": False, "audits": []}
    try:
        limit = int(query.get("limit", "50"))
    except ValueError:
        return 400, {"error": "invalid limit"}
    return 200, {
        "enabled": True,
        "audits": auditor.recent(
            limit=limit,
            request_id=query.get("request_id"),
            trace_id=query.get("trace_id"),
        ),
        **auditor.snapshot(),
    }
