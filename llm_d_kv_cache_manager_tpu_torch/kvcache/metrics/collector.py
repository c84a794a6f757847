"""Prometheus metrics for the KV-block index.

Metric names match the reference collectors
(``pkg/kvcache/metrics/collector.go:29-54``):

- ``kvcache_index_admissions_total``
- ``kvcache_index_evictions_total``
- ``kvcache_index_lookup_requests_total``
- ``kvcache_index_lookup_hits_total``  (defined-but-never-incremented in the
  reference — a noted gap; here it counts per-key hits returned by lookups)
- ``kvcache_index_lookup_latency_seconds`` histogram

A periodic "metrics beat" log thread mirrors ``StartMetricsLogging``
(``collector.go:75-130``). Falls back to inert counters when
``prometheus_client`` is unavailable so the library never hard-depends on it.
"""

from __future__ import annotations

import threading
from typing import Optional

from ...obs.lifecycle import COLD_DISTANCE_CLAMP, REUSE_DISTANCE_BUCKETS
from ...utils import get_logger

log = get_logger("kvcache.metrics")

try:
    import prometheus_client as _prom
except ImportError:  # pragma: no cover
    _prom = None


class _NullMetric:
    def inc(self, *_a, **_k):
        pass

    def observe(self, *_a, **_k):
        pass

    def set(self, *_a, **_k):
        pass

    def labels(self, *_a, **_k):
        return self


_registered = False
_lock = threading.Lock()

admissions = _NullMetric()
evictions = _NullMetric()
lookup_requests = _NullMetric()
lookup_hits = _NullMetric()
lookup_latency = _NullMetric()
# Fleet self-healing: seq gaps, snapshot resyncs, dead-pod sweeps,
# publisher-reported drops, transfer circuit-breaker transitions.
fleet_gaps = _NullMetric()
fleet_resyncs = _NullMetric()
fleet_pods_swept = _NullMetric()
fleet_publisher_drops = _NullMetric()
breaker_opens = _NullMetric()
breaker_closes = _NullMetric()
# Request-lifecycle robustness: pods that said a PodDrained goodbye
# (evicted without a TTL wait), scoring requests degraded to an empty
# scoreboard because the index backend failed (routing falls back to cold
# placement instead of erroring the request).
fleet_pods_drained = _NullMetric()
scorer_errors = _NullMetric()
# Observability: routing-decision counter (labeled by the blended
# router's verdict), scorer score latency, and index-occupancy gauges so
# dashboards can correlate routing quality with index fill.
route_decisions = _NullMetric()
score_latency = _NullMetric()
index_blocks = _NullMetric()
index_pods = _NullMetric()
# Routing-quality observability: event-plane staleness (publish →
# index-visibility lag per pod/event type, events-behind per pod), the
# predicted-vs-realized audit loop (hit ratio, per-decision regret, miss
# attribution), and the scoreboard-size gauge. Series appear only when the
# OBS_AUDIT/OBS_METRICS surfaces feed them — a knobs-off process never
# touches a label.
index_staleness = _NullMetric()
index_events_behind = _NullMetric()
scoreboard_size = _NullMetric()
route_pvr = _NullMetric()
route_regret = _NullMetric()
route_miss = _NullMetric()
# Predicted-TTFT routing: the latency model's per-decision
# prediction and its realized/predicted honesty ratio from the audit
# join. Series appear only when ROUTE_PREDICT feeds them — a knobs-off
# process never observes either.
route_predicted_ttft = _NullMetric()
route_ttft_ratio = _NullMetric()
# Sharded control plane: per-shard index occupancy and stale-ring
# misroute forwards. Series appear only when SCORER_SHARDS partitions the
# index — a knobs-off process never touches a shard label (the staleness /
# events-behind families above likewise grow a ``shard`` label that stays
# "" until the sharded plane feeds them).
shard_blocks = _NullMetric()
shard_pods = _NullMetric()
shard_misroutes = _NullMetric()
# KV-capacity observability plane: block tier transitions +
# per-tier residency from the lifecycle ledger, and the sampled
# reuse-distance histogram behind the MRC. Series appear only when
# OBS_LIFECYCLE attaches the ledger/estimator — a knobs-off process never
# touches a label.
block_transitions = _NullMetric()
block_residency = _NullMetric()
reuse_distance = _NullMetric()
# KV-block integrity plane: content-digest checks at tier
# transitions, quarantines, scrubber coverage, and fleet BadBlock
# revocations. Series appear only when KV_INTEGRITY feeds them — a
# knobs-off process never touches a label.
integrity_checks = _NullMetric()
integrity_quarantined = _NullMetric()
integrity_scrub_pages = _NullMetric()
integrity_bad_blocks = _NullMetric()
# Fleet observability federation: the derived fleet health
# rollup and the federator's own scrape accounting. Series appear only
# when OBS_FED scrapes feed them — a knobs-off process never sets the
# gauge or observes a scrape.
fleet_health_score = _NullMetric()
fleet_scrape_seconds = _NullMetric()
fleet_scrape_errors = _NullMetric()
fleet_pods_skipped = _NullMetric()

# Internal shadow counters so the metrics beat can log without scraping.
_shadow = {
    "admissions": 0,
    "evictions": 0,
    "lookup_requests": 0,
    "lookup_hits": 0,
    "fleet_gaps": 0,
    "fleet_resyncs": 0,
    "fleet_pods_swept": 0,
    "fleet_publisher_drops": 0,
    "breaker_opens": 0,
    "breaker_closes": 0,
    "fleet_pods_drained": 0,
    "scorer_errors": 0,
}
_shadow_lock = threading.Lock()


def bump(name: str, amount: int = 1) -> None:
    with _shadow_lock:
        _shadow[name] = _shadow.get(name, 0) + amount


def snapshot() -> dict:
    with _shadow_lock:
        return dict(_shadow)


def register(registry=None) -> None:
    """Idempotently create and register the collectors."""
    global _registered, admissions, evictions, lookup_requests, lookup_hits, lookup_latency
    global fleet_gaps, fleet_resyncs, fleet_pods_swept, fleet_publisher_drops
    global breaker_opens, breaker_closes, fleet_pods_drained, scorer_errors
    global route_decisions, score_latency, index_blocks, index_pods
    global index_staleness, index_events_behind, scoreboard_size
    global route_pvr, route_regret, route_miss
    global route_predicted_ttft, route_ttft_ratio
    global shard_blocks, shard_pods, shard_misroutes
    global block_transitions, block_residency, reuse_distance
    global integrity_checks, integrity_quarantined
    global integrity_scrub_pages, integrity_bad_blocks
    global fleet_health_score, fleet_scrape_seconds
    global fleet_scrape_errors, fleet_pods_skipped
    with _lock:
        if _registered:
            return
        if _prom is None:
            _registered = True
            return
        registry = registry or _prom.REGISTRY
        admissions = _prom.Counter(
            "kvcache_index_admissions_total",
            "Total number of KV-block admissions into the index",
            registry=registry,
        )
        evictions = _prom.Counter(
            "kvcache_index_evictions_total",
            "Total number of KV-block evictions from the index",
            registry=registry,
        )
        lookup_requests = _prom.Counter(
            "kvcache_index_lookup_requests_total",
            "Total number of index lookup requests",
            registry=registry,
        )
        lookup_hits = _prom.Counter(
            "kvcache_index_lookup_hits_total",
            "Total number of per-key hits returned by index lookups",
            registry=registry,
        )
        lookup_latency = _prom.Histogram(
            "kvcache_index_lookup_latency_seconds",
            "Latency of index lookups in seconds",
            registry=registry,
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
        )
        fleet_gaps = _prom.Counter(
            "kvcache_fleet_event_gaps_total",
            "Sequence gaps detected in pod event streams",
            registry=registry,
        )
        fleet_resyncs = _prom.Counter(
            "kvcache_fleet_resyncs_total",
            "IndexSnapshot resyncs applied (replace-all-for-pod)",
            registry=registry,
        )
        fleet_pods_swept = _prom.Counter(
            "kvcache_fleet_pods_swept_total",
            "Pods swept from the index after TTL expiry",
            registry=registry,
        )
        fleet_publisher_drops = _prom.Counter(
            "kvcache_fleet_publisher_drops_total",
            "Event batches publishers reported dropping (via heartbeats)",
            registry=registry,
        )
        breaker_opens = _prom.Counter(
            "kvcache_transfer_breaker_opens_total",
            "Transfer circuit-breaker open transitions",
            registry=registry,
        )
        breaker_closes = _prom.Counter(
            "kvcache_transfer_breaker_closes_total",
            "Transfer circuit-breaker close transitions (half-open probe ok)",
            registry=registry,
        )
        fleet_pods_drained = _prom.Counter(
            "kvcache_fleet_pods_drained_total",
            "Pods evicted immediately after a PodDrained goodbye",
            registry=registry,
        )
        scorer_errors = _prom.Counter(
            "kvcache_scorer_errors_total",
            "Scoring requests degraded to an empty scoreboard because the "
            "index backend failed",
            registry=registry,
        )
        route_decisions = _prom.Counter(
            "kvcache_scorer_route_decisions_total",
            "Blended-router routing decisions by verdict "
            "(route_warm / pull / cold)",
            ["decision"],
            registry=registry,
        )
        score_latency = _prom.Histogram(
            "kvcache_scorer_score_seconds",
            "Wall time of one scoring request (tokenize + hash + index "
            "lookup + score), as served by the scoring API",
            registry=registry,
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
        )
        index_blocks = _prom.Gauge(
            "kvcache_index_blocks",
            "Block keys currently tracked by the KV-block index "
            "(refreshed on /stats and /metrics scrapes)",
            registry=registry,
        )
        index_pods = _prom.Gauge(
            "kvcache_index_pods",
            "Distinct pods currently holding at least one index entry "
            "(refreshed on /stats and /metrics scrapes)",
            registry=registry,
        )
        index_staleness = _prom.Histogram(
            "kvcache_index_staleness_seconds",
            "Event-plane lag: publish timestamp to index application, per "
            "pod and event type (OBS_AUDIT); the shard label is \"\" on a "
            "single index and the owning scorer shard under SCORER_SHARDS",
            ["pod", "event", "shard"],
            registry=registry,
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
        )
        index_events_behind = _prom.Gauge(
            "kvcache_index_events_behind",
            "Events received from a pod's publisher but not yet applied "
            "to the index (subscriber seq high-water minus worker "
            "high-water; refreshed on /stats and /metrics scrapes); the "
            "shard label is \"\" on a single index and the ingest lane's "
            "shard under SCORER_SHARDS",
            ["pod", "shard"],
            registry=registry,
        )
        scoreboard_size = _prom.Gauge(
            "kvcache_scorer_scoreboard_size",
            "Pods in the most recent scoring response's scoreboard "
            "(OBS_METRICS)",
            registry=registry,
        )
        route_pvr = _prom.Histogram(
            "kvcache_route_predicted_vs_realized_blocks",
            "Realized prefix-cache hit blocks over the scorer's predicted "
            "matched blocks, per audited request (1.0 = the prediction "
            "held exactly; OBS_AUDIT)",
            registry=registry,
            buckets=(0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0, 1.25,
                     1.5, 2.0),
        )
        route_regret = _prom.Histogram(
            "kvcache_route_regret_blocks",
            "Per-decision counterfactual regret: best scoreboard entry "
            "minus the chosen pod's score, in blocks (0 = the warmest pod "
            "was picked), labeled by routing decision (OBS_AUDIT)",
            ["decision"],
            registry=registry,
            buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0),
        )
        route_miss = _prom.Counter(
            "kvcache_route_miss_attributed_total",
            "Audited requests whose realized hits fell short of the "
            "prediction, by attributed cause (stale_index / evicted_on_pod "
            "/ never_stored / dead_pod_reroute / quarantined; OBS_AUDIT)",
            ["cause"],
            registry=registry,
        )
        route_predicted_ttft = _prom.Histogram(
            "kvcache_route_predicted_ttft_seconds",
            "Modeled TTFT of the chosen routing arm (queue wait + miss "
            "prefill + pull cost, corrector-adjusted) per predicted-"
            "routing decision (ROUTE_PREDICT)",
            registry=registry,
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     5.0, 10.0, 30.0, 60.0),
        )
        route_ttft_ratio = _prom.Histogram(
            "kvcache_route_ttft_realized_over_predicted",
            "Realized TTFT over the routing model's predicted TTFT per "
            "audited request (1.0 = the latency model told the truth; "
            "ROUTE_PREDICT + OBS_AUDIT join)",
            registry=registry,
            buckets=(0.1, 0.25, 0.5, 0.8, 0.9, 1.0, 1.1, 1.25, 1.5, 2.0,
                     4.0, 10.0),
        )
        shard_blocks = _prom.Gauge(
            "kvcache_index_shard_blocks",
            "Block keys tracked by one scorer shard's sub-index "
            "(SCORER_SHARDS; refreshed on /stats and /metrics scrapes)",
            ["shard"],
            registry=registry,
        )
        shard_pods = _prom.Gauge(
            "kvcache_index_shard_pods",
            "Distinct pods holding at least one entry on one scorer "
            "shard's sub-index (SCORER_SHARDS; refreshed on /stats and "
            "/metrics scrapes)",
            ["shard"],
            registry=registry,
        )
        shard_misroutes = _prom.Counter(
            "kvcache_shard_misroute_total",
            "Event ops that landed on a stale-ring shard and were "
            "forwarded once to the current owner (SCORER_SHARDS resize "
            "in flight), labeled by the shard that observed the misroute",
            ["shard"],
            registry=registry,
        )
        block_transitions = _prom.Counter(
            "kvcache_block_tier_transitions_total",
            "KV-block tier transitions recorded by the lifecycle ledger "
            "(OBS_LIFECYCLE): from/to in {none, tpu_hbm, host_dram, "
            "remote}, reason = allocate/import/spill/restore/prefetch/"
            "demote/demote_failed/evict (pod hooks) or stored/removed/"
            "drained/resync/ttl_swept (scorer event feed)",
            ["from", "to", "reason"],
            registry=registry,
        )
        block_residency = _prom.Histogram(
            "kvcache_block_tier_residency_seconds",
            "How long a KV block stayed resident in a tier before "
            "leaving it (observed at departure; OBS_LIFECYCLE)",
            ["tier"],
            registry=registry,
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0, 300.0, 600.0, 1800.0, 3600.0),
        )
        reuse_distance = _prom.Histogram(
            "kvcache_reuse_distance_blocks",
            "Sampled LRU stack distance of prefix-block lookups, in "
            "blocks (OBS_LIFECYCLE): P[distance < C] is the modeled hit "
            "rate of a C-block tier — the MRC behind /debug/mrc; cold "
            "first-ever accesses land in +Inf",
            registry=registry,
            buckets=tuple(float(b) for b in REUSE_DISTANCE_BUCKETS),
        )
        integrity_checks = _prom.Counter(
            "kvcache_integrity_checks_total",
            "Content-digest verifications at KV tier transitions "
            "(KV_INTEGRITY), by transition path (restore / prefetch / "
            "import / remote_accept / remote_serve / export / scrub) and "
            "outcome (ok / corrupt / unverified — no recorded digest)",
            ["path", "outcome"],
            registry=registry,
        )
        integrity_quarantined = _prom.Counter(
            "kvcache_integrity_quarantined_total",
            "KV block copies quarantined after a failed content-digest "
            "check (KV_INTEGRITY), by the tier holding the bad copy "
            "(host_dram / remote / wire)",
            ["tier"],
            registry=registry,
        )
        integrity_scrub_pages = _prom.Counter(
            "kvcache_integrity_scrub_pages_total",
            "Resident host-tier pages verified by the background "
            "integrity scrubber (KV_INTEGRITY + INTEGRITY_SCRUB_INTERVAL_S)",
            registry=registry,
        )
        integrity_bad_blocks = _prom.Counter(
            "kvcache_integrity_bad_blocks_total",
            "Block hashes revoked fleet-wide by BadBlock events as seen "
            "by this process (published locally or applied by the scorer "
            "index; KV_INTEGRITY)",
            registry=registry,
        )
        fleet_health_score = _prom.Gauge(
            "kvcache_fleet_health_score",
            "Derived fleet health rollup in [0, 1] from the last "
            "federated scrape (OBS_FED): mean per-pod score — "
            "unreachable/expired pods score 0, draining caps at 0.5, "
            "burning SLOs / open breakers / near-full HBM / quarantines "
            "deduct (see obs/federation.py); refreshed per scrape",
            registry=registry,
        )
        fleet_scrape_seconds = _prom.Histogram(
            "kvcache_fleet_scrape_seconds",
            "Wall time of one federated fleet scrape-and-join across "
            "all registered pods (OBS_FED)",
            registry=registry,
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
        )
        fleet_scrape_errors = _prom.Counter(
            "kvcache_fleet_scrape_errors_total",
            "Registered pods whose /stats fetch failed during a "
            "federated scrape (OBS_FED) — expired pods are skipped, "
            "not errored",
            registry=registry,
        )
        fleet_pods_skipped = _prom.Counter(
            "kvcache_fleet_scrape_pods_skipped_total",
            "Registered pods skipped outright by a federated scrape "
            "because FleetHealth reported them expired/swept/drained "
            "(OBS_FED) — the dead-pod-costs-one-skip guarantee",
            registry=registry,
        )
        _registered = True


def observe_score_latency(seconds: float, trace_id: Optional[str] = None) -> None:
    """One scoring request's wall time. Under OBS_EXEMPLARS the caller
    passes the observing request's trace_id, which rides as an
    OpenMetrics exemplar on the bucket it lands in — a tail bucket then
    resolves directly to ``/debug/traces?trace=<id>``. Exemplars render
    only in the OpenMetrics exposition (the classic text format drops
    them), so the scorer switches formats under the same knob."""
    if trace_id:
        score_latency.observe(seconds, exemplar={"trace_id": trace_id})
    else:
        score_latency.observe(seconds)


def observe_fleet_scrape(
    scrape_s: float,
    errors: int = 0,
    skipped: int = 0,
    health: Optional[float] = None,
) -> None:
    """Mirror one federated fleet scrape into the OBS_FED families
    (scrape-driven, like the occupancy gauges): join wall time, per-scrape
    fetch errors and dead-pod skips, and the derived health rollup."""
    bump("fleet_scrapes")
    fleet_scrape_seconds.observe(scrape_s)
    if errors:
        fleet_scrape_errors.inc(errors)
    if skipped:
        fleet_pods_skipped.inc(skipped)
    if health is not None:
        fleet_health_score.set(health)


def observe_route_decision(action: str) -> None:
    """One blended-router verdict (route_warm / pull / cold)."""
    bump(f"route_decisions_{action}")
    route_decisions.labels(decision=action).inc()


def observe_staleness(pod: str, event: str, lag_s: float, shard: str = "") -> None:
    """One event's publish→index-application lag (OBS_AUDIT). ``shard``
    is "" on a single index; the sharded plane labels each observation
    with the applying shard."""
    bump("staleness_events")
    index_staleness.labels(pod=pod, event=event, shard=shard).observe(lag_s)


def set_events_behind(pod: str, behind: int, shard: str = "") -> None:
    index_events_behind.labels(pod=pod, shard=shard).set(behind)


def set_shard_index_size(shard: str, blocks: int, pods: int) -> None:
    """Refresh one scorer shard's occupancy gauges (scrape-driven)."""
    shard_blocks.labels(shard=shard).set(blocks)
    shard_pods.labels(shard=shard).set(pods)


def observe_shard_misroute(shard: str, n: int = 1) -> None:
    """Stale-ring misroute forwards observed by ``shard`` (SCORER_SHARDS)."""
    bump("shard_misroutes", n)
    shard_misroutes.labels(shard=shard).inc(n)


def set_scoreboard_size(n: int) -> None:
    scoreboard_size.set(n)


def observe_predicted_vs_realized(ratio: float) -> None:
    """Realized/predicted blocks for one audited request (OBS_AUDIT)."""
    bump("route_audits_joined")
    route_pvr.observe(ratio)


def observe_route_regret(decision: str, regret_blocks: int) -> None:
    route_regret.labels(decision=decision).observe(regret_blocks)


def observe_predicted_ttft(seconds: float) -> None:
    """One predicted-routing decision's modeled TTFT (ROUTE_PREDICT)."""
    bump("route_predictions")
    route_predicted_ttft.observe(seconds)


def observe_ttft_ratio(ratio: float) -> None:
    """Realized/predicted TTFT for one audited predicted-routing
    decision (ROUTE_PREDICT + OBS_AUDIT join)."""
    bump("route_ttft_joins")
    route_ttft_ratio.observe(ratio)


def observe_miss_cause(cause: str) -> None:
    bump(f"route_miss_{cause}")
    route_miss.labels(cause=cause).inc()


def observe_integrity_check(path: str, outcome: str) -> None:
    """One content-digest verification at a tier transition (KV_INTEGRITY)."""
    bump(f"integrity_checks_{outcome}")
    integrity_checks.labels(path=path, outcome=outcome).inc()


def observe_quarantine(tier: str) -> None:
    """One block copy quarantined after a corrupt digest (KV_INTEGRITY)."""
    bump("integrity_quarantined")
    integrity_quarantined.labels(tier=tier).inc()


def observe_scrub_pages(n: int) -> None:
    """Host-tier pages the background scrubber verified (KV_INTEGRITY)."""
    if n:
        bump("integrity_scrub_pages", n)
        integrity_scrub_pages.inc(n)


def observe_bad_blocks(n: int) -> None:
    """Block hashes revoked by BadBlock events (KV_INTEGRITY)."""
    if n:
        bump("integrity_bad_blocks", n)
        integrity_bad_blocks.inc(n)


def observe_tier_transition(frm: str, to: str, reason: str) -> None:
    """One lifecycle-ledger tier transition (OBS_LIFECYCLE). Keyword
    form avoided: ``from`` is a Python keyword, so the label rides
    positionally via labels(frm, to, reason)."""
    bump("block_transitions")
    block_transitions.labels(frm, to, reason).inc()


def observe_tier_residency(tier: str, seconds: float) -> None:
    block_residency.labels(tier=tier).observe(seconds)


def observe_reuse_distance(distance_blocks: float) -> None:
    """One sampled reuse distance (inf = cold first-ever access). Cold
    accesses are clamped to a finite over-the-top value so they land in
    the +Inf bucket without poisoning the ``_sum`` series with inf."""
    bump("reuse_distances")
    reuse_distance.observe(min(distance_blocks, COLD_DISTANCE_CLAMP))


def set_index_size(blocks: int, pods: int) -> None:
    """Refresh the index-occupancy gauges (scrape-driven, not event-driven:
    walking the index is O(keys), so only /stats and /metrics pay it)."""
    index_blocks.set(blocks)
    index_pods.set(pods)
    with _shadow_lock:
        _shadow["index_blocks"] = blocks
        _shadow["index_pods"] = pods


_beat_thread: Optional[threading.Thread] = None
_beat_stop = threading.Event()


def start_metrics_logging(interval_seconds: float) -> None:
    """Spawn the non-blocking metrics-beat logger (idempotent)."""
    global _beat_thread
    with _lock:
        if _beat_thread is not None and _beat_thread.is_alive():
            return
        _beat_stop.clear()

        def beat():
            while not _beat_stop.wait(interval_seconds):
                log.info("metrics beat", **snapshot())

        _beat_thread = threading.Thread(target=beat, name="kvcache-metrics-beat", daemon=True)
        _beat_thread.start()


def stop_metrics_logging(timeout: float = 2.0) -> None:
    """Stop the metrics beat and JOIN the thread. Without the join (the
    pre-PR-5 bug) a stop/start pair in one process raced: ``start`` saw the
    old thread still alive, returned early, and the beat never restarted —
    and the half-dead thread leaked past interpreter teardown checks."""
    global _beat_thread
    _beat_stop.set()
    with _lock:
        thread, _beat_thread = _beat_thread, None
    if thread is not None and thread.is_alive():
        thread.join(timeout=timeout)
