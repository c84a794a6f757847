"""The online scoring service: HTTP API + full wiring.

Parity with the reference's shipped binary (``examples/kv_events/online/
main.go``): starts the KV-cache indexer, the event-ingestion pool with its
ZMQ subscriber, optional metrics, and serves:

- ``POST /score_completions``       {"prompt": str, "model": str,
                                     "pod_identifiers": [str]?}
- ``POST /score_chat_completions``  {"messages": [...], "model": str,
                                     "chat_template": str?, ...}
  (fetches + renders the model's chat template, then scores the flattened
  prompt — reference ``online/main.go:273-339``)
- ``GET  /metrics``                 Prometheus exposition
- ``GET  /healthz``

Configuration comes from env vars matching the reference's
(``online/main.go:162-209``): HF_TOKEN, BLOCK_SIZE, PYTHONHASHSEED,
ZMQ_ENDPOINT, ZMQ_TOPIC, POOL_CONCURRENCY, HTTP_PORT.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..kvcache import KVCacheIndexer, KVCacheIndexerConfig
from ..kvcache.kvblock import TokenProcessorConfig
from ..kvcache.metrics import collector
from ..kvcache.kvevents import (
    FleetHealth,
    FleetHealthConfig,
    KVEventsPool,
    KVEventsPoolConfig,
    ZMQSubscriber,
    ZMQSubscriberConfig,
)
from ..obs.tracing import Tracer, format_traceparent, parse_traceparent
from ..preprocessing import ChatTemplatingProcessor, FetchTemplateRequest, RenderRequest
from ..tokenization import HFTokenizerConfig, TokenizationPoolConfig
from ..utils import get_logger, log_context

log = get_logger("server.api")


def _parse_placement(body: dict):
    """The optional ``placement`` field both scoring endpoints accept:
    returns ``(placement, None)`` when valid ("prefill"/"decode" for the
    disagg tiers, "pull_source" for the remote-tier read path — no role
    exclusion, liveness gate only, so kvstore holders are scorable as
    pull sources — or absent) or ``(None, 400-response)`` for anything
    else."""
    from aiohttp import web

    placement = body.get("placement")
    if placement not in (None, "prefill", "decode", "pull_source"):
        return None, web.json_response(
            {
                "error": "placement must be 'prefill', 'decode' or "
                "'pull_source' when set"
            },
            status=400,
        )
    return placement, None


@dataclass
class ServiceConfig:
    http_port: int = 8080
    zmq_endpoint: str = "tcp://*:5557"
    zmq_topic: str = "kv@"
    pool_concurrency: int = 4
    block_size: int = 16
    hash_seed: str = ""
    hf_token: Optional[str] = None
    enable_metrics: bool = True
    metrics_logging_interval: float = 0.0
    # Use the C++ index backend when its library is built (strictly faster,
    # same conformance-tested semantics); NATIVE_INDEX=0 forces pure Python.
    native_index: bool = True
    #: fleet self-healing: seconds of pod silence before its entries are
    #: swept from the index and it stops being scored. 0 (default) = off —
    #: observation-only health tracking, legacy routing behavior.
    pod_ttl_s: float = 0.0
    #: request tracing: mint-or-adopt a W3C trace id per scoring
    #: request, record a ``scorer.score`` span, echo the ``traceparent``
    #: response header for the router to forward, and serve finished
    #: traces at ``GET /debug/traces``. Off (default) = no new headers,
    #: bit-identical responses.
    obs_tracing: bool = False
    #: finished-span ring size for /debug/traces
    obs_trace_buffer: int = 2048
    #: routing-quality audit: index-staleness probes on event
    #: ingest (publish→visibility lag per pod/event type, events-behind
    #: per pod, ``/debug/staleness``) and the predicted-vs-realized route
    #: audit (scoring requests carrying a ``request_id`` record their
    #: scoreboard; pods report realized hits via ``RequestAudit`` events;
    #: joined audits at ``/debug/audit``). Off (default) = no trackers
    #: attached, bit-identical responses and ``/stats``.
    obs_audit: bool = False
    #: joined-audit ring size for /debug/audit
    obs_audit_ring: int = 2048
    #: scoring-side OBS_METRICS: the
    #: ``kvcache_scorer_scoreboard_size`` / ``kvcache_index_events_behind``
    #: gauges and an ``obs`` block on ``/stats``. Off (default) keeps the
    #: legacy ``/stats`` field set.
    obs_metrics: bool = False
    #: KV-capacity observability: scorer-side block-lifecycle
    #: ledger fed from the KV-event stream the pool already decodes
    #: (``BlockStored``/``BlockRemoved`` with their medium — no new wire
    #: fields), surfaced at ``/debug/lifecycle``, a ``lifecycle`` /stats
    #: block, and the ``kvcache_block_tier_*`` metric families. Off
    #: (default) = no ledger attached, bit-identical responses/``/stats``.
    obs_lifecycle: bool = False
    #: lifecycle-ledger ring depth for /debug/lifecycle
    obs_lifecycle_ring: int = 4096
    #: sharded control plane: partition the block index by chain
    #: hash across this many scorer shards — per-shard event-apply workers
    #: (no cross-shard lock on ingest) and score reads fanned out across
    #: shards and merged. 0 (default) = the single-index legacy plane,
    #: bit-identical responses, /stats fields, and wire bytes.
    scorer_shards: int = 0
    #: virtual nodes per shard on the consistent-hash ring (sizing: higher
    #: = smoother balance and smaller resize movement, more ring memory)
    scorer_shard_vnodes: int = 64
    #: predicted-TTFT routing: attach a ``TTFTPredictor`` to
    #: the scoring plane — scoring requests carrying a ``signals`` body
    #: field (per-pod queue depth / prefill rate from the caller's
    #: serving telemetry) get a ``predicted_ttft_s`` map alongside the
    #: scores, so an EPP-style router can argmin on modeled latency.
    #: The corrector loop needs a realized-TTFT feed, which only
    #: IN-PROCESS callers have (``RouteAuditor.record_realized(...,
    #: realized_ttft_s=)``; the ``RequestAudit`` wire event carries
    #: blocks, not latency — no new wire fields): an HTTP-only
    #: deployment serves uncorrected model output and its /stats
    #: ``predict.corrector`` stays at bias 1.0. Off (default) = no new
    #: body fields read, bit-identical responses and ``/stats``.
    route_predict: bool = False
    #: the fleet's heartbeat cadence for the predictor's staleness gate:
    #: a pod whose last heartbeat is older than 2x this treats its
    #: queue/rate signals as unknown (conservative defaults). 0 = the
    #: staleness gate is off (signals trusted as supplied)
    route_predict_heartbeat_s: float = 0.0
    #: fleet observability federation: attach a scorer-side
    #: ``FleetFederator`` that polls every registered pod's ``/stats`` +
    #: ``/debug/*`` surfaces (in-process hooks or HTTP) and serves the
    #: joined, causally-stamped fleet snapshot at ``GET /debug/fleet``
    #: plus a ``fed`` /stats block and the ``kvcache_fleet_*`` scrape
    #: families. Off (default) = no federator attached, bit-identical
    #: ``/stats`` keys, exposition, and wire bytes.
    obs_fed: bool = False
    #: federation delta-ring depth (scrapes of history) for /debug/fleet
    obs_fed_ring: int = 256
    #: per-pod HTTP fetch timeout for federated scrapes, seconds (the
    #: in-process hook path never times out)
    obs_fed_timeout_s: float = 2.0
    #: OpenMetrics trace exemplars: the scorer's score-latency
    #: histogram attaches the observing request's trace_id per bucket and
    #: ``/metrics`` switches to the OpenMetrics exposition (the classic
    #: text format drops exemplars). Off (default) = classic exposition,
    #: bit-identical bytes.
    obs_exemplars: bool = False

    @classmethod
    def from_env(cls) -> "ServiceConfig":
        env = os.environ
        return cls(
            http_port=int(env.get("HTTP_PORT", "8080")),
            zmq_endpoint=env.get("ZMQ_ENDPOINT", "tcp://*:5557"),
            zmq_topic=env.get("ZMQ_TOPIC", "kv@"),
            pool_concurrency=int(env.get("POOL_CONCURRENCY", "4")),
            block_size=int(env.get("BLOCK_SIZE", "16")),
            hash_seed=env.get("PYTHONHASHSEED", ""),
            hf_token=env.get("HF_TOKEN") or None,
            enable_metrics=env.get("ENABLE_METRICS", "true").lower() != "false",
            metrics_logging_interval=float(env.get("METRICS_LOGGING_INTERVAL", "0")),
            native_index=env.get("NATIVE_INDEX", "1").lower() not in ("0", "false"),
            pod_ttl_s=float(env.get("POD_TTL_S", "0")),
            obs_tracing=env.get("OBS_TRACING", "").strip().lower()
            in ("1", "true", "yes", "on"),
            obs_trace_buffer=int(env.get("OBS_TRACE_BUFFER", "2048")),
            obs_audit=env.get("OBS_AUDIT", "").strip().lower()
            in ("1", "true", "yes", "on"),
            obs_audit_ring=int(env.get("OBS_AUDIT_RING", "2048")),
            obs_metrics=env.get("OBS_METRICS", "").strip().lower()
            in ("1", "true", "yes", "on"),
            obs_lifecycle=env.get("OBS_LIFECYCLE", "").strip().lower()
            in ("1", "true", "yes", "on"),
            obs_lifecycle_ring=int(env.get("OBS_LIFECYCLE_RING", "4096")),
            scorer_shards=int(env.get("SCORER_SHARDS", "0")),
            scorer_shard_vnodes=int(env.get("SCORER_SHARD_VNODES", "64")),
            route_predict=env.get("ROUTE_PREDICT", "").strip().lower()
            in ("1", "true", "yes", "on"),
            route_predict_heartbeat_s=float(
                env.get("ROUTE_PREDICT_HEARTBEAT_S", "0")
            ),
            obs_fed=env.get("OBS_FED", "").strip().lower()
            in ("1", "true", "yes", "on"),
            obs_fed_ring=int(env.get("OBS_FED_RING", "256")),
            obs_fed_timeout_s=float(env.get("OBS_FED_TIMEOUT_S", "2.0")),
            obs_exemplars=env.get("OBS_EXEMPLARS", "").strip().lower()
            in ("1", "true", "yes", "on"),
        )


class ScoringService:
    """Owns the indexer + event plane and exposes the HTTP handlers."""

    @staticmethod
    def _index_config(cfg: "ServiceConfig"):
        from ..kvcache.kvblock import (
            IndexConfig,
            NativeMemoryIndexConfig,
            native_available,
        )

        use_native = cfg.native_index and native_available()
        if cfg.native_index and not use_native:
            log.warning(
                "native index requested but liblruindex.so is not built — "
                "falling back to the pure-Python index (~4x slower hot RPC); "
                "run `python -m llm_d_kv_cache_manager_tpu_torch.native.build`"
            )
        else:
            log.info(
                "index backend selected",
                backend="native" if use_native else "in_memory",
            )
        return IndexConfig(
            native_memory=NativeMemoryIndexConfig() if use_native else None,
            in_memory=None if use_native else IndexConfig().in_memory,
            enable_metrics=cfg.enable_metrics,
            metrics_logging_interval=cfg.metrics_logging_interval,
        )

    def _build_sharded_index(self, cfg: "ServiceConfig"):
        """SCORER_SHARDS plane: N independent backend sub-indexes behind
        the chain-hash facade. Metrics instrumentation wraps the FACADE
        (one logical read = one lookup metric, as on a single index); the
        events plane accounts its applies itself."""
        import dataclasses

        from ..kvcache.kvblock import InstrumentedIndex, create_index
        from ..kvcache.sharding import ShardedIndex

        base = self._index_config(cfg)
        shard_cfg = dataclasses.replace(
            base, enable_metrics=False, metrics_logging_interval=0.0
        )
        if shard_cfg.native_memory is not None:
            # Native shards share ONE intern table, which is what lets the
            # facade serve score fan-outs in a single C call (shared locks
            # inside, no Python lock).
            from ..kvcache.kvblock.native_memory import NativeMemoryIndex

            shards = NativeMemoryIndex.shard_group(
                cfg.scorer_shards, shard_cfg.native_memory
            )
        else:
            shards = [create_index(shard_cfg) for _ in range(cfg.scorer_shards)]
        self.sharded_index = ShardedIndex(
            shards, vnodes=cfg.scorer_shard_vnodes
        )
        log.info(
            "sharded control plane enabled",
            shards=cfg.scorer_shards,
            vnodes=cfg.scorer_shard_vnodes,
        )
        index = self.sharded_index
        if cfg.enable_metrics:
            collector.register()
            index = InstrumentedIndex(index)
            if cfg.metrics_logging_interval > 0:
                collector.start_metrics_logging(cfg.metrics_logging_interval)
        return index

    def __init__(
        self,
        config: Optional[ServiceConfig] = None,
        *,
        tokenizer=None,
        on_bad_block=None,
    ):
        """``on_bad_block`` (optional, ``fn(holder, block_hashes,
        medium)``): the fleet-revocation purge hook, threaded into the
        events pool. In-process fleet harnesses wire it to every pod's
        ``purge_bad_blocks`` so a ``BadBlock`` from one holder also
        destroys replica copies peers still store; a networked deployment
        leaves it None (index revocation here is what unroutes the bytes,
        and each holder quarantines its own copy at verify time)."""
        self.config = config or ServiceConfig()
        self._on_bad_block = on_bad_block
        cfg = self.config

        # Fleet health is always attached (observation is free); expiry +
        # sweeping only activate when POD_TTL_S > 0.
        self.fleet_health = FleetHealth(FleetHealthConfig(pod_ttl_s=cfg.pod_ttl_s))
        #: SCORER_SHARDS: the raw chain-hash-partitioned facade (None on
        #: the legacy single-index plane). The indexer may additionally see
        #: it through the instrumented decorator; the events plane applies
        #: to the raw sub-indexes.
        self.sharded_index = None
        #: last scrape's per-shard occupancy (written by the gauge refresh,
        #: read by the /stats sharding block — one walk per scrape)
        self._last_shard_sizes = None
        index = None
        if cfg.scorer_shards > 0:
            index = self._build_sharded_index(cfg)
        self.indexer = KVCacheIndexer(
            KVCacheIndexerConfig(
                token_processor=TokenProcessorConfig(
                    block_size=cfg.block_size, hash_seed=cfg.hash_seed
                ),
                index=self._index_config(cfg),
                tokenization_pool=TokenizationPoolConfig(
                    hf_tokenizer=HFTokenizerConfig(huggingface_token=cfg.hf_token)
                ),
            ),
            index=index,
            tokenizer=tokenizer,
            fleet_health=self.fleet_health,
        )
        #: routing-quality observability (OBS_AUDIT / OBS_METRICS): the
        #: staleness tracker rides event ingest whenever either surface
        #: wants it (events-behind needs the seq high-waters); the route
        #: auditor only with the audit knob. None (default) = the pool
        #: runs bit-identical legacy. Under SCORER_SHARDS each shard lane
        #: gets its own tracker (shard-labeled gauges) and ``staleness``
        #: becomes the merged read view over them.
        from ..obs.audit import MergedStaleness, RouteAuditor, StalenessTracker

        self._shard_staleness = None
        if cfg.obs_audit or cfg.obs_metrics:
            if self.sharded_index is not None:
                self._shard_staleness = [
                    StalenessTracker(shard=str(i))
                    for i in range(cfg.scorer_shards)
                ]
                self.staleness = MergedStaleness(self._shard_staleness)
            else:
                self.staleness = StalenessTracker()
        else:
            self.staleness = None
        #: scorer-side block-lifecycle ledger (OBS_LIFECYCLE): fed from
        #: the event stream (the pool's BlockStored/BlockRemoved feed),
        #: metric callbacks into the global collector registry. None
        #: (default) = the pool runs bit-identical legacy.
        self.lifecycle = None
        if cfg.obs_lifecycle:
            from ..obs.lifecycle import BlockLifecycleLedger

            self.lifecycle = BlockLifecycleLedger(
                ring=cfg.obs_lifecycle_ring,
                on_transition=collector.observe_tier_transition,
                on_residency=collector.observe_tier_residency,
            )
            # A TTL-swept pod must leave the ledger too (PodDrained and
            # resync wipes are fed by the pools; the sweeper bypasses
            # them and talks straight to the index).
            self.fleet_health.on_pod_swept = (
                lambda pod: self.lifecycle.observe_pod_gone(pod, "ttl_swept")
            )
        #: fleet miss-ratio-curve registry: per-pod ``/debug/mrc``
        #: payloads, pushed by pods (POST /debug/mrc) or an in-process
        #: fleet harness, aggregated on read into the ONE fleet curve the
        #: fleet controller scales on. Plain dict + lock, no knob: an
        #: empty registry answers disabled-shaped, same as a pod with
        #: OBS_LIFECYCLE off — nothing changes until somebody reports.
        self._pod_mrc: dict[str, dict] = {}  # guarded_by: _pod_mrc_mu
        self._pod_mrc_mu = threading.Lock()
        #: predicted-TTFT routing (ROUTE_PREDICT): the latency model +
        #: per-pod corrector. None (default) = no predictor, no new body
        #: fields read, bit-identical responses and /stats.
        if cfg.route_predict:
            from ..kvcache.predictor import TTFTPredictor, TTFTPredictorConfig

            self.predictor = TTFTPredictor(
                TTFTPredictorConfig(
                    block_size=cfg.block_size,
                    heartbeat_interval_s=cfg.route_predict_heartbeat_s,
                )
            )
        else:
            self.predictor = None
        self.route_auditor = (
            RouteAuditor(
                index=self.indexer.kv_block_index,
                fleet_health=self.fleet_health,
                ring=cfg.obs_audit_ring,
                # The audit plane as an actuator: joins carrying realized
                # TTFT correct the routing model's per-pod bias.
                ttft_corrector=(
                    self.predictor.corrector
                    if self.predictor is not None
                    else None
                ),
            )
            if cfg.obs_audit
            else None
        )
        if self.sharded_index is not None:
            from ..kvcache.sharding import (
                ShardedEventsPool,
                ShardedEventsPoolConfig,
            )

            self.events_pool = ShardedEventsPool(
                self.sharded_index,
                ShardedEventsPoolConfig(dispatchers=cfg.pool_concurrency),
                health=self.fleet_health,
                staleness=self._shard_staleness,
                audit=self.route_auditor,
                lifecycle=self.lifecycle,
                instrument=cfg.enable_metrics,
                on_bad_block=self._on_bad_block,
            )
            if isinstance(self.staleness, MergedStaleness):
                # Fold the plane's admission-edge backlog (batches queued
                # ahead of decode) into the events-behind view — per-shard
                # lane trackers only see work after dispatch.
                self.staleness.admission = self.events_pool.admission_behind
        else:
            self.events_pool = KVEventsPool(
                self.indexer.kv_block_index,
                KVEventsPoolConfig(concurrency=cfg.pool_concurrency),
                health=self.fleet_health,
                staleness=self.staleness,
                audit=self.route_auditor,
                lifecycle=self.lifecycle,
                on_bad_block=self._on_bad_block,
            )
        self.subscriber = ZMQSubscriber(
            self.events_pool,
            ZMQSubscriberConfig(endpoint=cfg.zmq_endpoint, topic_filter=cfg.zmq_topic),
        )
        self.chat = ChatTemplatingProcessor()
        #: last scoring response's scoreboard size (OBS_METRICS gauge echo)
        self._last_scoreboard_size = 0
        #: request tracing (OBS_TRACING; a disabled tracer is free)
        self.tracer = Tracer(
            enabled=cfg.obs_tracing,
            max_spans=cfg.obs_trace_buffer,
            service="scorer",
        )
        #: fleet observability federation (OBS_FED): the scorer-side
        #: scrape-and-join over every registered pod's surfaces. None
        #: (default) = no federator, /debug/fleet answers disabled-shaped,
        #: bit-identical /stats keys and exposition.
        self.federator = None
        if cfg.obs_fed:
            from ..obs.federation import FleetFederator

            self.federator = FleetFederator(
                health=self.fleet_health,
                staleness=self.staleness,
                ring=cfg.obs_fed_ring,
                timeout_s=cfg.obs_fed_timeout_s,
                on_scrape=collector.observe_fleet_scrape,
            )

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self.chat.initialize()
        self.indexer.run()
        self.events_pool.start()
        self.subscriber.start()
        self.fleet_health.start_sweeper(self.indexer.kv_block_index)
        log.info(
            "scoring service started",
            zmq=self.config.zmq_endpoint,
            block_size=self.config.block_size,
            pod_ttl_s=self.config.pod_ttl_s,
        )

    def shutdown(self) -> None:
        self.fleet_health.stop_sweeper()
        self.subscriber.shutdown()
        self.events_pool.shutdown()
        self.indexer.shutdown()
        self.chat.finalize()

    # -- handlers -----------------------------------------------------------
    async def handle_score_completions(self, request: web.Request) -> web.Response:
        from aiohttp import web

        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON body"}, status=400)
        prompt = body.get("prompt")
        model = body.get("model")
        if not isinstance(prompt, str) or not isinstance(model, str) or not model:
            return web.json_response(
                {"error": "fields 'prompt' (str) and 'model' (str) are required"},
                status=400,
            )
        pods = body.get("pod_identifiers") or []
        placement, bad = _parse_placement(body)
        if bad is not None:
            return bad
        headers, scores, degraded, predicted = await self._traced_score(
            request, "/score_completions", prompt, model, pods, placement,
            request_id=self._audit_request_id(body),
            signals=self._parse_signals(body, placement, pods),
        )
        if degraded is not None:
            return web.json_response(
                {"scores": {}, "degraded": degraded}, headers=headers
            )
        return web.json_response(
            {
                "scores": scores,
                # Key appears only under ROUTE_PREDICT with signals
                # supplied: knobs-off responses keep their legacy keys.
                **(
                    {"predicted_ttft_s": predicted}
                    if predicted is not None
                    else {}
                ),
            },
            headers=headers,
        )

    def _audit_request_id(self, body: dict) -> Optional[str]:
        """The optional ``request_id`` scoring-body field, read ONLY with
        the audit knob on — the knobs-off request path inspects no body
        fields it didn't before."""
        if self.route_auditor is None:
            return None
        rid = body.get("request_id")
        return rid if isinstance(rid, str) and rid else None

    def _parse_signals(self, body: dict, placement=None, candidates=None):
        """The optional ``signals`` scoring-body field (ROUTE_PREDICT):
        ``[{"pod": str, "queue_depth": num?, "prefill_rate": num?}, ...]``
        — the caller's serving-plane telemetry, merged with the
        heartbeat-derived half (signal age, draining/expired, role) from
        fleet health. Read ONLY with the predict knob on; malformed rows
        are skipped (a bad signal must not fail scoring). Rows naming
        pods outside ``candidates`` (the request's ``pod_identifiers``,
        when given) or whose advertised role cannot serve ``placement``
        are dropped — ``predicted_ttft_s`` must never steer the caller
        toward a pod the scoreboard's own filters would have rejected."""
        if self.predictor is None:
            return None
        raw = body.get("signals")
        if not isinstance(raw, list) or not raw:
            return None
        from ..kvcache.predictor import PodSignals

        allowed = set(candidates) if candidates else None
        # Same role gate as FleetHealth.filter_scores (kvstore is
        # excluded by the predictor itself; "pull_source" has no gate).
        wrong_role = {
            "prefill": {"decode"},
            "decode": {"prefill"},
        }.get(placement, set())
        # Scope the fleet-health cut to the pods this request names —
        # an O(fleet) locked walk per scoring request would scale with
        # fleet size, not request size.
        named = [
            row["pod"]
            for row in raw
            if isinstance(row, dict) and isinstance(row.get("pod"), str)
        ]
        views = self.indexer.signal_views(named)
        sigs = []
        for row in raw:
            if not isinstance(row, dict) or not isinstance(
                row.get("pod"), str
            ):
                continue
            if allowed is not None and row["pod"] not in allowed:
                continue
            view = views.get(row["pod"], {})
            if view.get("role") in wrong_role:
                continue
            qd = row.get("queue_depth")
            pr = row.get("prefill_rate")
            sigs.append(
                PodSignals(
                    name=row["pod"],
                    queue_depth=(
                        float(qd)
                        if isinstance(qd, (int, float))
                        and not isinstance(qd, bool)
                        else None
                    ),
                    prefill_rate=(
                        float(pr)
                        if isinstance(pr, (int, float))
                        and not isinstance(pr, bool)
                        and pr > 0
                        else None
                    ),
                    draining=bool(view.get("draining", False)),
                    dead=bool(view.get("expired", False)),
                    role=view.get("role"),
                    signal_age_s=view.get("age_s"),
                )
            )
        return sigs or None

    async def _traced_score(
        self,
        request: web.Request,
        endpoint: str,
        prompt: str,
        model: str,
        pods,
        placement=None,
        request_id: Optional[str] = None,
        signals=None,
    ):
        """The one scoring path both endpoints share: trace mint-or-adopt
        (the scoring service is the fleet's front door, so the trace id
        established here is the one the router forwards to the serving pod
        and the pod to its transfer peer), score off the event loop, score
        latency + degradation accounting. Returns ``(headers, scores,
        degraded)`` — ``degraded`` is the error string when the index
        backend failed: degrade to an empty scoreboard so the router falls
        back to a cold placement and the REQUEST still serves, just
        without cache affinity (a 500 here would turn an index outage
        into a serving outage). ``placement`` ("prefill"/"decode"/None)
        is the disagg tier being placed for — pods whose advertised role
        cannot serve it are dropped from the scoreboard.

        ``signals`` (ROUTE_PREDICT, parsed ``PodSignals``): the modeled
        per-pod TTFT rides back as the fourth tuple element so an
        external router can argmin on latency instead of score-max —
        None everywhere else, and the response then carries no new key.
        Returns ``(headers, scores, degraded, predicted_ttft)``."""
        loop = asyncio.get_running_loop()
        span = self.tracer.start_span(
            "scorer.score",
            parent=parse_traceparent(request.headers.get("traceparent"))
            if self.tracer.enabled
            else None,
            attrs={"endpoint": endpoint, "model": model},
        )
        headers = (
            {"traceparent": format_traceparent(span.context)}
            if span.context is not None
            else None
        )
        with span, log_context(
            trace_id=span.context.trace_id if span.context else None
        ):
            t0 = time.perf_counter()
            try:
                if signals is not None and self.predictor is not None:
                    # The predict path tokenizes once and scores the
                    # token ids directly (the pool's prefix store makes
                    # the split free), because the latency model needs
                    # the prompt's token length for its miss term.
                    def score_with_len():
                        toks = self.indexer.tokenization_pool.tokenize(
                            prompt, model
                        )
                        return (
                            self.indexer.score_tokens(
                                toks, model, pods, placement
                            ),
                            len(toks),
                        )

                    scores, prompt_len = await loop.run_in_executor(
                        None, score_with_len
                    )
                else:
                    scores = await loop.run_in_executor(
                        None, self.indexer.get_pod_scores, prompt, model,
                        pods, placement,
                    )
                    prompt_len = None
            except Exception as exc:
                log.exception("scoring failed; degrading to empty scoreboard")
                collector.bump("scorer_errors")
                collector.scorer_errors.inc()
                span.set_attr("error", type(exc).__name__)
                return headers, None, str(exc), None
            collector.observe_score_latency(
                time.perf_counter() - t0,
                # OBS_EXEMPLARS: the observing request's trace id rides
                # the histogram bucket as an OpenMetrics exemplar.
                trace_id=(
                    span.context.trace_id
                    if self.config.obs_exemplars and span.context is not None
                    else None
                ),
            )
            span.set_attr("pods_scored", len(scores))
            if self.config.obs_metrics:
                collector.set_scoreboard_size(len(scores))
                self._last_scoreboard_size = len(scores)
            predicted = None
            if (
                signals is not None
                and self.predictor is not None
                and prompt_len
            ):
                arms = self.predictor.predict_routes(
                    signals, prompt_len, scores
                )
                if arms:
                    predicted = {
                        p: round(a.ttft_s, 6)
                        for p, a in arms.items()
                        if a.ttft_s != float("inf")
                    }
                    if predicted:
                        collector.observe_predicted_ttft(
                            min(predicted.values())
                        )
            if self.route_auditor is not None and request_id is not None:
                # The scorer's half of the audit: the scoreboard this
                # request saw, with the argmax pod standing in for the
                # caller's eventual pick (the HTTP deployment's router is
                # external; an in-process BlendedRouter records richer
                # decisions itself) — under ROUTE_PREDICT the stand-in
                # is the latency argmin, the pod the caller will pick.
                # Empty scoreboard = an honest cold prediction of 0
                # blocks.
                if predicted:
                    chosen = min(
                        predicted, key=lambda p: (predicted[p], p)
                    )
                else:
                    chosen = (
                        max(scores, key=lambda p: (scores[p], p))
                        if scores
                        else ""
                    )
                predicted_ttft_chosen = None
                if predicted and chosen in predicted:
                    predicted_ttft_chosen = predicted[chosen]
                self.route_auditor.record_decision(
                    request_id,
                    chosen_pod=chosen,
                    predicted_blocks=scores.get(chosen, 0),
                    index_blocks=scores.get(chosen, 0),
                    scoreboard=scores,
                    model=model,
                    trace_id=(
                        span.context.trace_id
                        if span.context is not None
                        else None
                    ),
                    predicted_ttft_s=predicted_ttft_chosen,
                )
        return headers, scores, None, predicted

    async def handle_score_chat_completions(self, request: web.Request) -> web.Response:
        from aiohttp import web

        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON body"}, status=400)
        messages = body.get("messages")
        model = body.get("model")
        if not isinstance(messages, list) or not messages or not model:
            return web.json_response(
                {"error": "fields 'messages' (list) and 'model' (str) are required"},
                status=400,
            )
        # Validate before the template render: an invalid placement is a
        # guaranteed 400 and must not pay the fetch+render first.
        placement, bad = _parse_placement(body)
        if bad is not None:
            return bad
        loop = asyncio.get_running_loop()

        def render():
            template, template_vars = self.chat.fetch_chat_template(
                FetchTemplateRequest(
                    model=model,
                    chat_template=body.get("chat_template"),
                    token=self.config.hf_token,
                )
            )
            rendered = self.chat.render_chat_template(
                RenderRequest(
                    conversations=[messages],
                    chat_template=template,
                    tools=body.get("tools"),
                    add_generation_prompt=body.get("add_generation_prompt", True),
                    continue_final_message=body.get("continue_final_message", False),
                    template_vars=template_vars,
                )
            )
            return rendered.rendered_chats[0]

        # Template fetch/render failures are deterministic request problems
        # (malformed messages, bad chat_template) — a 400 the client can
        # act on, NOT a degradation: masking them as empty scores would
        # cold-place the broken request forever and pollute the
        # scorer-error counter that alerts on index outages.
        try:
            prompt = await loop.run_in_executor(None, render)
        except Exception as exc:
            log.exception("chat template render failed")
            return web.json_response({"error": str(exc)}, status=400)
        headers, scores, degraded, predicted = await self._traced_score(
            request, "/score_chat_completions", prompt, model,
            body.get("pod_identifiers") or [], placement,
            request_id=self._audit_request_id(body),
            signals=self._parse_signals(
                body, placement, body.get("pod_identifiers") or []
            ),
        )
        if degraded is not None:
            # Index backend down: same degradation contract as
            # /score_completions — cost cache affinity, not the request.
            return web.json_response(
                {"scores": {}, "degraded": degraded}, headers=headers
            )
        return web.json_response(
            {
                "scores": scores,
                "rendered_prompt_chars": len(prompt),
                **(
                    {"predicted_ttft_s": predicted}
                    if predicted is not None
                    else {}
                ),
            },
            headers=headers,
        )

    def _refresh_index_gauges(self) -> Optional[dict]:
        """Scrape-driven index-occupancy snapshot: updates the
        ``kvcache_index_blocks`` / ``kvcache_index_pods`` gauges and
        returns the raw dict for /stats (None when the backend cannot
        answer cheaply, e.g. Redis). The walk is O(index keys) — callers
        on the event loop must push it to the executor."""
        try:
            if self.sharded_index is not None:
                # ONE per-shard walk per scrape feeds everything: the
                # shard-labeled gauges (where the keys actually live), the
                # truthful aggregate (blocks summed over disjoint ranges,
                # pods unioned), and the /stats sharding block (which
                # reads the stashed snapshot instead of re-walking).
                per = self.sharded_index.per_shard_size_info()
                self._last_shard_sizes = per
                for i, p in enumerate(per):
                    if p is not None:
                        collector.set_shard_index_size(
                            str(i), p["blocks"], p["pods"]
                        )
                if any(p is None for p in per):
                    info = None
                else:
                    names = self.sharded_index.pod_names()
                    info = {
                        "blocks": sum(p["blocks"] for p in per),
                        "pods": (
                            len(names)
                            if names is not None
                            else max((p["pods"] for p in per), default=0)
                        ),
                    }
            else:
                info = self.indexer.kv_block_index.size_info()
        except Exception:
            log.exception("index size_info failed")
            return None
        if info is not None:
            collector.set_index_size(info["blocks"], info["pods"])
        return info

    async def handle_metrics(self, request: web.Request) -> web.Response:
        from aiohttp import web

        await asyncio.get_running_loop().run_in_executor(
            None, self._refresh_index_gauges
        )
        try:
            import prometheus_client

            if self.config.obs_exemplars:
                # Exemplars render only in the OpenMetrics exposition —
                # the classic text format silently drops them. aiohttp's
                # content_type= rejects parameterized types, so the full
                # header rides the headers dict.
                from prometheus_client.openmetrics import exposition as om

                return web.Response(
                    body=om.generate_latest(prometheus_client.REGISTRY),
                    headers={"Content-Type": om.CONTENT_TYPE_LATEST},
                )
            data = prometheus_client.generate_latest()
            return web.Response(
                body=data, content_type="text/plain", charset="utf-8"
            )
        except ImportError:
            from ..kvcache.metrics import collector

            return web.json_response(collector.snapshot())

    async def handle_healthz(self, request: web.Request) -> web.Response:
        from aiohttp import web

        return web.json_response({"status": "ok"})

    async def handle_stats(self, request: web.Request) -> web.Response:
        """Self-healing observability: per-pod health + stream-integrity
        counters (gaps/resyncs/sweeps/drops), subscriber drop counts, and
        the index collector's shadow counters."""
        from aiohttp import web

        from ..kvcache.metrics import collector

        # Occupancy first (off the event loop — O(index keys) walk), so the
        # snapshot below carries the fresh index_blocks/index_pods shadow
        # values too.
        index_size = await asyncio.get_running_loop().run_in_executor(
            None, self._refresh_index_gauges
        )
        payload = {
            "fleet": self.fleet_health.snapshot(),
            "subscriber": {
                "malformed_dropped": dict(self.subscriber.malformed_dropped),
            },
            "events_rejected_after_shutdown": (
                self.events_pool.rejected_after_shutdown
            ),
            "index_size": index_size,
            "index": collector.snapshot(),
        }
        # New blocks only behind their knobs: the knobs-off /stats payload
        # keeps its legacy field set bit-identical. The staleness tracker
        # is snapshotted ONCE and shared by the obs + staleness blocks —
        # two separate reads (the earlier shape) could tear: an event
        # applied between them made the obs block's events-behind disagree
        # with the staleness block's in the same response.
        stale_snap = (
            self.staleness.snapshot() if self.staleness is not None else None
        )
        if self.config.obs_metrics:
            payload["obs"] = {
                "scoreboard_size": self._last_scoreboard_size,
                "events_behind": (
                    stale_snap["events_behind"]
                    if stale_snap is not None
                    else {}
                ),
            }
        if stale_snap is not None and self.config.obs_audit:
            payload["staleness"] = stale_snap
        if self.lifecycle is not None:
            # Gated on OBS_LIFECYCLE: the knobs-off /stats payload keeps
            # its legacy field set bit-identical.
            payload["lifecycle"] = self.lifecycle.snapshot()
        if self.route_auditor is not None:
            payload["audit"] = self.route_auditor.snapshot()
        if self.predictor is not None:
            # Gated on ROUTE_PREDICT: the latency model's honesty
            # surface — prediction/abstention counts and the per-pod
            # corrector biases the audit joins have learned.
            payload["predict"] = self.predictor.snapshot()
        if self.sharded_index is not None:
            # Gated on SCORER_SHARDS: the knobs-off /stats payload keeps
            # its legacy field set bit-identical. The per-shard occupancy
            # is the snapshot the gauge refresh above just walked — one
            # O(shards) walk per scrape, not two.
            payload["sharding"] = {
                "shards": self.sharded_index.n_shards,
                "vnodes": self.sharded_index.ring.vnodes,
                "misroutes": self.events_pool.misroute_snapshot(),
                "per_shard_index": self._last_shard_sizes,
            }
        if self.federator is not None:
            # Gated on OBS_FED: compact scrape accounting only — the full
            # fleet join is /debug/fleet's job.
            payload["fed"] = self.federator.snapshot()
        return web.json_response(payload)

    async def handle_debug_traces(self, request: web.Request) -> web.Response:
        from aiohttp import web

        from ..obs.tracing import debug_traces_payload

        status, payload = debug_traces_payload(self.tracer, request.query)
        return web.json_response(payload, status=status)

    async def handle_debug_staleness(self, request: web.Request) -> web.Response:
        """Per-(pod, event type) publish→visibility histograms + the
        events-behind gauge state. Reports itself disabled (like
        /debug/traces) until OBS_AUDIT/OBS_METRICS attaches the tracker."""
        from aiohttp import web

        from ..obs.audit import debug_staleness_payload

        status, payload = debug_staleness_payload(
            self.staleness, request.query
        )
        return web.json_response(payload, status=status)

    async def handle_debug_audit(self, request: web.Request) -> web.Response:
        """Recent joined predicted-vs-realized audits, filterable by
        ``?request_id=`` / ``?trace_id=``; disabled until OBS_AUDIT."""
        from aiohttp import web

        from ..obs.audit import debug_audit_payload

        status, payload = debug_audit_payload(self.route_auditor, request.query)
        return web.json_response(payload, status=status)

    async def handle_debug_lifecycle(self, request: web.Request) -> web.Response:
        """The fleet's block tier story as seen from the event stream:
        recent per-pod transitions, filterable by ``?chain=``/``?block=``
        hash; disabled until OBS_LIFECYCLE."""
        from aiohttp import web

        from ..obs.lifecycle import debug_lifecycle_payload

        status, payload = debug_lifecycle_payload(self.lifecycle, request.query)
        return web.json_response(payload, status=status)

    # -- fleet miss-ratio curve (the autoscaler's capacity signal) ----------
    def report_mrc(self, pod: str, payload: Optional[dict]) -> None:
        """Register one pod's ``/debug/mrc`` payload (None drops the pod
        from the aggregate — a retired pod's stale curve must not keep
        voting). Called by the POST handler and by in-process fleet
        harnesses directly."""
        with self._pod_mrc_mu:
            if payload is None:
                self._pod_mrc.pop(pod, None)
            else:
                self._pod_mrc[pod] = payload

    def fleet_mrc(self) -> dict:
        """The fleet-aggregated miss-ratio curve: per-pod sampled curves
        merged sampled-weighted (aggregate == per-pod sum of sampled hits
        over summed samples — pinned by test)."""
        from ..kvcache.controller.mrc import aggregate_mrc

        with self._pod_mrc_mu:
            per_pod = dict(self._pod_mrc)
        return aggregate_mrc(per_pod)

    async def handle_debug_mrc(self, request: web.Request) -> web.Response:
        """GET: the fleet curve (disabled-shaped until any pod reports).
        POST: ``{"pod": ..., "mrc": {...}}`` registers a pod's curve
        (``"mrc": null`` withdraws it)."""
        from aiohttp import web

        if request.method == "POST":
            try:
                body = await request.json()
                pod = body["pod"]
                mrc = body.get("mrc")
                if not isinstance(pod, str) or not (
                    mrc is None or isinstance(mrc, dict)
                ):
                    raise TypeError
            except Exception:
                return web.json_response(
                    {"error": "want {'pod': str, 'mrc': dict|null}"},
                    status=400,
                )
            self.report_mrc(pod, mrc)
            return web.json_response({"ok": True})
        # The Tracer limit contract on the GET side: ?limit= caps fleet
        # curve rows (limit<=0 returns nothing), tolerant 400 on junk.
        try:
            limit = int(request.query.get("limit", "64"))
        except ValueError:
            return web.json_response(
                {"error": "invalid limit (want an int)"}, status=400
            )
        payload = self.fleet_mrc()
        if "curve" in payload:
            payload["curve"] = payload["curve"][: max(limit, 0)]
        return web.json_response(payload)

    async def handle_debug_fleet(self, request: web.Request) -> web.Response:
        """The federated fleet snapshot: a FRESH scrape-and-join over
        every registered pod (pushed to an executor — the HTTP fetch path
        blocks) plus the delta-ring history; disabled-shaped until
        OBS_FED attaches the federator."""
        from aiohttp import web

        from ..obs.federation import debug_fleet_payload

        status, payload = await asyncio.get_running_loop().run_in_executor(
            None, debug_fleet_payload, self.federator, request.query
        )
        return web.json_response(payload, status=status)

    def build_app(self) -> web.Application:
        from aiohttp import web

        app = web.Application()
        app.router.add_post("/score_completions", self.handle_score_completions)
        app.router.add_post("/score_chat_completions", self.handle_score_chat_completions)
        app.router.add_get("/metrics", self.handle_metrics)
        app.router.add_get("/healthz", self.handle_healthz)
        app.router.add_get("/stats", self.handle_stats)
        app.router.add_get("/debug/traces", self.handle_debug_traces)
        app.router.add_get("/debug/staleness", self.handle_debug_staleness)
        app.router.add_get("/debug/audit", self.handle_debug_audit)
        app.router.add_get("/debug/lifecycle", self.handle_debug_lifecycle)
        app.router.add_get("/debug/mrc", self.handle_debug_mrc)
        app.router.add_post("/debug/mrc", self.handle_debug_mrc)
        app.router.add_get("/debug/fleet", self.handle_debug_fleet)
        return app


def main() -> None:
    from aiohttp import web

    config = ServiceConfig.from_env()
    service = ScoringService(config)
    service.start()
    app = service.build_app()

    async def on_shutdown(_app):
        service.shutdown()

    app.on_shutdown.append(on_shutdown)
    web.run_app(app, port=config.http_port)


if __name__ == "__main__":
    main()
