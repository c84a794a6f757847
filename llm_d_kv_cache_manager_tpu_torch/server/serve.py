"""GPU pod serving binary: the port's ``PodServer``.

The port of the JAX package's ``server/serve.py``: a continuous-batching
``Engine`` wrapped in

- a background engine-loop thread (the only thread that touches the
  engine), fed by ``submit`` / ``generate`` through a staging queue,
- a ZMQ KV-event publisher wired to the block manager's alloc/evict
  transitions (``kv@<pod>@<model>`` topic, msgpack batches — the same wire
  the indexer's subscriber reads from the JAX pods),
- an OpenAI-style HTTP surface: ``POST /v1/completions``, ``GET /healthz``,
  ``POST /drain``, ``GET /stats``, ``GET /metrics``, ``GET /debug/traces``,
  ``GET /debug/lifecycle``, ``GET /debug/mrc``, ``GET /debug/flight`` and
  ``POST /debug/profile``.

Ported knobs: per-request deadlines (the ``X-Request-Deadline`` header, a
budget in seconds, and the ``REQUEST_DEADLINE_S`` default), the host-DRAM
tier (``HOST_PAGES``, ``KV_QUANT``, ``HOST_PREFETCH``,
``HOST_TIER_POLICY``), the cross-pod KV transfer plane (the
``TRANSFER_ENDPOINT`` export service, a ZMQ ROUTER whose handler hops onto
the engine loop; the blocking ``pull_prefix`` and ``ASYNC_PULL``, where a
request submitted with ``pull_source``, or over HTTP with an
``X-Pull-Source`` header, waits ``importing`` while a worker fetches its
prefix; a pool of DEALER clients with the per-peer circuit breaker,
``TRANSFER_*``, ``PULL_WORKERS``; a failed pull falls back to cold
prefill), and the pod's fleet contract:

- fleet self-healing: ``HEARTBEAT_INTERVAL_S`` (``Heartbeat`` beacons that
  carry the ``draining`` flag) and ``RESYNC_INTERVAL_S`` (periodic
  ``IndexSnapshot`` resyncs, the digest read and published on the engine
  loop; ``publish_index_snapshot`` on demand);
- admission control: ``ADMISSION_MAX_WAITING`` and
  ``ADMISSION_MAX_QUEUED_TOKENS`` shed with ``AdmissionError`` (HTTP 429 and
  ``Retry-After`` from the measured serving rates) before the engine is
  touched;
- graceful drain: ``drain`` / ``POST /drain`` / SIGTERM — submits answer
  503, ``/healthz`` turns 503, in-flight requests get ``DRAIN_TIMEOUT_S``,
  then the final ``IndexSnapshot`` and the ``PodDrained`` goodbye;
- the load signals a router reads (``queue_depth``, ``prefill_rate``,
  ``is_alive``, ``is_draining``, ``open_breaker_endpoints``);
- observability: ``OBS_TRACING``/``OBS_TRACE_BUFFER`` (request spans with
  W3C ``traceparent`` propagation, ``/debug/traces``), ``OBS_METRICS``
  (latency-decomposition histograms and the engine's step telemetry on
  ``/metrics``, an ``obs`` block on ``/stats``; step phases are host clocks,
  as in the JAX engine, so on CUDA they time launches and host waits, not
  device work), ``OBS_PROFILE_DIR`` (``/debug/profile`` writes a
  ``torch.profiler`` Chrome trace there), the router's ``X-Route-Action``
  label on the request histograms, the ``pod.pull_prefix`` spans and the
  pull and pull-overlap histograms, ``OBS_EXEMPLARS`` (trace ids on the
  latency buckets, ``/metrics`` in the OpenMetrics format) and
  ``OBS_AUDIT`` (a ``RequestAudit`` event per finished request, the
  realized prefix hit the scorer's route auditor joins);
- the fleet's control loops: ``OBS_SLO``/``OBS_SLO_WINDOWS`` (in-process
  SLO burn rates), ``OBS_LIFECYCLE``/``OBS_LIFECYCLE_RING``/``OBS_MRC_*``
  (the block-lifecycle ledger and the reuse-distance miss-ratio curve on
  the block manager's hooks, ``/debug/lifecycle`` and ``/debug/mrc``),
  ``OBS_FLIGHT*`` (the flight recorder: engine steps and fleet events on
  a ring, dumped as one timeline on an SLO burn, a breaker opening or a
  resync; ``/debug/flight``) and ``FLEET_CONTROLLER`` (live migration of
  in-flight decodes over the transfer plane, ``migrate_out`` /
  ``migrated_future``, and the warm-chain donor and revival side of a
  scale-up, ``warm_chains`` / ``revive_chain``; ``kvcache.controller``'s
  ``FleetController`` drives them).

Every knob defaults off, and then every response, ``/stats`` key and wire
byte equals the knobs-off JAX pod's.

The fleet's knob-gated glue:

- disaggregated roles: ``POD_ROLE`` ``prefill`` clamps every request to its
  first token and announces the finished chain with a ``PrefillComplete``
  event, ``decode`` takes the handed-off requests, ``kvstore`` holds demoted
  blocks and serves no request; the role rides the ``Heartbeat`` and a
  ``disagg`` block on ``/stats`` (``kvcache.disagg``'s ``DisaggCoordinator``
  drives the two hops);
- the remote tier: ``REMOTE_TIER``, ``REMOTE_STORE_PAGES``, ``REMOTE_PEERS``
  and ``REMOTE_DEMOTE_QUEUE`` (last-copy evictions pushed to the peer with
  the most headroom by a background pusher; pushes from peers hop onto the
  engine loop into the remote store; the heartbeat carries the headroom);
- KV-block integrity: ``KV_INTEGRITY``, ``INTEGRITY_SCRUB_INTERVAL_S``,
  ``INTEGRITY_SCRUB_PAGES`` and ``INTEGRITY_TABLE_CAP`` (a background scrub
  of the host slots on the engine loop; the integrity ``/metrics`` families
  and ``/stats`` block; ``purge_bad_blocks`` for the fleet's revocations);
- tenant QoS: ``TENANT_QOS`` (the ``X-Tenant`` header, per-tenant admission
  budgets, priority classes with preemption, weighted shares, cache-share
  caps, and the tenant slices of the SLO recorder and the MRC);
- speculative decoding: ``SPEC_DECODE=prompt_lookup``, ``SPEC_K``,
  ``SPEC_NGRAM``, ``SPEC_ROUNDS``, ``SPEC_MIN_ACCEPT``, ``SPEC_MIN_SAMPLE``
  and ``SPEC_MAX_SCAN`` (the engine's ``spec_*`` fields), mirrored into the
  four ``tpu_pod_spec_*`` counters every step.

Run: ``python -m llm_d_kv_cache_manager_tpu_torch.server.serve`` (needs
aiohttp, and pyzmq for publishing; prometheus_client for ``/metrics``).
"""

from __future__ import annotations

import math
import os
import socket
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field, replace
from typing import Optional

from ..kvcache.kvevents import (
    Heartbeat,
    IndexSnapshot,
    PodDrained,
    PrefillComplete,
    RequestAudit,
    ZMQPublisher,
    ZMQPublisherConfig,
)
from ..kvcache.transfer import (
    KVTransferClient,
    KVTransferService,
    MigrationPayload,
    TransferClientConfig,
    TransferClientPool,
    TransferError,
    TransferServiceConfig,
)
from ..models import (
    LLAMA_3_8B,
    QWEN3_30B_A3B,
    TINY_GEMMA,
    TINY_LLAMA,
    TINY_MOE,
    TINY_QWEN3_MOE,
    LlamaConfig,
)
from ..obs import lifecycle as lifecycle_mod
from ..obs.tracing import Tracer, debug_traces_payload, format_traceparent, parse_traceparent
from ..utils import get_logger, log_context
from .block_manager import BlockManagerConfig
from .engine import Engine, EngineConfig
from .sequence import SamplingParams, Sequence

log = get_logger("server.serve")


class AdmissionError(RuntimeError):
    """Request rejected by admission control (the pod is overloaded).
    Carries a ``retry_after_s`` hint derived from the measured serving
    rates — the HTTP surface turns it into ``429`` + ``Retry-After``."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DrainingError(RuntimeError):
    """Request rejected (or terminated) because the pod is draining for a
    rolling restart — clients should retry against another pod (503)."""


def admission_reject_response(web, err: AdmissionError):
    """The one 429 shape for every admission-reject site: the JSON body
    carries the float hint verbatim; the ``Retry-After`` header is the
    hint rounded UP to whole seconds (RFC 9110 allows only integers) and
    floored at 1 — truncation would turn a 0.2 s hint into ``0``, an
    immediate-retry invitation to the exact client being shed.
    ``web`` is the caller's ``aiohttp.web`` module (imported lazily by
    the HTTP surface, so this helper takes it rather than importing)."""
    retry_after = max(int(-(-err.retry_after_s // 1)), 1)
    return web.json_response(
        {"error": str(err), "retry_after_s": err.retry_after_s},
        status=429,
        headers={"Retry-After": str(retry_after)},
    )


class _ServingMetrics:
    """Prometheus serving metrics (the pod-side analogue of the indexer's
    collector): request/token counters, prefix-cache savings, TTFT histogram.
    Inert when prometheus_client is unavailable."""

    def __init__(
        self,
        obs: bool = False,
        lifecycle: bool = False,
        tenant_qos: bool = False,
        integrity: bool = False,
        exemplars: bool = False,
    ):
        """``obs``: build the latency-decomposition histograms and
        engine-step telemetry series (``OBS_METRICS``). ``lifecycle``:
        build the block-lifecycle families (tier transitions, per-tier
        residency, reuse distance), fed by the ``OBS_LIFECYCLE`` ledger and
        estimator. ``tenant_qos``, ``integrity``: build the tenant SLO-burn
        and KV-integrity families. ``exemplars``: the latency histograms
        carry the observing request's trace id (``OBS_EXEMPLARS``). All
        off (default) keeps the exposition surface bit-identical to the
        knobs-off JAX pod's.

        Every family the JAX pod registers under these flags is registered
        here, so the exposition lists the same families."""
        # Measured serving rates (EMAs over request completions), kept
        # OUTSIDE the prometheus guard: admission control derives its
        # Retry-After hint from them, with or without prometheus_client.
        self.request_rate: Optional[float] = None  # finished requests / s
        self.token_rate: Optional[float] = None  # generated tokens / s
        self._last_finish: Optional[float] = None
        self._obs = bool(obs)
        self._lifecycle = bool(lifecycle)
        self._tenant_qos = bool(tenant_qos)
        self._integrity = bool(integrity)
        # OBS_EXEMPLARS: latency histograms attach the observing request's
        # trace_id per bucket, and exposition() switches to the OpenMetrics
        # format (the classic text format drops exemplars), so a tail
        # bucket resolves to /debug/traces?trace_id=<id>.
        self._exemplars = bool(exemplars)
        try:
            import prometheus_client as prom
        except ImportError:  # pragma: no cover
            self._prom = None
            return
        self._prom = prom
        self.registry = prom.CollectorRegistry()
        self.requests = prom.Counter(
            "tpu_pod_requests_total", "Completed requests", registry=self.registry
        )
        self.generated = prom.Counter(
            "tpu_pod_generated_tokens_total",
            "Generated tokens",
            registry=self.registry,
        )
        self.cached_prompt = prom.Counter(
            "tpu_pod_cached_prompt_tokens_total",
            "Prompt tokens served from the prefix cache",
            registry=self.registry,
        )
        self.ttft = prom.Histogram(
            "tpu_pod_ttft_seconds",
            "Time to first token",
            registry=self.registry,
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30),
        )
        # Speculative decoding (engine.spec_stats mirrored as counters;
        # acceptance rate = accepted/proposed).
        self.spec_proposed = prom.Counter(
            "tpu_pod_spec_proposed_tokens_total",
            "Speculative tokens proposed",
            registry=self.registry,
        )
        self.spec_accepted = prom.Counter(
            "tpu_pod_spec_accepted_tokens_total",
            "Speculative tokens accepted",
            registry=self.registry,
        )
        self.spec_verify = prom.Counter(
            "tpu_pod_spec_verify_steps_total",
            "Speculative verify rounds",
            registry=self.registry,
        )
        self.spec_bursts = prom.Counter(
            "tpu_pod_spec_bursts_total",
            "Speculative host-sync bursts (verify rounds per host sync = "
            "verify_steps/bursts)",
            registry=self.registry,
        )
        self._spec_seen = {"proposed": 0, "accepted": 0, "verify_steps": 0, "bursts": 0}
        # Overload protection / request lifecycle: admission sheds,
        # deadline expiries, aborts, drain activity.
        self.admission_rejected = prom.Counter(
            "kvcache_admission_rejected_total",
            "Requests rejected by admission control (429)",
            registry=self.registry,
        )
        self.admission_rejected_draining = prom.Counter(
            "kvcache_admission_draining_rejected_total",
            "Requests rejected because the pod was draining (503)",
            registry=self.registry,
        )
        self.deadline_shed = prom.Counter(
            "kvcache_admission_deadline_shed_total",
            "Deadline-expired requests shed before any prefill compute",
            registry=self.registry,
        )
        self.deadline_expired = prom.Counter(
            "kvcache_admission_deadline_expired_total",
            "Running requests finished early at their deadline",
            registry=self.registry,
        )
        self.requests_aborted = prom.Counter(
            "kvcache_admission_aborted_total",
            "Requests aborted mid-flight (client disconnect/timeout)",
            registry=self.registry,
        )
        self.drain_started = prom.Counter(
            "kvcache_drain_started_total",
            "Graceful drains started (SIGTERM / POST /drain)",
            registry=self.registry,
        )
        self.drain_completed = prom.Counter(
            "kvcache_drain_completed_total",
            "Graceful drains completed with every inflight request finished",
            registry=self.registry,
        )
        self.drain_forced = prom.Counter(
            "kvcache_drain_forced_requests_total",
            "Inflight requests aborted because the drain timeout expired",
            registry=self.registry,
        )
        self._lifecycle_seen = {
            "deadline_shed": 0, "deadline_expired": 0, "aborted": 0,
        }
        # Latency decomposition + engine-step telemetry: built only
        # under OBS_METRICS so the default exposition stays unchanged.
        if self._obs:
            slo_buckets = (
                0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
            )
            # TTFT/ITL get a denser grid: a full sub-100 ms decade plus
            # 0.15/0.2 splits of the old 0.1–0.25 gap, where a median
            # inside one 2.5x-wide bucket moved more with bucket placement
            # than with routing policy. queue/e2e/pull keep the legacy
            # grid.
            lat_buckets = (
                0.001, 0.0025, 0.005, 0.0075, 0.01, 0.015, 0.02, 0.03,
                0.04, 0.06, 0.08, 0.1, 0.15, 0.2, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0, 60.0,
            )
            req_labels = ["outcome", "finish"]
            self.req_ttft = prom.Histogram(
                "kvcache_request_ttft_seconds",
                "Time to first token, by cache outcome (warm/pull/cold) "
                "and finish reason",
                req_labels, registry=self.registry, buckets=lat_buckets,
            )
            self.req_itl = prom.Histogram(
                "kvcache_request_itl_seconds",
                "Mean inter-token latency per request "
                "((finish - first token) / (generated - 1))",
                req_labels, registry=self.registry, buckets=lat_buckets,
            )
            self.req_queue = prom.Histogram(
                "kvcache_request_queue_seconds",
                "Submit-to-first-prefill-dispatch wait",
                req_labels, registry=self.registry, buckets=slo_buckets,
            )
            self.req_e2e = prom.Histogram(
                "kvcache_request_e2e_seconds",
                "Submit-to-finish wall time",
                req_labels, registry=self.registry, buckets=slo_buckets,
            )
            self.transfer_pull = prom.Histogram(
                "kvcache_transfer_pull_seconds",
                "pull_prefix wall time (fetch + import), by outcome "
                "(ok/empty/failed)",
                ["outcome"], registry=self.registry, buckets=slo_buckets,
            )
            self.pull_overlap = prom.Histogram(
                "kvcache_transfer_pull_overlap_seconds",
                "Async KV-pull (ASYNC_PULL) wall time split by exposure: "
                "hidden = spent before the scheduler first wanted the "
                "sequence (overlapped with other work), exposed = the "
                "remainder (it delayed this sequence's prefill)",
                ["kind"], registry=self.registry, buckets=slo_buckets,
            )
            self.engine_steps = prom.Counter(
                "kvcache_engine_steps_total",
                "Engine iterations",
                registry=self.registry,
            )
            self.engine_phase_s = prom.Counter(
                "kvcache_engine_step_phase_seconds_total",
                "Cumulative engine-step wall seconds by phase (schedule/"
                "prefill/decode/sample/gather/demote/publish; gather, "
                "sample and demote overlap the dispatch phases). Host "
                "clocks: on CUDA a graph replay's decode seconds are its "
                "launch, and the wait for the device lands in sample",
                ["phase"], registry=self.registry,
            )
            self.engine_occupancy = prom.Gauge(
                "kvcache_engine_batch_occupancy",
                "Running decode lanes / decode_batch_size",
                registry=self.registry,
            )
            self.engine_free_pages = prom.Gauge(
                "kvcache_engine_free_pages",
                "Free KV pages in the HBM pool",
                registry=self.registry,
            )
            self.engine_loop_lag = prom.Gauge(
                "kvcache_engine_loop_lag_seconds",
                "EMA of host-side gap between engine iterations while work "
                "was pending (staging, bookkeeping, GIL pressure)",
                registry=self.registry,
            )
            self._step_seen = dict.fromkeys(
                (
                    "schedule_s", "prefill_s", "decode_s", "sample_s",
                    "gather_s", "demote_s", "publish_s",
                ),
                0.0,
            )
            self._steps_seen = 0
            # Host-DRAM tier + prefetch: tier occupancy, pages
            # served back from host DRAM (by path: ahead-of-scheduler
            # prefetch vs blocking allocate), and prefetch-round wall time.
            self.host_pages_g = prom.Gauge(
                "kvcache_host_pages",
                "KV blocks currently cached in the host-DRAM tier",
                registry=self.registry,
            )
            self.host_hits = prom.Counter(
                "kvcache_host_hits_total",
                "KV blocks brought back from the host-DRAM tier, by path "
                "(prefetch = ahead of the scheduler, allocate = blocking)",
                ["path"], registry=self.registry,
            )
            self.host_prefetch_s = prom.Histogram(
                "kvcache_host_prefetch_seconds",
                "Host-tier prefetch round wall time (hash walk + restore "
                "queueing; the DMA itself overlaps the step's dispatch)",
                registry=self.registry, buckets=slo_buckets,
            )
            self._host_seen = {"restored": 0, "prefetched": 0}
            # SLO burn rate: in-process evaluation of OBS_SLO
            # objectives against the same measurements the request
            # histograms observe; series appear only when an SLORecorder
            # feeds them (scrape-driven sync).
            self.slo_burn = prom.Gauge(
                "kvcache_slo_burn_rate",
                "Error-budget burn rate per OBS_SLO objective and sliding "
                "window (1.0 = budget burns at exactly its sustainable "
                "rate)",
                ["objective", "window"], registry=self.registry,
            )
        # Block-lifecycle families (OBS_LIFECYCLE): tier
        # transitions, per-tier residency, sampled reuse distance. Built
        # only under the lifecycle knob so the default exposition surface
        # stays unchanged; fed by the ledger/estimator callbacks.
        if self._lifecycle:
            self.block_transitions = prom.Counter(
                "kvcache_block_tier_transitions_total",
                "KV-block tier transitions recorded by the lifecycle "
                "ledger: from/to in {none, tpu_hbm, host_dram, remote}, "
                "reason = allocate/import/spill/restore/prefetch/demote "
                "(hand-off to the pusher; corrected by demote_failed on "
                "drop/failure)/evict",
                ["from", "to", "reason"], registry=self.registry,
            )
            self.block_residency = prom.Histogram(
                "kvcache_block_tier_residency_seconds",
                "How long a KV block stayed resident in a tier before "
                "leaving it (observed at departure)",
                ["tier"], registry=self.registry,
                buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                         120.0, 300.0, 600.0, 1800.0, 3600.0),
            )
            self.reuse_distance = prom.Histogram(
                "kvcache_reuse_distance_blocks",
                "Sampled LRU stack distance of prefix-block lookups, in "
                "blocks: P[distance < C] is the modeled hit rate of a "
                "C-block tier (the MRC behind /debug/mrc); cold accesses "
                "land in +Inf",
                registry=self.registry,
                buckets=tuple(
                    float(b) for b in lifecycle_mod.REUSE_DISTANCE_BUCKETS
                ),
            )
        # Tenant-sliced SLO burn (TENANT_QOS): same arithmetic as
        # kvcache_slo_burn_rate over the recorder's per-tenant slices.
        # Built only under the tenant knob so the default exposition
        # surface stays unchanged; tenant label values are the serving
        # layer's bounded slice keys, never raw header values.
        if self._tenant_qos:
            self.tenant_slo_burn = prom.Gauge(
                "kvcache_tenant_slo_burn_rate",
                "Error-budget burn rate per tenant, OBS_SLO objective and "
                "sliding window (the per-tenant slice of "
                "kvcache_slo_burn_rate; 1.0 = budget burns at exactly its "
                "sustainable rate)",
                ["tenant", "objective", "window"], registry=self.registry,
            )
        # KV-block integrity families (KV_INTEGRITY): built only
        # under the knob so the default exposition surface stays
        # unchanged; delta-synced from ``BlockIntegrity.stats`` on the
        # engine loop.
        if self._integrity:
            self.integrity_checks = prom.Counter(
                "kvcache_integrity_checks_total",
                "KV-block content-digest checks at tier transitions, by "
                "outcome (ok / corrupt / unverified = no recorded digest, "
                "served on the legacy trust model)",
                ["outcome"], registry=self.registry,
            )
            self.integrity_quarantined = prom.Counter(
                "kvcache_integrity_quarantined_total",
                "KV-block copies quarantined after a failed digest check "
                "(chain truncated; suffix recomputed cold)",
                registry=self.registry,
            )
            self.integrity_scrub_pages = prom.Counter(
                "kvcache_integrity_scrub_pages_total",
                "Resident host-tier slots verified by the background "
                "integrity scrubber",
                registry=self.registry,
            )
            self._integrity_seen = {
                "checks_ok": 0,
                "checks_corrupt": 0,
                "checks_unverified": 0,
                "quarantined": 0,
                "scrub_pages": 0,
            }

    def observe_tier_transition(self, frm: str, to: str, reason: str) -> None:
        if self._prom is None or not self._lifecycle:
            return
        self.block_transitions.labels(frm, to, reason).inc()

    def observe_tier_residency(self, tier: str, seconds: float) -> None:
        if self._prom is None or not self._lifecycle:
            return
        self.block_residency.labels(tier=tier).observe(seconds)

    def observe_reuse_distance(self, distance_blocks: float) -> None:
        """Cold (inf) distances are clamped to a finite over-the-top
        value: they belong in the +Inf bucket, not in the _sum series."""
        if self._prom is None or not self._lifecycle:
            return
        self.reuse_distance.observe(
            min(distance_blocks, lifecycle_mod.COLD_DISTANCE_CLAMP)
        )

    def sync_integrity_stats(self, stats: dict) -> None:
        """Mirror the ``BlockIntegrity`` monotone counters into Prometheus
        (delta sync, as ``sync_lifecycle_stats``)."""
        if self._prom is None or not self._integrity:
            return
        for key, outcome in (
            ("checks_ok", "ok"),
            ("checks_corrupt", "corrupt"),
            ("checks_unverified", "unverified"),
        ):
            d = stats.get(key, 0) - self._integrity_seen[key]
            if d > 0:
                self.integrity_checks.labels(outcome=outcome).inc(d)
                self._integrity_seen[key] += d
        for key, counter in (
            ("quarantined", self.integrity_quarantined),
            ("scrub_pages", self.integrity_scrub_pages),
        ):
            d = stats.get(key, 0) - self._integrity_seen[key]
            if d > 0:
                counter.inc(d)
                self._integrity_seen[key] += d

    def set_slo_burn(self, objective: str, window: str, rate: float) -> None:
        if self._prom is None or not self._obs:
            return
        self.slo_burn.labels(objective=objective, window=window).set(rate)

    def set_tenant_slo_burn(self, tenant: str, objective: str, window: str, rate: float) -> None:
        if self._prom is None or not self._tenant_qos:
            return
        self.tenant_slo_burn.labels(tenant=tenant, objective=objective, window=window).set(rate)

    def observe_pull(
        self, seconds: float, outcome: str, trace_id: Optional[str] = None
    ) -> None:
        """One ``pull_prefix`` attempt: outcome ok (imported >= 1 block),
        empty (nothing to pull: no hashes, or the peer had no warm blocks),
        skipped (never attempted: deadline budget exhausted or the pod is
        shutting down), failed (fetch or import error, fell back to cold),
        or canceled (the sequence died while an async fetch was in
        flight). Under OBS_EXEMPLARS the pulling request's trace_id rides
        the bucket as an OpenMetrics exemplar."""
        if self._prom is None or not self._obs:
            return
        hist = self.transfer_pull.labels(outcome=outcome)
        if self._exemplars and trace_id:
            hist.observe(seconds, exemplar={"trace_id": trace_id})
        else:
            hist.observe(seconds)

    def observe_pull_overlap(self, hidden_s: float, exposed_s: float) -> None:
        """One async pull's wall-time split: ``hidden`` = before the
        scheduler first wanted the sequence (overlapped with other work),
        ``exposed`` = the remainder (it held this sequence's prefill)."""
        if self._prom is None or not self._obs:
            return
        self.pull_overlap.labels(kind="hidden").observe(max(hidden_s, 0.0))
        self.pull_overlap.labels(kind="exposed").observe(max(exposed_s, 0.0))

    def sync_step_stats(self, step_stats: dict, lag_s: Optional[float]) -> None:
        """Mirror the engine's cumulative step-phase seconds into the
        labeled counter (delta sync, as ``sync_lifecycle_stats``)."""
        if self._prom is None or not self._obs:
            return
        steps = step_stats.get("steps", 0)
        if steps > self._steps_seen:
            self.engine_steps.inc(steps - self._steps_seen)
            self._steps_seen = steps
        for key, seen in self._step_seen.items():
            delta = step_stats.get(key, 0.0) - seen
            if delta > 0:
                self.engine_phase_s.labels(phase=key[:-2]).inc(delta)
                self._step_seen[key] = step_stats[key]
        if lag_s is not None:
            self.engine_loop_lag.set(lag_s)

    def set_engine_gauges(self, occupancy: float, free_pages: int) -> None:
        if self._prom is None or not self._obs:
            return
        self.engine_occupancy.set(occupancy)
        self.engine_free_pages.set(free_pages)

    def observe_host_prefetch(self, seconds: float) -> None:
        if self._prom is None or not self._obs:
            return
        self.host_prefetch_s.observe(seconds)

    def sync_host_stats(self, host_stats: dict, host_cached: int) -> None:
        """Mirror the block manager's monotone host-tier counters (delta
        sync, as ``sync_lifecycle_stats``). ``restored`` counts every
        bring-back; the prefetch stage's share is broken out by label."""
        if self._prom is None or not self._obs:
            return
        self.host_pages_g.set(host_cached)
        d_pref = host_stats.get("prefetched", 0) - self._host_seen["prefetched"]
        d_rest = host_stats.get("restored", 0) - self._host_seen["restored"]
        if d_pref > 0:
            self.host_hits.labels(path="prefetch").inc(d_pref)
            self._host_seen["prefetched"] = host_stats["prefetched"]
        d_alloc = d_rest - d_pref
        if d_alloc > 0:
            self.host_hits.labels(path="allocate").inc(d_alloc)
        if d_rest > 0:
            self._host_seen["restored"] = host_stats["restored"]

    @staticmethod
    def request_labels(seq: Sequence) -> tuple[str, str]:
        """(outcome, finish) labels for the request histograms: outcome =
        "pull" when the router's verdict was a transfer pull, else the
        measured prefix-cache hit ("warm"/"cold"); finish = the
        early-finish reason or the normal stop/length verdict."""
        # Ground truth decides warm vs cold (a router that said "warm" on
        # a cold fleet still ran a cold prefill here — the pod's
        # histograms must agree with the scorer-side route_decisions
        # correction in router.py, not with the router's optimism); only
        # the "pull" verdict is kept as its own class.
        if seq.route_action == "pull":
            outcome = "pull"
        else:
            outcome = "warm" if seq.num_cached_prompt else "cold"
        finish = seq.finish_reason
        if finish is None:
            finish = (
                "length"
                if seq.num_generated >= seq.sampling.max_new_tokens
                else "stop"
            )
        return outcome, finish

    def observe_request_decomposition(self, seq: Sequence) -> None:
        """Latency-decomposition histograms from the timestamps the engine
        already stamps (no extra clock reads on the hot path)."""
        if self._prom is None or not self._obs:
            return
        outcome, finish = self.request_labels(seq)
        lab = {"outcome": outcome, "finish": finish}
        # OBS_EXEMPLARS: the finishing request's trace id (still attached
        # here; spans are detached later, in _emit_request_spans) rides
        # the TTFT/ITL buckets it lands in.
        exemplar = None
        if self._exemplars and seq.trace_span is not None:
            ctx = getattr(seq.trace_span, "context", None)
            if ctx is not None:
                exemplar = {"trace_id": ctx.trace_id}
        if seq.ttft is not None:
            if exemplar is not None:
                self.req_ttft.labels(**lab).observe(seq.ttft, exemplar=exemplar)
            else:
                self.req_ttft.labels(**lab).observe(seq.ttft)
        if seq.prefill_start_time is not None:
            self.req_queue.labels(**lab).observe(
                max(seq.prefill_start_time - seq.arrival_time, 0.0)
            )
        if seq.finish_time is not None:
            self.req_e2e.labels(**lab).observe(
                max(seq.finish_time - seq.arrival_time, 0.0)
            )
            if seq.mean_itl is not None:
                if exemplar is not None:
                    self.req_itl.labels(**lab).observe(seq.mean_itl, exemplar=exemplar)
                else:
                    self.req_itl.labels(**lab).observe(seq.mean_itl)

    def sync_spec_stats(self, stats: dict) -> None:
        """Mirror the engine's monotone spec counters into Prometheus."""
        if self._prom is None:
            return
        for key, counter in (
            ("proposed", self.spec_proposed),
            ("accepted", self.spec_accepted),
            ("verify_steps", self.spec_verify),
            ("bursts", self.spec_bursts),
        ):
            delta = stats.get(key, 0) - self._spec_seen[key]
            if delta > 0:
                counter.inc(delta)
                self._spec_seen[key] = stats[key]

    def sync_lifecycle_stats(self, stats: dict) -> None:
        """Mirror the engine's monotone lifecycle counters (deadline sheds/
        expiries, aborts) into Prometheus."""
        if self._prom is None:
            return
        for key, counter in (
            ("deadline_shed", self.deadline_shed),
            ("deadline_expired", self.deadline_expired),
            ("aborted", self.requests_aborted),
        ):
            delta = stats.get(key, 0) - self._lifecycle_seen[key]
            if delta > 0:
                counter.inc(delta)
                self._lifecycle_seen[key] = stats[key]

    def observe_rejected(self, draining: bool) -> None:
        if self._prom is None:
            return
        if draining:
            self.admission_rejected_draining.inc()
        else:
            self.admission_rejected.inc()

    def observe_drain(self, event: str, amount: int = 1) -> None:
        if self._prom is None:
            return
        counter = {
            "started": self.drain_started,
            "completed": self.drain_completed,
            "forced": self.drain_forced,
        }[event]
        counter.inc(amount)

    def observe_finished(self, seq: Sequence) -> None:
        # Rate EMAs first (prometheus-independent): only requests that
        # produced tokens feed them — a shed/aborted request finishing
        # instantly would wildly overstate sustainable throughput.
        if seq.num_generated > 0:
            now = time.monotonic()
            if self._last_finish is not None:
                dt = max(now - self._last_finish, 1e-3)
                alpha = 0.3
                inst_r, inst_t = 1.0 / dt, seq.num_generated / dt
                self.request_rate = (
                    inst_r
                    if self.request_rate is None
                    else (1 - alpha) * self.request_rate + alpha * inst_r
                )
                self.token_rate = (
                    inst_t
                    if self.token_rate is None
                    else (1 - alpha) * self.token_rate + alpha * inst_t
                )
            self._last_finish = now
        if self._prom is None:
            return
        self.requests.inc()
        self.generated.inc(seq.num_generated)
        if seq.num_cached_prompt:
            self.cached_prompt.inc(seq.num_cached_prompt)
        if seq.ttft is not None:
            self.ttft.observe(seq.ttft)
        if self._obs:
            self.observe_request_decomposition(seq)

    def exposition(self) -> Optional[bytes]:
        if self._prom is None:
            return None
        if self._exemplars:
            # Exemplars render only in the OpenMetrics exposition; the
            # classic text format silently drops them.
            from prometheus_client.openmetrics import exposition as om

            return om.generate_latest(self.registry)
        return self._prom.generate_latest(self.registry)

    def exposition_content_type(self) -> str:
        """The Content-Type matching ``exposition()``'s format (the
        OpenMetrics one is parameterized, so callers set it through a
        headers dict; aiohttp's ``content_type=`` rejects parameters)."""
        if self._exemplars:
            from prometheus_client.openmetrics import exposition as om

            return om.CONTENT_TYPE_LATEST
        return "text/plain"


def _env_bool(name: str, default: str) -> bool:
    """The JAX pod's parsing: anything but 0/false/no/off/empty is true."""
    return os.environ.get(name, default).strip().lower() not in (
        "0",
        "false",
        "no",
        "off",
        "",
    )


@dataclass
class PodServerConfig:
    model_name: str = "tiny-llama"
    pod_identifier: str = field(default_factory=socket.gethostname)
    #: indexer-side SUB socket to connect the PUB to (SUB binds, we connect)
    zmq_endpoint: str = "tcp://localhost:5557"
    publish_events: bool = True
    data_parallel_rank: Optional[int] = None
    http_port: int = 8000
    #: cross-pod KV transfer: ROUTER bind address of this pod's page export
    #: service (``tcp://*:5558``-style). None (default) = transfer plane
    #: off, nothing binds.
    transfer_endpoint: Optional[str] = None
    #: cap on blocks per transfer response (both served and pulled)
    transfer_max_blocks: int = 64
    #: fetch deadline; an expired pull falls back to cold prefill
    transfer_timeout_s: float = 10.0
    #: async prefix import (``ASYNC_PULL``): a request submitted with a
    #: ``pull_source`` waits in the queue ``importing`` while a worker
    #: fetches and installs its prefix; the scheduler admits it once the
    #: blocks land or the fetch fails (cold prefill). Off = the blocking
    #: ``pull_prefix``-then-submit flow.
    async_pull: bool = False
    #: import worker threads for ASYNC_PULL (concurrent fetches)
    pull_workers: int = 2
    #: disaggregated serving role (``POD_ROLE``): "mixed" (default) serves
    #: prefill and decode. "prefill" stops every request at its first token
    #: (its chain stays exportable) and announces it with a
    #: ``PrefillComplete`` event; "decode" takes handed-off requests
    #: (``pull_source``); "kvstore" holds demoted blocks and serves no
    #: request. The role rides the heartbeat.
    pod_role: str = "mixed"
    # -- remote tier (all off by default) -----------------------------------
    #: ``REMOTE_TIER``: an eviction that would destroy the last local copy of
    #: a block demotes it over the transfer plane to a peer with headroom
    #: (or a kvstore pod), imports may recycle evictable pages, heartbeats
    #: advertise the remote store's headroom, and peers' pushes are
    #: accepted into this pod's store.
    remote_tier: bool = False
    #: remote-store capacity in pages (demoted blocks this pod holds for
    #: peers); 0 accepts nothing
    remote_store_pages: int = 0
    #: comma-separated transfer endpoints of the demotion targets; empty =
    #: this pod never demotes (it can still accept pushes and serve pulls)
    remote_peers: str = ""
    #: bound on payloads parked for the pusher; an overflow drops the oldest
    #: (plain eviction, counted)
    remote_demote_queue: int = 1024
    # -- fleet self-healing (all off by default) ----------------------------
    #: seconds between Heartbeat events (liveness beacon + publisher drop
    #: report for the indexer's dead-pod sweep); 0 = no heartbeats.
    heartbeat_interval_s: float = 0.0
    #: seconds between periodic IndexSnapshot resyncs (replace-all-for-pod
    #: digest of resident blocks per tier); 0 = no periodic resync.
    resync_interval_s: float = 0.0
    #: transfer circuit breaker: consecutive pull failures per peer before
    #: pulls skip straight to cold prefill; 0 = off
    transfer_breaker_failures: int = 0
    #: first OPEN backoff; doubles per failed half-open probe (capped)
    transfer_breaker_backoff_s: float = 1.0
    transfer_breaker_backoff_max_s: float = 30.0
    # -- overload protection / request lifecycle (all off by default) -------
    #: admission control: max requests queued ahead of the engine (staged +
    #: scheduler waiting). Above it ``submit`` fails fast with 429 +
    #: ``Retry-After`` instead of queueing unboundedly. 0 = unbounded.
    admission_max_waiting: int = 0
    #: admission control: cap on outstanding admitted prompt tokens (a
    #: conservative proxy for queued prefill work — it includes requests
    #: currently in compute). 0 = unbounded.
    admission_max_queued_tokens: int = 0
    #: default per-request deadline in seconds when the client sends no
    #: ``X-Request-Deadline`` header. Expired waiting requests are shed
    #: before prefill; running requests finish early with
    #: ``finish_reason="deadline"``. 0 = no deadline.
    default_deadline_s: float = 0.0
    #: graceful drain: how long inflight requests get to finish after
    #: SIGTERM / ``POST /drain`` before being aborted.
    drain_timeout_s: float = 30.0
    # -- observability (all off by default = the knobs-off responses,
    # -- /stats fields and heartbeat wire bytes) ----------------------------
    #: request tracing: span recorder + W3C traceparent propagation
    #: (adopted from the ``traceparent`` request header); finished traces
    #: served at ``GET /debug/traces``.
    obs_tracing: bool = False
    #: finished-span ring size for /debug/traces
    obs_trace_buffer: int = 2048
    #: latency-decomposition histograms (TTFT/ITL/queue/e2e) + engine-step
    #: phase timing, batch-occupancy / free-page / loop-lag gauges on
    #: /metrics, and an ``obs`` block on /stats.
    obs_metrics: bool = False
    #: OpenMetrics trace exemplars: the OBS_METRICS latency histograms
    #: (TTFT/ITL/pull) attach the observing request's trace_id per bucket
    #: and /metrics switches to the OpenMetrics exposition. Off = the
    #: classic exposition.
    obs_exemplars: bool = False
    #: directory for ``POST /debug/profile`` torch.profiler traces; unset =
    #: the endpoint is disabled.
    obs_profile_dir: Optional[str] = None
    # -- routing-quality audit + SLO recording (off by default) -------------
    #: publish a ``RequestAudit`` KV event per finished request carrying
    #: the realized prefix-cache hit count, so the indexer's route auditor
    #: can join prediction with reality.
    obs_audit: bool = False
    #: SLO objectives evaluated in-process against the same measurements
    #: the latency histograms observe, e.g. ``"ttft:0.5:0.99;itl:0.05:0.95"``
    #: (metric:threshold_s:target, ";"-separated). Unset = no recorder.
    obs_slo: str = ""
    #: burn-rate windows in seconds, e.g. ``"60,300"`` (unset = 60,300)
    obs_slo_windows: str = ""
    # -- KV-capacity observability (off by default) -------------------------
    #: block-lifecycle ledger + reuse-distance MRC: record every cached
    #: block's tier transitions off the block-manager hooks and sample
    #: reuse distances off the allocate-time prefix walk. Surfaced at
    #: ``/debug/lifecycle`` / ``/debug/mrc``, a ``lifecycle`` /stats block,
    #: and the kvcache_block_tier_*/kvcache_reuse_distance_blocks families.
    obs_lifecycle: bool = False
    #: lifecycle-ledger ring depth (recent transitions kept for
    #: /debug/lifecycle)
    obs_lifecycle_ring: int = 4096
    #: MRC spatial sample rate in (0, 1]: fraction of blocks (by
    #: deterministic hash) whose reuse distances are tracked
    obs_mrc_sample: float = 1.0
    #: distinct sampled blocks the MRC stack tracks (distances beyond this
    #: read as cold: the curve saturates at this capacity)
    obs_mrc_tracked: int = 8192
    #: flight recorder: bounded ring of per-step engine telemetry + fleet
    #: events, dumped as one causally ordered timeline on a trigger (SLO
    #: burn-rate crossing, breaker OPEN, resync). Implies engine step
    #: timing (the ring needs the phase deltas).
    obs_flight: bool = False
    #: flight-recorder ring depth (per ring: steps and events)
    obs_flight_ring: int = 2048
    #: directory for triggered timeline dumps; unset = in memory only
    #: (``/debug/flight`` still serves the latest timeline)
    obs_flight_dir: Optional[str] = None
    #: burn-rate threshold that triggers a flight dump (needs OBS_SLO for
    #: the recorder)
    obs_flight_burn: float = 8.0
    # -- fleet controller (off by default) ----------------------------------
    #: ``FLEET_CONTROLLER``: this pod takes part in MRC-driven autoscaling.
    #: It accepts live-migrated in-flight decode sequences over the
    #: transfer plane (admitted through the ``importing`` state and resumed
    #: mid-generation) and may migrate its own sequences out on a
    #: scale-down. Off answers migrations with the tolerant refusal a
    #: service without the knob gives, and ``migrate_out`` refuses locally.
    fleet_controller: bool = False
    # -- multi-tenant QoS (off by default) ----------------------------------
    #: ``TENANT_QOS`` policy (the grammar is in ``server/qos.py``):
    #: ``name:prio=..,weight=..,max_waiting=..,max_queued_tokens=..,rps=..,
    #: cache_share=..`` entries separated by ";", ``*`` the default tenant.
    #: Set = requests are sliced by the ``X-Tenant`` header: per-tenant
    #: admission budgets (429 and ``Retry-After``), priority classes with
    #: preemption, weighted shares within a class, per-tenant cache caps and
    #: tenant slices of the SLO burn and the MRC. Unset = no tenant anywhere.
    tenant_qos: str = ""
    # -- KV-block integrity (off by default) --------------------------------
    #: ``KV_INTEGRITY`` (mirrored into the engine's config): write-time
    #: digests of every host spill, demotion and export, verified at every
    #: tier transition, quarantine and recompute on a mismatch, and the
    #: fleet-wide ``BadBlock`` revocation.
    kv_integrity: bool = False
    #: seconds between background scrub batches over the resident host
    #: slots (``INTEGRITY_SCRUB_INTERVAL_S``); 0 = no scrub. A batch runs on
    #: the engine loop between steps.
    integrity_scrub_interval_s: float = 0.0
    #: host slots verified a scrub batch (``INTEGRITY_SCRUB_PAGES``)
    integrity_scrub_pages: int = 32
    engine: EngineConfig = field(default_factory=EngineConfig)

    @classmethod
    def from_env(cls) -> "PodServerConfig":
        cfg = cls()
        cfg.model_name = os.environ.get("MODEL_NAME", cfg.model_name)
        cfg.pod_identifier = os.environ.get("POD_IDENTIFIER", cfg.pod_identifier)
        cfg.zmq_endpoint = os.environ.get("ZMQ_ENDPOINT", cfg.zmq_endpoint)
        cfg.publish_events = _env_bool("PUBLISH_EVENTS", "1")
        if "DP_RANK" in os.environ:
            cfg.data_parallel_rank = int(os.environ["DP_RANK"])
        cfg.http_port = int(os.environ.get("HTTP_PORT", cfg.http_port))
        # Cross-pod KV transfer (unset/empty = off).
        cfg.transfer_endpoint = os.environ.get("TRANSFER_ENDPOINT") or None
        cfg.transfer_max_blocks = int(
            os.environ.get("TRANSFER_MAX_BLOCKS", cfg.transfer_max_blocks)
        )
        cfg.transfer_timeout_s = float(
            os.environ.get("TRANSFER_TIMEOUT_S", cfg.transfer_timeout_s)
        )
        cfg.async_pull = _env_bool("ASYNC_PULL", "0")
        cfg.pull_workers = int(os.environ.get("PULL_WORKERS", cfg.pull_workers))
        # Disaggregated serving role (unset/"mixed" = one tier).
        cfg.pod_role = os.environ.get("POD_ROLE", cfg.pod_role).strip() or "mixed"
        # Remote tier (unset/0 = off).
        cfg.remote_tier = _env_bool("REMOTE_TIER", "0")
        cfg.remote_store_pages = int(os.environ.get("REMOTE_STORE_PAGES", cfg.remote_store_pages))
        cfg.remote_peers = os.environ.get("REMOTE_PEERS", cfg.remote_peers)
        cfg.remote_demote_queue = int(
            os.environ.get("REMOTE_DEMOTE_QUEUE", cfg.remote_demote_queue)
        )
        # Fleet self-healing (0/unset = off).
        cfg.heartbeat_interval_s = float(
            os.environ.get("HEARTBEAT_INTERVAL_S", cfg.heartbeat_interval_s)
        )
        cfg.resync_interval_s = float(
            os.environ.get("RESYNC_INTERVAL_S", cfg.resync_interval_s)
        )
        cfg.transfer_breaker_failures = int(
            os.environ.get("TRANSFER_BREAKER_FAILURES", cfg.transfer_breaker_failures)
        )
        cfg.transfer_breaker_backoff_s = float(
            os.environ.get("TRANSFER_BREAKER_BACKOFF_S", cfg.transfer_breaker_backoff_s)
        )
        cfg.transfer_breaker_backoff_max_s = float(
            os.environ.get("TRANSFER_BREAKER_BACKOFF_MAX_S", cfg.transfer_breaker_backoff_max_s)
        )
        # Overload protection / request lifecycle (0/unset = off).
        cfg.admission_max_waiting = int(
            os.environ.get("ADMISSION_MAX_WAITING", cfg.admission_max_waiting)
        )
        cfg.admission_max_queued_tokens = int(
            os.environ.get("ADMISSION_MAX_QUEUED_TOKENS", cfg.admission_max_queued_tokens)
        )
        cfg.default_deadline_s = float(
            os.environ.get("REQUEST_DEADLINE_S", cfg.default_deadline_s)
        )
        cfg.drain_timeout_s = float(os.environ.get("DRAIN_TIMEOUT_S", cfg.drain_timeout_s))
        # Observability (0/unset = off).
        cfg.obs_tracing = _env_bool("OBS_TRACING", "0")
        cfg.obs_trace_buffer = int(os.environ.get("OBS_TRACE_BUFFER", cfg.obs_trace_buffer))
        cfg.obs_metrics = _env_bool("OBS_METRICS", "0")
        cfg.obs_exemplars = _env_bool("OBS_EXEMPLARS", "0")
        cfg.obs_profile_dir = os.environ.get("OBS_PROFILE_DIR") or None
        cfg.obs_audit = _env_bool("OBS_AUDIT", "0")
        cfg.obs_slo = os.environ.get("OBS_SLO", "")
        cfg.obs_slo_windows = os.environ.get("OBS_SLO_WINDOWS", "")
        # KV-capacity observability (0/unset = off).
        cfg.obs_lifecycle = _env_bool("OBS_LIFECYCLE", "0")
        cfg.obs_lifecycle_ring = int(
            os.environ.get("OBS_LIFECYCLE_RING", cfg.obs_lifecycle_ring)
        )
        cfg.obs_mrc_sample = float(os.environ.get("OBS_MRC_SAMPLE", cfg.obs_mrc_sample))
        cfg.obs_mrc_tracked = int(os.environ.get("OBS_MRC_TRACKED", cfg.obs_mrc_tracked))
        cfg.obs_flight = _env_bool("OBS_FLIGHT", "0")
        cfg.obs_flight_ring = int(os.environ.get("OBS_FLIGHT_RING", cfg.obs_flight_ring))
        cfg.obs_flight_dir = os.environ.get("OBS_FLIGHT_DIR") or None
        cfg.obs_flight_burn = float(os.environ.get("OBS_FLIGHT_BURN", cfg.obs_flight_burn))
        # Fleet controller (0/unset = off).
        cfg.fleet_controller = _env_bool("FLEET_CONTROLLER", "0")
        # Multi-tenant QoS (unset/empty = off).
        cfg.tenant_qos = os.environ.get("TENANT_QOS", cfg.tenant_qos)
        # KV-block integrity (0/unset = off).
        cfg.kv_integrity = _env_bool("KV_INTEGRITY", "0")
        cfg.integrity_scrub_interval_s = float(
            os.environ.get("INTEGRITY_SCRUB_INTERVAL_S", cfg.integrity_scrub_interval_s)
        )
        cfg.integrity_scrub_pages = int(
            os.environ.get("INTEGRITY_SCRUB_PAGES", cfg.integrity_scrub_pages)
        )
        eng = cfg.engine
        eng.block_manager = BlockManagerConfig(
            total_pages=int(os.environ.get("TOTAL_PAGES", 1024)),
            page_size=int(os.environ.get("BLOCK_SIZE", 16)),
            # The engine's hash seed must match the indexer's.
            hash_seed=os.environ.get("PYTHONHASHSEED", ""),
            host_pages=int(os.environ.get("HOST_PAGES", 0)),
        )
        # Host-tier admission: "auto" (the recompute-vs-restore cost model)
        # or "always" (unconditional spill and restore).
        eng.host_tier_policy = os.environ.get("HOST_TIER_POLICY", eng.host_tier_policy)
        # Host-tier page storage ("int8" halves the bytes of a host slot).
        eng.kv_quant = os.environ.get("KV_QUANT") or None
        # Host-tier prefetch ahead of the scheduler (needs HOST_PAGES > 0).
        eng.host_prefetch = _env_bool("HOST_PREFETCH", "0")
        eng.max_model_len = int(os.environ.get("MAX_MODEL_LEN", eng.max_model_len))
        eng.decode_batch_size = int(
            os.environ.get("DECODE_BATCH_SIZE", eng.decode_batch_size)
        )
        eng.decode_steps_per_iter = int(
            os.environ.get("DECODE_STEPS_PER_ITER", eng.decode_steps_per_iter)
        )
        # Pipeline fused-decode bursts (host/device overlap); needs
        # DECODE_STEPS_PER_ITER > 1 to take effect.
        eng.decode_pipeline = _env_bool("DECODE_PIPELINE", "0")
        # Device-resident decode fast path: last-token ids stay on the
        # device across steps at any burst width. Off = the JAX default.
        eng.decode_fused_sampling = _env_bool("DECODE_FUSED_SAMPLING", "0")
        # Speculative decoding ("off" | "prompt_lookup") and its knobs.
        eng.spec_decode = os.environ.get("SPEC_DECODE", eng.spec_decode)
        eng.spec_k = int(os.environ.get("SPEC_K", eng.spec_k))
        eng.spec_ngram = int(os.environ.get("SPEC_NGRAM", eng.spec_ngram))
        # Verify rounds a dispatch, chained on the device.
        eng.spec_rounds = int(os.environ.get("SPEC_ROUNDS", eng.spec_rounds))
        # The adaptive gate (SPEC_MIN_ACCEPT=0 disables it).
        eng.spec_min_accept = float(os.environ.get("SPEC_MIN_ACCEPT", eng.spec_min_accept))
        eng.spec_min_sample = int(os.environ.get("SPEC_MIN_SAMPLE", eng.spec_min_sample))
        eng.spec_max_scan = int(os.environ.get("SPEC_MAX_SCAN", eng.spec_max_scan))
        # Weight quantization ("int8" halves weight bytes; models/quant.py).
        eng.quantize = os.environ.get("QUANTIZE") or None
        # int8 KV pages in device memory (twice the pages per byte).
        eng.kv_quant_hbm = os.environ.get("KV_QUANT_HBM") or None
        # Chunked prefill: a per-step prompt-token budget; 0 or unset = off.
        cpt = int(os.environ.get("CHUNKED_PREFILL_TOKENS", 0))
        eng.scheduler.chunked_prefill_tokens = cpt if cpt > 0 else None
        # Sharded serving: tensor- and sequence-parallel degrees (1 = one
        # device; more needs as many GPUs, or the engine raises).
        eng.tp = int(os.environ.get("TP", eng.tp))
        eng.sp = int(os.environ.get("SP", eng.sp))
        # The remote tier and the integrity plane reach the engine through
        # its own config.
        eng.remote_tier = cfg.remote_tier
        eng.remote_store_pages = cfg.remote_store_pages if cfg.remote_tier else 0
        eng.kv_integrity = cfg.kv_integrity
        eng.kv_integrity_table_cap = int(
            os.environ.get("INTEGRITY_TABLE_CAP", eng.kv_integrity_table_cap)
        )
        return cfg


class PodServer:
    """Engine + event publisher + KV transfer plane + HTTP front end for
    one GPU serving pod."""

    def __init__(
        self,
        config: Optional[PodServerConfig] = None,
        *,
        engine: Optional[Engine] = None,
        tokenizer=None,
        publisher: Optional[ZMQPublisher] = None,
        transfer_cost_model=None,
        device=None,
    ):
        """``engine``: a pre-built engine (its block manager gets the
        publisher attached); otherwise one is built from ``config.engine``
        on ``device`` (None = the GPU, ``"cpu"`` = plain PyTorch).
        ``transfer_cost_model``: the router's shared
        ``kvcache.transfer.TransferCostModel``, when this pod takes part in
        transfer-aware routing: every fetch this pod makes feeds it bytes/s,
        and every engine step re-seeds its prefill tokens/s from the
        engine's own rate."""
        self.config = config or PodServerConfig()
        if self.config.pod_role not in ("mixed", "prefill", "decode", "kvstore"):
            raise ValueError(
                f"POD_ROLE must be mixed/prefill/decode/kvstore, got "
                f"{self.config.pod_role!r}"
            )
        if self.config.remote_tier and engine is None:
            # The knobs reach the engine's config before it is built (its
            # constructor attaches them); an injected engine brings its own.
            self.config.engine.remote_tier = True
            self.config.engine.remote_store_pages = self.config.remote_store_pages
        if self.config.kv_integrity and engine is None:
            self.config.engine.kv_integrity = True
        self._tokenizer = tokenizer
        self._publisher = publisher
        self.transfer_cost_model = transfer_cost_model
        #: request tracing (OBS_TRACING); a disabled tracer hands out one
        #: shared no-op span, so the default request path allocates nothing.
        self.tracer = Tracer(
            enabled=self.config.obs_tracing,
            max_spans=self.config.obs_trace_buffer,
            service=f"pod:{self.config.pod_identifier}",
        )
        if self._publisher is None and self.config.publish_events:
            self._publisher = ZMQPublisher(
                ZMQPublisherConfig(
                    endpoint=self.config.zmq_endpoint,
                    pod_identifier=self.config.pod_identifier,
                    model_name=self.config.model_name,
                    data_parallel_rank=self.config.data_parallel_rank,
                )
            )
        on_events = self._publisher.publish if self._publisher is not None else None
        self.engine = engine or Engine(
            self.config.engine, on_events=on_events, device=device
        )
        if engine is not None and on_events is not None:
            self.engine.block_manager.on_events = on_events
        if self.config.obs_metrics or self.config.obs_flight:
            # The flight recorder's step ring needs the phase deltas, so
            # OBS_FLIGHT implies engine step timing even without
            # OBS_METRICS (same clocks, no new series).
            self.engine.obs_step_timing = True

        #: HTTP threads only touch the staging deques; the engine itself is
        #: single-threaded (loop thread only).
        self._mu = threading.Lock()
        self._work = threading.Condition(self._mu)
        #: staged requests: (tokens, sampling, deadline, rid, future, span,
        #: route_action, pull, tenant_key)
        self._staging: deque[tuple] = deque()  # guarded_by: _mu|_work
        #: staged aborts: (request_id | None = all, future -> bool)
        self._aborts: deque[tuple[Optional[str], Future]] = deque()  # guarded_by: _mu|_work
        self._futures: dict[int, Future] = {}  # loop-thread-only
        #: admission accounting (under _mu): requests admitted by submit
        #: whose futures have not resolved yet, and their prompt tokens.
        self._pending = 0  # guarded_by: _mu|_work
        self._pending_tokens = 0  # guarded_by: _mu|_work
        self.admission_rejected = 0  # guarded_by: _mu|_work
        self.admission_rejected_draining = 0  # guarded_by: _mu|_work
        #: graceful drain state
        self._draining = False  # guarded_by: _mu|_work
        self._drain_done = threading.Event()
        self._drain_clean: Optional[bool] = None
        self.drains_started = 0  # guarded_by: _mu|_work
        self.drain_forced_requests = 0  # guarded_by: _mu|_work
        self.metrics = _ServingMetrics(
            obs=self.config.obs_metrics,
            lifecycle=self.config.obs_lifecycle,
            tenant_qos=bool(self.config.tenant_qos.strip()),
            integrity=self.config.kv_integrity,
            exemplars=self.config.obs_exemplars,
        )
        # -- KV-block integrity plane (off = None, no hooks) ---------------
        #: the engine's ``BlockIntegrity``, or None (KV_INTEGRITY off, or an
        #: injected engine without it)
        self.integrity = getattr(self.engine, "integrity", None)
        self._integrity_quarantine_seen = 0  # loop-thread-only
        # -- multi-tenant QoS (off = None, no hooks) -----------------------
        #: the parsed TENANT_QOS policy and its per-tenant budgets. A
        #: malformed spec raises here: a dropped entry would read as an
        #: unbudgeted tenant.
        self.qos = None
        if self.config.tenant_qos.strip():
            from .qos import TenantQoS, parse_tenant_qos

            self.qos = TenantQoS(parse_tenant_qos(self.config.tenant_qos))
            # Priority order and weighted shares in the scheduler, tenant
            # page accounting and cache-share caps in the block manager, and
            # with OBS_LIFECYCLE a reuse-distance slice per tenant.
            self.engine.scheduler.attach_qos()
            self.engine.block_manager.attach_qos(
                self.qos,
                mrc_factory=self._make_tenant_mrc if self.config.obs_lifecycle else None,
            )
        # -- KV-capacity observability (off = None, no hooks) --------------
        #: block-lifecycle ledger + reuse-distance MRC (OBS_LIFECYCLE)
        self.lifecycle = None
        self.mrc = None
        if self.config.obs_lifecycle:
            self.lifecycle = lifecycle_mod.BlockLifecycleLedger(
                ring=self.config.obs_lifecycle_ring,
                on_transition=self.metrics.observe_tier_transition,
                on_residency=self.metrics.observe_tier_residency,
            )
            self.mrc = lifecycle_mod.ReuseDistanceEstimator(
                sample_rate=self.config.obs_mrc_sample,
                max_tracked=self.config.obs_mrc_tracked,
                on_distance=self.metrics.observe_reuse_distance,
            )
            self.engine.block_manager.attach_lifecycle(self.lifecycle, self.mrc)
        #: anomaly-triggered flight recorder (OBS_FLIGHT)
        self.flight = None
        if self.config.obs_flight:
            from ..obs.flight import FlightRecorder

            self.flight = FlightRecorder(
                ring=self.config.obs_flight_ring,
                out_dir=self.config.obs_flight_dir,
                pod=self.config.pod_identifier,
            )
        #: RequestAudit events published (OBS_AUDIT)
        self.audits_published = 0  # guarded_by: _mu|_work
        #: in-process SLO burn-rate recorder (OBS_SLO; None = off). A
        #: malformed spec raises here, at construction: a silently dropped
        #: objective would read as a perfectly green SLO.
        self.slo = None
        if self.config.obs_slo.strip():
            from ..obs.slo import SLORecorder, parse_slo_spec, parse_windows

            self.slo = SLORecorder(
                parse_slo_spec(self.config.obs_slo),
                windows_s=parse_windows(self.config.obs_slo_windows),
                # An SLO burn crossing is the flight recorder's primary
                # trigger. No recorder (OBS_FLIGHT off) = no burn checks.
                on_burn=self._on_slo_burn if self.flight is not None else None,
                burn_threshold=(
                    self.config.obs_flight_burn if self.flight is not None else 0.0
                ),
                # Per-tenant burn slices (TENANT_QOS): the same observations
                # sliced by the request's tenant key.
                track_tenants=self.qos is not None,
            )
        # -- disaggregated serving (POD_ROLE; "mixed" = nothing below runs) --
        #: submits whose max_new_tokens the prefill role clamped to one
        self.role_clamped_requests = 0  # guarded_by: _mu|_work
        #: PrefillComplete events published (the handoff supply)
        self.prefill_completes_published = 0  # guarded_by: _mu|_work
        self._running = False  # guarded_by: _mu|_work
        self._failed: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        #: engine-loop lag EMA (OBS_METRICS): host-side gap between the end
        #: of one iteration and the start of the next while work was
        #: pending — the "how far behind the device is the loop" signal.
        self._loop_lag_s: Optional[float] = None
        self._loop_prev_end: Optional[float] = None
        self._loop_had_work = False
        #: /debug/profile serialization (one capture at a time)
        self._profile_mu = threading.Lock()

        # -- cross-pod KV transfer plane (off unless configured) -----------
        # Exports and imports stage onto the engine loop, the only thread
        # that touches the page pools; the service and pulling threads wait
        # on a Future.
        self._transfer_exports: deque[tuple[list[int], Optional[int], Future]] = deque()  # guarded_by: _mu|_work
        self._transfer_imports: deque[tuple[list, str, Future]] = deque()  # guarded_by: _mu|_work
        #: one connected DEALER per peer, shared by pull_prefix and the
        #: async-pull workers
        self._transfer_pool = TransferClientPool(
            self._transfer_client_config,
            on_sample=self._observe_transfer_sample,
        )
        self._transfer_service: Optional[KVTransferService] = None
        self.transfer_pulls = 0  # pulls that imported >= 1 block  # guarded_by: _mu|_work
        self.transfer_pull_failures = 0  # fell back to cold  # guarded_by: _mu|_work
        # -- async prefix import (ASYNC_PULL; off = nothing below runs) -----
        #: worker pool for background fetches (built on first use)
        self._pull_pool: Optional[ThreadPoolExecutor] = None  # guarded_by: _mu|_work
        #: live import jobs, seq_id -> {"cancel": Event, "source": str}: an
        #: abort or resolve sets "cancel" so a fetch landing after the
        #: sequence died installs nothing
        self._pull_jobs: dict[int, dict] = {}  # guarded_by: _mu|_work
        #: completed imports staged for the engine loop (the only thread
        #: that clears ``Sequence.importing``)
        self._import_dones: deque[Sequence] = deque()  # guarded_by: _mu|_work
        self.async_pulls = 0  # landed >= 1 block  # guarded_by: _mu|_work
        self.async_pull_fallbacks = 0  # -> cold prefill  # guarded_by: _mu|_work
        self.async_pull_canceled = 0  # seq died mid-fetch  # guarded_by: _mu|_work
        # -- fleet self-healing (heartbeats + periodic resync) --------------
        # Digest reads hop onto the engine loop like exports/imports: page
        # bookkeeping is engine-loop-owned state.
        self._digest_requests: deque[Future] = deque()  # guarded_by: _mu|_work
        self.heartbeats_published = 0  # guarded_by: _mu|_work
        self.snapshots_published = 0  # guarded_by: _mu|_work
        self._self_heal_stop = threading.Event()
        self._self_heal_thread: Optional[threading.Thread] = None
        # -- background integrity scrub (KV_INTEGRITY + an interval) --------
        self._scrub_stop = threading.Event()
        self._scrub_thread: Optional[threading.Thread] = None
        # -- remote tier (REMOTE_TIER; off = nothing below runs) ------------
        #: peers' demotion pushes staged for the engine loop (the remote
        #: store shares the event stream's order)
        self._remote_pushes: deque[tuple[str, list, Future]] = deque()  # guarded_by: _mu|_work
        #: wire-ready payloads parked for the background pusher
        self._demote_queue: deque = deque()  # guarded_by: _mu|_work
        self._demote_thread: Optional[threading.Thread] = None
        self._demote_stop = threading.Event()
        #: each peer's headroom from its last push ack (None = not heard)
        self._peer_headroom: dict[str, Optional[int]] = {}  # guarded_by: _mu|_work
        self.demote_pushed_blocks = 0  # guarded_by: _mu|_work
        self.demote_failed_blocks = 0  # fell back to plain eviction  # guarded_by: _mu|_work
        self.demote_dropped = 0  # queue overflow (plain eviction)  # guarded_by: _mu|_work
        #: the seconds and batches of the pushes that a peer acked
        self.demote_push_s = 0.0  # guarded_by: _mu|_work
        self.demote_push_batches = 0  # guarded_by: _mu|_work
        self._remote_peers = [
            p.strip() for p in self.config.remote_peers.split(",") if p.strip()
        ]
        if self.config.remote_tier and self._remote_peers:
            self.engine.on_demotion = self._stage_demotions
        # -- live migration (FLEET_CONTROLLER; off = nothing below runs) ----
        #: freeze+export requests staged for the engine loop:
        #: (request_id, future -> (seq, MigrationPayload) | None)
        self._migrate_freezes: deque[tuple[str, Future]] = deque()  # guarded_by: _mu|_work
        #: migration verdicts staged for the engine loop:
        #: (seq, migrated: bool, future)
        self._migrate_settles: deque[tuple] = deque()  # guarded_by: _mu|_work
        #: inbound migrations staged for the engine loop:
        #: (source_pod, MigrationPayload, future -> (accepted, resumed))
        self._migrations_in: deque[tuple] = deque()  # guarded_by: _mu|_work
        #: continuation futures of migrated-in sequences, request_id ->
        #: Future (resolves with the resumed sequence)
        self._migrated_in_futures: dict[str, Future] = {}  # guarded_by: _mu|_work
        #: controller read hop: zero-arg callables run on the engine loop
        #: (warm-chain walks, live-request snapshots)
        self._controller_reads: deque[tuple] = deque()  # guarded_by: _mu|_work
        self.migrations_out = 0  # sequences resumed on a peer  # guarded_by: _mu|_work
        self.migrations_in = 0  # sequences resumed here  # guarded_by: _mu|_work
        self.migration_fallbacks = 0  # -> local recompute  # guarded_by: _mu|_work
        if self.config.transfer_endpoint:
            self._transfer_service = KVTransferService(
                TransferServiceConfig(
                    endpoint=self.config.transfer_endpoint,
                    model_name=self.config.model_name,
                    max_blocks=self.config.transfer_max_blocks,
                ),
                handler=self._serve_export,
                tracer=self.tracer,
                # Pushes are accepted with the knob on and a store to hold
                # them; otherwise they get the tolerant refusal.
                push_handler=(
                    self._serve_push
                    if self.config.remote_tier and self.config.remote_store_pages > 0
                    else None
                ),
                # Live-migration acceptance rides FLEET_CONTROLLER: off
                # answers with the tolerant refusal the source reads as
                # "resume locally".
                migrate_handler=(
                    self._serve_migrate if self.config.fleet_controller else None
                ),
            )

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        with self._mu:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._engine_loop, name="engine-loop", daemon=True
        )
        self._thread.start()
        if self._transfer_service is not None:
            self._transfer_service.start()
        if self.engine.on_demotion is not None:
            self._demote_stop.clear()
            self._demote_thread = threading.Thread(
                target=self._demote_loop, name="kv-demote", daemon=True
            )
            self._demote_thread.start()
        if self._publisher is not None and (
            self.config.heartbeat_interval_s > 0 or self.config.resync_interval_s > 0
        ):
            self._self_heal_stop.clear()
            self._self_heal_thread = threading.Thread(
                target=self._self_heal_loop, name="self-heal", daemon=True
            )
            self._self_heal_thread.start()
        if self.integrity is not None and self.config.integrity_scrub_interval_s > 0:
            self._scrub_stop.clear()
            self._scrub_thread = threading.Thread(
                target=self._scrub_loop, name="kv-scrub", daemon=True
            )
            self._scrub_thread.start()

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful drain for rolling restarts. Flips the pod to draining
        (new submits raise ``DrainingError`` → 503; ``/healthz`` turns 503
        so k8s readiness agrees; heartbeats advertise ``draining`` so the
        scorer stops picking this pod immediately), lets inflight requests
        finish for up to ``drain_timeout_s``, aborts whatever is left
        (their futures resolve with the partial sequence,
        ``finish_reason="abort"``; the abort first commits an in-flight
        pipelined decode burst, so no freed page is still being written),
        then publishes a final ``IndexSnapshot`` plus the ``PodDrained``
        goodbye — the fleet evicts this pod's entries at once instead of
        waiting out ``POD_TTL_S``. The engine loop stays up so ``/stats``
        remains queryable until the process exits (``shutdown`` still
        applies). Idempotent: concurrent calls wait for the first drain.
        Returns True when every inflight request finished within the
        budget."""
        with self._work:
            first = not self._draining
            if first:
                self._draining = True
                self.drains_started += 1
        if not first:
            self._drain_done.wait()
            return bool(self._drain_clean)
        self.metrics.observe_drain("started")
        self._flight_event("drain_started")
        log.warning(
            "drain started",
            pod=self.config.pod_identifier,
            timeout_s=timeout_s or self.config.drain_timeout_s,
        )
        # Advertise NOW, not at the next heartbeat tick: every second of
        # stale routing sends this pod prefixes it is about to evict.
        if self.config.heartbeat_interval_s > 0:
            self._publish_heartbeat()
        budget = self.config.drain_timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            with self._mu:
                if self._pending == 0:
                    break
            time.sleep(0.02)
        with self._mu:
            leftover = self._pending
        clean = leftover == 0
        if not clean:
            # Wedged clients / runaway generations past the budget: abort
            # them (pages released, futures resolve with partial output)
            # rather than holding the rolling restart hostage.
            with self._mu:
                self.drain_forced_requests += leftover
            self.metrics.observe_drain("forced", leftover)
            log.error(
                "drain timeout; aborting inflight requests",
                leftover=leftover,
                timeout_s=budget,
            )
            try:
                self.abort(None).result(timeout=30)
            except Exception:
                log.exception("drain abort-all failed")
        # Final goodbye, ordered: the snapshot (engine-loop read, so it
        # reflects post-abort truth) lands before PodDrained evicts the
        # pod — consumers without PodDrained support still get a truthful
        # final view instead of a stale one.
        if self._publisher is not None:
            self.publish_index_snapshot(timeout_s=30.0, wait=True)
            try:
                self._publisher.publish([PodDrained()])
            except Exception:
                log.exception("PodDrained publish failed")
        self._drain_clean = clean
        if clean:
            self.metrics.observe_drain("completed")
        self._flight_event("drain_complete", clean=clean, forced=leftover)
        self._drain_done.set()
        log.warning("drain complete", pod=self.config.pod_identifier, clean=clean)
        return clean

    @property
    def is_draining(self) -> bool:
        with self._mu:
            return self._draining

    @property
    def is_alive(self) -> bool:
        """Running with a healthy engine — the planner's ``dead`` signal
        (one locked read; the fleet view must not see a torn state)."""
        with self._mu:
            return self._running and self._failed is None

    @property
    def queue_depth(self) -> int:
        """Outstanding work — the router's load signal and the decode
        tier's ITL-headroom signal: the requests ``submit`` admitted whose
        futures have not resolved (staged, waiting, prefilling or
        running), read under the lock that counts them, so a request
        counts from the moment ``submit`` returns until its future
        resolves. The JAX pod sums len() snapshots of the staging deque
        and the scheduler's lists instead, which miss a request while the
        engine loop moves it from staging into the scheduler: routes sent
        back to back then read 0 and pile onto one pod."""
        with self._mu:
            return self._pending

    @property
    def prefill_rate(self) -> Optional[float]:
        """Measured prefill tokens/s (the engine's online EMA; None until
        the first prefill) — the planner's prefill-hop speed signal."""
        return self.engine._prefill_rate

    @property
    def open_breaker_endpoints(self) -> set:
        """Transfer endpoints this pod currently holds an OPEN circuit
        breaker for — a pull through them would skip straight to cold."""
        return {
            endpoint
            for endpoint, client in self._transfer_pool.clients().items()
            if client.breaker is not None and client.breaker.state == "open"
        }

    def shutdown(self) -> None:
        self._self_heal_stop.set()
        if self._self_heal_thread is not None:
            self._self_heal_thread.join(timeout=5)
            self._self_heal_thread = None
        self._scrub_stop.set()
        if self._scrub_thread is not None:
            self._scrub_thread.join(timeout=5)
            self._scrub_thread = None
        self._demote_stop.set()
        if self._demote_thread is not None:
            self._demote_thread.join(timeout=10)
            self._demote_thread = None
        if self._transfer_service is not None:
            self._transfer_service.shutdown()
        with self._mu:
            pool, self._pull_pool = self._pull_pool, None
            for job in self._pull_jobs.values():
                job["cancel"].set()
        if pool is not None:
            # Workers unwind on their own (fetch timeouts are bounded and
            # submit_import fails fast once _running flips).
            pool.shutdown(wait=False)
        with self._work:
            self._running = False
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._fail_outstanding(RuntimeError("pod server shut down"))
        self._transfer_pool.close_all()
        if self._publisher is not None:
            self._publisher.close()

    def _fail_outstanding(self, exc: BaseException) -> None:
        with self._mu:
            staged = list(self._staging)
            self._staging.clear()
            aborts = list(self._aborts)
            self._aborts.clear()
            transfers = (
                list(self._transfer_exports)
                + list(self._transfer_imports)
                + list(self._remote_pushes)
                + list(self._migrate_freezes)
                + list(self._migrate_settles)
                + list(self._migrations_in)
                + list(self._controller_reads)
                + [(fut,) for fut in self._digest_requests]
            )
            self._transfer_exports.clear()
            self._transfer_imports.clear()
            self._remote_pushes.clear()
            self._migrate_freezes.clear()
            self._migrate_settles.clear()
            self._migrations_in.clear()
            self._controller_reads.clear()
            self._demote_queue.clear()
            self._digest_requests.clear()
            migrated_futs = list(self._migrated_in_futures.values())
            self._migrated_in_futures.clear()
            self._import_dones.clear()
            jobs = list(self._pull_jobs.values())
            self._pull_jobs.clear()
            self._pending = 0
            self._pending_tokens = 0
            if self.qos is not None:
                # Nothing outstanding survives an engine failure.
                self.qos.reset_pending()
        for job in jobs:
            job["cancel"].set()
        for _, _, _, _, fut, span, _, _, _ in staged:
            span.set_attr("error", str(exc))
            span.end()
            if not fut.done():
                fut.set_exception(exc)
        for _, afut in aborts:
            if not afut.done():
                afut.set_result(False)
        for item in transfers:
            fut = item[-1]
            if not fut.done():
                fut.set_exception(exc)
        for fut in list(self._futures.values()) + migrated_futs:
            if not fut.done():
                fut.set_exception(exc)
        self._futures.clear()

    def _forget_pending(self, n_tokens: int, tenant: str = "") -> None:
        """Release one request's admission accounting (engine loop only),
        and with TENANT_QOS its tenant's budget ("" = untenanted)."""
        with self._mu:
            self._pending = max(self._pending - 1, 0)
            self._pending_tokens = max(self._pending_tokens - n_tokens, 0)
            if self.qos is not None and tenant:
                self.qos.on_resolved(tenant, n_tokens)

    def _resolve(self, seq: Sequence) -> None:
        """Resolve a finished/aborted sequence's future and release its
        admission accounting (engine loop only)."""
        with self._mu:
            job = self._pull_jobs.pop(seq.seq_id, None)
        if job is not None:
            # Aborted or shed while its import was in flight: the fetch
            # cannot be recalled, but the worker installs nothing.
            job["cancel"].set()
        self.metrics.observe_finished(seq)
        if self.slo is not None:
            # The same measurements the latency histograms observe.
            self.slo.observe(seq.ttft, seq.mean_itl, tenant=seq.tenant)
        if seq.trace_span is not None:
            self._emit_request_spans(seq)
        if (
            self.config.obs_audit
            and self._publisher is not None
            and seq.prefill_start_time is not None
        ):
            # Realized-hit ground truth for the route audit: how many prompt
            # blocks this pod's prefix cache served at first prefill. A
            # request that never reached prefill realized nothing
            # measurable. Failures are swallowed like heartbeats: auditing
            # must never fail a request.
            try:
                self._publisher.publish(
                    [
                        RequestAudit(
                            request_id=seq.request_id or "",
                            realized_blocks=(
                                seq.num_cached_prompt
                                // max(self.config.engine.block_manager.page_size, 1)
                            ),
                        )
                    ]
                )
                with self._mu:
                    self.audits_published += 1
            except Exception:
                log.exception("RequestAudit publish failed")
        if (
            self.config.pod_role == "prefill"
            and self._publisher is not None
            and seq.finish_reason not in ("abort", "deadline")
            and seq.num_generated >= 1
        ):
            # The handoff's announcement: the chain is registered and
            # exportable. Failures are swallowed like heartbeats: the handoff
            # itself (which carries the first token) does not need it.
            try:
                self._publisher.publish(
                    [
                        PrefillComplete(
                            request_id=seq.request_id or "",
                            num_blocks=seq.num_registered_pages,
                        )
                    ]
                )
                with self._mu:
                    self.prefill_completes_published += 1
            except Exception:
                log.exception("PrefillComplete publish failed")
        fut = self._futures.pop(seq.seq_id, None)
        if fut is not None:
            self._forget_pending(seq.user_prompt_len, seq.tenant)
            if not fut.done():
                fut.set_result(seq)

    def _emit_request_spans(self, seq: Sequence) -> None:
        """End the request span and reconstruct its queue/prefill/decode
        children from the timestamps the engine already stamps — zero
        per-token tracing cost; the whole decomposition is derived once at
        request completion."""
        span, seq.trace_span = seq.trace_span, None
        if span.context is None:  # noop span (tracing off)
            return
        end = seq.finish_time if seq.finish_time is not None else time.monotonic()
        if seq.prefill_start_time is not None:
            self.tracer.record_span(
                "pod.queue", span, span.start_mono, seq.prefill_start_time
            )
            prefill_end = (
                seq.first_token_time if seq.first_token_time is not None else end
            )
            self.tracer.record_span(
                "pod.prefill",
                span,
                seq.prefill_start_time,
                prefill_end,
                attrs={
                    "cached_prompt_tokens": seq.num_cached_prompt,
                    "prompt_tokens": seq.user_prompt_len,
                },
            )
            if seq.first_token_time is not None and seq.num_generated > 1:
                self.tracer.record_span(
                    "pod.decode",
                    span,
                    seq.first_token_time,
                    end,
                    attrs={"generated_tokens": seq.num_generated},
                )
        else:
            # Never reached prefill (shed/aborted while queued): the whole
            # life was queueing.
            self.tracer.record_span("pod.queue", span, span.start_mono, end)
        outcome, finish = _ServingMetrics.request_labels(seq)
        span.set_attr("outcome", outcome)
        span.set_attr("finish", finish)
        span.set_attr("generated_tokens", seq.num_generated)
        if seq.error:
            span.set_attr("error", seq.error)
        span.end(end_mono=end)

    # -- flight recorder (OBS_FLIGHT) ----------------------------------------
    def _make_tenant_mrc(self):
        """One tenant's reuse-distance estimator (TENANT_QOS with
        OBS_LIFECYCLE): the global curve's sampling knobs, and no
        ``on_distance`` hook (the global estimator already feeds the
        histogram)."""
        return lifecycle_mod.ReuseDistanceEstimator(
            sample_rate=self.config.obs_mrc_sample,
            max_tracked=self.config.obs_mrc_tracked,
        )

    def _on_slo_burn(self, objective: str, window: str, rate: float) -> None:
        """SLORecorder burn-crossing callback: the flight recorder's
        primary trigger. The burn sample itself rides the timeline, so a
        dump always holds what tripped it."""
        flight = self.flight
        if flight is None:
            return
        flight.record_event("slo_burn", objective=objective, window=window, rate=round(rate, 4))
        flight.trigger("slo_burn", objective=objective, window=window, rate=round(rate, 4))

    def _flight_event(self, kind: str, **attrs) -> None:
        """Record a fleet event on the flight ring (noop with the knob
        off): breaker transitions, resyncs, drains, sheds and migrations."""
        if self.flight is not None:
            self.flight.record_event(kind, **attrs)

    def _engine_loop(self) -> None:
        try:
            while True:
                with self._work:
                    # has_ready_work, not has_work: an engine whose only
                    # work waits on an async import parks here until the
                    # import's completion wakes it.
                    while self._running and not (
                        self._staging
                        or self._aborts
                        or self._transfer_exports
                        or self._transfer_imports
                        or self._remote_pushes
                        or self._digest_requests
                        or self._import_dones
                        or self._migrate_freezes
                        or self._migrate_settles
                        or self._migrations_in
                        or self._controller_reads
                        or self.engine.has_ready_work
                    ):
                        self._work.wait(timeout=0.1)
                    if not self._running:
                        return
                    staged = list(self._staging)
                    self._staging.clear()
                    aborts = list(self._aborts)
                    self._aborts.clear()
                    exports = list(self._transfer_exports)
                    self._transfer_exports.clear()
                    imports = list(self._transfer_imports)
                    self._transfer_imports.clear()
                    pushes = list(self._remote_pushes)
                    self._remote_pushes.clear()
                    digests = list(self._digest_requests)
                    self._digest_requests.clear()
                    import_dones = list(self._import_dones)
                    self._import_dones.clear()
                    freezes = list(self._migrate_freezes)
                    self._migrate_freezes.clear()
                    settles = list(self._migrate_settles)
                    self._migrate_settles.clear()
                    migrations_in = list(self._migrations_in)
                    self._migrations_in.clear()
                    controller_reads = list(self._controller_reads)
                    self._controller_reads.clear()
                # Digests first: the snapshot callback publishes here, on
                # the engine loop, ordered with the KV-event stream.
                for fut in digests:
                    try:
                        fut.set_result(self.engine.block_digest())
                    except Exception as e:
                        fut.set_exception(e)
                # Imports land before admissions, so a request staged after
                # its pull (pull_prefix, then submit) sees the warm pages.
                for blocks, src_pod, fut in imports:
                    try:
                        fut.set_result(self.engine.import_kv_blocks(blocks, source_pod=src_pod))
                    except Exception as e:
                        fut.set_exception(e)
                for source_pod, blocks, fut in pushes:
                    try:
                        fut.set_result(self.engine.accept_remote_blocks(source_pod, blocks))
                    except Exception as e:
                        fut.set_exception(e)
                for hashes, max_blocks, fut in exports:
                    try:
                        fut.set_result(self.engine.export_kv_blocks(hashes, max_blocks))
                    except Exception as e:
                        fut.set_exception(e)
                # A completed import makes its sequence admittable the very
                # step its pages are committed.
                for seq in import_dones:
                    seq.importing = False
                # Migration work in causal order: freezes (park + export)
                # before settles (commit or roll back an earlier freeze)
                # before inbound admissions.
                for rid, fut in freezes:
                    try:
                        fut.set_result(self._freeze_for_migration(rid))
                    except Exception as e:
                        fut.set_exception(e)
                for seq, migrated, fut in settles:
                    try:
                        fut.set_result(self._settle_migration(seq, migrated))
                    except Exception as e:
                        fut.set_exception(e)
                for source_pod, migration, fut in migrations_in:
                    try:
                        fut.set_result(self._admit_migration(source_pod, migration))
                    except Exception as e:
                        fut.set_exception(e)
                for call, fut in controller_reads:
                    try:
                        fut.set_result(call())
                    except Exception as e:
                        fut.set_exception(e)
                for tokens, sampling, deadline, rid, fut, span, action, pull, tenant in staged:
                    try:
                        if self.qos is not None:
                            # The policy's class and weight ride the
                            # sequence into the scheduler and block manager.
                            pol = self.qos.policy(tenant)
                            seq = self.engine.add_request(
                                tokens, sampling, request_id=rid, deadline=deadline,
                                tenant=tenant, priority=pol.priority, qos_weight=pol.weight,
                            )
                        else:
                            seq = self.engine.add_request(
                                tokens, sampling, request_id=rid, deadline=deadline
                            )
                    except ValueError as e:
                        self._forget_pending(len(tokens), tenant)
                        span.set_attr("error", str(e))
                        span.end()
                        # A disconnected client may have cancelled the future.
                        if not fut.done():
                            fut.set_exception(e)
                        continue
                    seq.trace_span = span if span.context is not None else None
                    seq.route_action = action
                    self._futures[seq.seq_id] = fut
                    if pull is not None:
                        self._start_async_pull(seq, pull, span)
                # Aborts AFTER admissions: a submit-then-abort staged in the
                # same cycle must find its sequence in the engine.
                for rid, afut in aborts:
                    try:
                        # abort/abort_all commit an in-flight pipelined burst
                        # first: no page freed here is still being written.
                        seqs = (
                            self.engine.abort_all()
                            if rid is None
                            else list(filter(None, [self.engine.abort(rid)]))
                        )
                    except Exception as e:
                        afut.set_exception(e)
                        continue
                    for seq in seqs:
                        self._resolve(seq)
                    afut.set_result(bool(seqs))
                if aborts:
                    # An idle engine may not step again for a while; the
                    # abort counters must not lag until it does.
                    self.metrics.sync_lifecycle_stats(self.engine.lifecycle_stats)
                if self.engine.has_ready_work:
                    obs = self.config.obs_metrics
                    if obs:
                        t_start = time.perf_counter()
                        if self._loop_had_work and self._loop_prev_end is not None:
                            # Lag only counts gaps while work was pending at
                            # the previous iteration's end — idle waits are
                            # not loop lag.
                            sample = max(t_start - self._loop_prev_end, 0.0)
                            self._loop_lag_s = (
                                sample
                                if self._loop_lag_s is None
                                else 0.7 * self._loop_lag_s + 0.3 * sample
                            )
                    finished = self.engine.step()
                    if self.flight is not None:
                        # Per-step telemetry onto the flight ring: phase
                        # deltas (step timing is on under the knob) and the
                        # occupancy, free-page and loop-lag gauges.
                        sch_f = self.engine.scheduler
                        self.flight.record_step(
                            self.engine.step_stats,
                            occupancy=len(sch_f.running)
                            / max(self.config.engine.decode_batch_size, 1),
                            free_pages=self.engine.block_manager.num_free,
                            loop_lag_s=self._loop_lag_s,
                        )
                    lp = self.engine.last_prefetch
                    if lp is not None:
                        # Host-tier bring-back ran ahead of the scheduler
                        # this step: one span + one histogram sample per
                        # prefetch round (noop with both OBS_* knobs off).
                        self.engine.last_prefetch = None
                        pages, t0, t1 = lp
                        self.metrics.observe_host_prefetch(t1 - t0)
                        self.tracer.record_span(
                            "pod.host_bringback",
                            None,
                            t0,
                            t1,
                            attrs={"pages": pages, "pod": self.config.pod_identifier},
                        )
                    if self.transfer_cost_model is not None and self.engine._prefill_rate:
                        # The transfer decision's prefill rate: the engine's
                        # own online EMA, re-pinned every step.
                        self.transfer_cost_model.seed_rates(
                            prefill_tokens_s=self.engine._prefill_rate
                        )
                    self.metrics.sync_spec_stats(self.engine.spec_stats)
                    self.metrics.sync_lifecycle_stats(self.engine.lifecycle_stats)
                    if self.integrity is not None:
                        istats = self.integrity.stats
                        q = istats["quarantined"]
                        if q > self._integrity_quarantine_seen:
                            # A corrupt block surfaced this step: keep the
                            # window around it before it scrolls away.
                            delta = q - self._integrity_quarantine_seen
                            self._integrity_quarantine_seen = q
                            self._flight_event("kv_quarantine", blocks=delta)
                            if self.flight is not None:
                                self.flight.trigger("quarantine", blocks=delta)
                        self.metrics.sync_integrity_stats(istats)
                    if obs:
                        self._loop_prev_end = time.perf_counter()
                        self._loop_had_work = self.engine.has_ready_work
                        sch = self.engine.scheduler
                        self.metrics.sync_step_stats(self.engine.step_stats, self._loop_lag_s)
                        self.metrics.set_engine_gauges(
                            len(sch.running) / max(self.config.engine.decode_batch_size, 1),
                            self.engine.block_manager.num_free,
                        )
                        if self.config.engine.block_manager.host_pages:
                            bm = self.engine.block_manager
                            self.metrics.sync_host_stats(bm.host_stats, bm.num_host_cached_pages)
                    for seq in finished:
                        self._resolve(seq)
        except Exception as e:  # engine wedged: fail fast and visibly
            log.exception("engine loop died")
            self._failed = f"{type(e).__name__}: {e}"
            self._fail_outstanding(RuntimeError(f"engine failed: {self._failed}"))

    # -- fleet self-healing --------------------------------------------------
    def _scrub_loop(self) -> None:
        """Background integrity scrub (KV_INTEGRITY with
        ``INTEGRITY_SCRUB_INTERVAL_S`` > 0): every interval, hop onto the
        engine loop and verify a bounded batch of resident host slots, so
        latent rot surfaces before a restore reads it. Failures are logged:
        the scrub never takes a pod down."""
        interval = self.config.integrity_scrub_interval_s
        while not self._scrub_stop.wait(interval):
            try:
                self._controller_read(
                    lambda: self.engine.scrub_host_pages(self.config.integrity_scrub_pages)
                )
            except Exception as e:
                log.warning("integrity scrub pass failed", error=repr(e))

    def _self_heal_loop(self) -> None:
        """Heartbeat / periodic-resync publisher. Runs only when a knob is
        enabled; all failures are swallowed — self-healing must never take
        a serving pod down."""
        hb = self.config.heartbeat_interval_s
        rs = self.config.resync_interval_s
        tick = min(x for x in (hb, rs) if x > 0)
        next_hb = 0.0 if hb > 0 else float("inf")
        # First snapshot goes out after one full interval: at process start
        # the digest is empty and the normal event stream covers warm-up.
        now = time.monotonic()
        next_rs = now + rs if rs > 0 else float("inf")
        while not self._self_heal_stop.wait(min(tick, 0.25)):
            now = time.monotonic()
            if now >= next_hb:
                next_hb = now + hb
                self._publish_heartbeat()
            if now >= next_rs:
                next_rs = now + rs
                # Fire-and-forget: the snapshot publishes from the engine
                # loop when the digest resolves. Blocking here would starve
                # heartbeats behind a long device step — a slow resync must
                # never make a live pod look dead.
                self.publish_index_snapshot(wait=False)

    def _publish_heartbeat(self) -> None:
        """One ``Heartbeat`` from this thread (the self-heal thread or a
        drain): the publisher serialises its socket under its own lock. The
        role rides only a non-mixed pod's, the headroom only a remote-tier
        pod's, so a knobs-off pod's bytes are the legacy bytes."""
        if self._publisher is None:
            return
        # Flag read under the lock; the (bounded-blocking) publish stays
        # outside it so a retrying socket never convoys submit/drain.
        with self._mu:
            draining = self._draining
        try:
            self._publisher.publish(
                [
                    Heartbeat(
                        dropped_batches=getattr(self._publisher, "dropped_batches", 0),
                        draining=draining,
                        role=self.config.pod_role if self.config.pod_role != "mixed" else None,
                        headroom=self.engine.remote_headroom,
                    )
                ]
            )
            with self._mu:
                self.heartbeats_published += 1
        except Exception:
            log.exception("heartbeat publish failed")

    def publish_index_snapshot(self, timeout_s: float = 30.0, wait: bool = True) -> bool:
        """Emit an ``IndexSnapshot`` resync. The digest is read AND
        published on the engine loop (digest-future callback), so no
        ``BlockStored``/``BlockRemoved`` the loop emits can interleave
        between reading the digest and shipping it — a stale snapshot
        would silently wipe the interleaved event from the index. Callable
        on demand (e.g. after the indexer flags this pod suspect) and
        periodically via ``RESYNC_INTERVAL_S`` (which passes ``wait=False``
        so a slow engine step can't starve heartbeats)."""
        if self._publisher is None:
            return False
        done: Future = Future()

        def on_digest(f: Future) -> None:
            # Runs where the future is settled: the engine loop (ordered
            # with the event stream) or the failure path.
            try:
                digest = f.result()
                self._publisher.publish([IndexSnapshot(blocks_by_medium=digest)])
                with self._mu:
                    self.snapshots_published += 1
                if self.flight is not None:
                    # A resync is a repair worth a postmortem: the timeline
                    # before it explains what the index was repaired from
                    # (dumps are rate-limited per reason).
                    self.flight.record_event(
                        "resync", blocks={m: len(h) for m, h in digest.items()}
                    )
                    self.flight.trigger("resync")
                done.set_result(True)
            except Exception:
                log.exception("index snapshot publish failed")
                done.set_result(False)

        fut: Future = Future()
        fut.add_done_callback(on_digest)
        with self._work:
            if not self._running or self._failed is not None:
                return False
            self._digest_requests.append(fut)
            self._work.notify()
        if not wait:
            return True
        try:
            return done.result(timeout=timeout_s)
        except Exception:
            log.exception("index snapshot publish timed out")
            return False

    # -- cross-pod KV transfer ----------------------------------------------
    def _observe_transfer_sample(self, n_bytes: int, seconds: float) -> None:
        """The transfer clients' link samples, into the router's cost model
        (when this pod takes part in transfer-aware routing)."""
        if self.transfer_cost_model is not None:
            self.transfer_cost_model.observe_transfer(n_bytes, seconds)

    def _serve_export(self, hashes: list[int], max_blocks: int) -> list:
        """The export service's handler (service thread): hop onto the
        engine loop, the only thread that reads the page pools, and wait."""
        fut: Future = Future()
        with self._work:
            if not self._running or self._failed is not None:
                return []
            self._transfer_exports.append((hashes, max_blocks, fut))
            self._work.notify()
        return fut.result(timeout=max(self.config.transfer_timeout_s * 3, 30.0))

    def submit_import(self, blocks: list, source_pod: str = "") -> Future:
        """Stage fetched blocks for installation on the engine loop; the
        Future resolves to the number of blocks imported. ``source_pod``
        (the endpoint the blocks came from) is named in rejections."""
        fut: Future = Future()
        with self._work:
            if self._failed is not None:
                raise RuntimeError(f"engine failed: {self._failed}")
            if not self._running:
                raise RuntimeError("pod server not running")
            self._transfer_imports.append((blocks, source_pod, fut))
            self._work.notify()
        return fut

    def _transfer_client_config(self, endpoint: str) -> TransferClientConfig:
        """Pool factory: per-peer client config (timeouts and breaker)."""
        return TransferClientConfig(
            endpoint=endpoint,
            timeout_s=self.config.transfer_timeout_s,
            breaker_failures=self.config.transfer_breaker_failures,
            breaker_backoff_s=self.config.transfer_breaker_backoff_s,
            breaker_backoff_max_s=self.config.transfer_breaker_backoff_max_s,
        )

    def _get_client(self, endpoint: str) -> Optional[KVTransferClient]:
        """The pooled client of ``endpoint``; None once the pod is shutting
        down (a client made after the shutdown sweep would leak its
        socket)."""
        with self._mu:
            if not self._running:
                return None
        client = self._transfer_pool.get(endpoint)
        if (
            client is not None
            and self.flight is not None
            and client.breaker is not None
            and client.breaker.on_transition is None
        ):
            # A breaker opening is a flight trigger (a dead peer explains
            # the burn that usually follows); every transition rides the
            # timeline. Wired once per pooled client.
            def _breaker_cb(state: str, endpoint: str = endpoint) -> None:
                flight = self.flight
                if flight is None:
                    return
                flight.record_event("breaker", endpoint=endpoint, state=state)
                if state == "open":
                    flight.trigger("breaker_open", endpoint=endpoint)

            client.breaker.on_transition = _breaker_cb
        return client

    # -- remote-tier demotion (REMOTE_TIER) ---------------------------------
    def _serve_push(self, source_pod: str, blocks: list) -> tuple[int, int]:
        """The transfer service's push handler (service thread): hop onto
        the engine loop (the remote store shares the event stream's order)
        and wait for the verdict, ``(accepted, headroom)``."""
        fut: Future = Future()
        with self._work:
            if not self._running or self._failed is not None:
                return 0, 0
            self._remote_pushes.append((source_pod, blocks, fut))
            self._work.notify()
        return fut.result(timeout=max(self.config.transfer_timeout_s * 3, 30.0))

    def _stage_demotions(self, payloads: list) -> None:
        """``Engine.on_demotion`` sink (engine loop): park wire-ready
        payloads for the pusher. Bounded: an overflow drops the oldest
        payloads (the plain eviction the tier replaces), counted."""
        dropped_hashes = []
        with self._mu:
            self._demote_queue.extend(payloads)
            cap = max(self.config.remote_demote_queue, 1)
            while len(self._demote_queue) > cap:
                dropped_hashes.append(self._demote_queue.popleft().block_hash)
            self.demote_dropped += len(dropped_hashes)
        self._demote_failed_lifecycle(dropped_hashes)

    def _demote_failed_lifecycle(self, hashes) -> None:
        """End the ledger's optimistic ``remote`` residency of blocks the
        pusher dropped or failed to place (the block manager records the
        hand-off before the wire's outcome is known). A block registered
        locally again meanwhile keeps its newer residency."""
        if self.lifecycle is None:
            return
        for h in hashes:
            if h is not None:
                self.lifecycle.end_if_tier(h, "remote", "demote_failed")

    def _demotion_targets(self) -> list[str]:
        """Peers, most headroom first (unknown headroom ranks as open-ended
        until an ack says otherwise), without those whose breaker is open.
        A peer that acked zero headroom ranks last but stays a target: a
        full store still accepts by rotating out its coldest blocks."""
        with self._mu:
            headroom = dict(self._peer_headroom)
        open_eps = self.open_breaker_endpoints
        ranked = []
        for ep in self._remote_peers:
            if ep in open_eps:
                continue
            h = headroom.get(ep)
            ranked.append((-(h if h is not None else 1 << 30), ep))
        ranked.sort()
        return [ep for _, ep in ranked]

    def _demote_loop(self) -> None:
        """Background pusher: drain the parked demotions to the best target
        in batches of ``transfer_max_blocks``. Every failure is plain
        eviction; a dead target costs bounded timeouts, then its breaker."""
        while not self._demote_stop.wait(0.02):
            with self._mu:
                if not self._demote_queue:
                    continue
                batch = []
                cap = max(self.config.transfer_max_blocks, 1)
                while self._demote_queue and len(batch) < cap:
                    batch.append(self._demote_queue.popleft())
            self._push_batch(batch)

    def _push_batch(self, batch: list) -> None:
        for endpoint in self._demotion_targets():
            client = self._get_client(endpoint)
            if client is None:
                break  # shutting down: plain eviction
            t0 = time.perf_counter()
            try:
                accepted, headroom = client.push_blocks(
                    self.config.model_name,
                    self.config.pod_identifier,
                    batch,
                    timeout_s=self.config.transfer_timeout_s,
                )
            except TransferError as e:
                log.warning(
                    "demotion push failed; trying next peer",
                    target=endpoint,
                    blocks=len(batch),
                    error=repr(e),
                )
                continue
            with self._mu:
                self._peer_headroom[endpoint] = headroom
                self.demote_pushed_blocks += accepted
                self.demote_push_s += time.perf_counter() - t0
                self.demote_push_batches += 1
                if accepted < len(batch):
                    # Rejected or already held: the rest is plainly evicted.
                    self.demote_failed_blocks += len(batch) - accepted
            if accepted < len(batch):
                # The ack counts, it names no block; the store validates in
                # order, so the tail is charged.
                self._demote_failed_lifecycle([b.block_hash for b in batch[accepted:]])
            return
        with self._mu:
            self.demote_failed_blocks += len(batch)
        self._demote_failed_lifecycle([b.block_hash for b in batch])

    def purge_bad_blocks(self, holder: str, block_hashes: list, medium=None) -> int:
        """The fleet's revocation consumer: a ``BadBlock`` that ``holder``
        published reached the control plane, so drop the copies this pod's
        remote store holds for those hashes (they share provenance with the
        corrupt ones; locally computed pages stay). Runs on the engine loop.
        Returns the blocks dropped: 0 when the holder is this pod or there is
        no store. Not knob-gated: every pod honours revocations."""
        if (
            self.engine.remote_store is None
            or not block_hashes
            or holder == self.config.pod_identifier
        ):
            return 0
        try:
            return (
                self._controller_read(lambda: self.engine.remote_store.purge(block_hashes)) or 0
            )
        except Exception as e:
            log.warning("bad-block purge failed", error=repr(e))
            return 0

    # -- live sequence migration (FLEET_CONTROLLER) --------------------------
    def migrate_out(
        self,
        request_id: str,
        target_endpoint: str,
        timeout_s: Optional[float] = None,
    ) -> bool:
        """Live-migrate one in-flight request to the pod serving
        ``target_endpoint`` (its transfer endpoint). The engine loop
        freezes the sequence preemption-style (generated tokens fold into
        the prompt; registered pages survive in the prefix cache) and
        exports its KV chain in the same cycle; this thread ships the
        decode state and the chain over the transfer plane; on the target's
        ``resumed`` ack the local half finishes with
        ``finish_reason="migrated"`` (its submit future resolves with the
        partial sequence; the target's continuation carries the rest). Any
        failure (dead target, refusal, timeout, undecodable ack) rolls back
        to local recompute: the sequence re-enters scheduling as a
        preemption would, pages back to baseline. Returns True only when
        the target resumed the sequence. ``FLEET_CONTROLLER`` off = False
        without touching the engine."""
        if not self.config.fleet_controller:
            return False
        wait = max(self.config.transfer_timeout_s * 3, 30.0)
        fut: Future = Future()
        with self._work:
            if not self._running or self._failed is not None:
                return False
            self._migrate_freezes.append((request_id, fut))
            self._work.notify()
        try:
            frozen = fut.result(timeout=wait)
        except Exception:
            log.exception("migration freeze failed", request=request_id)
            return False
        if frozen is None:
            return False  # not live here (finished, unknown, or importing)
        seq, payload = frozen
        resumed = False
        client = self._get_client(target_endpoint)
        if client is not None:
            try:
                _accepted, resumed = client.migrate(
                    self.config.model_name,
                    self.config.pod_identifier,
                    payload,
                    timeout_s=timeout_s,
                )
            except TransferError as e:
                log.warning(
                    "migration transfer failed; resuming locally",
                    request=request_id,
                    target=target_endpoint,
                    error=str(e),
                )
            except Exception:
                log.exception("migration transfer failed; resuming locally")
        sfut: Future = Future()
        with self._work:
            if not self._running or self._failed is not None:
                return False
            self._migrate_settles.append((seq, resumed, sfut))
            self._work.notify()
        try:
            ok = bool(sfut.result(timeout=wait))
        except Exception:
            log.exception("migration settle failed", request=request_id)
            return False
        with self._mu:
            if ok:
                self.migrations_out += 1
            else:
                self.migration_fallbacks += 1
        self._flight_event(
            "migration",
            direction="out",
            request=request_id,
            target=target_endpoint,
            resumed=ok,
            blocks=len(payload.blocks),
            tokens=len(payload.token_ids),
        )
        return ok

    def migrated_future(self, request_id: str) -> Optional[Future]:
        """The continuation future of a request migrated into this pod
        (resolves with the resumed sequence, whose ``generated_tokens`` is
        the request's whole output). None when no such migration was
        admitted. Entries are kept for the pod's lifetime."""
        with self._mu:
            return self._migrated_in_futures.get(request_id)

    def _controller_read(self, call):
        """Run a zero-arg callable on the engine loop and wait: the fleet
        controller's read hop into engine-owned state (scheduler queues,
        the prefix cache). Returns None when the pod is down."""
        fut: Future = Future()
        with self._work:
            if not self._running or self._failed is not None:
                return None
            self._controller_reads.append((call, fut))
            self._work.notify()
        return fut.result(timeout=max(self.config.transfer_timeout_s * 3, 30.0))

    def live_requests(self) -> list[str]:
        """Request ids of every live (admitted, unfinished) sequence, the
        controller's scale-down migration plan, read on the engine loop so
        it never tears against a step."""

        def read() -> list[str]:
            sch = self.engine.scheduler
            return [
                seq.request_id
                for bucket in (sch.waiting, sch.prefilling, sch.running)
                for seq in bucket
                if not seq.is_finished()
            ]

        return self._controller_read(read) or []

    def warm_chains(self, limit: int) -> list[list[int]]:
        """Chain-ordered block-hash lists of this pod's hottest resident
        prefix chains (longest first): the donor side of a scale-up's warm
        revival. Empty with ``FLEET_CONTROLLER`` off."""
        if not self.config.fleet_controller or limit <= 0:
            return []
        return (
            self._controller_read(lambda: self.engine.block_manager.hot_chains(limit))
            or []
        )

    def revive_chain(
        self,
        chain_hashes: list[int],
        source_endpoint: str,
        timeout_s: Optional[float] = None,
    ) -> int:
        """Warm revival on a scale-up: pull one chain (hashes in chain
        order, from a donor's ``warm_chains``) over the transfer plane and
        commit it here. Returns the blocks imported; 0 on any failure (the
        new pod just starts colder) and with ``FLEET_CONTROLLER`` off."""
        if not self.config.fleet_controller or not chain_hashes:
            return 0
        client = self._get_client(source_endpoint)
        if client is None:
            return 0
        try:
            blocks, _complete = client.fetch(
                self.config.model_name,
                list(chain_hashes),
                self.config.transfer_max_blocks,
                timeout_s=timeout_s,
            )
            if not blocks:
                return 0
            return self.submit_import(blocks, source_pod=source_endpoint).result(
                timeout=timeout_s or max(self.config.transfer_timeout_s * 3, 30.0)
            )
        except (TransferError, RuntimeError, FuturesTimeout) as e:
            log.warning(
                "warm revival pull failed; starting cold",
                source=source_endpoint,
                error=repr(e),
            )
            return 0

    def _freeze_for_migration(self, request_id: str):
        """Engine-loop half of ``migrate_out``: freeze the sequence and
        build the wire payload (decode state + exported KV chain) in one
        loop cycle, so no eviction can come between the freeze releasing
        the pages and the export reading them. The freeze commits an
        in-flight pipelined burst first; the export's gather and copy back
        to the host finish before it returns."""
        frozen = self.engine.freeze_for_migration(request_id)
        if frozen is None:
            return None
        seq, hashes = frozen
        blocks = self.engine.export_kv_blocks(hashes) if hashes else []
        payload = MigrationPayload(
            request_id=request_id,
            token_ids=list(seq.prompt_tokens),  # after the fold: the full history
            user_prompt_len=seq.user_prompt_len,
            num_generated=seq.num_generated,
            max_new_tokens=seq.sampling.max_new_tokens,
            temperature=seq.sampling.temperature,
            top_k=seq.sampling.top_k,
            top_p=seq.sampling.top_p,
            stop_token_ids=tuple(seq.sampling.stop_token_ids),
            deadline_remaining_s=(
                max(seq.deadline - time.monotonic(), 0.0)
                if seq.deadline is not None
                else None
            ),
            blocks=blocks,
        )
        return seq, payload

    def _settle_migration(self, seq: Sequence, migrated: bool) -> bool:
        """Engine-loop half of ``migrate_out``'s verdict: commit (finish
        the local half; its future resolves) or roll back (clear
        ``importing`` so the scheduler re-admits the folded sequence)."""
        if seq.is_finished():
            # Aborted or shed while the wire transfer ran: its future
            # already resolved; nothing to settle.
            return False
        if not migrated:
            self.engine.cancel_migration(seq)
            return False
        self.engine.finish_migrated(seq)
        self._resolve(seq)
        return True

    def _serve_migrate(self, source_pod: str, migration) -> tuple[int, bool]:
        """The transfer service's migrate handler (service thread): hop
        onto the engine loop (install the chain, admit the continuation
        through the ``importing`` state) and wait for the verdict. A
        draining pod refuses (``resumed=False``): the source resumes
        locally rather than migrating onto a pod about to go."""
        fut: Future = Future()
        with self._work:
            if not self._running or self._failed is not None or self._draining:
                return 0, False
            self._migrations_in.append((source_pod, migration, fut))
            self._work.notify()
        return fut.result(timeout=max(self.config.transfer_timeout_s * 3, 30.0))

    def _admit_migration(self, source_pod: str, migration) -> tuple[int, bool]:
        """Engine-loop half of an inbound migration: install the shipped
        chain, then admit the continuation with the full token history as
        its prompt (the ``fold_for_preemption`` form, so the warm prefill
        hits the imported pages and greedy decode resumes where the source
        stopped), entering through the ``importing`` state, cleared next
        cycle. The continuation counts in ``queue_depth`` and the admission
        totals from here until ``_resolve`` releases it, as a submitted
        request does."""
        installed = 0
        if migration.blocks:
            try:
                installed = self.engine.import_kv_blocks(
                    migration.blocks, source_pod=source_pod
                )
            except Exception:
                # Geometry and chain failures already degrade inside
                # import_kv_blocks; anything past that just means the
                # continuation prefills colder.
                log.exception("migration import failed; continuation recomputes")
        sampling = SamplingParams(
            max_new_tokens=migration.max_new_tokens,
            temperature=migration.temperature,
            top_k=migration.top_k,
            top_p=migration.top_p,
            stop_token_ids=tuple(migration.stop_token_ids),
        )
        try:
            seq = self.engine.add_request(
                list(migration.token_ids),
                sampling,
                request_id=migration.request_id,
                deadline=(
                    time.monotonic() + migration.deadline_remaining_s
                    if migration.deadline_remaining_s is not None
                    else None
                ),
            )
        except ValueError as e:
            log.warning(
                "refusing migration; source resumes locally",
                request=migration.request_id,
                error=str(e),
            )
            return installed, False
        # Continue the source's bookkeeping: with the generated tokens
        # folded into the prompt, ``generated_tokens`` and the
        # max_new_tokens and stop conditions line up with an unmigrated run.
        seq.user_prompt_len = migration.user_prompt_len
        seq.num_generated = migration.num_generated
        seq.importing = True
        fut: Future = Future()
        fut.request_id = migration.request_id
        self._futures[seq.seq_id] = fut
        with self._work:
            self._pending += 1
            # _resolve releases user_prompt_len tokens; mirror it here.
            self._pending_tokens += seq.user_prompt_len
            self._migrated_in_futures[migration.request_id] = fut
            self.migrations_in += 1
            self._import_dones.append(seq)
            self._work.notify()
        self._flight_event(
            "migration",
            direction="in",
            source=source_pod,
            request=migration.request_id,
            blocks=installed,
            tokens=len(migration.token_ids),
        )
        return installed, True

    def pull_prefix(
        self,
        prompt_tokens: list[int],
        source_endpoint: str,
        timeout_s: Optional[float] = None,
        deadline: Optional[float] = None,
        trace_ctx=None,
    ) -> int:
        """Pull ``prompt_tokens``' warm prefix from a peer's export service
        and commit it here (the router's pull-then-compute arm). Returns
        the blocks imported; 0 on any failure: a pull is an optimisation,
        so every error degrades to cold prefill, never to a failed request.
        ``deadline`` (absolute monotonic, the request's): the fetch and the
        import wait are clamped to the budget left, and a pull with none
        left is skipped. ``trace_ctx``: parent span context; the
        ``pod.pull_prefix`` span (and, through the transfer envelope's
        traceparent, the exporting peer's spans) joins that trace."""
        span = self.tracer.start_span(
            "pod.pull_prefix",
            parent=trace_ctx,
            attrs={"source": source_endpoint, "pod": self.config.pod_identifier},
        )
        t_pull = time.monotonic()

        def done(n: int, outcome: str) -> int:
            span.set_attr("outcome", outcome)
            span.set_attr("imported_blocks", n)
            span.end()
            self.metrics.observe_pull(
                time.monotonic() - t_pull,
                outcome,
                trace_id=span.context.trace_id if span.context is not None else None,
            )
            return n

        fetch_timeout: Optional[float] = None  # None = the client's own
        wait_timeout = timeout_s or self.config.transfer_timeout_s * 3
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # Budget spent before the fetch: not "the peer had
                # nothing", the overload signal the outcome label exposes.
                return done(0, "skipped")
            fetch_timeout = min(self.config.transfer_timeout_s, remaining)
            wait_timeout = min(wait_timeout, remaining)
        hashes = self.engine.block_manager.token_db.prefix_hashes(prompt_tokens)
        if not hashes:
            return done(0, "empty")
        client = self._get_client(source_endpoint)
        if client is None:
            return done(0, "skipped")
        try:
            blocks, _complete = client.fetch(
                self.config.model_name,
                hashes,
                self.config.transfer_max_blocks,
                timeout_s=fetch_timeout,
                traceparent=(
                    format_traceparent(span.context) if span.context is not None else None
                ),
            )
            imported = (
                self.submit_import(blocks, source_pod=source_endpoint).result(
                    timeout=wait_timeout
                )
                if blocks
                else 0
            )
        except (TransferError, RuntimeError, FuturesTimeout) as e:
            with self._mu:  # concurrent pulls race this counter
                self.transfer_pull_failures += 1
            log.warning(
                "KV pull failed; falling back to cold prefill",
                source=source_endpoint,
                error=repr(e),
            )
            span.set_attr("error", repr(e))
            return done(0, "failed")
        if imported:
            with self._mu:
                self.transfer_pulls += 1
        return done(imported, "ok" if imported else "empty")

    # -- async prefix import (ASYNC_PULL) -----------------------------------
    def _start_async_pull(self, seq: Sequence, source: str, span) -> None:
        """Flip a just-admitted sequence into the ``importing`` state and
        hand its prefix fetch to the worker pool (engine loop only). The
        scheduler skips the sequence, admitting later arrivals past it,
        until ``_finish_async_pull`` clears the flag."""
        job = {"cancel": threading.Event(), "source": source}
        with self._mu:
            if not self._running:
                # Racing shutdown: no pull; the sequence stays admittable
                # and _fail_outstanding resolves its future.
                return
            if self._pull_pool is None:
                self._pull_pool = ThreadPoolExecutor(
                    max_workers=max(self.config.pull_workers, 1),
                    thread_name_prefix="kv-pull",
                )
            pool = self._pull_pool
            self._pull_jobs[seq.seq_id] = job
        seq.importing = True
        trace_ctx = span.context if span is not None else None
        try:
            pool.submit(self._async_pull_worker, seq, source, job, trace_ctx)
        except RuntimeError:  # the executor shut down meanwhile
            seq.importing = False
            with self._mu:
                self._pull_jobs.pop(seq.seq_id, None)

    def _finish_async_pull(self, seq: Sequence) -> None:
        """Stage the import's completion onto the engine loop (the only
        thread that clears ``importing``) and wake it."""
        with self._work:
            self._pull_jobs.pop(seq.seq_id, None)
            if self._running:
                self._import_dones.append(seq)
                self._work.notify()
            else:
                seq.importing = False  # the loop is gone; unblock directly

    def _async_pull_worker(self, seq: Sequence, source: str, job: dict, trace_ctx) -> None:
        """Background prefix import of one sequence (worker thread): fetch
        its warm chain from ``source``, install it through the engine loop,
        then release the sequence to the scheduler. Every exit releases it:
        a failure means cold prefill, never a stuck or failed request. The
        fetch is clamped to the request's remaining deadline, and an open
        breaker fails it at once. The ``pod.pull_prefix`` span carries the
        async and overlap attributes: ``overlap`` is the part of the pull
        hidden behind other work (before the scheduler first wanted this
        sequence)."""
        span = self.tracer.start_span(
            "pod.pull_prefix",
            parent=trace_ctx,
            attrs={"source": source, "pod": self.config.pod_identifier, "async": True},
        )
        t0 = time.monotonic()
        imported = 0
        outcome = "failed"
        try:
            fetch_timeout: Optional[float] = None
            wait_timeout = self.config.transfer_timeout_s * 3
            if seq.deadline is not None:
                remaining = seq.deadline - t0
                if remaining <= 0:
                    outcome = "skipped"
                    return
                fetch_timeout = min(self.config.transfer_timeout_s, remaining)
                wait_timeout = min(wait_timeout, remaining)
            hashes = self.engine.block_manager.token_db.prefix_hashes(seq.prompt_tokens)
            if not hashes:
                outcome = "empty"
                return
            client = self._get_client(source)
            if client is None or job["cancel"].is_set():
                outcome = "skipped"
                return
            blocks, _complete = client.fetch(
                self.config.model_name,
                hashes,
                self.config.transfer_max_blocks,
                timeout_s=fetch_timeout,
                traceparent=(
                    format_traceparent(span.context) if span.context is not None else None
                ),
            )
            if job["cancel"].is_set():
                # The sequence died while the bytes were in flight: install
                # nothing, pages stay at baseline.
                outcome = "canceled"
                return
            imported = (
                self.submit_import(blocks, source_pod=source).result(timeout=wait_timeout)
                if blocks
                else 0
            )
            outcome = "ok" if imported else "empty"
        except (TransferError, RuntimeError, FuturesTimeout) as e:
            log.warning(
                "async KV pull failed; sequence falls back to cold prefill",
                source=source,
                seq=seq.seq_id,
                error=repr(e),
            )
            span.set_attr("error", repr(e))
            outcome = "failed"
        finally:
            t1 = time.monotonic()
            if outcome != "ok" and job["cancel"].is_set():
                # The sequence died while the fetch was in flight: a cancel,
                # not a fallback (no sequence is left to fall back).
                outcome = "canceled"
            with self._mu:  # workers finish concurrently
                if outcome == "canceled":
                    self.async_pull_canceled += 1
                elif imported:
                    self.transfer_pulls += 1
                    self.async_pulls += 1
                elif outcome == "failed":
                    self.transfer_pull_failures += 1
                    self.async_pull_fallbacks += 1
            # Overlap: the time before the scheduler first wanted this
            # sequence was hidden behind other work; the rest was exposed
            # (it held this sequence's prefill).
            wanted = seq.import_wanted_time
            hidden = t1 - t0 if wanted is None else min(max(wanted - t0, 0.0), t1 - t0)
            exposed = (t1 - t0) - hidden
            span.set_attr("outcome", outcome)
            span.set_attr("imported_blocks", imported)
            span.set_attr("overlap", round(hidden, 6))
            span.end()
            self.metrics.observe_pull(
                t1 - t0,
                outcome,
                trace_id=span.context.trace_id if span.context is not None else None,
            )
            self.metrics.observe_pull_overlap(hidden, exposed)
            self._finish_async_pull(seq)

    # -- request path -------------------------------------------------------
    def _retry_after_s(self, depth: int, queued_tokens: int) -> float:
        """Retry-After hint from the measured serving rates: time to drain
        the queue at the observed request-completion rate, falling back to
        queued prefill work over the engine's online prefill-rate EMA.
        Floored at 1 s (sub-second retries just re-overload) and capped at
        60 s (past that the estimate is noise; the client should re-route).
        """
        est = None
        if self.metrics.request_rate:
            est = depth / self.metrics.request_rate
        elif self.engine._prefill_rate and queued_tokens:
            est = queued_tokens / self.engine._prefill_rate
        return float(min(max(est if est is not None else 1.0, 1.0), 60.0))

    def _check_admission(self, n_tokens: int, tenant: str = "") -> None:  # kvlint: holds=_work
        """Admission control (caller holds ``_mu``): reject fast — before
        the request touches the engine — when the configured queue-depth or
        queued-token cap would be exceeded. ``tenant``: the request's QoS
        slice key; with TENANT_QOS its budgets (max_waiting,
        max_queued_tokens, rps) are checked first, so a tenant over its
        budget gets the tenant's 429 even when the pod has room. Both caps
        off (0) and no QoS policy = unbounded admission."""
        cfg = self.config
        if self.qos is not None:
            verdict = self.qos.admit(tenant, n_tokens)
            if verdict is not None:
                cap, message, rate_hint, t_depth, t_queued = verdict
                self.admission_rejected += 1
                self.metrics.observe_rejected(draining=False)
                self._flight_event("admission_reject", cap=f"tenant_{cap}", tenant=tenant)
                # A rate rejection knows when its window frees a slot; a
                # budget rejection estimates from the tenant's own queue.
                raise AdmissionError(
                    message,
                    rate_hint if rate_hint is not None else self._retry_after_s(t_depth, t_queued),
                )
        if cfg.admission_max_waiting <= 0 and cfg.admission_max_queued_tokens <= 0:
            return
        sch = self.engine.scheduler
        # len() snapshots of engine-owned lists: momentarily stale is fine,
        # admission is a load shedder, not an exact semaphore.
        active = len(sch.running) + len(sch.prefilling)
        depth = max(self._pending - active, 0)
        queued_tokens = self._pending_tokens
        if cfg.admission_max_waiting > 0 and depth >= cfg.admission_max_waiting:
            self.admission_rejected += 1
            self.metrics.observe_rejected(draining=False)
            self._flight_event("admission_reject", cap="waiting", depth=depth)
            raise AdmissionError(
                f"overloaded: {depth} requests waiting >= "
                f"ADMISSION_MAX_WAITING={cfg.admission_max_waiting}",
                self._retry_after_s(depth, queued_tokens),
            )
        if (
            cfg.admission_max_queued_tokens > 0
            and queued_tokens + n_tokens > cfg.admission_max_queued_tokens
        ):
            self.admission_rejected += 1
            self.metrics.observe_rejected(draining=False)
            self._flight_event("admission_reject", cap="tokens", queued_tokens=queued_tokens)
            raise AdmissionError(
                f"overloaded: {queued_tokens} + {n_tokens} queued prompt "
                f"tokens > ADMISSION_MAX_QUEUED_TOKENS="
                f"{cfg.admission_max_queued_tokens}",
                self._retry_after_s(depth, queued_tokens),
            )

    def submit(
        self,
        prompt_tokens: list[int],
        sampling: Optional[SamplingParams] = None,
        *,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
        trace_ctx=None,
        route_action: Optional[str] = None,
        pull_source: Optional[str] = None,
        tenant: str = "",
    ) -> Future:
        """Enqueue a request; the Future resolves to the finished Sequence
        (or raises: invalid request, engine failure, shutdown). Raises
        ``AdmissionError`` when over the admission caps (fast 429 — never
        touches the engine) and ``DrainingError`` while draining (503).
        ``deadline_s``: per-request deadline budget in seconds (falls back
        to ``default_deadline_s``; 0/None = none). The returned Future
        carries ``request_id`` for ``abort``. ``trace_ctx`` (an
        ``obs.tracing.SpanContext``, e.g. parsed from a ``traceparent``
        header): parent for this request's spans — with tracing enabled
        the pod mints its own trace when None. ``route_action``: the
        router's verdict ("route_warm"/"pull"/"cold") labelling the latency
        histograms; None derives warm/cold from the prefix-cache hit.
        ``pull_source``: a peer's transfer endpoint whose warm prefix this
        request should import; honoured only with ``async_pull`` on (the
        request then waits ``importing`` while a worker fetches it; any
        failure means cold prefill), ignored otherwise. ``tenant``: the
        request's tenant (the ``X-Tenant`` header); with ``TENANT_QOS`` it
        is collapsed onto a policy slice key for budgets, scheduling, cache
        accounting and observability, and ignored otherwise. A ``prefill``
        pod clamps ``max_new_tokens`` to 1; a ``kvstore`` pod raises
        ``ValueError``."""
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if self.config.pod_role == "kvstore":
            # Storage, not compute: a misrouted request fails loudly.
            raise ValueError("kvstore pods do not serve requests")
        clamped = False
        if self.config.pod_role == "prefill":
            # The prefill tier stops at the first token: every sequence
            # finishes at its prefill commit; decode belongs to the decode
            # tier.
            sampling = sampling or SamplingParams()
            if sampling.max_new_tokens > 1:
                sampling = replace(sampling, max_new_tokens=1)
                clamped = True
        if deadline_s is None and self.config.default_deadline_s > 0:
            deadline_s = self.config.default_deadline_s
        deadline = (
            time.monotonic() + deadline_s
            if deadline_s is not None and deadline_s > 0
            else None
        )
        rid = request_id or str(uuid.uuid4())
        # The raw tenant header collapses onto a policy slice key at once:
        # everything downstream sees a bounded set of keys.
        tkey = self.qos.key(tenant) if self.qos is not None else ""
        fut: Future = Future()
        fut.request_id = rid
        with self._work:
            if self._failed is not None:
                raise RuntimeError(f"engine failed: {self._failed}")
            if not self._running:
                raise RuntimeError("pod server not running")
            if self._draining:
                self.admission_rejected_draining += 1
                self.metrics.observe_rejected(draining=True)
                self._flight_event("admission_reject", cap="draining")
                raise DrainingError("pod is draining; retry against another pod")
            self._check_admission(len(prompt_tokens), tkey)
            if clamped:
                self.role_clamped_requests += 1
            # The span starts at submit (queueing time includes staging),
            # after the reject paths — a 429/503 is not a served request.
            span = self.tracer.start_span(
                "pod.request",
                parent=trace_ctx,
                attrs={
                    "request_id": rid,
                    "pod": self.config.pod_identifier,
                    "prompt_tokens": len(prompt_tokens),
                },
            )
            fut.trace_context = span.context
            self._pending += 1
            self._pending_tokens += len(prompt_tokens)
            if self.qos is not None:
                self.qos.on_admitted(tkey, len(prompt_tokens))
            pull = pull_source if pull_source and self.config.async_pull else None
            self._staging.append(
                (list(prompt_tokens), sampling, deadline, rid, fut, span, route_action, pull, tkey)
            )
            self._work.notify()
        return fut

    def abort(self, request_id: Optional[str]) -> Future:
        """Stage an abort onto the engine loop. Resolves to True when a live
        sequence was aborted; ``request_id=None`` aborts every request."""
        fut: Future = Future()
        with self._work:
            if not self._running or self._failed is not None:
                fut.set_result(False)
                return fut
            self._aborts.append((request_id, fut))
            self._work.notify()
        return fut

    def generate(
        self,
        prompt_tokens: list[int],
        sampling: Optional[SamplingParams] = None,
        timeout: Optional[float] = None,
        *,
        deadline_s: Optional[float] = None,
    ) -> Sequence:
        fut = self.submit(prompt_tokens, sampling, deadline_s=deadline_s)
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeout:
            # The caller stopped waiting: free the sequence's pages.
            try:
                self.abort(fut.request_id).result(timeout=30)
            except Exception:
                log.exception("post-timeout abort failed")
            raise

    # -- HTTP surface -------------------------------------------------------
    def build_app(self):
        from aiohttp import web

        async def completions(request: web.Request) -> web.Response:
            import asyncio

            try:
                body = await request.json()
            except Exception:
                return web.json_response({"error": "invalid JSON"}, status=400)

            prompt = body.get("prompt")
            token_ids = body.get("prompt_token_ids")
            if token_ids is None:
                if not isinstance(prompt, str) or not prompt:
                    return web.json_response(
                        {"error": "prompt or prompt_token_ids required"}, status=400
                    )
                if self._tokenizer is None:
                    return web.json_response(
                        {"error": "no tokenizer loaded; pass prompt_token_ids"},
                        status=400,
                    )
                token_ids, _ = self._tokenizer.encode(prompt, self.config.model_name)
            try:
                stop_ids = [int(t) for t in body.get("stop_token_ids", [])]
                sampling = SamplingParams(
                    max_new_tokens=int(body.get("max_tokens", 64)),
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)),
                    stop_token_ids=tuple(stop_ids),
                )
                token_ids = [int(t) for t in token_ids]
            except (TypeError, ValueError) as e:
                return web.json_response(
                    {"error": f"invalid request field: {e}"}, status=400
                )
            # Per-request deadline: X-Request-Deadline header (seconds of
            # budget), falling back to the configured default inside submit.
            deadline_s = None
            hdr = request.headers.get("X-Request-Deadline")
            if hdr is not None:
                try:
                    deadline_s = float(hdr)
                    # NaN fails every comparison, so `<= 0` alone would
                    # silently accept it as "no deadline": reject instead.
                    if not math.isfinite(deadline_s) or deadline_s <= 0:
                        raise ValueError
                except ValueError:
                    return web.json_response(
                        {"error": "invalid X-Request-Deadline (want seconds > 0)"},
                        status=400,
                    )
            # W3C trace propagation: adopt the caller's traceparent (the
            # scoring service / router minted it) so this pod's spans join
            # the request's fleet-wide trace. Parsed only when tracing is
            # on — the off path reads no headers it didn't before.
            trace_ctx = None
            if self.tracer.enabled:
                trace_ctx = parse_traceparent(request.headers.get("traceparent"))
            route_action = request.headers.get("X-Route-Action")
            if route_action not in ("route_warm", "pull", "cold"):
                route_action = None
            # The router names the warm peer in X-Pull-Source; read only
            # with ASYNC_PULL on.
            pull_source = (
                request.headers.get("X-Pull-Source") if self.config.async_pull else None
            )
            # The tenant (X-Tenant), read only with TENANT_QOS on; an absent
            # or unknown tenant collapses onto the "*" entry in submit.
            tenant = request.headers.get("X-Tenant", "") if self.qos is not None else ""
            try:
                fut = self.submit(
                    token_ids,
                    sampling,
                    deadline_s=deadline_s,
                    trace_ctx=trace_ctx,
                    route_action=route_action,
                    pull_source=pull_source,
                    tenant=tenant,
                )
            except AdmissionError as e:  # overloaded: fast 429, engine untouched
                return admission_reject_response(web, e)
            except DrainingError as e:  # rolling restart: go elsewhere
                return web.json_response({"error": str(e)}, status=503)
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400)
            except RuntimeError as e:  # engine failure / shutdown
                return web.json_response({"error": str(e)}, status=503)
            ctx = getattr(fut, "trace_context", None)
            with log_context(
                request_id=fut.request_id,
                trace_id=ctx.trace_id if ctx is not None else None,
            ):
                try:
                    seq = await asyncio.wrap_future(fut)
                except asyncio.CancelledError:
                    # Client disconnected: free the sequence's pages.
                    self.abort(fut.request_id)
                    raise
                except ValueError as e:  # rejected by engine admission checks
                    return web.json_response({"error": str(e)}, status=400)
                except RuntimeError as e:  # engine failure / shutdown / drain
                    return web.json_response({"error": str(e)}, status=503)
            if seq.error:
                return web.json_response({"error": seq.error}, status=500)

            # Preemption-stable outputs (prompt folding never leaks).
            out_tokens = seq.generated_tokens
            text = None
            if self._tokenizer is not None:
                try:
                    text = self._tokenizer.decode(out_tokens, self.config.model_name)
                except Exception as e:
                    # Generation succeeded; token ids suffice.
                    log.warning("decode failed", error=repr(e))
            stopped = bool(out_tokens) and out_tokens[-1] in sampling.stop_token_ids
            finish_reason = seq.finish_reason or ("stop" if stopped else "length")
            # traceparent echo ONLY when tracing is on: with knobs off the
            # response (body AND headers) is the legacy one.
            headers = {"traceparent": format_traceparent(ctx)} if ctx is not None else None
            return web.json_response(
                {
                    "id": seq.request_id,
                    "object": "text_completion",
                    "model": self.config.model_name,
                    "choices": [
                        {
                            "index": 0,
                            "text": text,
                            "token_ids": out_tokens,
                            "finish_reason": finish_reason,
                        }
                    ],
                    "usage": {
                        "prompt_tokens": seq.user_prompt_len,
                        "completion_tokens": seq.num_generated,
                        "cached_prompt_tokens": seq.num_cached_prompt,
                    },
                    "ttft_s": seq.ttft,
                },
                headers=headers,
            )

        async def healthz(_request: web.Request) -> web.Response:
            if self._failed is not None:
                return web.json_response(
                    {"status": "failed", "error": self._failed}, status=503
                )
            with self._mu:
                draining = self._draining
            if draining:
                # k8s readiness must agree with admission: a draining pod
                # takes no new traffic.
                return web.json_response({"status": "draining"}, status=503)
            return web.json_response({"status": "ok"})

        async def drain_endpoint(_request: web.Request) -> web.Response:
            """Operator-triggered graceful drain (same path as SIGTERM).
            Returns immediately; poll /stats (drain block) or /healthz for
            progress. Idempotent."""
            threading.Thread(target=self.drain, name="drain", daemon=True).start()
            return web.json_response(
                {"status": "draining", "drain_timeout_s": self.config.drain_timeout_s},
                status=202,
            )

        async def stats(_request: web.Request) -> web.Response:
            bm = self.engine.block_manager
            with self._mu:
                # One consistent cut of everything _mu guards.
                staged = len(self._staging)
                pending = self._pending
                pending_tokens = self._pending_tokens
                clients = self._transfer_pool.clients()
                breakers = {
                    ep: client.breaker.snapshot()
                    for ep, client in clients.items()
                    if client.breaker is not None
                }
                breaker_skips = sum(client.breaker_skips for client in clients.values())
                pulls = self.transfer_pulls
                pull_failures = self.transfer_pull_failures
                heartbeats_published = self.heartbeats_published
                snapshots_published = self.snapshots_published
                rejected = self.admission_rejected
                rejected_draining = self.admission_rejected_draining
                draining = self._draining
                drains_started = self.drains_started
                drain_forced = self.drain_forced_requests
                importing = len(self._pull_jobs)
                async_pulls = self.async_pulls
                async_fallbacks = self.async_pull_fallbacks
                async_canceled = self.async_pull_canceled
                role_clamped = self.role_clamped_requests
                prefill_completes = self.prefill_completes_published
                audits_published = self.audits_published
                demote_pushed = self.demote_pushed_blocks
                demote_failed = self.demote_failed_blocks
                demote_dropped = self.demote_dropped
                demote_queued = len(self._demote_queue)
                peer_headroom = dict(self._peer_headroom)
                tenant_qos_snap = self.qos.snapshot() if self.qos is not None else None
                # Fleet-controller counters in the same cut.
                migrations_out = self.migrations_out
                migrations_in = self.migrations_in
                migration_fallbacks = self.migration_fallbacks
            payload = {
                "pod": self.config.pod_identifier,
                "model": self.config.model_name,
                "data_parallel_rank": self.config.data_parallel_rank,
                "staged": staged,
                "waiting": len(self.engine.scheduler.waiting),
                "running": len(self.engine.scheduler.running),
                "free_pages": bm.num_free,
                "total_pages": bm.config.total_pages,
                "prefill": dict(self.engine.prefill_stats),
                "transfer": {
                    **self.engine.transfer_stats,
                    "endpoint": self.config.transfer_endpoint,
                    "pulls": pulls,
                    "pull_failures": pull_failures,
                    "breaker_skips": breaker_skips,
                    "breakers": breakers,
                    "requests_served": (
                        self._transfer_service.requests_served
                        if self._transfer_service
                        else 0
                    ),
                },
                "self_heal": {
                    "heartbeat_interval_s": self.config.heartbeat_interval_s,
                    "resync_interval_s": self.config.resync_interval_s,
                    "heartbeats_published": heartbeats_published,
                    "snapshots_published": snapshots_published,
                    "event_batches_dropped": getattr(self._publisher, "dropped_batches", 0),
                },
                "admission": {
                    "max_waiting": self.config.admission_max_waiting,
                    "max_queued_tokens": self.config.admission_max_queued_tokens,
                    "default_deadline_s": self.config.default_deadline_s,
                    "pending_requests": pending,
                    "pending_prompt_tokens": pending_tokens,
                    "rejected": rejected,
                    "rejected_draining": rejected_draining,
                    **dict(self.engine.lifecycle_stats),
                },
                "drain": {
                    "draining": draining,
                    "drain_timeout_s": self.config.drain_timeout_s,
                    "drains_started": drains_started,
                    "forced_requests": drain_forced,
                },
            }
            if self.config.pod_role != "mixed":
                # Only on a pod with a role.
                payload["disagg"] = {
                    "role": self.config.pod_role,
                    "role_clamped_requests": role_clamped,
                    "prefill_completes_published": prefill_completes,
                }
            if self.config.async_pull:
                # Async-import block only when the knob is on: the knobs-off
                # /stats payload stays the legacy one.
                payload["transfer"]["async_pull"] = {
                    "workers": self.config.pull_workers,
                    "importing": importing,
                    "pulls": async_pulls,
                    "fallbacks": async_fallbacks,
                    "canceled": async_canceled,
                }
            if self.config.remote_tier:
                # Remote-tier block only when the knob is on.
                store = self.engine.remote_store
                payload["remote"] = {
                    "peers": list(self._remote_peers),
                    "store_pages": self.config.remote_store_pages,
                    "store_cached": len(store) if store is not None else 0,
                    "headroom": self.engine.remote_headroom,
                    "peer_headroom": peer_headroom,
                    **dict(self.engine.remote_stats),
                    "pushed_blocks": demote_pushed,
                    "push_failed_blocks": demote_failed,
                    "queue_dropped": demote_dropped,
                    "queued": demote_queued,
                    "store_stats": dict(store.stats) if store is not None else {},
                    "pushes_served": (
                        self._transfer_service.pushes_served if self._transfer_service else 0
                    ),
                    # Pulls and demotion pushes share one DEALER a peer.
                    "clients": self._transfer_pool.snapshot(),
                }
            if bm.config.host_pages > 0:
                # Host tier + KV quant block only when the tier knob is on.
                payload["host"] = {
                    "host_pages": bm.config.host_pages,
                    "cached": bm.num_host_cached_pages,
                    "kv_quant": self.config.engine.kv_quant,
                    "prefetch_enabled": self.config.engine.host_prefetch,
                    **dict(bm.host_stats),
                    "prefetch": dict(self.engine.host_prefetch_stats),
                }
            if self.integrity is not None:
                # Integrity block only with KV_INTEGRITY on.
                payload["integrity"] = self.integrity.snapshot()
            if self.engine.mesh is not None:
                # Only on a sharded pod (TP or SP > 1): the shards' devices,
                # the collective between them and how decode dispatches.
                payload["mesh"] = dict(self.engine.mesh.describe(),
                                       decode_dispatch=self.engine.decode_stats["dispatch"])
            if self.config.engine.kv_quant_hbm is not None:
                # Only when the device-page quant knob is on.
                payload["kv_quant_hbm"] = {
                    "mode": self.config.engine.kv_quant_hbm,
                    "total_pages": bm.config.total_pages,
                    "pool_dtype": str((self.engine.k_pages[0] if self.engine.mesh is not None
                                       else self.engine.k_pages).dtype),
                }
            if self.config.obs_tracing or self.config.obs_metrics:
                # Only with an OBS_* knob on.
                payload["obs"] = {
                    "tracing": self.tracer.snapshot(),
                    "step_stats": {
                        k: round(v, 6) if isinstance(v, float) else v
                        for k, v in self.engine.step_stats.items()
                    },
                    "loop_lag_s": self._loop_lag_s,
                }
            if self.config.obs_audit:
                payload["audit"] = {"published": audits_published}
            if self.slo is not None:
                # Only when OBS_SLO configured an objective.
                payload["slo"] = self.slo.snapshot()
            if self.config.obs_lifecycle:
                payload["lifecycle"] = {
                    **self.lifecycle.snapshot(),
                    "mrc": self.mrc.snapshot(),
                }
            if self.config.obs_flight:
                payload["flight"] = self.flight.snapshot()
            if self.qos is not None:
                # Tenant-QoS block only with the knob on. The scheduler's and
                # block manager's tenant state are read as the queue depths
                # above are: point-in-time reads.
                sch = self.engine.scheduler
                tenant_qos_snap["qos_served_tokens"] = {
                    t: round(v, 1) for t, v in dict(sch._qos_served).items()
                }
                tenant_qos_snap["cache"] = {
                    "evictable_pages": dict(bm._tenant_evictable),
                    "stats": {t: dict(st) for t, st in dict(bm.tenant_stats).items()},
                }
                if self.slo is not None:
                    tenant_qos_snap["slo_burn"] = self.slo.tenant_burn_rates()
                payload["tenant_qos"] = tenant_qos_snap
            if self.config.fleet_controller:
                payload["fleet"] = {
                    "migrations_out": migrations_out,
                    "migrations_in": migrations_in,
                    "migration_fallbacks": migration_fallbacks,
                    "migrations_served": (
                        self._transfer_service.migrations_served
                        if self._transfer_service
                        else 0
                    ),
                    "migration_blocks_accepted": (
                        self._transfer_service.migration_blocks_accepted
                        if self._transfer_service
                        else 0
                    ),
                }
            return web.json_response(payload)

        async def metrics(_request: web.Request) -> web.Response:
            if self.slo is not None:
                # Scrape-driven: the burn rates recompute here.
                self.slo.sync_gauges(self.metrics.set_slo_burn)
                if self.qos is not None:
                    self.slo.sync_tenant_gauges(self.metrics.set_tenant_slo_burn)
            body = self.metrics.exposition()
            if body is None:
                return web.json_response(
                    {"error": "prometheus_client not installed"}, status=501
                )
            return web.Response(
                body=body, headers={"Content-Type": self.metrics.exposition_content_type()}
            )

        async def debug_traces(request: web.Request) -> web.Response:
            """Finished traces from the bounded ring, filterable by
            ``?trace_id=`` / ``?request_id=``. Empty (with enabled=false)
            when OBS_TRACING is off — the endpoint itself is harmless."""
            status, payload = debug_traces_payload(self.tracer, request.query)
            return web.json_response(payload, status=status)

        async def debug_lifecycle(request: web.Request) -> web.Response:
            """Recent block tier transitions from the bounded ledger ring,
            filterable by ``?chain=`` / ``?block=`` hash. Reports itself
            disabled until OBS_LIFECYCLE."""
            status, payload = lifecycle_mod.debug_lifecycle_payload(
                self.lifecycle, request.query
            )
            return web.json_response(payload, status=status)

        async def debug_mrc(request: web.Request) -> web.Response:
            """The sampled miss-ratio-vs-capacity curve, plus each tier's
            cumulative capacity read off it. Disabled-shaped until
            OBS_LIFECYCLE."""
            bm_cfg = self.config.engine.block_manager
            caps = {"tpu_hbm": bm_cfg.total_pages - 1}
            if bm_cfg.host_pages > 0:
                caps["tpu_hbm+host_dram"] = bm_cfg.total_pages - 1 + bm_cfg.host_pages
            status, payload = lifecycle_mod.debug_mrc_payload(
                self.mrc, tier_capacities=caps, query=request.query
            )
            if status != 200:
                return web.json_response(payload, status=status)
            if self.qos is not None:
                # Each tenant's own curve (TENANT_QOS with OBS_LIFECYCLE):
                # how much cache that tenant's hit rate needs.
                payload["tenants"] = {
                    t: lifecycle_mod.debug_mrc_payload(
                        est, tier_capacities=caps, query=request.query
                    )[1]
                    for t, est in sorted(dict(self.engine.block_manager._tenant_mrc).items())
                }
            return web.json_response(payload)

        async def debug_flight(request: web.Request) -> web.Response:
            """Flight-recorder counters and the latest triggered timeline
            (causally ordered). Disabled-shaped until OBS_FLIGHT."""
            from ..obs.flight import debug_flight_payload

            status, payload = debug_flight_payload(self.flight, query=request.query)
            return web.json_response(payload, status=status)

        async def debug_profile(request: web.Request) -> web.Response:
            """Capture a ``torch.profiler`` trace of the live engine (CPU
            operators and, on CUDA, every kernel the card runs, graph
            replays included) for ``?seconds=N`` (default 3, capped at 60)
            into ``OBS_PROFILE_DIR`` as a Chrome trace. Disabled (400) until
            that knob is set; one capture at a time (409)."""
            import asyncio

            profile_dir = self.config.obs_profile_dir
            if not profile_dir:
                return web.json_response(
                    {"error": "profiling disabled; set OBS_PROFILE_DIR"}, status=400
                )
            try:
                seconds = float(request.query.get("seconds", "3"))
            except ValueError:
                return web.json_response({"error": "invalid seconds"}, status=400)
            if not (0 < seconds <= 60):
                return web.json_response(
                    {"error": "seconds must be in (0, 60]"}, status=400
                )
            if not self._profile_mu.acquire(blocking=False):
                return web.json_response(
                    {"error": "a profile capture is already running"}, status=409
                )

            def capture() -> None:
                # The lock is released HERE, not in the handler: a client
                # disconnect cancels the awaiting handler, but executor
                # work is uncancellable — releasing from the handler would
                # let a second capture collide with the running profiler.
                try:
                    self._profile_capture(profile_dir, seconds)
                finally:
                    self._profile_mu.release()

            try:
                fut = asyncio.get_running_loop().run_in_executor(None, capture)
            except RuntimeError:
                self._profile_mu.release()  # never dispatched
                raise
            try:
                await fut
            except Exception as e:
                return web.json_response(
                    {"error": f"profile capture failed: {e!r}"}, status=500
                )
            return web.json_response({"profile_dir": profile_dir, "seconds": seconds})

        app = web.Application()
        app.router.add_post("/v1/completions", completions)
        app.router.add_get("/healthz", healthz)
        app.router.add_post("/drain", drain_endpoint)
        app.router.add_get("/stats", stats)
        app.router.add_get("/metrics", metrics)
        app.router.add_get("/debug/traces", debug_traces)
        app.router.add_get("/debug/lifecycle", debug_lifecycle)
        app.router.add_get("/debug/mrc", debug_mrc)
        app.router.add_get("/debug/flight", debug_flight)
        app.router.add_post("/debug/profile", debug_profile)
        return app

    def _profile_capture(self, profile_dir: str, seconds: float) -> None:
        """One ``torch.profiler`` window of ``seconds`` over the whole
        process, written to ``profile_dir`` as a Chrome trace
        (``<pod>-<time>-<id>.pt.trace.json``). CUDA activity is recorded when the engine runs on the
        card; CUPTI sees kernels of every thread and stream, the engine
        loop's graph replays included. The device is synchronized before
        the window closes, so the kernels it launched are in the trace."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from ..ops import LAUNCH_LOCK

        cuda = self.engine.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(
            profile_dir,
            f"{self.config.pod_identifier}-{time.strftime('%Y%m%d-%H%M%S')}"
            f"-{uuid.uuid4().hex[:8]}.pt.trace.json",
        )
        prof = profile(activities=activities)
        # Start and stop (with the closing device sync) outside any decode
        # graph capture: a capture holds LAUNCH_LOCK from start to end.
        with LAUNCH_LOCK:
            prof.start()
        try:
            time.sleep(seconds)
        finally:
            with LAUNCH_LOCK:
                if cuda:
                    torch.cuda.synchronize(self.engine.device)
                prof.stop()
        prof.export_chrome_trace(path)


def _resolve_model(name: str) -> LlamaConfig:
    presets = {
        "tiny-llama": TINY_LLAMA,
        "tiny-moe": TINY_MOE,
        "tiny-gemma": TINY_GEMMA,
        "tiny-qwen3-moe": TINY_QWEN3_MOE,
        "meta-llama/Llama-3.1-8B-Instruct": LLAMA_3_8B,
        "meta-llama/Meta-Llama-3-8B": LLAMA_3_8B,
        "Qwen/Qwen3-30B-A3B": QWEN3_30B_A3B,
    }
    if name in presets:
        return presets[name]
    raise SystemExit(f"unknown model {name!r}; known presets: {sorted(presets)}")


def main() -> None:
    from aiohttp import web

    config = PodServerConfig.from_env()
    config.engine.model = _resolve_model(config.model_name)
    server = PodServer(config)
    server.start()
    log.info(
        "GPU pod server listening",
        port=config.http_port,
        pod=config.pod_identifier,
        model=config.model_name,
        zmq=config.zmq_endpoint,
    )
    app = server.build_app()

    async def _drain_on_shutdown(_app):
        # SIGTERM path: aiohttp's GracefulExit lands here before the
        # process dies — drain (finish inflight up to DRAIN_TIMEOUT_S,
        # publish the final snapshot + PodDrained goodbye) so a rolling
        # restart never leaves stale locality in the fleet for POD_TTL_S.
        import asyncio

        await asyncio.get_running_loop().run_in_executor(None, server.drain)

    app.on_shutdown.append(_drain_on_shutdown)
    try:
        web.run_app(app, port=config.http_port)
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
