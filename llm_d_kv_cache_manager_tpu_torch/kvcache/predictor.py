"""Predicted-TTFT routing model: route on modeled latency, not score-max.

BENCH_r03-r11 showed warmth-first routing hitting a ceiling the audit
plane made legible: once every pod holds *some* warmth, the
residual TTFT is QUEUE time, and a router that always picks the warmest
pod piles requests onto it — paying more in queue delay than the cache
hits save (the r11 blended headline went NEGATIVE vs round-robin on the
saturated ramp). Every input the fix needs already rides the
heartbeats and in-process telemetry: per-pod queue depth, the engine's
measured prefill-rate EMA, and draining/admission state.

``TTFTPredictor`` models, per candidate pod,

    TTFT ~= queue_wait + miss_tokens / prefill_rate [+ pull cost]

- **queue_wait** — ``queue_depth x service_s``: each outstanding request
  ahead of ours costs roughly its prefill work at the pod's measured
  rate (the predictor keeps an EMA of observed prompt lengths as the
  per-request work estimate; until any rate is measured the coarse
  ``est_service_s`` proxy — the same constant the transfer cost model
  queues on — stands in).
- **miss_tokens / prefill_rate** — the suffix the pod must actually
  prefill: prompt length minus the warm prefix the index claims there
  (capped at ``prompt_len - 1``; the engine always computes one fresh
  position).
- **pull cost** — for pull arms, the cost model's measured link
  rate prices moving the warm chain: ``pull_blocks x block_bytes /
  transfer_rate``.

The router (``BlendedRouter`` with a predictor attached — the
``ROUTE_PREDICT`` knob) routes to the argmin. Draining, dead, kvstore,
and admission-closed pods predict ``inf`` — never picked while any
eligible pod exists.

**Abstention** mirrors the cost model's bootstrap rule: until at least
one usable pod has a measured prefill rate the predictor returns None
and the legacy score-max ranking stands — the model must never un-warm
routing on guesses.

**Heartbeat staleness**: a pod whose signals are older than
``staleness_factor x heartbeat_interval_s`` (2x the heartbeat cadence by
default) has its queue_depth/prefill_rate treated as UNKNOWN and decays
to conservative defaults — the deepest fresh queue and the slowest fresh
rate — so a crashed pod's frozen "shallow queue" never attracts the
whole fleet (``kvevents/health.py`` carries the ages).

**The corrector closes the loop** (the first time the audit plane
is an actuator, not a dashboard): the ``RouteAuditor`` join hands each
decision's realized-vs-predicted TTFT to ``PredictionCorrector``, a
per-pod EWMA of the realized/predicted ratio applied multiplicatively to
that pod's future predictions — when heartbeats go stale or the rate EMA
lies, the model's error feeds back within a few requests instead of
compounding. Biases are clamped (``corrector_min``/``corrector_max``) so
one absurd sample cannot invert routing.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..utils import get_logger

log = get_logger("kvcache.predictor")

#: prediction arms (RoutingDecision.action values the predictor emits)
ARM_WARM = "route_warm"
ARM_PULL = "pull"


@dataclass
class PodSignals:
    """Per-pod routing signals, assembled by the caller from heartbeat
    state (``FleetHealth.signal_views``) and serving telemetry (queue
    depth + prefill-rate EMA — the same carriers ``disagg.PodView``
    reads). ``None`` means unknown, never zero: an unknown queue must
    not read as an idle pod."""

    name: str
    #: outstanding requests (waiting + running); None = unknown
    queue_depth: Optional[float] = None
    #: measured prefill tokens/s (engine EMA); None = unknown
    prefill_rate: Optional[float] = None
    draining: bool = False
    dead: bool = False
    #: heartbeat-advertised role; "kvstore" pods are storage, never routed
    role: Optional[str] = None
    #: admission control state: False = the pod is 429ing new work
    admitting: bool = True
    #: age of these signals in seconds (now - last heartbeat); None =
    #: fresh/in-process (live attribute reads are never stale)
    signal_age_s: Optional[float] = None
    #: request-parallelism of the pod's serving plane (continuous-
    #: batching width): queued work is served ~this many at a time, so
    #: one outstanding request is NOT a full service-time wait. None =
    #: the config default
    concurrency: Optional[float] = None


@dataclass
class PredictedArm:
    """One pod's best predicted serving option."""

    pod: str
    ttft_s: float
    action: str = ARM_WARM
    pull_source: Optional[str] = None
    pull_blocks: int = 0
    #: the un-corrected model output (observability: bias visible as
    #: ttft_s / raw_ttft_s)
    raw_ttft_s: float = 0.0


@dataclass
class TTFTPredictorConfig:
    #: tokens per KV block (align with the indexer's block_size)
    block_size: int = 16
    #: the fleet's heartbeat cadence; signals older than
    #: ``staleness_factor x heartbeat_interval_s`` decay to conservative
    #: defaults. 0 (default) = signals are live attribute reads, never
    #: stale (the in-process co-sim / single-binary case)
    heartbeat_interval_s: float = 0.0
    #: staleness multiple of the heartbeat interval (2 = one missed beat
    #: plus slack — the satellite contract)
    staleness_factor: float = 2.0
    #: coarse per-queued-request service proxy until a prefill rate is
    #: measured (same constant the transfer cost model queues on)
    est_service_s: float = 0.05
    #: EMA weight for the per-request prompt-work estimate
    work_ema_alpha: float = 0.2
    #: modeled request-parallelism when a pod's signals don't carry one:
    #: queue_wait = (depth / concurrency) x per-request service. Leave
    #: at 1 when the supplied prefill rate is the engine's EMA — that
    #: rate is BATCH-AGGREGATE tokens/s, so per-request service is
    #: already amortized over the batch width and dividing again would
    #: double-count the parallelism. Raise it only for feeds that carry
    #: a per-request (single-stream) rate.
    default_concurrency: float = 1.0
    #: relative tie band: candidate arms whose predicted TTFT is within
    #: this fraction (plus ``tie_abs_s``) of the best are TIES, resolved
    #: by the legacy ranking (warmth > affinity > load) — when the model
    #: sees no meaningful latency difference it must not scatter warm
    #: prefix groups over noise, which is what protects hit-rate parity
    #: with score-max routing
    tie_band: float = 0.1
    tie_abs_s: float = 0.002
    #: a pull arm must beat the pod's best non-pull arm by this fraction
    #: to be chosen: the wire rate is an EMA that starts from a seed, so
    #: the first pulls are the worst-priced decisions the model makes —
    #: demanding a decisive modeled win keeps marginal pulls (where a
    #: mispriced import would land straight in the TTFT tail) off the
    #: table while the high-value ones (deep warm chain, idle target)
    #: still fire and feed the EMA real samples
    pull_margin: float = 0.25
    #: corrector EWMA weight for the per-pod realized/predicted ratio
    corrector_alpha: float = 0.2
    #: clamp on the per-pod bias multiplier (one absurd sample must not
    #: invert routing)
    corrector_min: float = 0.25
    corrector_max: float = 4.0


class PredictionCorrector:
    """Two-level multiplicative bias learned from the audit join:
    ``bias(pod) = global x residual(pod)``, both geometric EWMAs of the
    realized/predicted TTFT ratio.

    The decomposition matters. The model's SYSTEMATIC error (scheduler
    step granularity, batching, decode interference — whatever the
    closed-form misses) is fleet-wide: the **global** factor absorbs it,
    so a fresh replica inherits the fleet's calibration instead of
    restarting at 1.0. A PER-POD lie (a frozen heartbeat advertising a
    stale rate, one slow host) lands in that pod's **residual** — and
    because residuals default to 1.0, a lying pod's prediction rises
    RELATIVE to its honest peers and routing actually fails over. (A
    single flat per-pod-or-global bias cannot do both: when only the
    winning pod gets joins, the lie and the fleet default scale together
    and the liar keeps winning forever.)

    Updates are geometric (``factor *= err^alpha``) — the natural EWMA
    for a multiplicative quantity — with the per-sample error clamped to
    [0.1, 10] and both factors clamped to [lo, hi], so one absurd join
    cannot invert routing."""

    def __init__(
        self,
        alpha: float = 0.2,
        lo: float = 0.25,
        hi: float = 4.0,
        global_alpha: Optional[float] = None,
    ):
        self.alpha = alpha
        self.global_alpha = global_alpha if global_alpha is not None else alpha / 2
        self.lo = lo
        self.hi = hi
        self._mu = threading.Lock()
        self._resid: dict[str, float] = {}  # guarded_by: _mu
        self._global = 1.0  # guarded_by: _mu
        self.observed = 0  # guarded_by: _mu

    def observe(
        self, pod: str, predicted_s: float, realized_s: float
    ) -> Optional[float]:
        """Fold one realized outcome; returns the pod's new bias (None
        when the sample is unusable — non-positive prediction/outcome)."""
        if predicted_s <= 0 or realized_s <= 0:
            return None
        err = min(max(realized_s / predicted_s, 0.1), 10.0)
        with self._mu:
            r = self._resid.get(pod, 1.0) * err**self.alpha
            self._resid[pod] = min(max(r, self.lo), self.hi)
            self._global = min(
                max(self._global * err**self.global_alpha, self.lo),
                self.hi,
            )
            self.observed += 1
        return self.bias(pod)

    def bias(self, pod: str) -> float:
        with self._mu:
            return min(
                max(self._global * self._resid.get(pod, 1.0), self.lo),
                self.hi,
            )

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "observed": self.observed,
                "global_bias": round(self._global, 4),
                "bias": {
                    p: round(
                        min(max(self._global * r, self.lo), self.hi), 4
                    )
                    for p, r in self._resid.items()
                },
            }


class TTFTPredictor:
    """The latency model. Stateless per decision except the prompt-work
    EMA (and the attached corrector) — safe to share across router
    threads."""

    def __init__(
        self,
        config: Optional[TTFTPredictorConfig] = None,
        corrector: Optional[PredictionCorrector] = None,
    ):
        self.config = config or TTFTPredictorConfig()
        cfg = self.config
        self.corrector = corrector or PredictionCorrector(
            alpha=cfg.corrector_alpha, lo=cfg.corrector_min,
            hi=cfg.corrector_max,
        )
        self._mu = threading.Lock()
        #: EMA of prompt lengths routed through this predictor — the
        #: per-queued-request work estimate for queue_wait
        self._req_tokens: Optional[float] = None  # guarded_by: _mu
        self.predictions = 0  # guarded_by: _mu
        self.abstained = 0  # guarded_by: _mu

    # -- signal resolution ----------------------------------------------------
    def _is_stale(self, sig: PodSignals) -> bool:
        hb = self.config.heartbeat_interval_s
        if hb <= 0 or sig.signal_age_s is None:
            return False
        return sig.signal_age_s > self.config.staleness_factor * hb

    @staticmethod
    def _eligible(sig: PodSignals) -> bool:
        return not (
            sig.dead or sig.draining or sig.role == "kvstore"
            or not sig.admitting
        )

    def _observe_work(self, prompt_len: int) -> float:
        a = self.config.work_ema_alpha
        with self._mu:
            self._req_tokens = (
                float(prompt_len)
                if self._req_tokens is None
                else (1 - a) * self._req_tokens + a * prompt_len
            )
            self.predictions += 1
            return self._req_tokens

    # -- the model ------------------------------------------------------------
    def predict_pod(
        self,
        sig: PodSignals,
        prompt_len: int,
        warm_blocks: int,
        *,
        queue_fallback: float,
        rate_fallback: float,
        req_tokens: float,
        pull_blocks: int = 0,
        transfer_rate: Optional[float] = None,
        block_bytes: int = 0,
    ) -> float:
        """One pod's predicted TTFT for one serving arm, in seconds
        (``inf`` for pods that must never be picked). ``pull_blocks > 0``
        prices the pull arm: the chain lands before prefill, so the
        reusable prefix is the pulled one and the wire time is added."""
        if not self._eligible(sig):
            return float("inf")
        stale = self._is_stale(sig)
        # Unknown is WORSE than the worst known: a stale/absent queue
        # reads as the deepest fresh queue plus one, so it can never
        # win a tie against a pod we have live signals for. Negative
        # inputs (a buggy upstream feed) are unknown too — clamping a
        # negative depth to 0 would model the corrupt pod as the idlest
        # in the fleet and convoy everything onto it, and a negative
        # rate would predict a negative TTFT and win every route.
        q = (
            sig.queue_depth
            if not stale
            and sig.queue_depth is not None
            and sig.queue_depth >= 0
            else queue_fallback + 1.0
        )
        rate = (
            sig.prefill_rate
            if not stale and sig.prefill_rate and sig.prefill_rate > 0
            else rate_fallback
        )
        cfg = self.config
        # Per-queued-request service time: its prefill work at this pod's
        # rate (the est_service_s proxy until rates exist — rate_fallback
        # is then <= 0 and predict() never reaches here without one).
        service_s = req_tokens / rate if rate > 0 else cfg.est_service_s
        width = max(
            sig.concurrency
            if sig.concurrency is not None
            else cfg.default_concurrency,
            1.0,
        )
        queue_wait = (q / width) * service_s
        reuse_blocks = pull_blocks if pull_blocks > 0 else warm_blocks
        reuse_tokens = min(
            reuse_blocks * cfg.block_size, max(prompt_len - 1, 0)
        )
        miss_s = max(prompt_len - reuse_tokens, 1) / rate
        pull_s = 0.0
        if pull_blocks > 0:
            if not transfer_rate or transfer_rate <= 0 or block_bytes <= 0:
                return float("inf")  # can't price the move — not an arm
            pull_s = pull_blocks * block_bytes / transfer_rate
        raw = queue_wait + miss_s + pull_s
        return raw * self.corrector.bias(sig.name)

    def predict_routes(
        self,
        signals: Sequence[PodSignals],
        prompt_len: int,
        scores: dict,
        *,
        remote_scores: Optional[dict] = None,
        remote_endpoint_of=None,
        transfer_rate: Optional[float] = None,
        block_bytes: int = 0,
        max_pull_blocks: Optional[int] = None,
    ) -> Optional[dict[str, PredictedArm]]:
        """Predict every pod's best serving arm for this prompt.

        Returns ``{pod: PredictedArm}`` over the eligible pods, or None
        when the model abstains (no usable pod has a measured prefill
        rate — legacy routing stands). Pull arms are considered per pod
        against the single best source: the warmest OTHER serving pod,
        or a remote holder with strictly more of the prefix
        (``remote_scores``); both priced only when the transfer plane's
        measured link rate exists."""
        usable = [s for s in signals if self._eligible(s)]
        if not usable:
            self.note_abstained()
            return None
        fresh = [s for s in usable if not self._is_stale(s)]
        rates = [
            s.prefill_rate
            for s in fresh
            if s.prefill_rate and s.prefill_rate > 0
        ]
        if not rates:
            self.note_abstained()
            return None
        # Conservative decay targets for stale/unknown signals: the
        # SLOWEST fresh rate and the DEEPEST fresh queue — a pod we know
        # nothing current about must look no better than the worst pod
        # we do (the stale-shallow-queue failure this exists to prevent).
        rate_fallback = min(rates)
        depths = [
            s.queue_depth
            for s in fresh
            if s.queue_depth is not None
        ]
        queue_fallback = max(depths) if depths else 0.0
        req_tokens = self._observe_work(prompt_len)
        # Best pull source: warmest serving pod (by index score), and a
        # remote holder when it holds strictly more than any server.
        best_src, best_src_blocks = None, 0
        for s in usable:
            b = scores.get(s.name, 0)
            if b > best_src_blocks:
                best_src, best_src_blocks = s.name, b
        remote_src, remote_blocks = None, 0
        if remote_scores:
            holder, rblocks = max(
                remote_scores.items(), key=lambda kv: (kv[1], kv[0])
            )
            if rblocks > best_src_blocks:
                endpoint = (
                    remote_endpoint_of(holder)
                    if remote_endpoint_of is not None
                    else holder
                ) or holder
                remote_src, remote_blocks = endpoint, rblocks

        def cap(blocks: int) -> int:
            return (
                min(blocks, max_pull_blocks)
                if max_pull_blocks is not None
                else blocks
            )

        out: dict[str, PredictedArm] = {}
        for sig in usable:
            warm = scores.get(sig.name, 0)
            common = dict(
                queue_fallback=queue_fallback,
                rate_fallback=rate_fallback,
                req_tokens=req_tokens,
            )
            best = PredictedArm(
                pod=sig.name,
                ttft_s=self.predict_pod(sig, prompt_len, warm, **common),
                action=ARM_WARM,
            )
            # Pull arm: move the best source's chain here first. Never
            # "pull" a pod's own chain onto itself.
            for src, blocks in (
                (best_src, best_src_blocks),
                (remote_src, remote_blocks),
            ):
                if src is None or src == sig.name or blocks <= warm:
                    continue
                t = self.predict_pod(
                    sig, prompt_len, warm,
                    pull_blocks=cap(blocks),
                    transfer_rate=transfer_rate,
                    block_bytes=block_bytes,
                    **common,
                )
                if t < best.ttft_s * (1.0 - self.config.pull_margin):
                    best = PredictedArm(
                        pod=sig.name, ttft_s=t, action=ARM_PULL,
                        pull_source=src, pull_blocks=cap(blocks),
                    )
            bias = self.corrector.bias(sig.name)
            best.raw_ttft_s = best.ttft_s / bias if bias > 0 else best.ttft_s
            out[sig.name] = best
        return out

    def note_abstained(self) -> None:
        """Count one abstained decision (no usable pod, no measured
        rate, or — counted by the router — every arm inf): the /stats
        counter exists to surface exactly 'legacy routing is handling
        this traffic', so every abstention path must feed it."""
        with self._mu:
            self.abstained += 1

    def snapshot(self) -> dict:
        """Observability block for ``/stats`` (gated by the knob)."""
        with self._mu:
            preds, abst = self.predictions, self.abstained
            req_tokens = self._req_tokens
        return {
            "predictions": preds,
            "abstained": abst,
            "req_tokens_ema": (
                round(req_tokens, 1) if req_tokens is not None else None
            ),
            "corrector": self.corrector.snapshot(),
        }
