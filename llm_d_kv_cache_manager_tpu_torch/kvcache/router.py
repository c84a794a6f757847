"""Fleet routing built on the KV-block index: blended scorer.

The reference library stops at ``GetPodScores`` — blending with other
scorers happens in the consuming scheduler (its production deployments
combine the kv-cache scorer with prefix-affinity and load scorers; the
EPP sketch in ``examples/kv_cache_aware_scorer`` shows the embedding
point). This module ships that blending as a first-class component,
because round-4 fleet measurements showed pure index routing INVERTING
under pool thrash: when every pod's cache churns, the index truthfully
reports "cold everywhere", and load-tiebreaking then scatters each
prefix group across pods so no warmth ever forms — an index-free sticky
LRU beat it 2× at the tail (benchmarking/results/routing_capacity.md,
round-4 section).

``BlendedRouter`` ranks pods by:

1. **index score** — longest consecutive prefix of KV blocks the pod
   actually holds (real KV events; dominates whenever it exists);
2. **routed-affinity memory** — a per-pod capacity-bounded LRU of the
   block chains this router previously sent there (``PrefixAffinityTracker``),
   giving load-aware FIRST placement and sticky rebuilds when the index
   is cold;
3. **load** — fewest outstanding requests, supplied by the caller.

Measured at a thrash-sized pool: p90 TTFT 2.51 s vs 5.66 s for pure
index routing, and −17 % vs the strongest index-free baseline.

Routing toward warmth has a hard limit this module hit in round 4: when
the warmest pod is overloaded (or a replica joins cold), the best options
used to be "queue behind the hot pod" or "recompute the whole prefill
cold". With an optional ``kvcache/transfer`` cost model the router gains
the third option — MOVE the warmth: ``RoutingDecision.action`` reports
route-to-warm / pull-then-compute / cold-recompute, decided from measured
transfer bytes/s vs prefill tokens/s (see ``transfer/cost_model.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from .kvblock.token_processor import ChunkedTokenDatabase, TokenProcessorConfig
from .metrics import collector
from .predictor import PodSignals


class PrefixAffinityTracker:
    """Per-pod capacity-bounded LRU of routed token-block chains.

    Models "which pod did I send this prefix to, and would its cache
    plausibly still hold it" WITHOUT observing KV events: capacity should
    approximate the pod's pool (HBM pages + host-tier slots, in blocks);
    an optional TTL additionally expires stale affinity. This is also the
    strongest index-free comparator (``bench.py``'s ``estimated`` policy).
    """

    def __init__(
        self,
        n_pods: int,
        capacity_blocks: int,
        ttl_s: Optional[float] = None,
        token_processor: Optional[ChunkedTokenDatabase] = None,
    ):
        self.tp = token_processor or ChunkedTokenDatabase(TokenProcessorConfig())
        self.capacity = capacity_blocks
        self.ttl_s = ttl_s
        #: per-pod OrderedDict: block hash -> last-touch time
        self._routed: list[OrderedDict] = [OrderedDict() for _ in range(n_pods)]

    def keys(self, tokens: Sequence[int]) -> list[int]:
        return self.tp.prefix_hashes(tokens)

    def score(self, keys: Sequence[int], pod: int, now: float = 0.0) -> int:
        """Longest consecutive modeled-resident prefix on ``pod``."""
        lru = self._routed[pod]
        n = 0
        for h in keys:
            ts = lru.get(h)
            if ts is None or (self.ttl_s is not None and now - ts > self.ttl_s):
                break
            n += 1
        return n

    def record(self, keys: Sequence[int], pod: int, now: float = 0.0) -> None:
        """Refresh the routed chain in the pod's modeled LRU (insertion
        order = recency), then evict past capacity — mirroring what the
        pod's own page pool will do with the blocks this request touches."""
        lru = self._routed[pod]
        for h in keys:
            lru.pop(h, None)
            lru[h] = now
        while len(lru) > self.capacity:
            lru.popitem(last=False)


@dataclass
class RoutingDecision:
    pod: str
    index_score: int
    affinity_score: int
    #: transfer-aware verdict (kvcache/transfer cost model): "route_warm"
    #: (serve where the prefix lives — the only action without a cost
    #: model), "pull" (land on ``pod`` but fetch the warm prefix from
    #: ``pull_source`` first), or "cold" (land on ``pod``, recompute).
    action: str = "route_warm"
    pull_source: Optional[str] = None
    #: consecutive warm prefix blocks available at ``pull_source``
    pull_blocks: int = 0
    #: modeled TTFT of the chosen arm (ROUTE_PREDICT only; None = the
    #: legacy score-max ranking made this decision)
    predicted_ttft_s: Optional[float] = None


class BlendedRouter:
    """index score → routed-affinity tiebreak → least load.

    ``score_fn(tokens, pods) -> {pod: score}`` is the index read path
    (e.g. ``KVCacheIndexer.score_tokens`` partially applied with the
    model name); ``loads_fn(pods) -> [outstanding]`` supplies load.

    With a ``cost_model`` (``kvcache/transfer.TransferCostModel``) the
    router gains a third axis beyond *where warmth is*: whether to MOVE
    it. When the warmest pod is loaded, the model compares queueing
    behind it against pulling its prefix blocks onto the least-loaded pod
    (measured transfer bytes/s vs prefill tokens/s) against plain cold
    recompute there — the decision rides back on ``RoutingDecision.action``
    and the caller performs the pull (``PodServer.pull_prefix``). Without
    a cost model the behavior is bit-identical to the legacy router.
    """

    def __init__(
        self,
        score_fn: Callable,
        affinity: PrefixAffinityTracker,
        loads_fn: Callable[[Sequence[str]], Sequence[float]],
        cost_model=None,
        auditor=None,
        remote_score_fn: Optional[Callable] = None,
        remote_endpoint_of: Optional[Callable[[str], Optional[str]]] = None,
        predictor=None,
        signals_fn: Optional[Callable] = None,
    ):
        """``auditor`` (optional, an ``obs.RouteAuditor``): records each
        decision's predicted matched-block count + scoreboard keyed by
        request id, so the pod's realized prefix-cache hits can be joined
        back into the predicted-vs-realized / regret / miss-attribution
        metrics. None (default) records nothing — legacy behavior.

        ``remote_score_fn(tokens) -> {holder: blocks}`` (optional, the
        ``REMOTE_TIER`` read path): warmth held by NON-serving remote
        holders — kvstore pods and peers' remote stores, scored through
        the same index on their ``medium="remote"`` entries. With it (and
        a ``cost_model``) the router gains the demoted-warmth arm: when a
        holder has strictly more of the prefix than the warmest serving
        pod and the measured cost model says moving it beats recomputing,
        the decision becomes a pull from the holder onto the best serving
        target — a remote hit beats recompute but loses to a warm local
        hit. ``remote_endpoint_of(holder) -> transfer endpoint`` maps the
        holder's pod identity to its export endpoint (None keeps the pod
        name, which in-process fleets use directly). Both None (default)
        = bit-identical legacy routing.

        ``predictor`` (optional, a ``kvcache.predictor.TTFTPredictor``
        — the ``ROUTE_PREDICT`` knob): replace score-max ranking with
        predicted-TTFT minimization — per candidate pod, queue wait
        (depth x measured prefill rate) + miss-suffix prefill time
        (+ measured pull cost for pull arms), argmin wins.
        ``signals_fn(pods) -> [PodSignals]`` supplies the per-pod queue
        depth / prefill rate / liveness signals (heartbeat state or live
        attribute reads); without it the predictor only sees loads and
        abstains. The predictor ABSTAINS (None) until a prefill rate is
        measured, and whenever every candidate predicts inf — in both
        cases this router's decision is bit-identical to the legacy
        path. None (default) = legacy score-max routing."""
        self.score_fn = score_fn
        self.affinity = affinity
        self.loads_fn = loads_fn
        self.cost_model = cost_model
        self.auditor = auditor
        self.remote_score_fn = remote_score_fn
        self.remote_endpoint_of = remote_endpoint_of
        self.predictor = predictor
        self.signals_fn = signals_fn

    def route(
        self,
        tokens: Sequence[int],
        pods: Sequence[str],
        now: float = 0.0,
        request_id: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> RoutingDecision:
        scores = self.score_fn(tokens, pods)
        keys = self.affinity.keys(tokens)
        loads = list(self.loads_fn(pods))
        aff_scores = [
            self.affinity.score(keys, i, now) for i in range(len(pods))
        ]
        predicted = (
            self._predict(tokens, pods, scores, loads, aff_scores)
            if self.predictor is not None
            else None
        )
        if predicted is not None:
            # Predicted-TTFT minimization (ROUTE_PREDICT): the argmin of
            # the modeled latency replaces score-max ranking entirely —
            # the legacy block below never runs for this decision.
            target, action, pull_source, pull_blocks, predicted_ttft = predicted
            warm_blocks = scores.get(pods[target], 0)
            collector.observe_predicted_ttft(predicted_ttft)
            return self._finish(
                tokens, pods, scores, keys, loads, aff_scores, now,
                target, action, pull_source, pull_blocks, warm_blocks,
                request_id, trace_id, predicted_ttft,
            )
        best = max(
            range(len(pods)),
            key=lambda i: (scores.get(pods[i], 0), aff_scores[i], -loads[i], -i),
        )
        target, action, pull_source, pull_blocks = best, "route_warm", None, 0
        warm_blocks = scores.get(pods[best], 0)
        if self.cost_model is not None and warm_blocks > 0:
            coldest = min(range(len(pods)), key=lambda i: (loads[i], i))
            if coldest != best:
                verdict = self.cost_model.decide(
                    prompt_len=len(tokens),
                    warm_blocks=warm_blocks,
                    warm_load=loads[best],
                    cold_load=loads[coldest],
                )
                if verdict == "pull":
                    target, action = coldest, "pull"
                    pull_source, pull_blocks = pods[best], warm_blocks
                elif verdict == "cold":
                    target, action = coldest, "cold"
        if (
            self.remote_score_fn is not None
            and self.cost_model is not None
            and action != "pull"
        ):
            remote = self.remote_score_fn(tokens)
            if remote:
                # Deterministic best holder: most blocks, name tiebreak.
                holder, rblocks = max(
                    remote.items(), key=lambda kv: (kv[1], kv[0])
                )
                if rblocks > warm_blocks:
                    # The demoted copy holds strictly more of the prefix
                    # than any serving pod. Land on the stickiest/least
                    # loaded target and pull — if the measured cost model
                    # says the move beats both the warm local option and
                    # recompute (remote beats recompute, loses to warm).
                    tgt = max(
                        range(len(pods)),
                        key=lambda i: (aff_scores[i], -loads[i], -i),
                    )
                    verdict = self.cost_model.decide_remote(
                        prompt_len=len(tokens),
                        remote_blocks=rblocks,
                        target_load=loads[tgt],
                        warm_blocks=warm_blocks,
                        warm_load=loads[best],
                    )
                    if verdict == "pull":
                        target, action = tgt, "pull"
                        pull_blocks = rblocks
                        pull_source = (
                            self.remote_endpoint_of(holder)
                            if self.remote_endpoint_of is not None
                            else holder
                        ) or holder
        return self._finish(
            tokens, pods, scores, keys, loads, aff_scores, now,
            target, action, pull_source, pull_blocks, warm_blocks,
            request_id, trace_id, None,
        )

    def _predict(self, tokens, pods, scores, loads, aff_scores):
        """ROUTE_PREDICT arm: ask the predictor for every pod's best
        modeled arm and argmin. Returns ``(target_idx, action,
        pull_source, pull_blocks, predicted_ttft_s)`` or None when the
        model abstains (no measured rate / every arm inf) — the legacy
        ranking then stands, so prediction can never make a decision the
        legacy fleet could not survive."""
        signals = list(self.signals_fn(pods)) if self.signals_fn else []
        by_name = {s.name: s for s in signals}
        sigs = [
            by_name.get(p, PodSignals(name=p, queue_depth=loads[i]))
            for i, p in enumerate(pods)
        ]
        cm = self.cost_model
        # The remote scan is only worth paying when a cost model exists
        # to price the resulting pull arms (same gate as the legacy
        # remote block) — without one every pull arm is inf anyway.
        remote = (
            self.remote_score_fn(tokens)
            if self.remote_score_fn is not None and cm is not None
            else None
        )
        arms = self.predictor.predict_routes(
            sigs,
            len(tokens),
            scores,
            remote_scores=remote,
            remote_endpoint_of=self.remote_endpoint_of,
            transfer_rate=cm.transfer_rate if cm is not None else None,
            block_bytes=cm.config.block_bytes if cm is not None else 0,
            max_pull_blocks=(
                cm.config.max_pull_blocks if cm is not None else None
            ),
        )
        if not arms:
            return None
        candidates = [
            (i, arms[p]) for i, p in enumerate(pods)
            if p in arms and arms[p].ttft_s != float("inf")
        ]
        if not candidates:
            self.predictor.note_abstained()
            return None
        # Argmin with a tie band: candidates whose modeled TTFT is
        # within tie_band (relative) + tie_abs_s of the best are TIES —
        # the model sees no meaningful latency difference there, and
        # scattering a warm prefix group over sub-noise deltas would
        # trade real future hits for nothing. Ties resolve by the legacy
        # ranking axes (warmth, affinity, load, index), so quiet traffic
        # routes exactly as the score-max fleet would.
        cfg = self.predictor.config
        best_ttft = min(c[1].ttft_s for c in candidates)
        threshold = best_ttft * (1.0 + cfg.tie_band) + cfg.tie_abs_s
        ties = [c for c in candidates if c[1].ttft_s <= threshold]
        i, arm = max(
            ties,
            key=lambda c: (
                scores.get(pods[c[0]], 0),
                aff_scores[c[0]],
                -loads[c[0]],
                -c[1].ttft_s,
                -c[0],
            ),
        )
        return i, arm.action, arm.pull_source, arm.pull_blocks, arm.ttft_s

    def _finish(
        self, tokens, pods, scores, keys, loads, aff_scores, now,
        target, action, pull_source, pull_blocks, warm_blocks,
        request_id, trace_id, predicted_ttft,
    ):
        self.affinity.record(keys, target, now)
        # Routing-quality observability: verdict counts let dashboards see
        # the warm/pull/cold mix shift as the fleet warms or thrashes
        # (kvcache_scorer_route_decisions_total{decision=...}). The metric
        # label reports the PLACEMENT QUALITY, not the code path: the
        # default "route_warm" action with a zero index score is a cold
        # placement (cold fleet, or no cost model) and must count as one —
        # otherwise the counter reads 100% warm exactly when nothing is.
        collector.observe_route_decision(
            "cold" if action == "route_warm" and warm_blocks == 0 else action
        )
        if self.auditor is not None and request_id is not None:
            # Predicted = what this router believed the target would serve
            # from cache: the index's claim when it has one, else the
            # affinity model's (index_blocks=0 then marks the prediction
            # as index-free — the `never_stored` discriminator). A pull
            # decision promises the SOURCE's warm chain lands on the
            # target before prefill, so its prediction is pull_blocks —
            # recording the cold target's own score (~0) would drop every
            # pull from the ratio histogram and leave a failed pull
            # (dead peer, cold fallback) with nothing to attribute.
            index_blocks = scores.get(pods[target], 0)
            if action == "pull":
                predicted_blocks = pull_blocks
            elif index_blocks > 0:
                predicted_blocks = index_blocks
            else:
                predicted_blocks = aff_scores[target]
            self.auditor.record_decision(
                request_id,
                chosen_pod=pods[target],
                predicted_blocks=predicted_blocks,
                index_blocks=index_blocks,
                scoreboard=scores,
                decision=(
                    "cold"
                    if action == "route_warm" and warm_blocks == 0
                    else action
                ),
                chain_hashes=keys,
                trace_id=trace_id,
                predicted_ttft_s=predicted_ttft,
            )
        # Decision metadata is DECISION-time state (what drove the pick),
        # captured before record() refreshes the affinity memory.
        return RoutingDecision(
            pod=pods[target],
            index_score=scores.get(pods[target], 0),
            affinity_score=aff_scores[target],
            action=action,
            pull_source=pull_source,
            pull_blocks=pull_blocks,
            predicted_ttft_s=predicted_ttft,
        )


# -- disaggregated prefill/decode placement ------------------------


@dataclass
class PodView:
    """Planner-facing snapshot of one pod, assembled by the caller from
    heartbeat state (role/draining, ``FleetHealth.pod_views``) and serving
    telemetry (queue depth, measured prefill rate — the heartbeat /
    ``/stats`` carriers). A view is a point-in-time read; the planner
    treats it as truth for one placement and re-plans on failure."""

    name: str
    #: "prefill" | "decode" | "mixed" (mixed serves either tier)
    role: str = "mixed"
    #: the pod's KV-transfer export endpoint (chain handoff source); None
    #: = the pod cannot export, so it can never be a disagg prefill hop
    transfer_endpoint: Optional[str] = None
    draining: bool = False
    #: crashed/expired/unreachable (TTL-expired per FleetHealth, engine
    #: failed, or the caller observed a submit fail)
    dead: bool = False
    #: the pod's transfer plane is suspect: some peer's circuit breaker to
    #: its export endpoint is OPEN — a pull through it would skip to cold
    breaker_open: bool = False
    #: outstanding requests (waiting + prefilling + running) — the decode
    #: tier's ITL-headroom signal and the prefill tier's load tiebreak
    queue_depth: float = 0.0
    #: measured prefill tokens/s (the engine's online EMA); None = unknown
    prefill_rate: Optional[float] = None


@dataclass
class DisaggPlan:
    """A two-hop placement: run ingest on ``prefill_pod`` (stop at first
    token), hand the chain to ``decode_pod`` over the transfer fabric,
    stream tokens there. ``mode == "single"`` is the fallback — serve the
    whole request on ``decode_pod`` exactly as today, so no failure mode
    is worse than the non-disagg fleet."""

    prefill_pod: Optional[str]
    decode_pod: str
    #: "disagg" (two hops) or "single" (legacy one-pod serving)
    mode: str = "disagg"
    #: why the planner fell back / what drove the pick (operator-facing)
    reason: str = ""
    #: the prefill pod's transfer endpoint the decode hop pulls from
    pull_source: Optional[str] = None
    #: index warmth at the prefill pick (observability)
    prefill_score: int = 0


class PlanError(RuntimeError):
    """No healthy pod can serve the request (e.g. every decode-capable pod
    is dead or draining) — the caller surfaces this as an overload-style
    failure rather than silently queueing on a doomed pod."""


class TwoHopPlanner:
    """Placement for disaggregated prefill/decode serving.

    The prefill hop goes where ingest finishes soonest: index warmth
    first (a warm chain skips most of the prefill), then the measured
    prefill rate, then the shortest queue. The decode hop goes where
    streaming has the most ITL headroom: the shallowest queue among
    decode-capable pods. Draining and dead pods are never picked;
    breaker-open pods (pulls from their export endpoint skip to cold)
    are excluded only from the prefill hop — they still serve decode and
    single-pod traffic exactly as a legacy fleet would. ``exclude`` lets
    the caller re-plan around a pod that just failed mid-handoff. When the two picks coincide (mixed pod), or no
    prefill-capable exporter exists, the plan degrades to single-pod
    serving — bit-identical to the legacy fleet's behavior.

    ``score_fn(tokens, pod_names) -> {pod: score}`` is the same index
    read path ``BlendedRouter`` uses (None = warmth-blind placement).
    """

    def __init__(self, score_fn: Optional[Callable] = None):
        self.score_fn = score_fn

    @staticmethod
    def _usable(v: PodView) -> bool:
        # breaker_open is deliberately NOT a liveness exclusion: it only
        # means pulls FROM this pod's export endpoint skip to cold, so it
        # disqualifies the pod as a prefill hop (below), never from decode
        # or single-pod serving — legacy fleets serve fine with open
        # breakers, and "no failure mode worse than today" must hold.
        return not (v.dead or v.draining)

    def plan(
        self,
        tokens: Sequence[int],
        views: Sequence[PodView],
        exclude: Optional[set] = None,
    ) -> DisaggPlan:
        exclude = exclude or set()
        usable = [v for v in views if self._usable(v) and v.name not in exclude]
        if not usable:
            raise PlanError("no healthy pods to place on")
        decode_tier = [v for v in usable if v.role in ("decode", "mixed")]
        if not decode_tier:
            # A prefill-only fleet cannot stream tokens for anyone: this is
            # a deployment error, not a degradable state (docs/operations).
            raise PlanError("no decode-capable pod (fleet is prefill-only)")
        scores = (
            self.score_fn(tokens, [v.name for v in usable])
            if self.score_fn is not None
            else {}
        )
        prefill_tier = [
            v
            for v in usable
            if v.role in ("prefill", "mixed")
            and v.transfer_endpoint
            and not v.breaker_open
        ]
        # Decode pick: most ITL headroom = shallowest queue (deterministic
        # name tiebreak so identical fleets plan identically).
        decode = min(decode_tier, key=lambda v: (v.queue_depth, v.name))
        if not prefill_tier:
            # No exporter to run ingest on: single-pod serve at the warmth
            # (falling back to headroom) among decode-capable pods.
            best = max(
                decode_tier,
                key=lambda v: (scores.get(v.name, 0), -v.queue_depth, v.name),
            )
            return DisaggPlan(
                prefill_pod=None,
                decode_pod=best.name,
                mode="single",
                reason="no prefill-capable exporter",
                prefill_score=scores.get(best.name, 0),
            )
        prefill = max(
            prefill_tier,
            key=lambda v: (
                scores.get(v.name, 0),
                v.prefill_rate or 0.0,
                -v.queue_depth,
                v.name,
            ),
        )
        if prefill.name == decode.name:
            # Both hops land on one (mixed) pod: a handoff to yourself is
            # pure overhead — serve single-pod there, exactly as today.
            return DisaggPlan(
                prefill_pod=None,
                decode_pod=decode.name,
                mode="single",
                reason="prefill and decode picks coincide",
                prefill_score=scores.get(decode.name, 0),
            )
        return DisaggPlan(
            prefill_pod=prefill.name,
            decode_pod=decode.name,
            mode="disagg",
            reason="warmth+rate prefill pick, headroom decode pick",
            pull_source=prefill.transfer_endpoint,
            prefill_score=scores.get(prefill.name, 0),
        )
