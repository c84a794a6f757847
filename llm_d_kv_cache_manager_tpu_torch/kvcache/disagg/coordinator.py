"""Two-hop request orchestration for disaggregated prefill/decode serving.

``DisaggCoordinator`` is the serving-plane composition layer: given a
fleet of ``PodServer``s (role-assigned via ``POD_ROLE``), it drives each
request through

1. **plan** — ``TwoHopPlanner`` picks the prefill pod (index warmth +
   measured prefill rate + queue) and the decode pod (queue-depth/ITL
   headroom), skipping draining/dead/breaker-open pods;
2. **prefill hop** — submit to the prefill pod (its role clamps the
   request to the first token; admission sheds HERE, so overload answers
   arrive as a fast 429-style ``AdmissionError`` with a Retry-After hint
   before any decode-tier capacity is touched);
3. **handoff** — the finished chain stays registered on the prefill pod
   (its ``PrefillComplete`` event announces supply); the coordinator
   carries the first token forward and names the prefill pod's transfer
   endpoint as the decode hop's ``pull_source``;
4. **decode hop** — submit ``prompt + [first_token]`` to the decode pod,
   which admits the request in the ``importing`` state, pulls the
   chain asynchronously, cache-hits the imported pages, and streams the
   remaining tokens.

Failure handling is strictly "never worse than today": a hop that dies
or drains mid-flight is excluded and the request re-planned (up to
``max_replans`` times); when no two-pod plan exists the request serves
single-pod exactly as the legacy fleet would. Deadlines span both hops —
each hop receives only the remaining budget. With tracing enabled the
whole request is ONE trace: ``disagg.request`` parents both pods'
``pod.request`` spans plus a ``disagg.handoff`` span covering the
gap between the prefill pod's first token and the decode admission.

This coordinator runs in-process over ``PodServer`` objects (the form
the tests, chaos harness, and bench fleet use). An HTTP deployment
embeds the same logic at the router: the planner inputs are all carried
by heartbeats and ``/stats``, and both hops are plain ``/v1/completions``
calls (the decode hop adding ``X-Pull-Source``).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence

from ...obs.tracing import Tracer
from ...utils import get_logger
from ..router import DisaggPlan, PlanError, PodView, TwoHopPlanner

log = get_logger("kvcache.disagg")


@dataclass
class DisaggConfig:
    #: re-plan attempts per request after a hop fails mid-flight (dead /
    #: draining pod). Each re-plan excludes the failed pod; exhausting the
    #: budget surfaces the last error. 1 covers the single-failure chaos
    #: modes; raise for fleets where correlated restarts are common.
    max_replans: int = 1
    #: cap on waiting for any single hop's Future (seconds) — a wedged pod
    #: must not hold the request forever even without a client deadline.
    hop_timeout_s: float = 120.0


@dataclass
class DisaggResult:
    """One served request: the combined view of both hops."""

    tokens: list[int]
    finish_reason: str
    #: "disagg" (two hops ran) or "single" (fallback / planner collapse)
    mode: str
    prefill_pod: Optional[str]
    decode_pod: Optional[str]
    replans: int = 0
    trace_id: Optional[str] = None
    #: prefill-hop TTFT (the user-visible first-token latency)
    ttft_s: Optional[float] = None
    #: prompt tokens the decode hop served from cache (imported chain +
    #: any local warmth) — the handoff-efficiency signal
    decode_cached_tokens: int = 0
    handoff_s: Optional[float] = None


def views_from_pods(pods: Dict[str, "object"]) -> list[PodView]:
    """Planner views from live in-process ``PodServer``s: role and
    endpoint from config, draining/alive from the pod, queue depth and
    the prefill-rate EMA from the engine — the same signals heartbeats
    and ``/stats`` carry for an HTTP deployment. A pod whose export
    endpoint has an OPEN circuit breaker at any peer is marked
    ``breaker_open`` (a pull through it would skip straight to cold)."""
    open_endpoints = set()
    for pod in pods.values():
        open_endpoints |= pod.open_breaker_endpoints
    views = []
    for name, pod in pods.items():
        endpoint = pod.config.transfer_endpoint
        views.append(
            PodView(
                name=name,
                role=pod.config.pod_role,
                transfer_endpoint=endpoint,
                draining=pod.is_draining,
                dead=not pod.is_alive,
                breaker_open=endpoint is not None and endpoint in open_endpoints,
                queue_depth=pod.queue_depth,
                prefill_rate=pod.prefill_rate,
            )
        )
    return views


class DisaggCoordinator:
    """Serving-plane driver for two-hop (prefill pod → decode pod)
    requests, with single-pod fallback. Thread-safe: ``generate`` may be
    called concurrently (bench load generators, chaos harness)."""

    def __init__(
        self,
        pods: Dict[str, "object"],
        config: Optional[DisaggConfig] = None,
        *,
        score_fn=None,
        views_fn=None,
        tracer: Optional[Tracer] = None,
    ):
        """``pods``: name → ``PodServer``. ``score_fn(tokens, names)``:
        index warmth read (e.g. ``KVCacheIndexer.score_tokens`` partially
        applied), None = warmth-blind placement. ``views_fn``: override
        for the planner-view snapshot (tests inject synthetic fleets);
        defaults to ``views_from_pods``."""
        self.pods = pods
        self.config = config or DisaggConfig()
        self.planner = TwoHopPlanner(score_fn)
        self.tracer = tracer or Tracer(enabled=False)
        self._views_fn = views_fn or (lambda: views_from_pods(self.pods))
        self._mu = threading.Lock()
        self.handoffs = 0  # guarded_by: _mu
        self.single_pod_served = 0  # guarded_by: _mu
        self.replans = 0  # guarded_by: _mu

    # -- internals -----------------------------------------------------------
    def _remaining(self, deadline: Optional[float]) -> Optional[float]:
        if deadline is None:
            return None
        # Floor at ~0, never negative-to-None: an exhausted budget must
        # reach the pod as an (already expired) deadline so the scheduler
        # sheds it with finish_reason="deadline" — not as "no deadline".
        return max(deadline - time.monotonic(), 1e-3)

    def _hop_timeout(self, deadline: Optional[float]) -> float:
        rem = self._remaining(deadline)
        if rem is None:
            return self.config.hop_timeout_s
        # A small grace past the deadline: the pod itself sheds/finishes
        # the sequence at the deadline (finish_reason="deadline") and the
        # result must travel back rather than racing a client-side cutoff.
        return min(self.config.hop_timeout_s, max(rem, 0.0) + 5.0)

    def _run_hop(self, pod, fut, deadline: Optional[float]):
        """Wait out one hop's Future; a wedged pod gets its sequence
        aborted (pages released) before the timeout propagates."""
        try:
            return fut.result(timeout=self._hop_timeout(deadline))
        except FuturesTimeout:
            try:
                pod.abort(fut.request_id).result(timeout=30)
            except Exception:
                log.exception("post-timeout hop abort failed")
            raise

    def _single_pod(
        self, pod_name, tokens, sampling, deadline, span, replans, tenant=""
    ) -> DisaggResult:
        """Legacy one-pod serving (the fallback arm): exactly what the
        non-disagg fleet does today. Its failures re-plan like any hop's:
        a dead/draining/wedged pod raises ``_HopFailed`` so the caller
        excludes it and picks the next healthy pod — only admission sheds
        surface directly (shedding IS the overload design)."""
        from ...server.serve import AdmissionError, DrainingError

        pod = self.pods[pod_name]
        try:
            fut = pod.submit(
                list(tokens),
                sampling,
                deadline_s=self._remaining(deadline),
                trace_ctx=span.context,
                tenant=tenant,
            )
            seq = self._run_hop(pod, fut, deadline)
        except (DrainingError, FuturesTimeout) as e:
            raise _HopFailed(pod_name, "single", e)
        except RuntimeError as e:
            if isinstance(e, AdmissionError):
                raise
            raise _HopFailed(pod_name, "single", e)
        with self._mu:
            self.single_pod_served += 1
        out = list(seq.generated_tokens)
        # Same derivation as the HTTP handler: an engine-reported reason
        # wins; otherwise a trailing stop token is "stop" even at the cap.
        stopped = bool(out) and out[-1] in sampling.stop_token_ids
        return DisaggResult(
            tokens=out,
            finish_reason=seq.finish_reason or ("stop" if stopped else "length"),
            mode="single",
            prefill_pod=None,
            decode_pod=pod_name,
            replans=replans,
            ttft_s=seq.ttft,
            decode_cached_tokens=seq.num_cached_prompt,
        )

    # -- the request path ----------------------------------------------------
    def generate(
        self,
        tokens: Sequence[int],
        sampling=None,
        *,
        deadline_s: Optional[float] = None,
        tenant: str = "",
    ) -> DisaggResult:
        """Serve one request through the two-hop pipeline (or the
        single-pod fallback). Raises ``AdmissionError`` when the prefill
        tier sheds (carrying the Retry-After hint), ``PlanError`` when no
        healthy pod can serve at all, and whatever terminal error the
        last re-plan attempt hit. ``tenant`` (TENANT_QOS) rides every hop
        — the prefill tier enforces the same per-tenant budgets the
        decode tier does, so a tenant's flood sheds at ingest."""
        from ...server.sequence import SamplingParams

        sampling = sampling or SamplingParams()
        deadline = (
            time.monotonic() + deadline_s
            if deadline_s is not None and deadline_s > 0
            else None
        )
        span = self.tracer.start_span(
            "disagg.request", attrs={"prompt_tokens": len(tokens)}
        )
        trace_id = span.context.trace_id if span.context is not None else None
        try:
            result = self._generate_planned(
                tokens, sampling, deadline, span, tenant
            )
            result.trace_id = trace_id
            span.set_attr("mode", result.mode)
            span.set_attr("replans", result.replans)
            span.set_attr("finish", result.finish_reason)
            return result
        except Exception as e:
            span.set_attr("error", repr(e))
            raise
        finally:
            span.end()

    def _generate_planned(
        self, tokens, sampling, deadline, span, tenant=""
    ) -> DisaggResult:
        exclude: set = set()
        #: one re-plan budget shared by both hops (the decode hop re-plans
        #: in place to reuse the finished prefill; its attempts count here)
        state = {"replans": 0}
        last_err: Optional[Exception] = None
        while True:
            try:
                plan = self.planner.plan(tokens, self._views_fn(), exclude)
            except PlanError:
                if last_err is not None:
                    raise last_err
                raise
            try:
                if plan.mode == "single":
                    return self._single_pod(
                        plan.decode_pod, tokens, sampling, deadline, span,
                        state["replans"], tenant,
                    )
                return self._two_hop(
                    plan, tokens, sampling, deadline, span, state, exclude,
                    tenant,
                )
            except _HopFailed as hf:
                # Dead/draining pod mid-flight: exclude it and re-plan.
                # AdmissionError is deliberately NOT retried — shedding at
                # the prefill tier is the overload design, and bouncing a
                # shed request around the fleet re-overloads it.
                exclude.add(hf.pod)
                last_err = hf.cause
                # The counter (stats too) ticks only when a retry actually
                # follows: an exhausted budget surfaces the failure, it is
                # not itself a re-plan.
                if state["replans"] >= self.config.max_replans:
                    raise last_err
                state["replans"] += 1
                with self._mu:
                    self.replans += 1
                log.warning(
                    "disagg hop failed; re-planning",
                    pod=hf.pod,
                    hop=hf.hop,
                    error=repr(hf.cause),
                )

    def _two_hop(
        self, plan: DisaggPlan, tokens, sampling, deadline, span, state,
        exclude, tenant="",
    ) -> DisaggResult:
        from ...server.serve import DrainingError

        prefill_pod = self.pods[plan.prefill_pod]
        decode_pod_name = plan.decode_pod
        # -- hop 1: ingest at the prefill tier, stop at first token ---------
        try:
            pfut = prefill_pod.submit(
                list(tokens),
                replace(sampling, max_new_tokens=1),
                deadline_s=self._remaining(deadline),
                trace_ctx=span.context,
                tenant=tenant,
            )
            pseq = self._run_hop(prefill_pod, pfut, deadline)
        except (DrainingError, FuturesTimeout) as e:
            # A wedged prefill pod (hop timeout, sequence already aborted by
            # _run_hop) is as re-plannable as a draining one.
            raise _HopFailed(plan.prefill_pod, "prefill", e)
        except RuntimeError as e:
            # AdmissionError (a RuntimeError subclass) re-raises untouched:
            # shedding at the prefill tier IS the overload design, and the
            # Retry-After hint must reach the client. Everything else here
            # is a dead pod — re-plannable.
            from ...server.serve import AdmissionError

            if isinstance(e, AdmissionError):
                raise
            raise _HopFailed(plan.prefill_pod, "prefill", e)
        t_handoff = time.monotonic()
        first = list(pseq.generated_tokens)
        if not first and pseq.finish_reason in ("deadline", "abort"):
            # Shed before ingest (deadline expired while queued, or the
            # request was aborted): the honest end-to-end answer — the
            # deadline clamp spans both hops, and the decode tier is never
            # touched for a request that already missed it.
            return DisaggResult(
                tokens=[],
                finish_reason=pseq.finish_reason,
                mode="disagg",
                prefill_pod=plan.prefill_pod,
                decode_pod=None,
                replans=state["replans"],
            )
        if pseq.error or not first:
            raise _HopFailed(
                plan.prefill_pod,
                "prefill",
                RuntimeError(pseq.error or "prefill hop produced no token"),
            )
        done_reason = pseq.finish_reason
        stop_hit = first[-1] in sampling.stop_token_ids
        if (
            sampling.max_new_tokens <= 1
            or stop_hit
            or done_reason in ("deadline", "abort")
        ):
            # Nothing left to decode (single-token request, immediate stop,
            # or the deadline expired during ingest): the prefill hop's
            # answer IS the answer — no chain ever moved, so `handoffs`
            # stays untouched. finish_reason mirrors single-pod truth.
            reason = done_reason or ("stop" if stop_hit else "length")
            return DisaggResult(
                tokens=first,
                finish_reason=reason,
                mode="disagg",
                prefill_pod=plan.prefill_pod,
                decode_pod=None,
                replans=state["replans"],
                ttft_s=pseq.ttft,
            )
        # -- hop 2: pull the chain + stream tokens at the decode tier -------
        decode_sampling = replace(
            sampling, max_new_tokens=sampling.max_new_tokens - 1
        )
        handoff_tokens = list(tokens) + first
        while True:
            decode_pod = self.pods[decode_pod_name]
            # A re-plan may land the decode hop on the prefill pod itself
            # (mixed fleets: its queue is shallow after the 1-token stop):
            # the chain is already local there, so naming its own endpoint
            # as pull_source would re-transfer every block to itself.
            pull_source = (
                plan.pull_source
                if decode_pod_name != plan.prefill_pod
                else None
            )
            try:
                dfut = self._submit_decode_hop(
                    decode_pod, handoff_tokens, decode_sampling, deadline,
                    span, pull_source, prompt_len=len(tokens), tenant=tenant,
                )
                dseq = self._run_hop(decode_pod, dfut, deadline)
            except (DrainingError, RuntimeError, FuturesTimeout) as e:
                from ...server.serve import AdmissionError

                if isinstance(e, AdmissionError):
                    raise
                # Decode pod died/drained mid-handoff: re-plan ONLY the
                # decode hop — the prefill work is done and its chain is
                # still exportable; re-running ingest would waste it.
                exclude.add(decode_pod_name)
                if state["replans"] >= self.config.max_replans:
                    raise _HopFailed(decode_pod_name, "decode", e)
                state["replans"] += 1
                with self._mu:
                    self.replans += 1
                log.warning(
                    "decode hop failed mid-handoff; re-planning decode",
                    pod=decode_pod_name,
                    error=repr(e),
                )
                try:
                    replan = self.planner.plan(tokens, self._views_fn(), exclude)
                except PlanError:
                    raise _HopFailed(decode_pod_name, "decode", e)
                decode_pod_name = replan.decode_pod
                continue
            break
        t_decoded = time.monotonic()
        self.tracer.record_span(
            "disagg.handoff",
            span,
            t_handoff,
            min(
                dseq.prefill_start_time
                if dseq.prefill_start_time is not None
                else t_decoded,
                t_decoded,
            ),
            attrs={
                "prefill_pod": plan.prefill_pod,
                "decode_pod": decode_pod_name,
                "pull_source": pull_source,
                "chain_blocks": pseq.num_registered_pages,
            },
        )
        with self._mu:
            self.handoffs += 1
        combined = first + list(dseq.generated_tokens)
        # Mirror the HTTP handler's derivation: a trailing stop token is
        # "stop" even when it landed exactly at the max_new_tokens cap.
        stopped = combined[-1] in sampling.stop_token_ids
        reason = dseq.finish_reason or ("stop" if stopped else "length")
        return DisaggResult(
            tokens=combined,
            finish_reason=reason,
            mode="disagg",
            prefill_pod=plan.prefill_pod,
            decode_pod=decode_pod_name,
            replans=state["replans"],
            ttft_s=pseq.ttft,
            decode_cached_tokens=dseq.num_cached_prompt,
            handoff_s=(
                dseq.prefill_start_time - t_handoff
                if dseq.prefill_start_time is not None
                else None
            ),
        )

    def _submit_decode_hop(
        self, decode_pod, handoff_tokens, sampling, deadline, span,
        pull_source, prompt_len, tenant="",
    ):
        """Decode-tier admission: async-pull pods import the chain in the
        ``importing`` state (admission never blocks on the wire);
        pods without the knob do the blocking pull first — either
        way every pull failure degrades to cold prefill of the handoff
        prompt, never a failed request."""
        if pull_source is not None and not decode_pod.config.async_pull:
            decode_pod.pull_prefix(
                handoff_tokens[:prompt_len],
                pull_source,
                deadline=deadline,
                trace_ctx=span.context,
            )
            pull_source = None
        return decode_pod.submit(
            handoff_tokens,
            sampling,
            deadline_s=self._remaining(deadline),
            trace_ctx=span.context,
            route_action="pull" if pull_source is not None else None,
            pull_source=pull_source,
            tenant=tenant,
        )

    def stats(self) -> dict:
        with self._mu:
            return {
                "handoffs": self.handoffs,
                "single_pod_served": self.single_pod_served,
                "replans": self.replans,
            }


class _HopFailed(Exception):
    """Internal: one hop's pod failed in a re-plannable way (died or
    drained mid-flight) — never an admission shed, which must surface."""

    def __init__(self, pod: str, hop: str, cause: Exception):
        super().__init__(f"{hop} hop failed on {pod}: {cause!r}")
        self.pod = pod
        self.hop = hop
        self.cause = cause
