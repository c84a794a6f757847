"""Request/sequence state for the serving engine."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

_id_counter = itertools.count()


class SequenceStatus(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class SamplingParams:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0
    stop_token_ids: tuple[int, ...] = ()


@dataclass
class Sequence:
    prompt_tokens: list[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    seq_id: int = field(default_factory=lambda: next(_id_counter))
    request_id: Optional[str] = None

    # engine-managed state
    status: SequenceStatus = SequenceStatus.WAITING
    output_tokens: list[int] = field(default_factory=list)
    block_table: list[int] = field(default_factory=list)
    #: tokens whose K/V are resident in pages (cached prefix + processed)
    num_computed: int = 0
    #: tokens of the prompt served from the prefix cache
    num_cached_prompt: int = 0
    #: prompt tokens whose K/V are resident (cached prefix + prefilled
    #: chunks). Equals num_cached_prompt right after allocation and
    #: len(prompt_tokens) once prefill completes; strictly between the two
    #: while a sequence is mid-prefill under chunked-prefill scheduling.
    num_prefilled: int = 0
    #: total generated tokens — survives preemption (output_tokens may be
    #: folded into prompt_tokens when a sequence is preempted and recomputed)
    num_generated: int = 0
    #: length of the user's original prompt, for reporting after preemption
    user_prompt_len: int = -1
    #: prefix-cache registration bookkeeping (incremental hashing)
    num_registered_pages: int = 0
    last_chain_hash: Optional[int] = None
    arrival_time: float = field(default_factory=time.monotonic)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    #: when the first prefill chunk for this sequence dispatched — the
    #: queue→compute boundary the latency decomposition (queue span /
    #: kvcache_request_queue_seconds) is derived from. Always stamped
    #: (one clock read per prefill batch; no behavior change).
    prefill_start_time: Optional[float] = None
    #: the router's verdict that placed this request here ("route_warm" /
    #: "pull" / "cold"), when the serving layer knows it — labels the
    #: latency histograms; None = derived from num_cached_prompt.
    route_action: Optional[str] = None
    #: live ``obs.tracing.Span`` for the request (serving layer owns it;
    #: child queue/prefill/decode spans are reconstructed from the
    #: timestamps above when the request resolves). None = tracing off.
    trace_span: Optional[object] = None
    #: absolute monotonic deadline (``time.monotonic()`` scale). None
    #: (default) = no deadline — bit-identical legacy behavior. An expired
    #: waiting sequence is shed before prefill; an expired running sequence
    #: finishes at the next commit point with ``finish_reason="deadline"``.
    deadline: Optional[float] = None
    #: why the request ended early, when not a normal stop/length finish:
    #: "deadline" (expired) or "abort" (client gone / operator abort).
    #: None = the normal finish reasons apply.
    finish_reason: Optional[str] = None
    #: set when the engine had to abort the request (e.g. unschedulable)
    error: Optional[str] = None
    #: speculative-decode acceptance history (drives the engine's adaptive
    #: per-sequence gate; survives preemption with the sequence)
    spec_proposed: int = 0
    spec_accepted: int = 0
    #: memoized prompt prefix-chain hashes for the host-tier prefetch
    #: stage (hashing is O(prompt) sha256 work; a sequence may wait many
    #: steps). Invalidated when preemption folds output into the prompt.
    prefetch_hashes: Optional[list[int]] = None
    #: async KV-pull (``ASYNC_PULL``): True while a background transfer
    #: fetch is importing this sequence's warm prefix — the scheduler
    #: skips it (admitting later waiting sequences past it) until the
    #: import lands or fails, so a slow wire never stalls admission.
    #: False (default) = legacy behavior, the scheduler never checks it.
    importing: bool = False
    #: when the scheduler FIRST skipped this sequence because its import
    #: was still in flight — the hidden/exposed boundary of the pull
    #: overlap decomposition (pull time before this instant was hidden
    #: behind other work; time after it delayed this sequence's prefill).
    import_wanted_time: Optional[float] = None
    #: OBS_LIFECYCLE reuse-distance MRC: True once this request's prefix
    #: chain has been observed by the estimator. Allocation rollbacks
    #: (scheduler budget overflow) and preemption re-prefills call
    #: ``allocate`` again for the SAME request — re-observing would feed
    #: tiny artificial reuse distances and bias the curve upward, the
    #: same reason ``hit_stats`` snapshots only the first prefill.
    mrc_observed: bool = False
    #: TENANT_QOS slice key this request is charged to ("" = knob off,
    #: no tenant dimension anywhere). Unknown tenants are collapsed onto
    #: the "*" slice by the serving layer before the sequence is built.
    tenant: str = ""
    #: TENANT_QOS priority class (0 = highest). The scheduler orders the
    #: waiting queue by class and preemption only takes pages from a
    #: strictly lower class. 0 for every sequence when the knob is off,
    #: so ordering is a no-op.
    priority: int = 0
    #: TENANT_QOS weighted-fair share within the class (> 0).
    qos_weight: float = 1.0
    #: per-tenant hit-stats bookkeeping: True once this request's first
    #: successful allocation has been counted (same first-prefill-only
    #: rationale as ``mrc_observed``).
    qos_observed: bool = False

    def __post_init__(self):
        if self.user_prompt_len < 0:
            self.user_prompt_len = len(self.prompt_tokens)

    @property
    def all_tokens(self) -> list[int]:
        return self.prompt_tokens + self.output_tokens

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def generated_tokens(self) -> list[int]:
        """User-visible output, stable across preemption."""
        return self.all_tokens[self.user_prompt_len :]

    @property
    def prompt_remaining(self) -> int:
        """Prompt tokens still to prefill (chunked-prefill progress)."""
        return len(self.prompt_tokens) - self.num_prefilled

    def reset_allocation(self) -> None:
        """Clear all page/prefix-cache bookkeeping (single source of truth
        for rollback and preemption)."""
        self.num_computed = 0
        self.num_cached_prompt = 0
        self.num_prefilled = 0
        self.num_registered_pages = 0
        self.last_chain_hash = None

    def fold_for_preemption(self) -> None:
        """Recompute-preemption: all tokens become the new 'prompt'; the
        re-prefill will cache-hit the pages that survived eviction."""
        self.prompt_tokens = self.all_tokens
        self.output_tokens = []
        self.prefetch_hashes = None  # prompt changed: memo is stale
        self.reset_allocation()
        self.status = SequenceStatus.WAITING

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def mean_itl(self) -> Optional[float]:
        """Mean inter-token latency over the generated tokens; None when
        not measurable (unfinished, or <= 1 generated token). The one
        definition both the latency histograms and the SLO recorder feed
        from — they must never diverge."""
        if (
            self.finish_time is None
            or self.first_token_time is None
            or self.num_generated <= 1
        ):
            return None
        return max(self.finish_time - self.first_token_time, 0.0) / (
            self.num_generated - 1
        )

    def is_finished(self) -> bool:
        return self.status == SequenceStatus.FINISHED
