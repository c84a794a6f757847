"""Request scheduler: continuous batching with FCFS admission.

Two scheduling modes share the admission rules (page-budget FCFS, running
cap):

- **Legacy (default, ``chunked_prefill_tokens=None``)**: each engine step is
  either a **prefill step** (admit waiting sequences whose pages fit,
  batched with padding) or a **decode step** (all running sequences, one
  token each). Prefill-priority keeps TTFT low, matching how the
  reference's benchmarked engines schedule (prefill preemption).

- **Chunked prefill (``chunked_prefill_tokens`` set)**: every step is a
  **mixed step** — it packs up to the token budget of prefill-chunk work
  (resuming partially-prefilled sequences first, then admitting new ones
  under the same page-budget/FCFS rules) *and* carries all running decode
  lanes. One long prompt then never stalls running decodes for its whole
  prefill (Sarathi-Serve-style stall-free scheduling): its ingest is split
  into budget-sized chunks and decode lanes advance between chunks.
  Non-final chunks are floored to ``chunk_align`` (the engine sets
  lcm(prefill_bucket, page_size)) so chunk boundaries stay page-aligned —
  the next chunk's paged context is then exactly the pages written by
  chunks 0..N-1 plus any prefix-cache hit, the same warm-prefill shape the
  engine already compiles.

In both modes the page pool's LRU recycling provides the back-pressure and
page-budget admission prevents over-commit.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from ..utils import get_logger
from .block_manager import AllocationError, BlockManager
from .sequence import Sequence, SequenceStatus

log = get_logger("server.scheduler")


@dataclass
class SchedulerConfig:
    max_running: int = 64
    max_prefill_batch: int = 8
    #: cap on tokens in one prefill batch (bounds score-matrix memory)
    max_prefill_tokens: int = 8192
    #: per-step prefill token budget for chunked prefill + mixed
    #: prefill/decode steps. None (default) keeps the legacy either-or
    #: scheduling bit-identical; set (e.g. 256-2048) to bound how long any
    #: single step's prefill work can stall running decode lanes.
    chunked_prefill_tokens: Optional[int] = None
    #: alignment for non-final chunk lengths; the engine overrides this
    #: with lcm(prefill_bucket, page_size) so mid-prefill chunk boundaries
    #: stay page-aligned (paged-context contract) and dispatch widths stay
    #: on the jit shape buckets.
    chunk_align: int = 1


@dataclass
class ScheduleOutput:
    prefill: list[Sequence]
    decode: list[Sequence]
    #: tokens to prefill per ``prefill`` entry this step (chunked mode;
    #: None in legacy mode = each entry prefills its whole fresh suffix)
    chunks: Optional[list[int]] = None


class Scheduler:
    def __init__(self, block_manager: BlockManager, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        self.block_manager = block_manager
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        #: admitted (pages allocated) but only partially prefilled — only
        #: populated in chunked mode; FCFS order preserved.
        self.prefilling: list[Sequence] = []
        #: TENANT_QOS (off by default): when enabled, the waiting queue is
        #: re-ordered by (priority class, weighted-fair served tokens)
        #: before each admission walk. Engine-thread-only state.
        self.qos_enabled: bool = False
        #: prefill tokens served per tenant slice, divided by the tenant's
        #: weight at comparison time — the weighted-fair tiebreak within a
        #: priority class (lowest normalized share admits first, bounding
        #: starvation between same-class tenants).
        self._qos_served: dict[str, float] = {}

    def attach_qos(self) -> None:
        """Enable TENANT_QOS ordering (serving layer calls this once at
        construction, before the engine thread starts)."""
        self.qos_enabled = True

    def _qos_sort_key(self, seq: Sequence) -> tuple[int, float]:
        served = self._qos_served.get(seq.tenant, 0.0)
        return (seq.priority, served / max(seq.qos_weight, 1e-9))

    def qos_reorder_waiting(self) -> None:
        """Stable-sort the waiting queue by (priority class, normalized
        served tokens). Stability keeps FIFO order within a tenant and
        between tenants with equal shares, so the legacy FCFS admission
        walks below run unmodified — their head-of-queue break rule then
        protects the highest-priority request instead of the oldest."""
        if not self.qos_enabled or len(self.waiting) <= 1:
            return
        self.waiting = deque(sorted(self.waiting, key=self._qos_sort_key))

    def _qos_charge(self, seq: Sequence, tokens: int) -> None:
        """Charge admitted prefill tokens to the tenant's fair-share
        meter. Occasionally renormalized (only relative shares matter)
        so the floats never grow without bound."""
        if not self.qos_enabled or tokens <= 0:
            return
        served = self._qos_served
        served[seq.tenant] = served.get(seq.tenant, 0.0) + float(tokens)
        if len(served) > 1:
            floor = min(served.values())
            if floor >= 1e9:
                for k in served:
                    served[k] -= floor

    def add(self, seq: Sequence) -> None:
        seq.status = SequenceStatus.WAITING
        self.waiting.append(seq)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    @property
    def has_ready_work(self) -> bool:
        """Work the engine could make progress on THIS step — ``has_work``
        minus waiting sequences whose async KV-pull is still importing
        (stepping for those alone would busy-spin until the wire
        delivers). The head-of-deque check keeps the common no-import
        case O(1)."""
        if self.prefilling or self.running:
            return True
        w = self.waiting
        if not w:
            return False
        if not w[0].importing:
            return True
        return any(not s.importing for s in w)

    def _skip_importing(self, idx: int) -> int:
        """Advance ``idx`` past waiting sequences mid-import, stamping the
        first time each would otherwise have been an admission candidate
        (the hidden/exposed boundary of the pull-overlap decomposition)."""
        while idx < len(self.waiting) and self.waiting[idx].importing:
            seq = self.waiting[idx]
            if seq.import_wanted_time is None:
                seq.import_wanted_time = time.monotonic()
            idx += 1
        return idx

    def shed_expired(self, now: float) -> list[Sequence]:
        """Deadline shedding for requests that have not produced a token
        yet: expired WAITING sequences are dropped before any prefill
        compute is spent on them, and expired MID-PREFILL sequences (their
        chunked ingest cannot beat an already-passed deadline) release
        their pages. Running lanes are not touched here — the engine
        finishes them at the next commit point so partial output is still
        returned. Shed sequences are marked FINISHED with
        ``finish_reason="deadline"``; the caller (engine step) reports
        them as finished so the serving layer resolves their futures.
        Only called when at least one live request carries a deadline, so
        the legacy no-deadline path never pays the scan."""
        shed: list[Sequence] = []
        if any(
            s.deadline is not None and now >= s.deadline for s in self.waiting
        ):
            keep: deque[Sequence] = deque()
            for seq in self.waiting:
                if seq.is_finished():
                    # Defensive: a sequence that already finished (aborted
                    # or shed elsewhere after a preemption re-queued it)
                    # is dropped without re-counting — one shed per
                    # request, the counters stay exact.
                    continue
                if seq.deadline is not None and now >= seq.deadline:
                    shed.append(seq)
                else:
                    keep.append(seq)
            self.waiting = keep
        for seq in list(self.prefilling):
            if seq.is_finished():
                self.prefilling.remove(seq)
                continue
            if seq.deadline is not None and now >= seq.deadline:
                self.prefilling.remove(seq)
                self.block_manager.free_sequence(seq)
                seq.reset_allocation()
                shed.append(seq)
        for seq in shed:
            seq.status = SequenceStatus.FINISHED
            if seq.finish_reason is None:
                seq.finish_reason = "deadline"
            log.warning(
                "shedding deadline-expired request before prefill",
                seq=seq.seq_id,
                request=seq.request_id,
            )
        return shed

    def schedule(self) -> ScheduleOutput:
        """Pick the work for one engine step."""
        if self.config.chunked_prefill_tokens is not None:
            return self._schedule_chunked()
        self.qos_reorder_waiting()
        # Admit waiting sequences first (prefill priority). Sequences
        # whose async KV-pull is still importing are skipped in place
        # (admission continues past them — the wire must never stall
        # later arrivals); with no imports in flight the walk is the
        # legacy head-of-deque FCFS loop exactly.
        prefill: list[Sequence] = []
        budget = self.config.max_prefill_tokens
        idx = 0
        while (
            len(prefill) < self.config.max_prefill_batch
            and len(self.running) + len(prefill) < self.config.max_running
        ):
            idx = self._skip_importing(idx)
            if idx >= len(self.waiting):
                break
            seq = self.waiting[idx]
            if not self.block_manager.can_allocate(seq):
                break  # FCFS: wait for pages rather than starving this seq
            try:
                self.block_manager.allocate(seq)
            except AllocationError:
                break
            # The token budget bounds prefill *compute*, which is only the
            # non-cached suffix — known exactly after allocation resolves
            # the prefix-cache hit. Roll back rather than over-commit.
            suffix = max(len(seq.prompt_tokens) - seq.num_cached_prompt, 1)
            if prefill and suffix > budget:
                self.block_manager.free_sequence(seq)
                seq.reset_allocation()
                break
            del self.waiting[idx]
            budget -= suffix
            self._qos_charge(seq, suffix)
            prefill.append(seq)

        if prefill:
            return ScheduleOutput(prefill=prefill, decode=[])
        return ScheduleOutput(prefill=[], decode=list(self.running))

    def _take_chunk(self, remaining: int, budget: int, align: int) -> int:
        """Chunk size for a sequence with ``remaining`` fresh prompt tokens
        under ``budget``: the whole remainder when it fits (final chunk),
        else the largest align-multiple that fits (0 = budget exhausted for
        a non-final chunk — the caller stops packing)."""
        if remaining <= budget:
            return remaining
        return (budget // align) * align

    def _schedule_chunked(self) -> ScheduleOutput:
        """Token-budget mixed step: prefill chunks up to the budget plus
        every running decode lane."""
        self.qos_reorder_waiting()
        align = max(1, self.config.chunk_align)
        # A budget below one alignment unit could never form a non-final
        # chunk; the align clamp is applied LAST (also overriding
        # max_prefill_tokens) so long prompts always make forward progress
        # — one align-sized chunk is a single prefill-bucket dispatch, the
        # minimum width the engine compiles anyway.
        budget = max(
            min(self.config.chunked_prefill_tokens, self.config.max_prefill_tokens),
            align,
        )
        prefill: list[Sequence] = []
        chunks: list[int] = []

        # Resume partially-prefilled sequences first (their pages are
        # already held — finishing them releases decode capacity soonest).
        for seq in self.prefilling:
            if budget <= 0 or len(prefill) >= self.config.max_prefill_batch:
                break
            take = self._take_chunk(seq.prompt_remaining, budget, align)
            if take == 0:
                break
            prefill.append(seq)
            chunks.append(take)
            self._qos_charge(seq, take)
            budget -= take

        # Then admit new sequences under the page-budget/FCFS rules
        # (mid-import sequences skipped in place, as in the legacy loop).
        idx = 0
        while (
            budget > 0
            and len(prefill) < self.config.max_prefill_batch
            and len(self.running) + len(self.prefilling) < self.config.max_running
        ):
            idx = self._skip_importing(idx)
            if idx >= len(self.waiting):
                break
            seq = self.waiting[idx]
            if not self.block_manager.can_allocate(seq):
                break  # FCFS: wait for pages rather than starving this seq
            try:
                self.block_manager.allocate(seq)
            except AllocationError:
                break
            take = self._take_chunk(seq.prompt_remaining, budget, align)
            if take == 0:
                # Not even one aligned chunk fits the leftover budget: roll
                # back rather than hold pages for a sequence doing nothing
                # this step.
                self.block_manager.free_sequence(seq)
                seq.reset_allocation()
                break
            del self.waiting[idx]
            self.prefilling.append(seq)
            prefill.append(seq)
            chunks.append(take)
            self._qos_charge(seq, take)
            budget -= take

        return ScheduleOutput(
            prefill=prefill, decode=list(self.running), chunks=chunks
        )

    def on_prefill_done(self, seqs: list[Sequence]) -> None:
        for seq in seqs:
            if seq in self.prefilling:
                self.prefilling.remove(seq)
            seq.status = SequenceStatus.RUNNING
            self.running.append(seq)

    def on_preempted(self, seq: Sequence) -> None:
        """Remove a preempted sequence from whichever active list holds it
        (running lane, or mid-prefill in chunked mode)."""
        if seq in self.running:
            self.running.remove(seq)
        elif seq in self.prefilling:
            self.prefilling.remove(seq)

    def on_finished(self, seq: Sequence) -> None:
        seq.status = SequenceStatus.FINISHED
        self.running.remove(seq)
        self.block_manager.free_sequence(seq)
