"""The paged-KV inference engine with continuous batching, in PyTorch.

Port of the JAX package's ``server/engine.py`` main path: per step the
engine either prefills a batch of admitted prompts (suffix-only on
prefix-cache hits) or decodes one token for every running sequence, samples
on the device, and publishes ``BlockStored``/``BlockRemoved`` so the routing
indexer tracks this replica's cache. The block manager and scheduler are
the JAX package's own (copied verbatim). Knob-gated features of the JAX
engine — host/remote tiers, transfer, quantization, speculative decoding,
chunked prefill, fused multi-step decode, TP/SP — are not ported yet, and
their config fields do not exist here.

Shapes stay bucketed as in the JAX engine (prefill batch padded to
``max_prefill_batch``, chunk length to ``prefill_bucket``, decode lanes to
``decode_batch_size``), so the page-pool bytes the port writes match the
JAX package's, padded decode lanes included (they write reserved page 0,
slot 0).

The engine runs on CUDA (prefill through the flash-prefill kernel, decode
through the paged-decode kernel) unless it is built with ``device="cpu"``,
which runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..kvcache.kvevents.events import Event
from ..models import llama
from ..models.llama import LlamaConfig
from ..utils import get_logger
from .block_manager import AllocationError, BlockManager, BlockManagerConfig
from ..ops.sampling import sample_tokens
from .scheduler import Scheduler, SchedulerConfig
from .sequence import SamplingParams, Sequence, SequenceStatus

log = get_logger("server.engine")


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def resolve_device(device) -> torch.device:
    """``None`` means the GPU: raise when there is none rather than run
    silently on the CPU. Callers that want the CPU path pass ``"cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the engine runs on the GPU; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclass
class EngineConfig:
    model: LlamaConfig = field(default_factory=lambda: llama.TINY_LLAMA)
    block_manager: BlockManagerConfig = field(default_factory=BlockManagerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    max_model_len: int = 2048
    #: decode batch lanes (padded); also the max concurrent running seqs
    decode_batch_size: int = 8
    #: prefill length bucket granularity (shape bucketing)
    prefill_bucket: int = 64
    #: decode block-table width bucket (pages): the table is sized to the
    #: longest ACTIVE context rounded up to this, not to max_model_len
    decode_pages_bucket: int = 16
    #: context block-table width bucket granularity for warm prefills
    prefill_ctx_bucket: int = 4
    seed: int = 0


class Engine:
    def __init__(
        self,
        config: EngineConfig,
        params=None,
        on_events: Optional[Callable[[list[Event]], None]] = None,
        device=None,
    ):
        """``params``: a parameter dict on ``device`` (``models.init_params``
        / ``models.params_from_jax``); None random-initialises from
        ``config.seed``. ``device``: None = the current CUDA device (raises
        when there is none), ``"cpu"`` = plain PyTorch on the CPU."""
        self.config = config
        self.device = resolve_device(device)
        cfg = config.model
        self.model_cfg = cfg
        ps = config.block_manager.page_size
        self.page_size = ps
        if config.block_manager.host_pages:
            raise ValueError("the host-DRAM tier is not ported: host_pages must be 0")
        if config.scheduler.chunked_prefill_tokens is not None:
            raise ValueError("chunked prefill is not ported: chunked_prefill_tokens must be None")
        self.max_pages_per_seq = -(-config.max_model_len // ps)

        self.block_manager = BlockManager(config.block_manager, on_events=on_events)
        sched_cfg = dataclasses.replace(
            config.scheduler,
            max_running=min(config.scheduler.max_running, config.decode_batch_size),
        )
        self.scheduler = Scheduler(self.block_manager, sched_cfg)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = llama.init_params(cfg, gen, self.device)
        elif params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, engine device is {self.device}"
            )
        self.params = params
        # Updated in place by every prefill / decode dispatch.
        self.k_pages, self.v_pages = llama.init_kv_pages(
            cfg, config.block_manager.total_pages, ps, self.device
        )
        #: prefill observability: tokens actually pushed through prefill
        #: dispatches (prefix-cache hits reduce it) and dispatch count.
        self.prefill_stats = {"tokens_computed": 0, "dispatches": 0}
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.seed ^ 0x5EED
        )
        self.finished: list[Sequence] = []
        self._step_count = 0
        #: set once any request carries a deadline — gates the per-step
        #: expiry scan.
        self._deadlines_used = False
        #: request-lifecycle observability (deadline sheds/expiries, aborts)
        self.lifecycle_stats = {
            "deadline_shed": 0,
            "deadline_expired": 0,
            "aborted": 0,
        }

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def add_request(
        self,
        prompt_tokens: list[int],
        sampling: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> Sequence:
        """``deadline``: absolute ``time.monotonic()`` deadline. Expired
        waiting sequences are shed before prefill; running sequences past
        it finish early with ``finish_reason="deadline"``."""
        if len(prompt_tokens) == 0:
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self.config.max_model_len:
            raise ValueError("prompt exceeds max_model_len")
        # A prompt whose pages can never all fit would wait forever and
        # starve the FCFS queue behind it; reject it up front.
        prompt_pages = -(-(len(prompt_tokens) + 1) // self.page_size)
        if prompt_pages > self.config.block_manager.total_pages - 1:
            raise ValueError(
                f"prompt needs {prompt_pages} pages but the pool holds only "
                f"{self.config.block_manager.total_pages - 1}"
            )
        seq = Sequence(
            prompt_tokens=list(prompt_tokens),
            sampling=sampling or SamplingParams(),
            request_id=request_id,
            deadline=deadline,
        )
        if deadline is not None:
            self._deadlines_used = True
        self.scheduler.add(seq)
        return seq

    def abort(self, request_id: str) -> Optional[Sequence]:
        """Abort a live request, releasing its pages immediately; marks it
        FINISHED with ``finish_reason="abort"``. Returns None when no live
        sequence carries ``request_id``. Engine thread only."""
        seq = None
        for cand in (
            list(self.scheduler.waiting)
            + self.scheduler.prefilling
            + self.scheduler.running
        ):
            if cand.request_id == request_id:
                seq = cand
                break
        if seq is None:
            return None
        if seq in self.scheduler.waiting:
            self.scheduler.waiting.remove(seq)
        else:
            self.scheduler.on_preempted(seq)  # removes from running/prefilling
        self.block_manager.free_sequence(seq)
        seq.status = SequenceStatus.FINISHED
        seq.finish_reason = "abort"
        seq.finish_time = time.monotonic()
        self.lifecycle_stats["aborted"] += 1
        self.finished.append(seq)
        # Ship pending BlockStored/BlockRemoved now: an idle engine may not
        # step again for a while.
        self.block_manager.flush_events()
        log.warning(
            "aborted request; pages released",
            request=request_id,
            seq=seq.seq_id,
            generated=seq.num_generated,
        )
        return seq

    def abort_all(self) -> list[Sequence]:
        """Abort every live sequence, releasing all pages. Engine thread
        only."""
        out: list[Sequence] = []
        for seq in (
            list(self.scheduler.waiting)
            + list(self.scheduler.prefilling)
            + list(self.scheduler.running)
        ):
            self.scheduler.on_preempted(seq)  # removes from running/prefilling
            if seq in self.scheduler.waiting:
                self.scheduler.waiting.remove(seq)
            self.block_manager.free_sequence(seq)
            seq.status = SequenceStatus.FINISHED
            seq.finish_reason = "abort"
            seq.finish_time = time.monotonic()
            self.lifecycle_stats["aborted"] += 1
            self.finished.append(seq)
            out.append(seq)
        if out:
            self.block_manager.flush_events()
            log.warning("aborted all live requests", count=len(out))
        return out

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def has_ready_work(self) -> bool:
        return self.scheduler.has_ready_work

    def step(self) -> list[Sequence]:
        """One engine iteration — a prefill batch or a decode step. Returns
        sequences finished this step."""
        shed: list[Sequence] = []
        if self._deadlines_used:
            # Deadline shedding BEFORE scheduling: an expired waiting seq
            # must never reach prefill.
            now = time.monotonic()
            shed = self.scheduler.shed_expired(now)
            for seq in shed:
                seq.finish_time = now
                self.lifecycle_stats["deadline_shed"] += 1
                self.finished.append(seq)
        out = self.scheduler.schedule()
        if out.prefill:
            self._run_prefill(out.prefill)
        elif out.decode:
            self._run_decode(out.decode)

        newly_finished = list(shed)
        for seq in list(self.scheduler.running):
            if self._should_finish(seq):
                seq.finish_time = time.monotonic()
                self.scheduler.on_finished(seq)
                self.finished.append(seq)
                newly_finished.append(seq)

        self.block_manager.flush_events()
        self._step_count += 1
        return newly_finished

    def run_until_complete(self, max_steps: int = 100_000) -> list[Sequence]:
        done: list[Sequence] = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            done.extend(self.step())
        return done

    # -- internals ----------------------------------------------------------
    def _should_finish(self, seq: Sequence) -> bool:
        if seq.num_generated == 0:
            return False
        if seq.num_generated >= seq.sampling.max_new_tokens:
            return True
        if seq.all_tokens[-1] in seq.sampling.stop_token_ids:
            return True
        if seq.deadline is not None and time.monotonic() >= seq.deadline:
            # Past-deadline running lane: finish with what it has.
            if seq.finish_reason is None:
                seq.finish_reason = "deadline"
                self.lifecycle_stats["deadline_expired"] += 1
            return True
        return seq.num_tokens >= self.config.max_model_len

    def _run_prefill(self, seqs: list[Sequence]) -> None:
        """Prefill one batch: each sequence's whole fresh suffix, attending
        over the paged context already resident (its prefix-cache hit)."""
        ps = self.page_size
        chunks = [s.prompt_remaining for s in seqs]
        # Bucketed shapes: batch padded to the configured prefill width,
        # chunk length and context pages bucketed.
        chunk = _round_up(max(chunks), self.config.prefill_bucket)
        b = self.config.scheduler.max_prefill_batch

        tokens = np.zeros((b, chunk), np.int32)
        positions = np.zeros((b, chunk), np.int32)
        valid = np.zeros((b, chunk), bool)
        page_ids = np.zeros((b, chunk), np.int32)
        slot_ids = np.zeros((b, chunk), np.int32)
        # Zero-width context when the whole batch is cache-cold.
        max_ctx = max(s.num_prefilled // ps for s in seqs)
        ctx_pages = _round_up(max_ctx, self.config.prefill_ctx_bucket)
        ctx_bt = np.zeros((b, ctx_pages), np.int32)
        ctx_lens = np.zeros((b,), np.int32)

        t_prefill_start = time.monotonic()
        for i, (seq, n) in enumerate(zip(seqs, chunks)):
            if seq.prefill_start_time is None:
                seq.prefill_start_time = t_prefill_start
            start = seq.num_prefilled
            tokens[i, :n] = seq.prompt_tokens[start : start + n]
            pos = np.arange(start, start + n)
            positions[i, :n] = pos
            valid[i, :n] = True
            page_ids[i, :n] = np.asarray(seq.block_table, np.int32)[pos // ps]
            slot_ids[i, :n] = pos % ps
            n_ctx_pages = start // ps
            ctx_bt[i, :n_ctx_pages] = seq.block_table[:n_ctx_pages]
            ctx_lens[i] = start

        logits, self.k_pages, self.v_pages = llama.prefill(
            self.params,
            self.model_cfg,
            self._to_device(tokens),
            self._to_device(positions),
            self._to_device(valid),
            self.k_pages,
            self.v_pages,
            self._to_device(page_ids),
            self._to_device(slot_ids),
            self._to_device(ctx_bt),
            self._to_device(ctx_lens),
        )
        first_tokens = self._sample(logits, seqs)  # syncs the dispatch
        self.prefill_stats["tokens_computed"] += int(valid.sum())
        self.prefill_stats["dispatches"] += 1
        now = time.monotonic()
        # Admit to running BEFORE appending slots: batchmates must be
        # preemption candidates if page growth exhausts the pool here.
        self.scheduler.on_prefill_done(seqs)
        for (seq, n), tok in zip(zip(seqs, chunks), first_tokens):
            if not seq.block_table:
                continue  # preempted by an earlier seq in this very batch
            seq.num_prefilled += n
            seq.num_computed = seq.num_prefilled
            # The last-position logits are the first-token logits of the
            # whole prompt — sample and publish.
            seq.output_tokens.append(int(tok))
            seq.num_generated += 1
            if seq.first_token_time is None:
                seq.first_token_time = now
            self._append_slot_or_preempt(seq)
            self.block_manager.register_full_pages(seq)

    def _decode_table_width(self, seqs: list[Sequence]) -> int:
        """Block-table width for this decode call: longest active context in
        pages, rounded up to ``decode_pages_bucket``."""
        used = max((len(s.block_table) for s in seqs), default=1)
        bucket = max(1, self.config.decode_pages_bucket)
        return min(self.max_pages_per_seq, _round_up(used, bucket))

    def _run_decode(self, seqs: list[Sequence]) -> None:
        """One decode token for every running lane, sampled on the device
        (the JAX engine's ``_run_decode_fused`` at one step per iteration,
        no pipelining): reserve each lane's next slot, dispatch, commit."""
        lanes = self.config.decode_batch_size
        if len(seqs) > lanes:
            raise RuntimeError(f"{len(seqs)} running sequences exceed {lanes} decode lanes")
        seqs = [s for s in seqs if not self._should_finish(s)]
        if not seqs:
            return
        # Reservation may preempt batchmates out of `seqs`.
        for seq in seqs:
            if not seq.block_table or self._should_finish(seq):
                continue
            self._reserve_slots_or_preempt(seq, 1)
        active = [s for s in seqs if s.block_table and not self._should_finish(s)]
        if not active:
            return

        tokens = np.zeros((lanes,), np.int32)
        positions = np.zeros((lanes,), np.int32)
        seq_lens = np.zeros((lanes,), np.int32)  # 0 = inactive lane
        block_tables = np.zeros((lanes, self._decode_table_width(active)), np.int32)
        temperature = np.zeros((lanes,), np.float32)
        top_k = np.zeros((lanes,), np.int32)
        top_p = np.ones((lanes,), np.float32)
        for i, seq in enumerate(active):
            bt = seq.block_table
            block_tables[i, : len(bt)] = bt
            temperature[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p
            tokens[i] = seq.all_tokens[-1]
            positions[i] = seq.num_tokens - 1
            seq_lens[i] = seq.num_tokens

        toks, self.k_pages, self.v_pages = llama.decode_steps(
            self.params,
            self.model_cfg,
            self._to_device(tokens),
            self._to_device(positions),
            self.k_pages,
            self.v_pages,
            self._to_device(block_tables),
            self._to_device(seq_lens),
            self._to_device(temperature),
            self._to_device(top_k),
            self._to_device(top_p),
            self._generator,
            page_size=self.page_size,
            num_steps=1,
        )
        self._commit_burst({"toks": toks, "active": active, "k": 1})

    def _commit_burst(self, burst: dict) -> None:
        toks = burst["toks"].cpu().numpy()  # [lanes, k] — the one host sync
        for i, seq in enumerate(burst["active"]):
            if not seq.block_table:
                continue  # preempted after this burst was dispatched
            for j in range(burst["k"]):
                # Pre-check keeps num_generated <= max_new_tokens even when
                # a reservation abort clamped the cap before the burst ran.
                if self._should_finish(seq):
                    break
                seq.num_computed = seq.num_tokens
                seq.output_tokens.append(int(toks[i, j]))
                seq.num_generated += 1
            self.block_manager.register_full_pages(seq)

    def _reserve_slots_or_preempt(self, seq: Sequence, n: int) -> None:
        """Ensure ``seq`` can grow by ``n`` tokens, preempting on pool
        exhaustion."""
        self._grow_or_preempt(seq, lambda: self.block_manager.reserve_slots(seq, n))

    def _append_slot_or_preempt(self, seq: Sequence) -> None:
        """Grow ``seq`` by one slot, preempting on pool exhaustion."""
        self._grow_or_preempt(seq, lambda: self.block_manager.append_slot(seq))

    def _pick_victim(self, seq: Sequence) -> Optional[Sequence]:
        """Preemption victim: the most recently admitted active sequence
        that is not done generating (re-prefilling a finished one would
        emit a token beyond its max_new_tokens contract)."""
        candidates = [
            cand
            for cand in list(reversed(self.scheduler.running))
            + list(reversed(self.scheduler.prefilling))
            if cand is not seq and not self._should_finish(cand)
        ]
        return candidates[0] if candidates else None

    def _grow_or_preempt(self, seq: Sequence, grow) -> None:
        """Run ``grow()``; on pool exhaustion, preempt another sequence
        (recompute-style: its pages are freed — surviving cached pages make
        its later re-prefill cheap — and it requeues). When nothing is left
        to reclaim, aborts ``seq`` rather than wedging the engine."""
        while True:
            try:
                grow()
                return
            except AllocationError:
                victim = self._pick_victim(seq)
                if victim is None:
                    seq.error = "KV page pool too small for sequence growth"
                    seq.sampling.max_new_tokens = seq.num_generated
                    log.error("aborting sequence: pool exhausted", seq=seq.seq_id)
                    return
                log.warning(
                    "preempting sequence for pages",
                    victim=victim.seq_id,
                    for_seq=seq.seq_id,
                )
                self.scheduler.on_preempted(victim)
                self.block_manager.free_sequence(victim)
                victim.fold_for_preemption()
                self.scheduler.waiting.appendleft(victim)

    def _sample(self, logits: torch.Tensor, seqs: list[Sequence]) -> np.ndarray:
        b = logits.shape[0]
        temperature = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int32)
        top_p = np.ones((b,), np.float32)
        for i, seq in enumerate(seqs[:b]):
            temperature[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p
        out = sample_tokens(
            logits.float(),
            self._to_device(temperature),
            self._to_device(top_k),
            self._to_device(top_p),
            self._generator,
        )
        return out.cpu().numpy()
