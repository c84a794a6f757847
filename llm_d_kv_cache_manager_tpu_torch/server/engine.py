"""The paged-KV inference engine with continuous batching, in PyTorch.

Port of the JAX package's ``server/engine.py`` main path: per step the
engine either prefills a batch of admitted prompts (suffix-only on
prefix-cache hits) or decodes one token for every running sequence, samples
on the device, and publishes ``BlockStored``/``BlockRemoved`` so the routing
indexer tracks this replica's cache. The block manager and scheduler are
the JAX package's own (copied verbatim). Ported knobs: weight int8
quantization (``quantize``, ``quantize_experts``), int8 KV pages in device
memory (``kv_quant_hbm="int8"``: int8 page pools with per-page f32 scale
pools ``k_scales``/``v_scales``) and chunked prefill
(``SchedulerConfig.chunked_prefill_tokens``: a step then prefills up to
that many prompt tokens and decodes the running lanes in the same
iteration), and the decode fast path (``decode_steps_per_iter``,
``decode_pipeline``, ``decode_fused_sampling``: multi-step bursts, burst
N+1 dispatched before burst N commits, with the JAX engine's drain rules).
The other knob-gated features of the JAX engine — host/remote tiers,
transfer, speculative decoding, TP/SP — are not ported yet, and their
config fields do not exist here.

Shapes stay bucketed as in the JAX engine (prefill batch padded to
``max_prefill_batch``, chunk length to ``prefill_bucket``, decode lanes to
``decode_batch_size``), so the page-pool bytes the port writes match the
JAX package's, padded decode lanes included (they write reserved page 0,
slot 0).

The engine runs on CUDA (prefill through the flash-prefill kernel, decode
through the paged-decode kernel) unless it is built with ``device="cpu"``,
which runs the kernels' plain PyTorch versions. Every decode burst goes
through ``DecodeGraphs`` (``server/decode_graphs.py``): on CUDA one graph
replay a burst, captured per (k, block-table width); on the CPU the same
code without capture.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..kvcache.kvevents.events import Event
from ..models import llama, quant
from ..models.llama import LlamaConfig
from ..utils import get_logger
from .block_manager import AllocationError, BlockManager, BlockManagerConfig
from .decode_graphs import DecodeGraphs
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
    #: fused decode steps per engine iteration (one graph replay runs k
    #: model steps with on-device sampling — one host sync per k tokens).
    #: 1 = one token per dispatch; sampling is on the device at every
    #: setting.
    decode_steps_per_iter: int = 1
    #: prefill length bucket granularity (shape bucketing)
    prefill_bucket: int = 64
    #: decode block-table width bucket (pages): the table is sized to the
    #: longest ACTIVE context rounded up to this, not to max_model_len
    decode_pages_bucket: int = 16
    #: context block-table width bucket granularity for warm prefills
    prefill_ctx_bucket: int = 4
    #: weight quantization: None (serve in model dtype) or "int8"
    #: (symmetric per-output-channel weight-only int8, models/quant.py).
    #: Applied to full-precision params; params that are already quantized
    #: must be in the form these two fields ask for, or the engine raises.
    quantize: Optional[str] = None
    #: also quantize MoE expert stacks (they then run through the int8
    #: grouped-matmul kernel)
    quantize_experts: bool = False
    #: KV pool storage in device memory: None (the model dtype) or "int8"
    #: (codes plus one f32 scale per page per (layer, kv head): half the
    #: bytes of a bf16 page). "float8_e4m3" is declared but not implemented.
    kv_quant_hbm: Optional[str] = None
    #: pipeline fused decode bursts: dispatch burst N+1 (its input tokens
    #: chained on the device from burst N's last sampled token) BEFORE
    #: fetching/committing burst N, hiding the host's commit bookkeeping
    #: under device execution. Needs decode_steps_per_iter > 1. Commit
    #: bookkeeping lags one burst; any lane-set change (prefill scheduled,
    #: preemption, finish) drains first, so greedy results are identical to
    #: the unpipelined engine. (temperature>0 streams are identically
    #: distributed but not identical across the two modes: discarded
    #: surplus bursts draw extra noise from the generator.)
    decode_pipeline: bool = False
    #: device-resident decode fast path (``DECODE_FUSED_SAMPLING``): the
    #: pipelined chaining above extended down to k=1 — every steady-state
    #: decode step takes its input tokens from the previous dispatch's
    #: on-device sample instead of a host round trip. Greedy outputs are
    #: identical to the unfused engine (same drain rules as
    #: decode_pipeline, same temperature>0 caveat). The sampled ids' copy
    #: to pinned host memory starts right after every dispatch at every
    #: setting. Off by default = the JAX default.
    decode_fused_sampling: bool = False
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
        cpt = config.scheduler.chunked_prefill_tokens
        if cpt is not None and cpt < 1:
            raise ValueError("chunked_prefill_tokens must be >= 1 (None disables chunking)")
        if config.decode_steps_per_iter < 1:
            raise ValueError("decode_steps_per_iter must be >= 1")
        # decode_fused_sampling keeps the burst machinery live at any k
        # (k=1 pipelining is exactly the device-resident step-per-token
        # loop); decode_pipeline alone still needs k > 1 to pay off.
        self._pipeline = (
            config.decode_pipeline and config.decode_steps_per_iter > 1
        ) or config.decode_fused_sampling
        # Width includes fused-burst headroom: a sequence finishing at
        # max_model_len mid-burst keeps writing its surplus KV into reserved
        # pages of its own row, never into another sequence's pages.
        # Pipelining keeps up to TWO bursts in flight.
        bursts_in_flight = 2 if self._pipeline else 1
        self.max_pages_per_seq = -(
            -(
                config.max_model_len
                + max(config.decode_steps_per_iter * bursts_in_flight - 1, 0)
            )
            // ps
        )

        self.block_manager = BlockManager(config.block_manager, on_events=on_events)
        sched_cfg = dataclasses.replace(
            config.scheduler,
            max_running=min(config.scheduler.max_running, config.decode_batch_size),
            # Non-final chunks end page-aligned (the next chunk's paged
            # context is whole pages) and land on the prefill buckets.
            chunk_align=math.lcm(config.prefill_bucket, ps),
        )
        self.scheduler = Scheduler(self.block_manager, sched_cfg)

        if config.quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {config.quantize!r}")
        if config.kv_quant_hbm is not None:
            if config.kv_quant_hbm not in quant.KV_QUANT_HBM_MODES:
                raise ValueError(f"unknown kv_quant_hbm mode {config.kv_quant_hbm!r}")
            if config.kv_quant_hbm == "float8_e4m3":
                raise NotImplementedError(
                    "kv_quant_hbm='float8_e4m3' is the declared follow-on "
                    "storage mode; the paged-attention kernel has no fp8 "
                    "dequant path yet — use 'int8'"
                )
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = llama.init_params(
                cfg, gen, self.device,
                quantize=config.quantize, quantize_experts=config.quantize_experts,
            )
        elif params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, engine device is {self.device}"
            )
        elif config.quantize is not None and not quant.is_quantized(params):
            # The caller's full-precision tree stays alive during this; for
            # a model near device capacity use init_params(quantize=...).
            params = quant.quantize_params(params, quantize_experts=config.quantize_experts)
        elif config.quantize is not None:
            bad = quant.quantize_mismatch(params, quantize_experts=config.quantize_experts)
            if bad is not None:
                raise ValueError(
                    f"params are already quantized, but {bad!r} is not in the form "
                    f"quantize={config.quantize!r}, quantize_experts="
                    f"{config.quantize_experts} asks for"
                )
        self.params = params
        # Updated in place by every prefill / decode dispatch.
        self.k_pages, self.v_pages = llama.init_kv_pages(
            cfg, config.block_manager.total_pages, ps, self.device,
            kv_quant_hbm=config.kv_quant_hbm,
        )
        # Scale pools of the int8 pages (None when the knob is off).
        self.k_scales: Optional[torch.Tensor] = None
        self.v_scales: Optional[torch.Tensor] = None
        if config.kv_quant_hbm == "int8":
            self.k_scales, self.v_scales = llama.init_kv_scales(
                cfg, config.block_manager.total_pages, self.device
            )
        #: prefill observability: tokens actually pushed through prefill
        #: dispatches (prefix-cache hits reduce it) and dispatch count.
        self.prefill_stats = {"tokens_computed": 0, "dispatches": 0}
        #: decode dispatches (a mixed step makes one prefill and one decode
        #: dispatch, so engine steps do not count them) and the model steps
        #: they ran (``decode_steps_per_iter`` a dispatch)
        self.decode_stats = {"dispatches": 0, "steps": 0}
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.seed ^ 0x5EED
        )
        #: every decode burst's dispatch: one CUDA graph replay on the card
        self.decode_graphs = DecodeGraphs(
            self.params, cfg, self.k_pages, self.v_pages, self.k_scales, self.v_scales,
            lanes=config.decode_batch_size, max_pages=self.max_pages_per_seq,
            page_size=ps, generator=self._generator, device=self.device,
            chain=self._pipeline,
        )
        #: in-flight decode burst (pipelined): its sampled ids on their way
        #: to the host, the lane-ordered active list, and the np
        #: position/len arrays the NEXT burst derives from.
        self._inflight: Optional[dict] = None
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
        # An in-flight pipelined burst may hold this lane on the device:
        # commit it first so batchmates keep their tokens and the lane set
        # the next dispatch sees matches scheduler state.
        if self._inflight is not None and any(
            s is seq for s in self._inflight["active"]
        ):
            self._drain_inflight()
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
        """Abort every live sequence: commits any in-flight burst, then
        releases all pages. Engine thread only."""
        self._drain_inflight()
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
        """One engine iteration — a prefill batch or a decode step, or with
        chunked prefill a mixed step (prefill chunks, then the running
        lanes' decode). Returns sequences finished this step."""
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
            # Prefill must see committed decode state (page accounting,
            # finish detection): it never overlaps an in-flight burst.
            self._drain_inflight()
            self._run_prefill(out.prefill, out.chunks)
        if out.decode:
            # Mixed step: the lanes were snapshotted at schedule time — a
            # final chunk published above joins next step, and lanes its
            # page growth preempted are dropped by the decode path's
            # block_table/finish filters.
            self._run_decode_fused(out.decode)
        elif not out.prefill:
            self._drain_inflight()

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

    def _run_prefill(self, seqs: list[Sequence], chunks: Optional[list[int]] = None) -> None:
        """Prefill one batch. ``chunks[i]`` = prompt tokens to process for
        ``seqs[i]`` this step (chunked prefill); None = each sequence's
        whole fresh suffix. Every row attends over the paged context
        already resident — its prefix-cache hit, plus the pages its earlier
        chunks wrote. Only a sequence's final chunk samples a first token
        and publishes it to the decode lanes."""
        ps = self.page_size
        if chunks is None:
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

        # The pools (and scale pools) are written in place.
        logits = llama.prefill(
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
            k_scales=self.k_scales,
            v_scales=self.v_scales,
        )[0]
        first_tokens = self._sample(logits, seqs)  # syncs the dispatch
        self.prefill_stats["tokens_computed"] += int(valid.sum())
        self.prefill_stats["dispatches"] += 1
        now = time.monotonic()
        finals = [
            seq for seq, n in zip(seqs, chunks)
            if seq.num_prefilled + n >= len(seq.prompt_tokens)
        ]
        # Admit to running BEFORE appending slots: batchmates must be
        # preemption candidates if page growth exhausts the pool here.
        self.scheduler.on_prefill_done(finals)
        for (seq, n), tok in zip(zip(seqs, chunks), first_tokens):
            if not seq.block_table:
                continue  # preempted by an earlier seq in this very batch
            seq.num_prefilled += n
            seq.num_computed = seq.num_prefilled
            if seq.prompt_remaining == 0:
                # Final chunk: the last-position logits are the first-token
                # logits of the whole prompt — sample and publish.
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

    def _run_decode_fused(self, seqs: list[Sequence]) -> None:
        """Every decode goes through here; at k=1 it is the classic
        step-per-token loop, sampling on the device inside the same dispatch
        (one transfer of sampled ids, never a [lanes, vocab] logit round
        trip).

        Fused multi-token decode: reserve page capacity for the whole
        burst up front, dispatch ``decode_steps`` (one graph replay with
        on-device sampling), then commit sampled tokens per sequence,
        truncating at stop conditions. Surplus device-side KV writes land in
        pages the sequence owns (or reserved page 0 for padded lanes) and
        are never registered in the prefix cache, so discarding them is
        safe.

        With pipelining, burst N+1 is dispatched BEFORE burst N is
        fetched: its input tokens are chained on the device from burst N's
        last sampled token, so host work (fetch, commit, next dispatch)
        overlaps device execution. The pipeline only continues while the
        lane set is unchanged and no lane is about to finish; anything else
        drains first, making greedy results identical to the unpipelined
        engine (a finished/preempted lane's surplus burst is discarded by
        the same rules as surplus tokens within a burst)."""
        k = self.config.decode_steps_per_iter
        lanes = self.config.decode_batch_size
        if len(seqs) > lanes:
            raise RuntimeError(f"{len(seqs)} running sequences exceed {lanes} decode lanes")

        prev = self._inflight
        if prev is not None:
            # Drain when the pipeline cannot (or should not) continue:
            # different lane set, or every lane reaches its token budget
            # within the in-flight burst (pipelining then only produces a
            # surplus burst that gets discarded).
            same_lanes = len(prev["active"]) == len(seqs) and all(
                a is b for a, b in zip(prev["active"], seqs)
            )
            all_done_after_prev = all(
                s.num_generated + k >= s.sampling.max_new_tokens for s in seqs
            )
            if not same_lanes or all_done_after_prev:
                self._drain_inflight()
                prev = None

        # Commit lag means any drain can finish lanes mid-call; never
        # reserve pages for (or redispatch) a finished sequence — the
        # unpipelined engine would have finished it a step() ago.
        seqs = [s for s in seqs if not self._should_finish(s)]
        if not seqs:
            return

        # Reserve capacity for the burst's growth per sequence (x 2 when a
        # previous burst is still in flight); preemption inside reservation
        # may knock batchmates out of `seqs` — or the in-flight set.
        reserve = k * (2 if self._pipeline else 1)
        for seq in seqs:
            # The finished re-check matters after a mid-loop degrade-drain
            # (below): committing the lagged burst can finish any lane.
            if not seq.block_table or self._should_finish(seq):
                continue
            if reserve > k:
                # Double-burst headroom is an optimization, not a
                # requirement: when the pool is too tight for it, drain and
                # degrade to the unpipelined reservation rather than
                # preempting/aborting lanes the unpipelined engine would
                # complete.
                try:
                    self.block_manager.reserve_slots(seq, reserve)
                    continue
                except AllocationError:
                    self._drain_inflight()
                    prev = None
                    reserve = k
                    if self._should_finish(seq):
                        continue  # the drain just finished this lane
            self._reserve_slots_or_preempt(seq, reserve)
        # A degrade-drain above may also have finished lanes.
        active = [s for s in seqs if s.block_table and not self._should_finish(s)]
        if prev is not None:
            same = len(prev["active"]) == len(active) and all(
                a is b for a, b in zip(prev["active"], active)
            )
            if not same:  # reservation preempted an in-flight lane
                self._drain_inflight()
                prev = None
                active = [s for s in active if not self._should_finish(s)]
        if not active:
            self._drain_inflight()
            return

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

        if prev is not None:
            # Chain from the in-flight burst: its last sampled token stays
            # on the device; positions/lengths advance by k without a host
            # sync. Inactive padded lanes keep their 0 = inactive sentinel:
            # they must not run garbage attention or write KV into reserved
            # page 0 just because the active lanes advanced.
            tokens = None
            was_active = prev["seq_lens"] > 0
            positions = np.where(was_active, prev["positions"] + k, 0).astype(np.int32)
            seq_lens = np.where(was_active, prev["seq_lens"] + k, 0).astype(np.int32)
        else:
            tokens = np.zeros((lanes,), np.int32)
            for i, seq in enumerate(active):
                tokens[i] = seq.all_tokens[-1]
                positions[i] = seq.num_tokens - 1
                seq_lens[i] = seq.num_tokens

        toks = self.decode_graphs.dispatch(
            k, tokens, positions, seq_lens, block_tables, temperature, top_k, top_p
        )
        self.decode_stats["dispatches"] += 1
        self.decode_stats["steps"] += k
        burst = {
            "toks": toks,
            "active": active,
            "k": k,
            "positions": positions,
            "seq_lens": seq_lens,
        }
        if prev is not None:
            # Commit burst N while burst N+1 executes on the device.
            self._inflight = None
            self._commit_burst(prev)
        if self._pipeline:
            self._inflight = burst
        else:
            self._commit_burst(burst)

    def _drain_inflight(self) -> None:
        if self._inflight is None:
            return
        burst, self._inflight = self._inflight, None
        self._commit_burst(burst)

    def _commit_burst(self, burst: dict) -> None:
        # [lanes, k] from pinned host memory: waits on this burst's copy
        # event, the one host sync of a burst.
        toks = burst["toks"].tokens()
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
