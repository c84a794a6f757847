"""GPU pod serving binary: the port's minimal ``PodServer``.

The port of the JAX package's ``server/serve.py`` main path: a
continuous-batching ``Engine`` wrapped in

- a background engine-loop thread (the only thread that touches the
  engine), fed by ``submit`` / ``generate`` through a staging queue,
- a ZMQ KV-event publisher wired to the block manager's alloc/evict
  transitions (``kv@<pod>@<model>`` topic, msgpack batches — the same wire
  the indexer's subscriber reads from the JAX pods),
- an OpenAI-style HTTP surface: ``POST /v1/completions``, ``GET /healthz``.

Per-request deadlines are ported (the ``X-Request-Deadline`` header, a
budget in seconds, and the ``REQUEST_DEADLINE_S`` default), and so are the
host-DRAM tier's knobs (``HOST_PAGES``, ``KV_QUANT``, ``HOST_PREFETCH``,
``HOST_TIER_POLICY``) and the cross-pod KV transfer plane: the
``TRANSFER_ENDPOINT`` export service (a ZMQ ROUTER whose handler hops onto
the engine loop), the blocking ``pull_prefix`` and ``ASYNC_PULL`` (a
request submitted with ``pull_source``, or over HTTP with an
``X-Pull-Source`` header, waits ``importing`` while a worker fetches its
prefix), through a pool of DEALER clients with the per-peer circuit
breaker (``TRANSFER_*``, ``PULL_WORKERS``). A failed pull falls back to
cold prefill. The JAX pod's other knob-gated surfaces are not ported yet:
the remote tier's pushes and migrations and ``X-Route-Action`` labelling
(ROADMAP A10), and drain, admission control, tenants, tracing spans,
Prometheus histograms, the flight recorder and ``/stats`` (A5).

Run: ``python -m llm_d_kv_cache_manager_tpu_torch.server.serve`` (needs
aiohttp, and pyzmq for publishing).
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
from dataclasses import dataclass, field
from typing import Optional

from ..kvcache.kvevents import ZMQPublisher, ZMQPublisherConfig
from ..kvcache.transfer import (
    KVTransferClient,
    KVTransferService,
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
from ..utils import get_logger
from .block_manager import BlockManagerConfig
from .engine import Engine, EngineConfig
from .sequence import SamplingParams, Sequence

log = get_logger("server.serve")


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
    #: transfer circuit breaker: consecutive pull failures per peer before
    #: pulls skip straight to cold prefill; 0 = off
    transfer_breaker_failures: int = 0
    #: first OPEN backoff; doubles per failed half-open probe (capped)
    transfer_breaker_backoff_s: float = 1.0
    transfer_breaker_backoff_max_s: float = 30.0
    #: default per-request deadline in seconds when the client sends no
    #: ``X-Request-Deadline`` header. Expired waiting requests are shed
    #: before prefill; running requests finish early with
    #: ``finish_reason="deadline"``. 0 = no deadline.
    default_deadline_s: float = 0.0
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
        cfg.transfer_breaker_failures = int(
            os.environ.get("TRANSFER_BREAKER_FAILURES", cfg.transfer_breaker_failures)
        )
        cfg.transfer_breaker_backoff_s = float(
            os.environ.get("TRANSFER_BREAKER_BACKOFF_S", cfg.transfer_breaker_backoff_s)
        )
        cfg.transfer_breaker_backoff_max_s = float(
            os.environ.get("TRANSFER_BREAKER_BACKOFF_MAX_S", cfg.transfer_breaker_backoff_max_s)
        )
        cfg.default_deadline_s = float(
            os.environ.get("REQUEST_DEADLINE_S", cfg.default_deadline_s)
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
        # Weight quantization ("int8" halves weight bytes; models/quant.py).
        eng.quantize = os.environ.get("QUANTIZE") or None
        # int8 KV pages in device memory (twice the pages per byte).
        eng.kv_quant_hbm = os.environ.get("KV_QUANT_HBM") or None
        # Chunked prefill: a per-step prompt-token budget; 0 or unset = off.
        cpt = int(os.environ.get("CHUNKED_PREFILL_TOKENS", 0))
        eng.scheduler.chunked_prefill_tokens = cpt if cpt > 0 else None
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
        self._tokenizer = tokenizer
        self._publisher = publisher
        self.transfer_cost_model = transfer_cost_model
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

        #: HTTP threads only touch the staging deques; the engine itself is
        #: single-threaded (loop thread only).
        self._mu = threading.Lock()
        self._work = threading.Condition(self._mu)
        #: staged requests: (tokens, sampling, deadline, rid, future, pull)
        self._staging: deque[tuple] = deque()  # guarded_by: _mu|_work
        #: staged aborts: (request_id | None = all, future -> bool)
        self._aborts: deque[tuple[Optional[str], Future]] = deque()  # guarded_by: _mu|_work
        self._futures: dict[int, Future] = {}  # loop-thread-only
        self._running = False  # guarded_by: _mu|_work
        self._failed: Optional[str] = None
        self._thread: Optional[threading.Thread] = None

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
        if self.config.transfer_endpoint:
            self._transfer_service = KVTransferService(
                TransferServiceConfig(
                    endpoint=self.config.transfer_endpoint,
                    model_name=self.config.model_name,
                    max_blocks=self.config.transfer_max_blocks,
                ),
                handler=self._serve_export,
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

    def shutdown(self) -> None:
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
            transfers = list(self._transfer_exports) + list(self._transfer_imports)
            self._transfer_exports.clear()
            self._transfer_imports.clear()
            self._import_dones.clear()
            jobs = list(self._pull_jobs.values())
            self._pull_jobs.clear()
        for job in jobs:
            job["cancel"].set()
        for item in staged:
            fut = item[4]
            if not fut.done():
                fut.set_exception(exc)
        for _, afut in aborts:
            if not afut.done():
                afut.set_result(False)
        for item in transfers:
            fut = item[-1]
            if not fut.done():
                fut.set_exception(exc)
        for fut in list(self._futures.values()):
            if not fut.done():
                fut.set_exception(exc)
        self._futures.clear()

    def _resolve(self, seq: Sequence) -> None:
        with self._mu:
            job = self._pull_jobs.pop(seq.seq_id, None)
        if job is not None:
            # Aborted or shed while its import was in flight: the fetch
            # cannot be recalled, but the worker installs nothing.
            job["cancel"].set()
        fut = self._futures.pop(seq.seq_id, None)
        if fut is not None and not fut.done():
            fut.set_result(seq)

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
                        or self._import_dones
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
                    import_dones = list(self._import_dones)
                    self._import_dones.clear()
                # Imports land before admissions, so a request staged after
                # its pull (pull_prefix, then submit) sees the warm pages.
                for blocks, src_pod, fut in imports:
                    try:
                        fut.set_result(self.engine.import_kv_blocks(blocks, source_pod=src_pod))
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
                for tokens, sampling, deadline, rid, fut, pull in staged:
                    try:
                        seq = self.engine.add_request(
                            tokens, sampling, request_id=rid, deadline=deadline
                        )
                    except ValueError as e:
                        # A disconnected client may have cancelled the future.
                        if not fut.done():
                            fut.set_exception(e)
                        continue
                    self._futures[seq.seq_id] = fut
                    if pull is not None:
                        self._start_async_pull(seq, pull)
                # Aborts AFTER admissions: a submit-then-abort staged in the
                # same cycle must find its sequence in the engine.
                for rid, afut in aborts:
                    seqs = (
                        self.engine.abort_all()
                        if rid is None
                        else list(filter(None, [self.engine.abort(rid)]))
                    )
                    for seq in seqs:
                        self._resolve(seq)
                    afut.set_result(bool(seqs))
                if self.engine.has_ready_work:
                    for seq in self.engine.step():
                        self._resolve(seq)
                    if self.transfer_cost_model is not None and self.engine._prefill_rate:
                        # The transfer decision's prefill rate: the engine's
                        # own online EMA, re-pinned every step.
                        self.transfer_cost_model.seed_rates(
                            prefill_tokens_s=self.engine._prefill_rate
                        )
        except Exception as e:  # engine wedged: fail fast and visibly
            log.exception("engine loop died")
            self._failed = f"{type(e).__name__}: {e}"
            self._fail_outstanding(RuntimeError(f"engine failed: {self._failed}"))

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
        return self._transfer_pool.get(endpoint)

    def pull_prefix(
        self,
        prompt_tokens: list[int],
        source_endpoint: str,
        timeout_s: Optional[float] = None,
        deadline: Optional[float] = None,
    ) -> int:
        """Pull ``prompt_tokens``' warm prefix from a peer's export service
        and commit it here (the router's pull-then-compute arm). Returns
        the blocks imported; 0 on any failure: a pull is an optimisation,
        so every error degrades to cold prefill, never to a failed request.
        ``deadline`` (absolute monotonic, the request's): the fetch and the
        import wait are clamped to the budget left, and a pull with none
        left is skipped."""
        fetch_timeout: Optional[float] = None  # None = the client's own
        wait_timeout = timeout_s or self.config.transfer_timeout_s * 3
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return 0
            fetch_timeout = min(self.config.transfer_timeout_s, remaining)
            wait_timeout = min(wait_timeout, remaining)
        hashes = self.engine.block_manager.token_db.prefix_hashes(prompt_tokens)
        if not hashes:
            return 0
        client = self._get_client(source_endpoint)
        if client is None:
            return 0
        try:
            blocks, _complete = client.fetch(
                self.config.model_name,
                hashes,
                self.config.transfer_max_blocks,
                timeout_s=fetch_timeout,
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
            return 0
        if imported:
            with self._mu:
                self.transfer_pulls += 1
        return imported

    # -- async prefix import (ASYNC_PULL) -----------------------------------
    def _start_async_pull(self, seq: Sequence, source: str) -> None:
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
        try:
            pool.submit(self._async_pull_worker, seq, source, job)
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

    def _async_pull_worker(self, seq: Sequence, source: str, job: dict) -> None:
        """Background prefix import of one sequence (worker thread): fetch
        its warm chain from ``source``, install it through the engine loop,
        then release the sequence to the scheduler. Every exit releases it:
        a failure means cold prefill, never a stuck or failed request. The
        fetch is clamped to the request's remaining deadline, and an open
        breaker fails it at once."""
        imported = 0
        outcome = "failed"
        try:
            fetch_timeout: Optional[float] = None
            wait_timeout = self.config.transfer_timeout_s * 3
            if seq.deadline is not None:
                remaining = seq.deadline - time.monotonic()
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
            outcome = "failed"
        finally:
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
            self._finish_async_pull(seq)

    # -- request API --------------------------------------------------------
    def submit(
        self,
        prompt_tokens: list[int],
        sampling: Optional[SamplingParams] = None,
        *,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
        pull_source: Optional[str] = None,
    ) -> Future:
        """Enqueue a request; the Future resolves to the finished Sequence
        (or raises: invalid request, engine failure, shutdown). It carries
        ``request_id`` for ``abort``. ``pull_source``: a peer's transfer
        endpoint whose warm prefix this request should import; honoured
        only with ``async_pull`` on (the request then waits ``importing``
        while a worker fetches it; any failure means cold prefill), ignored
        otherwise."""
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if deadline_s is None and self.config.default_deadline_s > 0:
            deadline_s = self.config.default_deadline_s
        deadline = (
            time.monotonic() + deadline_s
            if deadline_s is not None and deadline_s > 0
            else None
        )
        fut: Future = Future()
        fut.request_id = request_id or str(uuid.uuid4())
        pull = pull_source if pull_source and self.config.async_pull else None
        with self._work:
            if self._failed is not None:
                raise RuntimeError(f"engine failed: {self._failed}")
            if not self._running:
                raise RuntimeError("pod server not running")
            self._staging.append(
                (list(prompt_tokens), sampling, deadline, fut.request_id, fut, pull)
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
            # The router names the warm peer in X-Pull-Source; read only
            # with ASYNC_PULL on.
            pull_source = (
                request.headers.get("X-Pull-Source") if self.config.async_pull else None
            )
            try:
                fut = self.submit(
                    token_ids, sampling, deadline_s=deadline_s, pull_source=pull_source
                )
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400)
            except RuntimeError as e:  # engine failure / shutdown
                return web.json_response({"error": str(e)}, status=503)
            try:
                seq = await asyncio.wrap_future(fut)
            except asyncio.CancelledError:
                # Client disconnected: free the sequence's pages.
                self.abort(fut.request_id)
                raise
            except ValueError as e:  # rejected by engine admission checks
                return web.json_response({"error": str(e)}, status=400)
            except RuntimeError as e:
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
                }
            )

        async def healthz(_request: web.Request) -> web.Response:
            if self._failed is not None:
                return web.json_response(
                    {"status": "failed", "error": self._failed}, status=503
                )
            return web.json_response({"status": "ok"})

        app = web.Application()
        app.router.add_post("/v1/completions", completions)
        app.router.add_get("/healthz", healthz)
        return app


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
    try:
        web.run_app(server.build_app(), port=config.http_port)
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
