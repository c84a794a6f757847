"""GPU pod serving binary: the port's minimal ``PodServer``.

The port of the JAX package's ``server/serve.py`` main path: a
continuous-batching ``Engine`` wrapped in

- a background engine-loop thread (the only thread that touches the
  engine), fed by ``submit`` / ``generate`` through a staging queue,
- a ZMQ KV-event publisher wired to the block manager's alloc/evict
  transitions (``kv@<pod>@<model>`` topic, msgpack batches — the same wire
  the indexer's subscriber reads from the JAX pods),
- an OpenAI-style HTTP surface: ``POST /v1/completions``, ``GET /healthz``.

The JAX pod's knob-gated surfaces (transfer, tiers, drain, admission
control, tenants, observability) are not ported yet.

Run: ``python -m llm_d_kv_cache_manager_tpu_torch.server.serve`` (needs
aiohttp, and pyzmq for publishing).
"""

from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field
from typing import Optional

from ..kvcache.kvevents import ZMQPublisher, ZMQPublisherConfig
from ..models import LLAMA_3_8B, TINY_GEMMA, TINY_LLAMA, LlamaConfig
from ..utils import get_logger
from .block_manager import BlockManagerConfig
from .engine import Engine, EngineConfig
from .sequence import SamplingParams, Sequence

log = get_logger("server.serve")


def _env_bool(name: str, default: str) -> bool:
    return os.environ.get(name, default).strip().lower() in ("1", "true", "yes", "on")


@dataclass
class PodServerConfig:
    model_name: str = "tiny-llama"
    pod_identifier: str = field(default_factory=socket.gethostname)
    #: indexer-side SUB socket to connect the PUB to (SUB binds, we connect)
    zmq_endpoint: str = "tcp://localhost:5557"
    publish_events: bool = True
    data_parallel_rank: Optional[int] = None
    http_port: int = 8000
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
        eng = cfg.engine
        eng.block_manager = BlockManagerConfig(
            total_pages=int(os.environ.get("TOTAL_PAGES", 1024)),
            page_size=int(os.environ.get("BLOCK_SIZE", 16)),
            # The engine's hash seed must match the indexer's.
            hash_seed=os.environ.get("PYTHONHASHSEED", ""),
        )
        eng.max_model_len = int(os.environ.get("MAX_MODEL_LEN", eng.max_model_len))
        eng.decode_batch_size = int(
            os.environ.get("DECODE_BATCH_SIZE", eng.decode_batch_size)
        )
        return cfg


class PodServer:
    """Engine + event publisher + HTTP front end for one GPU serving pod."""

    def __init__(
        self,
        config: Optional[PodServerConfig] = None,
        *,
        engine: Optional[Engine] = None,
        tokenizer=None,
        publisher: Optional[ZMQPublisher] = None,
        device=None,
    ):
        """``engine``: a pre-built engine (its block manager gets the
        publisher attached); otherwise one is built from ``config.engine``
        on ``device`` (None = the GPU, ``"cpu"`` = plain PyTorch)."""
        self.config = config or PodServerConfig()
        self._tokenizer = tokenizer
        self._publisher = publisher
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
        #: staged requests: (tokens, sampling, deadline, rid, future)
        self._staging: deque[tuple] = deque()  # guarded_by: _mu|_work
        #: staged aborts: (request_id | None = all, future -> bool)
        self._aborts: deque[tuple[Optional[str], Future]] = deque()  # guarded_by: _mu|_work
        self._futures: dict[int, Future] = {}  # loop-thread-only
        self._running = False  # guarded_by: _mu|_work
        self._failed: Optional[str] = None
        self._thread: Optional[threading.Thread] = None

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

    def shutdown(self) -> None:
        with self._work:
            self._running = False
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._fail_outstanding(RuntimeError("pod server shut down"))
        if self._publisher is not None:
            self._publisher.close()

    def _fail_outstanding(self, exc: BaseException) -> None:
        with self._mu:
            staged = list(self._staging)
            self._staging.clear()
            aborts = list(self._aborts)
            self._aborts.clear()
        for *_, fut in staged:
            if not fut.done():
                fut.set_exception(exc)
        for _, afut in aborts:
            if not afut.done():
                afut.set_result(False)
        for fut in list(self._futures.values()):
            if not fut.done():
                fut.set_exception(exc)
        self._futures.clear()

    def _resolve(self, seq: Sequence) -> None:
        fut = self._futures.pop(seq.seq_id, None)
        if fut is not None and not fut.done():
            fut.set_result(seq)

    def _engine_loop(self) -> None:
        try:
            while True:
                with self._work:
                    while self._running and not (
                        self._staging or self._aborts or self.engine.has_ready_work
                    ):
                        self._work.wait(timeout=0.1)
                    if not self._running:
                        return
                    staged = list(self._staging)
                    self._staging.clear()
                    aborts = list(self._aborts)
                    self._aborts.clear()
                for tokens, sampling, deadline, rid, fut in staged:
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
        except Exception as e:  # engine wedged: fail fast and visibly
            log.exception("engine loop died")
            self._failed = f"{type(e).__name__}: {e}"
            self._fail_outstanding(RuntimeError(f"engine failed: {self._failed}"))

    # -- request API --------------------------------------------------------
    def submit(
        self,
        prompt_tokens: list[int],
        sampling: Optional[SamplingParams] = None,
        *,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
    ) -> Future:
        """Enqueue a request; the Future resolves to the finished Sequence
        (or raises: invalid request, engine failure, shutdown). It carries
        ``request_id`` for ``abort``."""
        if not prompt_tokens:
            raise ValueError("empty prompt")
        deadline = (
            time.monotonic() + deadline_s
            if deadline_s is not None and deadline_s > 0
            else None
        )
        fut: Future = Future()
        fut.request_id = request_id or str(uuid.uuid4())
        with self._work:
            if self._failed is not None:
                raise RuntimeError(f"engine failed: {self._failed}")
            if not self._running:
                raise RuntimeError("pod server not running")
            self._staging.append(
                (list(prompt_tokens), sampling, deadline, fut.request_id, fut)
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
            try:
                fut = self.submit(token_ids, sampling)
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
        "tiny-gemma": TINY_GEMMA,
        "meta-llama/Llama-3.1-8B-Instruct": LLAMA_3_8B,
        "meta-llama/Meta-Llama-3-8B": LLAMA_3_8B,
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
