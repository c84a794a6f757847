"""Tokenization worker pool with sync and fire-and-forget modes.

Parity with reference ``pkg/tokenization/pool.go``: N workers (default 5)
consume a queue of (prompt, model) tasks; each task first consults the
prefix store and only runs the full tokenizer when the cached overlap ratio
is below the threshold (default 0.8, ``pool.go:161-191``), writing fresh
tokenizations back to the store. ``tokenize`` blocks for the result;
``enqueue_tokenization`` is fire-and-forget. Failed tasks are retried with
exponential backoff, mirroring the rate-limited workqueue (``:150-155``).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..utils import get_logger
from .prefixstore import Indexer, LRUTokenStore
from .tokenizer import CachedHFTokenizer, HFTokenizerConfig, Tokenizer

log = get_logger("tokenization.pool")

DEFAULT_WORKERS = 5
DEFAULT_MIN_PREFIX_OVERLAP_RATIO = 0.8
_MAX_RETRIES = 5
_BASE_RETRY_DELAY = 0.005  # 5ms, doubling per attempt (workqueue default style)


@dataclass
class TokenizationPoolConfig:
    workers_count: int = DEFAULT_WORKERS
    min_prefix_overlap_ratio: float = DEFAULT_MIN_PREFIX_OVERLAP_RATIO
    hf_tokenizer: HFTokenizerConfig = field(default_factory=HFTokenizerConfig)


@dataclass
class _Task:
    prompt: str
    model_name: str
    result: Optional["_Future"] = None
    attempts: int = 0


class TokenizationError(RuntimeError):
    """Raised to sync callers when a tokenization task permanently fails."""


class _Future:
    """Single-assignment result slot (the reference's result channel)."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def set(self, value) -> None:
        self._value = value
        self._event.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def get(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("tokenization timed out")
        if self._error is not None:
            raise self._error
        return self._value


class TokenizationPool:
    def __init__(
        self,
        config: Optional[TokenizationPoolConfig] = None,
        store: Optional[Indexer] = None,
        tokenizer: Optional[Tokenizer] = None,
    ):
        self.config = config or TokenizationPoolConfig()
        self.indexer = store if store is not None else LRUTokenStore()
        self.tokenizer = tokenizer if tokenizer is not None else CachedHFTokenizer(
            self.config.hf_tokenizer
        )
        self._queue: "queue.Queue[Optional[_Task]]" = queue.Queue()
        self._mu = threading.Lock()
        self._threads: list[threading.Thread] = []  # guarded_by: _mu
        self._running = False  # guarded_by: _mu

    # -- lifecycle ----------------------------------------------------------
    def run(self) -> None:
        """Start the worker threads (idempotent, non-blocking)."""
        with self._mu:
            if self._running:
                return
            self._running = True
            for i in range(self.config.workers_count):
                t = threading.Thread(
                    target=self._worker_loop, name=f"tokenize-worker-{i}", daemon=True
                )
                t.start()
                self._threads.append(t)

    def shutdown(self) -> None:
        with self._mu:
            if not self._running:
                return
            self._running = False
            for _ in self._threads:
                self._queue.put(None)  # poison pill per worker
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5)

    # -- API ----------------------------------------------------------------
    def enqueue_tokenization(self, prompt: str, model_name: str) -> None:
        """Fire-and-forget (reference ``EnqueueTokenization``)."""
        self._queue.put(_Task(prompt, model_name))

    def tokenize(self, prompt: str, model_name: str, timeout: Optional[float] = 60.0) -> list[int]:
        """Queue a task and block until tokens are available
        (reference ``Tokenize``)."""
        fut = _Future()
        self._queue.put(_Task(prompt, model_name, result=fut))
        return fut.get(timeout)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queued task has been processed (for tests and
        the async-throughput benchmark). A task awaiting its retry backoff
        counts as done for this check. Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                return True
            time.sleep(0.002)
        return False

    # -- workers ------------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            task = self._queue.get()
            try:
                if task is None:
                    return
                self._process_task(task)
            except Exception as exc:
                task.attempts += 1
                if task.attempts >= _MAX_RETRIES:
                    log.error(
                        "tokenization task dropped after retries",
                        model=task.model_name,
                        error=repr(exc),
                    )
                    if task.result is not None:
                        task.result.set_error(
                            TokenizationError(
                                f"tokenization failed for model {task.model_name!r} "
                                f"after {task.attempts} attempts: {exc!r}"
                            )
                        )
                else:
                    delay = _BASE_RETRY_DELAY * (2 ** (task.attempts - 1))
                    threading.Timer(delay, self._requeue, args=(task,)).start()
            finally:
                self._queue.task_done()

    def _requeue(self, task: _Task) -> None:
        """Retry hop; fails the task fast if the pool shut down meanwhile so
        sync callers aren't stranded on a dead queue."""
        with self._mu:
            running = self._running
        if running:
            self._queue.put(task)
        elif task.result is not None:
            task.result.set_error(
                TokenizationError("tokenization pool shut down during retry")
            )

    def _process_task(self, task: _Task) -> None:
        token_ids, overlap_ratio = self.indexer.find_longest_contained_tokens(
            task.prompt, task.model_name
        )

        if overlap_ratio < self.config.min_prefix_overlap_ratio:
            tokens, offsets = self.tokenizer.encode(task.prompt, task.model_name)
            self.indexer.add_tokenization(task.model_name, task.prompt, tokens, offsets)
            token_ids = tokens

        if task.result is not None:
            task.result.set(list(token_ids))
