"""Structured logging with verbosity levels.

Mirrors the reference's klog verbosity convention (reference
``pkg/utils/logging/levels.go:17-20``): DEBUG=4, TRACE=5. We map these onto
stdlib logging levels below ``logging.DEBUG`` so that `-v=5`-style tracing can
be enabled independently of ordinary debug output.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time

#: request-scoped structured-log context: {"request_id": ..., "trace_id":
#: ...} injected into every record emitted inside a ``log_context`` block,
#: so one request's pod logs grep end to end by id. Contextvars propagate
#: through asyncio tasks and thread-pool executors started inside the
#: context; the engine loop sets its own context around per-request work.
_LOG_CTX: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "kvcache_log_ctx", default={}
)


@contextlib.contextmanager
def log_context(**kv):
    """Attach key-values (e.g. ``request_id=...``, ``trace_id=...``) to
    every structured log record emitted within the block. Nests: inner
    contexts extend (and may override) outer ones."""
    current = _LOG_CTX.get()
    token = _LOG_CTX.set({**current, **{k: v for k, v in kv.items() if v is not None}})
    try:
        yield
    finally:
        _LOG_CTX.reset(token)

# klog-style verbosity levels, mapped into stdlib numeric levels.
# stdlib DEBUG is 10; we give TRACE a lower number so it is *more* verbose.
DEBUG = logging.DEBUG  # klog V(4)
TRACE = 5  # klog V(5)

logging.addLevelName(TRACE, "TRACE")

_PKG_LOGGER = "llm_d_kv_cache_manager_tpu"
_CONFIGURED = False


def _configure_package_logger() -> None:
    """Configure only this package's logger subtree — never the root logger,
    so embedding applications keep control of their own logging setup.

    Entry points (the online service, demos) may call
    ``logging.basicConfig`` themselves; library imports must not.
    """
    global _CONFIGURED
    if _CONFIGURED:
        return
    pkg = logging.getLogger(_PKG_LOGGER)
    level_name = os.environ.get("KVCACHE_LOG_LEVEL", "").upper()
    if level_name:
        level = TRACE if level_name == "TRACE" else getattr(logging, level_name, logging.INFO)
        pkg.setLevel(level)
        if not pkg.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
            )
            pkg.addHandler(handler)
    else:
        pkg.addHandler(logging.NullHandler())
    _CONFIGURED = True


class _KVLogger(logging.LoggerAdapter):
    """Logger adapter supporting structured key-values, klog style.

    ``log.debug("msg", keys=..., pods=...)`` renders the kwargs as
    ``msg | keys=... pods=...``.
    """

    _RESERVED = ("exc_info", "stack_info", "stacklevel", "extra")

    def process(self, msg, kwargs):
        kv = {k: kwargs.pop(k) for k in list(kwargs) if k not in self._RESERVED}
        ctx = _LOG_CTX.get()
        if ctx:
            kv = {**ctx, **kv}  # explicit call kwargs win over context
        if kv:
            msg = f"{msg} | " + " ".join(f"{k}={v!r}" for k, v in kv.items())
        return msg, kwargs

    def trace(self, msg, *args, **kwargs):
        self.log(TRACE, msg, *args, **kwargs)


def get_logger(name: str) -> _KVLogger:
    _configure_package_logger()
    if not name.startswith(_PKG_LOGGER):
        name = f"{_PKG_LOGGER}.{name}"
    return _KVLogger(logging.getLogger(name), {})


class RateLimitedWarn:
    """At-most-once-per-interval WARN per key, with a suppressed count.

    Background threads (event workers, heartbeat/self-heal loops, span
    exporters) hit the same fault thousands of times a second when a peer
    misbehaves; an unconditional ``log.exception`` per event is itself an
    outage. This emits the first occurrence immediately, then at most one
    line per ``interval_s`` per key carrying how many were swallowed in
    between — faults stay visible without the log volume scaling with the
    event rate.

    Thread-safe; uses ``time.monotonic`` (rate math must not step under
    NTP slew).
    """

    def __init__(self, log: _KVLogger, interval_s: float = 5.0):
        self._log = log
        self._interval_s = interval_s
        self._lock = threading.Lock()
        self._last_emit: dict[str, float] = {}  # guarded_by: _lock
        self._suppressed: dict[str, int] = {}  # guarded_by: _lock

    def warning(self, key: str, msg: str, *, exc_info: bool = False, **kv) -> None:
        now = time.monotonic()
        with self._lock:
            last = self._last_emit.get(key)
            if last is not None and now - last < self._interval_s:
                self._suppressed[key] = self._suppressed.get(key, 0) + 1
                return
            suppressed = self._suppressed.pop(key, 0)
            self._last_emit[key] = now
        if suppressed:
            kv["suppressed_repeats"] = suppressed
        self._log.warning(msg, exc_info=exc_info, **kv)
