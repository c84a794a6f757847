"""Dependency-free span recorder with W3C ``traceparent`` propagation.

Design constraints (matching the convention of zero-cost-when-off):

- **No hard deps.** Only stdlib. When ``opentelemetry-sdk`` happens to be
  installed AND ``OBS_OTLP_ENDPOINT`` is set, finished spans are mirrored
  to an OTLP exporter; otherwise that path is a no-op.
- **Off = free.** A disabled ``Tracer`` hands out one shared ``NOOP_SPAN``
  singleton: no allocation, no clock reads, no lock. Callers never branch
  on enablement — they branch (at most) on ``span.context is None`` when
  deciding whether to emit a ``traceparent``.
- **Bounded memory.** Finished spans land in a ring buffer
  (``max_spans``, default 2048); old traces fall off the back. Served by
  ``GET /debug/traces`` on the scoring API and the pod server.

Propagation follows the W3C Trace Context format::

    traceparent: 00-<32 hex trace-id>-<16 hex parent-span-id>-<2 hex flags>

The scoring service mints or adopts a trace id, the serving layer forwards
it through ``Sequence``, and the transfer protocol carries it to the
exporting peer so that pod's spans join the same trace.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from ..utils import RateLimitedWarn, get_logger

log = get_logger("obs.tracing")
#: exporter faults repeat per span once a collector misbehaves; keep them
#: visible without the log scaling with span volume.
_warn = RateLimitedWarn(log)

_HEX = set("0123456789abcdef")


@dataclass(frozen=True)
class SpanContext:
    """The propagated identity of a span: what children parent onto."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars


def _is_hex(s: str, n: int) -> bool:
    return len(s) == n and set(s) <= _HEX


def gen_trace_id() -> str:
    return os.urandom(16).hex()


def gen_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C ``traceparent`` header; None for absent/malformed input
    (a bad header must never fail a request — tracing is best-effort)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if not _is_hex(version, 2) or version == "ff":
        return None
    if not _is_hex(trace_id, 32) or trace_id == "0" * 32:
        return None
    if not _is_hex(span_id, 16) or span_id == "0" * 16:
        return None
    if not _is_hex(flags, 2):
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id)


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


class Span:
    """One live span. End it explicitly or use it as a context manager;
    attributes set after ``end()`` are ignored."""

    __slots__ = (
        "name",
        "context",
        "parent_span_id",
        "attrs",
        "start_wall",
        "start_mono",
        "end_mono",
        "_tracer",
        "_ended",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        context: SpanContext,
        parent_span_id: Optional[str],
        attrs: Optional[dict] = None,
    ):
        self._tracer = tracer
        self.name = name
        self.context = context
        self.parent_span_id = parent_span_id
        self.attrs = dict(attrs) if attrs else {}
        # Wall clock on purpose: start_unix_s is a cross-host display/export
        # timestamp; durations below use the monotonic pair.
        self.start_wall = time.time()  # kvlint: disable=monotonic-time
        self.start_mono = time.monotonic()
        self.end_mono: Optional[float] = None
        self._ended = False

    def set_attr(self, key: str, value) -> None:
        if not self._ended:
            self.attrs[key] = value

    def end(self, end_mono: Optional[float] = None) -> None:
        if self._ended:
            return
        self._ended = True
        self.end_mono = time.monotonic() if end_mono is None else end_mono
        self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        if exc is not None:
            self.attrs.setdefault("error", repr(exc))
        self.end()


class _NoopSpan:
    """Shared do-nothing span for disabled tracers. ``context`` is None —
    the one thing callers may branch on (to skip header emission)."""

    __slots__ = ()
    context = None
    parent_span_id = None
    name = ""
    attrs: dict = {}

    def set_attr(self, key: str, value) -> None:
        pass

    def end(self, end_mono=None) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *_a) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Per-process span recorder with a bounded finished-span ring.

    ``service`` tags every span dict (which process recorded it) so merged
    multi-process trace views stay attributable.
    """

    def __init__(
        self,
        enabled: bool = False,
        max_spans: int = 2048,
        service: str = "",
        otlp_endpoint: Optional[str] = None,
    ):
        self.enabled = bool(enabled)
        self.service = service
        self._mu = threading.Lock()
        self._spans: deque = deque(maxlen=max(int(max_spans), 16))  # guarded_by: _mu
        self.spans_recorded = 0  # guarded_by: _mu
        self.spans_dropped = 0  # guarded_by: _mu
        self._otlp = None
        if self.enabled:
            endpoint = otlp_endpoint or os.environ.get("OBS_OTLP_ENDPOINT")
            if endpoint:
                self._otlp = _make_otlp_exporter(endpoint)

    # -- recording -----------------------------------------------------------
    def start_span(self, name: str, parent=None, attrs: Optional[dict] = None):
        """Start a span. ``parent`` is a ``SpanContext``, a ``Span``, or
        None (mint a fresh trace). Disabled tracers return ``NOOP_SPAN``."""
        if not self.enabled:
            return NOOP_SPAN
        pctx = getattr(parent, "context", parent)  # Span -> its context
        if isinstance(pctx, SpanContext):
            ctx = SpanContext(trace_id=pctx.trace_id, span_id=gen_span_id())
            parent_id = pctx.span_id
        else:
            ctx = SpanContext(trace_id=gen_trace_id(), span_id=gen_span_id())
            parent_id = None
        return Span(self, name, ctx, parent_id, attrs)

    def record_span(
        self,
        name: str,
        parent,
        start_mono: float,
        end_mono: float,
        attrs: Optional[dict] = None,
    ) -> None:
        """Record an already-elapsed interval as a finished span — the path
        for timestamp-derived spans (queue/prefill/decode) reconstructed at
        request completion from the timestamps the engine already keeps."""
        if not self.enabled:
            return
        span = self.start_span(name, parent=parent, attrs=attrs)
        # Back-date: the span object was just created but the interval it
        # describes happened earlier.
        span.start_mono = start_mono
        # Back-dating a display timestamp: wall clock minus monotonic delta.
        span.start_wall = time.time() - (time.monotonic() - start_mono)  # kvlint: disable=monotonic-time
        span.end(end_mono=end_mono)

    def _finish(self, span: Span) -> None:
        rec = {
            "name": span.name,
            "service": self.service,
            "trace_id": span.context.trace_id,
            "span_id": span.context.span_id,
            "parent_span_id": span.parent_span_id,
            "start_unix_s": round(span.start_wall, 6),
            "duration_s": round(max(span.end_mono - span.start_mono, 0.0), 6),
            "attrs": span.attrs,
        }
        with self._mu:
            if len(self._spans) == self._spans.maxlen:
                self.spans_dropped += 1
            self._spans.append(rec)
            self.spans_recorded += 1
        if self._otlp is not None:
            try:
                self._otlp(rec)
            except Exception:
                # Broad by necessity (the OTLP SDK's fault surface is not
                # enumerable); a broken exporter must not tax serving, but
                # disabling the mirror silently left operators staring at
                # an empty collector — say so, once.
                log.warning(
                    "OTLP span mirror failed; disabling for this process",
                    exc_info=True,
                )
                self._otlp = None

    # -- reading -------------------------------------------------------------
    def traces(
        self,
        trace_id: Optional[str] = None,
        request_id: Optional[str] = None,
        span_name: Optional[str] = None,
        limit: int = 50,
    ) -> list[dict]:
        """Finished spans grouped by trace (oldest trace first). A
        ``request_id`` filter keeps traces where ANY span carries that
        ``request_id`` attribute; a ``span_name`` filter keeps traces
        containing a span of that name (the whole trace is returned, so
        the match stays readable in context — grepping the disagg
        two-hop traces by ``span=disagg.handoff`` beats hunting ids)."""
        if limit <= 0:
            return []
        with self._mu:
            spans = list(self._spans)
        by_trace: dict[str, list[dict]] = {}
        for rec in spans:
            by_trace.setdefault(rec["trace_id"], []).append(rec)
        out = []
        for tid, recs in by_trace.items():
            if trace_id is not None and tid != trace_id:
                continue
            if request_id is not None and not any(
                r["attrs"].get("request_id") == request_id for r in recs
            ):
                continue
            if span_name is not None and not any(
                r["name"] == span_name for r in recs
            ):
                continue
            out.append({"trace_id": tid, "spans": recs})
        return out[-limit:]

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "enabled": self.enabled,
                "spans_buffered": len(self._spans),
                "spans_recorded": self.spans_recorded,
                "spans_dropped": self.spans_dropped,
            }


def debug_traces_payload(tracer: Tracer, query) -> tuple[int, dict]:
    """The shared ``GET /debug/traces`` contract for the scoring API and
    the pod server: ``(http_status, payload)`` from a query mapping with
    optional ``trace_id`` / ``request_id`` / ``span`` / ``limit`` keys.
    Framework-agnostic so both aiohttp handlers stay one line."""
    try:
        limit = int(query.get("limit", "50"))
    except ValueError:
        return 400, {"error": "invalid limit (want a positive int)"}
    return 200, {
        "enabled": tracer.enabled,
        "traces": tracer.traces(
            trace_id=query.get("trace_id"),
            request_id=query.get("request_id"),
            span_name=query.get("span"),
            limit=limit,
        ),
    }


def _make_otlp_exporter(endpoint: str):
    """Optional OTLP mirror: returns a ``span_dict -> None`` callable when
    the opentelemetry SDK is importable, else None (pure no-op path — the
    container does not bake the SDK in).

    Trace identity is preserved by parenting each mirrored span on a
    ``NonRecordingSpan`` carrying the record's trace id (and its recorded
    parent span id), so spans from the scorer, pod, and transfer peer land
    in ONE collector trace. The SDK generates the mirrored span's own id,
    so internal ids additionally ride as attributes for exact matching."""
    try:
        from opentelemetry import trace as otel_trace
        from opentelemetry.exporter.otlp.proto.http.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
    except ImportError:
        return None
    provider = TracerProvider(resource=Resource.create({}))
    provider.add_span_processor(
        BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint))
    )
    otel_tracer = provider.get_tracer("llm_d_kv_cache_manager_tpu")

    def export(rec: dict) -> None:
        start_ns = int(rec["start_unix_s"] * 1e9)
        parent_ctx = otel_trace.SpanContext(
            trace_id=int(rec["trace_id"], 16),
            span_id=int(rec["parent_span_id"] or rec["span_id"], 16),
            is_remote=True,
            trace_flags=otel_trace.TraceFlags(otel_trace.TraceFlags.SAMPLED),
        )
        context = otel_trace.set_span_in_context(
            otel_trace.NonRecordingSpan(parent_ctx)
        )
        span = otel_tracer.start_span(
            rec["name"], context=context, start_time=start_ns
        )
        for k, v in {
            **rec["attrs"],
            "internal.span_id": rec["span_id"],
            "internal.parent_span_id": rec["parent_span_id"] or "",
            "service": rec["service"],
        }.items():
            try:
                span.set_attribute(k, v)
            except Exception:
                # Attribute values come from user-supplied request fields
                # and the SDK's fault surface is not enumerable; any escape
                # here would hit _finish's handler and disable the WHOLE
                # mirror. Drop THAT attribute, not the span — visibly, and
                # rate-limited per attribute key.
                _warn.warning(
                    f"otlp-attr:{k}",
                    "dropping unserializable span attribute",
                    attr=k,
                    value_type=type(v).__name__,
                )
        span.end(end_time=start_ns + int(rec["duration_s"] * 1e9))

    return export
