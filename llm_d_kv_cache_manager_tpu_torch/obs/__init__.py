"""Fleet observability: request tracing + latency decomposition.

The tracing layer is dependency-free (stdlib only) and off by default —
``OBS_TRACING=1`` turns it on per process. Spans propagate across the
scorer → pod → transfer-peer hop via W3C ``traceparent`` (HTTP headers on
the scoring/serving APIs, a trailing optional field in the KV-transfer
msgpack envelope), so one request's time is attributable end to end.
"""

from .audit import (  # noqa: F401
    AuditRecord,
    RouteAuditor,
    StalenessTracker,
    debug_audit_payload,
    debug_staleness_payload,
)
from .federation import (  # noqa: F401
    SCRAPE_SURFACES,
    FederatedPod,
    FleetFederator,
    debug_fleet_payload,
)
from .slo import (  # noqa: F401
    SLObjective,
    SLORecorder,
    parse_slo_spec,
    parse_windows,
)
from .tracing import (  # noqa: F401
    NOOP_SPAN,
    Span,
    SpanContext,
    Tracer,
    format_traceparent,
    parse_traceparent,
)
