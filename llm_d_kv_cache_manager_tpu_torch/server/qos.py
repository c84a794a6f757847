"""Multi-tenant QoS policy for the serving layer (``TENANT_QOS``).

Grammar
=======

``TENANT_QOS`` is a semicolon-separated list of tenant entries::

    TENANT_QOS="premium:prio=0,weight=4;batch:prio=1,max_waiting=8,\
rps=5,cache_share=0.25;*:prio=1"

Each entry is ``name`` or ``name:key=value,key=value,...``.  Keys:

``prio``
    Priority class (int, **0 = highest**).  The scheduler orders the
    waiting queue by class, and priority preemption only ever takes
    pages from a strictly lower class (larger ``prio``).
``weight``
    Weighted-fair share *within* a class (float > 0).  Tenants in the
    same class split the token budget proportionally to their weights,
    which bounds starvation between same-class tenants.
``max_waiting``
    Cap on a tenant's outstanding (admitted, unresolved) requests.
    0 = unbounded.
``max_queued_tokens``
    Cap on a tenant's outstanding prompt tokens.  0 = unbounded.
``rps``
    Request-rate budget: at most ``rps * RATE_WINDOW_S`` admissions per
    sliding :data:`RATE_WINDOW_S` window.  0 = unbounded.
``cache_share``
    Cap on the tenant's share of *evictable* (warm, reusable) HBM
    pages, as a fraction of the pool.  Once over the cap, the tenant
    recycles its own LRU page instead of evicting other tenants' warm
    prefixes.  0 = uncapped.

The special name ``*`` is the default entry: requests with no
``X-Tenant`` header, and any tenant not named in the policy, share the
``*`` entry's class and budgets (collectively — the point is that a
swarm of anonymous tenants cannot multiply its budget by inventing
names).  If the spec does not define ``*``, one is synthesized with the
lowest configured priority class and no budgets.

Threading contract
==================

The policy table is immutable after parse.  The budget state
(outstanding counts, rate windows, per-tenant counters) is owned by the
serving layer and mutated only under ``PodServer._mu`` (the same lock
that guards the shared admission accounting); this class adds no
lock of its own.  Scheduler/block-manager QoS state lives on those
objects and stays engine-thread-only.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

#: Default tenant key (see module docstring).
DEFAULT_TENANT = "*"

#: Sliding window (seconds) behind ``rps`` budgets.  A fixed window
#: keeps the budget arithmetic exact and testable; the budget itself is
#: still expressed per-second in the policy grammar.
RATE_WINDOW_S = 10.0


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's parsed policy entry (immutable)."""

    name: str
    priority: int = 0
    weight: float = 1.0
    max_waiting: int = 0
    max_queued_tokens: int = 0
    rps: float = 0.0
    cache_share: float = 0.0


def parse_tenant_qos(spec: str) -> dict[str, TenantPolicy]:
    """Parse a ``TENANT_QOS`` spec; raises ``ValueError`` at config time
    on malformed input (unknown key, non-positive weight, cache_share
    outside [0, 1], duplicate tenant, empty spec)."""
    policies: dict[str, TenantPolicy] = {}
    for raw_entry in spec.split(";"):
        entry = raw_entry.strip()
        if not entry:
            continue
        name, _, kvs = entry.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"TENANT_QOS entry has no tenant name: {entry!r}")
        if name in policies:
            raise ValueError(f"TENANT_QOS duplicates tenant {name!r}")
        fields: dict[str, object] = {}
        for raw_kv in kvs.split(","):
            kv = raw_kv.strip()
            if not kv:
                continue
            key, sep, val = kv.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or not val:
                raise ValueError(f"TENANT_QOS bad key=value {kv!r} in {entry!r}")
            try:
                if key == "prio":
                    fields["priority"] = int(val)
                elif key == "weight":
                    fields["weight"] = float(val)
                elif key == "max_waiting":
                    fields["max_waiting"] = int(val)
                elif key == "max_queued_tokens":
                    fields["max_queued_tokens"] = int(val)
                elif key == "rps":
                    fields["rps"] = float(val)
                elif key == "cache_share":
                    fields["cache_share"] = float(val)
                else:
                    raise ValueError(f"TENANT_QOS unknown key {key!r} in {entry!r}")
            except ValueError as exc:
                if "TENANT_QOS" in str(exc):
                    raise
                raise ValueError(
                    f"TENANT_QOS bad value for {key!r} in {entry!r}: {val!r}"
                ) from exc
        pol = TenantPolicy(name=name, **fields)  # type: ignore[arg-type]
        if pol.weight <= 0:
            raise ValueError(f"TENANT_QOS weight must be > 0 in {entry!r}")
        if not 0.0 <= pol.cache_share <= 1.0:
            raise ValueError(f"TENANT_QOS cache_share must be in [0,1] in {entry!r}")
        if pol.max_waiting < 0 or pol.max_queued_tokens < 0 or pol.rps < 0:
            raise ValueError(f"TENANT_QOS budgets must be >= 0 in {entry!r}")
        policies[name] = pol
    if not policies:
        raise ValueError("TENANT_QOS is set but defines no tenants")
    if DEFAULT_TENANT not in policies:
        # Unnamed tenants default to the *lowest* configured class with
        # no budgets — unknown traffic is never silently promoted above
        # a named tenant, and never hard-rejected by omission.
        lowest = max(p.priority for p in policies.values())
        policies[DEFAULT_TENANT] = TenantPolicy(
            name=DEFAULT_TENANT, priority=lowest
        )
    return policies


class TenantQoS:
    """Parsed policy table + per-tenant admission budget state.

    All mutable state is keyed by the *slice key* (:meth:`key`): named
    tenants map to themselves, everything else collapses onto
    ``DEFAULT_TENANT`` — so per-tenant state is bounded by the policy
    size no matter what headers clients invent.
    """

    def __init__(
        self,
        policies: dict[str, TenantPolicy],
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policies = dict(policies)
        self._clock = clock
        keys = list(self.policies)
        # Outstanding = admitted and not yet resolved (queued or in
        # compute); released in _forget_pending / request resolution.
        self.pending: dict[str, int] = {k: 0 for k in keys}
        self.pending_tokens: dict[str, int] = {k: 0 for k in keys}
        self._rate_events: dict[str, deque] = {k: deque() for k in keys}
        self.admitted: dict[str, int] = {k: 0 for k in keys}
        self.rejected: dict[str, dict[str, int]] = {
            k: {"waiting": 0, "tokens": 0, "rate": 0} for k in keys
        }

    # -- policy lookups (read-only, safe from any thread) --------------

    def key(self, tenant: str) -> str:
        """Slice key for a request's tenant header value."""
        return tenant if tenant in self.policies else DEFAULT_TENANT

    def policy(self, tenant: str) -> TenantPolicy:
        return self.policies[self.key(tenant)]

    def cache_cap_pages(self, tenant: str, usable_pages: int) -> Optional[int]:
        """Evictable-page cap for ``tenant``, or None when uncapped."""
        share = self.policy(tenant).cache_share
        if share <= 0.0:
            return None
        return max(int(share * usable_pages), 1)

    # -- budget state (mutate only under the serving layer's _mu) ------

    def admit(
        self, tenant: str, n_tokens: int, now: Optional[float] = None
    ) -> Optional[tuple[str, str, Optional[float], int, int]]:
        """Check ``tenant``'s budgets for one request of ``n_tokens``
        prompt tokens.  Returns None to admit, else a reject tuple
        ``(cap, message, retry_hint_s, depth, queued_tokens)`` —
        ``retry_hint_s`` is exact for rate rejections (when the oldest
        window event expires) and None otherwise (the caller derives
        Retry-After from its measured serving rates)."""
        k = self.key(tenant)
        pol = self.policies[k]
        depth = self.pending[k]
        queued = self.pending_tokens[k]
        if pol.max_waiting and depth >= pol.max_waiting:
            self.rejected[k]["waiting"] += 1
            return (
                "waiting",
                f"tenant {k!r} over max_waiting "
                f"({depth} outstanding >= {pol.max_waiting})",
                None,
                depth,
                queued,
            )
        if pol.max_queued_tokens and queued + n_tokens > pol.max_queued_tokens:
            self.rejected[k]["tokens"] += 1
            return (
                "tokens",
                f"tenant {k!r} over max_queued_tokens "
                f"({queued} + {n_tokens} > {pol.max_queued_tokens})",
                None,
                depth,
                queued,
            )
        if pol.rps > 0:
            t = self._clock() if now is None else now
            window = self._rate_events[k]
            horizon = t - RATE_WINDOW_S
            while window and window[0] <= horizon:
                window.popleft()
            budget = pol.rps * RATE_WINDOW_S
            if len(window) >= budget:
                self.rejected[k]["rate"] += 1
                hint = min(max(window[0] + RATE_WINDOW_S - t, 1.0), 60.0)
                return (
                    "rate",
                    f"tenant {k!r} over request-rate budget "
                    f"({len(window)} admits in {RATE_WINDOW_S:g}s >= "
                    f"{pol.rps:g}/s)",
                    hint,
                    depth,
                    queued,
                )
        return None

    def on_admitted(
        self, tenant: str, n_tokens: int, now: Optional[float] = None
    ) -> None:
        k = self.key(tenant)
        self.pending[k] += 1
        self.pending_tokens[k] += n_tokens
        self.admitted[k] += 1
        if self.policies[k].rps > 0:
            self._rate_events[k].append(
                self._clock() if now is None else now
            )

    def on_resolved(self, tenant: str, n_tokens: int) -> None:
        """Release one outstanding request's budget (clamped at zero so
        a double release can never go negative and wedge a tenant)."""
        k = self.key(tenant)
        self.pending[k] = max(self.pending[k] - 1, 0)
        self.pending_tokens[k] = max(self.pending_tokens[k] - n_tokens, 0)

    def reset_pending(self) -> None:
        """Zero all outstanding budgets (engine death / fail-outstanding
        path, mirroring the shared admission counters being zeroed)."""
        for k in self.pending:
            self.pending[k] = 0
            self.pending_tokens[k] = 0

    def snapshot(self) -> dict:
        """Budget-state snapshot for /stats (call under the serving
        layer's _mu)."""
        return {
            "tenants": {
                k: {
                    "priority": p.priority,
                    "weight": p.weight,
                    "pending": self.pending[k],
                    "pending_tokens": self.pending_tokens[k],
                    "admitted": self.admitted[k],
                    "rejected": dict(self.rejected[k]),
                }
                for k, p in sorted(self.policies.items())
            },
            "rate_window_s": RATE_WINDOW_S,
        }
