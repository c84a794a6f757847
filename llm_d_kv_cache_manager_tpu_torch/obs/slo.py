"""In-process SLO burn-rate recording over the serving latency stream.

``OBS_SLO`` declares objectives against the same per-request measurements
the latency histograms observe (TTFT and per-request mean ITL), e.g.

    OBS_SLO="ttft:0.5:0.99;itl:0.05:0.95"

reads "99% of requests must see TTFT <= 0.5 s, 95% must see mean ITL <=
0.05 s". For each objective and each sliding window (``OBS_SLO_WINDOWS``,
default 60 s and 300 s) the recorder exports

    kvcache_slo_burn_rate{objective, window}

where burn rate = (observed violating fraction) / (1 - target): 1.0 means
the error budget burns exactly at its sustainable rate, N means the
budget is exhausted N x faster — the standard multi-window burn-rate
alerting input, computed in-process so it works without a Prometheus
server (the ``/stats`` ``slo`` block carries the same numbers).

Off by default: with ``OBS_SLO`` unset nothing here is constructed and
the serving path reads no extra clocks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils import get_logger

log = get_logger("obs.slo")

SLO_METRICS = ("ttft", "itl")
DEFAULT_WINDOWS_S = (60.0, 300.0)


@dataclass(frozen=True)
class SLObjective:
    """One objective: ``target`` fraction of requests must see ``metric``
    at or under ``threshold_s``."""

    metric: str  # "ttft" | "itl"
    threshold_s: float
    target: float  # e.g. 0.99

    @property
    def label(self) -> str:
        """The ``objective`` metric-label value (stable, PromQL-friendly)."""
        return f"{self.metric}_le_{self.threshold_s:g}s_p{self.target:g}"


def parse_slo_spec(spec: str) -> list[SLObjective]:
    """``"ttft:0.5:0.99;itl:0.05:0.95"`` → objectives. Raises ValueError
    on malformed specs — a silently-dropped objective would read as a
    perfectly green SLO."""
    out = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 3:
            raise ValueError(f"bad OBS_SLO segment {part!r} (want metric:threshold_s:target)")
        metric, thr, target = fields
        if metric not in SLO_METRICS:
            raise ValueError(f"bad OBS_SLO metric {metric!r} (want one of {SLO_METRICS})")
        thr_f, target_f = float(thr), float(target)
        if thr_f <= 0 or not (0.0 < target_f < 1.0):
            raise ValueError(f"bad OBS_SLO segment {part!r} (threshold > 0, 0 < target < 1)")
        out.append(SLObjective(metric=metric, threshold_s=thr_f, target=target_f))
    return out


def parse_windows(spec: str) -> tuple[float, ...]:
    """``"60,300"`` → window seconds; empty/unset → the defaults."""
    if not (spec or "").strip():
        return DEFAULT_WINDOWS_S
    out = tuple(float(w) for w in spec.split(",") if w.strip())
    if not out or any(w <= 0 for w in out):
        raise ValueError(f"bad OBS_SLO_WINDOWS {spec!r} (want positive seconds)")
    return out


class SLORecorder:
    """Sliding-window violation accounting for a set of objectives.

    ``observe`` is called once per finished request (the same feed as the
    latency histograms); ``burn_rates`` is scrape-driven (/stats and
    /metrics), so the hot path pays one deque append per objective.
    """

    def __init__(
        self,
        objectives: list[SLObjective],
        windows_s=DEFAULT_WINDOWS_S,
        clock: Callable[[], float] = time.monotonic,
        max_samples_per_objective: int = 65536,
        on_burn: Optional[Callable[[str, str, float], None]] = None,
        burn_threshold: float = 0.0,
        burn_check_interval_s: float = 1.0,
        track_tenants: bool = False,
    ):
        """``on_burn(objective, window, rate)`` (optional, e.g. the
        ``OBS_FLIGHT`` recorder's trigger): fired when any objective's
        burn rate CROSSES ``burn_threshold`` from below — edge-triggered
        per (objective, window), so a sustained burn triggers once until
        it recovers under the threshold. Evaluation is throttled to at
        most once per ``burn_check_interval_s`` (burn rates are
        O(window samples) to compute, which must not ride every request).
        ``burn_threshold <= 0`` or ``on_burn=None`` disables the check —
        the legacy observe path reads no extra state."""
        self.objectives = list(objectives)
        self.windows_s = tuple(windows_s)
        self._clock = clock
        self._mu = threading.Lock()
        #: per objective: deque[(t, violated)] pruned past the max window
        self._events: dict[str, deque] = {  # guarded_by: _mu
            o.label: deque(maxlen=max_samples_per_objective)
            for o in self.objectives
        }
        self._max_samples = max_samples_per_objective
        #: TENANT_QOS per-tenant burn tracking: (tenant, objective label)
        #: -> the same deque[(t, violated)] shape as ``_events``. Only
        #: populated when ``track_tenants`` and the observation carries a
        #: tenant, so the knob-off recorder holds no extra state. Tenant
        #: keys are the serving layer's slice keys (bounded by policy
        #: size), never raw header values.
        self.track_tenants = bool(track_tenants)
        self._tenant_events: dict[tuple[str, str], deque] = {}  # guarded_by: _mu
        self.observed = 0  # guarded_by: _mu
        self.on_burn = on_burn
        self.burn_threshold = float(burn_threshold)
        self._burn_check_interval_s = float(burn_check_interval_s)
        self._next_burn_check = 0.0  # guarded_by: _mu
        #: (objective, window) currently at-or-over the threshold (the
        #: edge detector's state)
        self._burning: set[tuple[str, str]] = set()  # guarded_by: _mu
        self.burn_crossings = 0  # guarded_by: _mu

    def observe(
        self,
        ttft_s: Optional[float],
        itl_s: Optional[float],
        tenant: str = "",
    ) -> None:
        """One finished request's measurements (None = not measurable for
        this request, e.g. single-token generations have no ITL).
        ``tenant`` slices the same observation per tenant when tenant
        tracking is on; "" (always, with TENANT_QOS off) changes
        nothing."""
        now = self._clock()
        values = {"ttft": ttft_s, "itl": itl_s}
        slice_tenant = tenant if self.track_tenants else ""
        check_burn = False
        with self._mu:
            self.observed += 1
            horizon = now - max(self.windows_s)
            for obj in self.objectives:
                v = values[obj.metric]
                if v is None:
                    continue
                ev = self._events[obj.label]
                ev.append((now, v > obj.threshold_s))
                while ev and ev[0][0] < horizon:
                    ev.popleft()
                if slice_tenant:
                    tev = self._tenant_events.get((slice_tenant, obj.label))
                    if tev is None:
                        tev = self._tenant_events[(slice_tenant, obj.label)] = (
                            deque(maxlen=self._max_samples)
                        )
                    tev.append((now, v > obj.threshold_s))
                    while tev and tev[0][0] < horizon:
                        tev.popleft()
            if (
                self.on_burn is not None
                and self.burn_threshold > 0
                and now >= self._next_burn_check
            ):
                self._next_burn_check = now + self._burn_check_interval_s
                check_burn = True
        if check_burn:
            self._check_burn_crossings()

    def burn_rates(self) -> dict[str, dict[str, Optional[float]]]:
        """{objective label: {window label: burn rate | None}} — None when
        the window holds no samples (no traffic is not a green SLO)."""
        now = self._clock()
        out: dict[str, dict[str, Optional[float]]] = {}
        with self._mu:
            for obj in self.objectives:
                ev = list(self._events[obj.label])
                rates: dict[str, Optional[float]] = {}
                for w in self.windows_s:
                    cutoff = now - w
                    total = bad = 0
                    for t, violated in reversed(ev):
                        if t < cutoff:
                            break
                        total += 1
                        bad += violated
                    budget = 1.0 - obj.target
                    rates[f"{w:g}s"] = (
                        round((bad / total) / budget, 4) if total else None
                    )
                out[obj.label] = rates
        return out

    def tenant_burn_rates(self) -> dict[str, dict[str, dict[str, Optional[float]]]]:
        """{tenant: {objective label: {window label: burn rate | None}}}
        over the per-tenant slices (empty until tenant tracking observed
        anything). Same arithmetic as ``burn_rates``, same None-for-empty
        rule."""
        now = self._clock()
        with self._mu:
            slices = {k: list(ev) for k, ev in self._tenant_events.items()}
        out: dict[str, dict[str, dict[str, Optional[float]]]] = {}
        by_label = {o.label: o for o in self.objectives}
        for (tenant, label), ev in sorted(slices.items()):
            obj = by_label.get(label)
            if obj is None:
                continue
            rates: dict[str, Optional[float]] = {}
            for w in self.windows_s:
                cutoff = now - w
                total = bad = 0
                for t, violated in reversed(ev):
                    if t < cutoff:
                        break
                    total += 1
                    bad += violated
                budget = 1.0 - obj.target
                rates[f"{w:g}s"] = (
                    round((bad / total) / budget, 4) if total else None
                )
            out.setdefault(tenant, {})[label] = rates
        return out

    def sync_tenant_gauges(
        self, set_fn: Callable[[str, str, str, float], None]
    ) -> None:
        """Push per-tenant burn rates into labeled gauges
        (``set_fn(tenant, objective, window, rate)``), skipping empty
        windows like ``sync_gauges``."""
        for tenant, objectives in self.tenant_burn_rates().items():
            for objective, windows in objectives.items():
                for window, rate in windows.items():
                    if rate is not None:
                        set_fn(tenant, objective, window, rate)

    def _check_burn_crossings(self) -> None:
        """Edge-triggered burn-threshold detector: fires ``on_burn`` once
        per (objective, window) crossing; a window that recovers below
        the threshold re-arms. Called off the observe path (throttled) so
        the O(samples) burn-rate walk never rides every request."""
        fired: list[tuple[str, str, float]] = []
        rates = self.burn_rates()
        with self._mu:
            for objective, windows in rates.items():
                for window, rate in windows.items():
                    key = (objective, window)
                    if rate is not None and rate >= self.burn_threshold:
                        if key not in self._burning:
                            self._burning.add(key)
                            self.burn_crossings += 1
                            fired.append((objective, window, rate))
                    else:
                        self._burning.discard(key)
            cb = self.on_burn
        for objective, window, rate in fired:
            try:
                cb(objective, window, rate)
            except Exception:
                # The callback (a flight-recorder dump) must never fail
                # the request whose observation tripped it.
                log.exception("on_burn callback failed")

    def sync_gauges(self, set_fn: Callable[[str, str, float], None]) -> None:
        """Push current burn rates into labeled gauges (scrape-driven).
        Windows with no samples are skipped — a gauge stuck at a stale
        value is worse than an absent series."""
        for objective, windows in self.burn_rates().items():
            for window, rate in windows.items():
                if rate is not None:
                    set_fn(objective, window, rate)

    def snapshot(self) -> dict:
        with self._mu:
            observed = self.observed
        return {
            "objectives": [
                {
                    "objective": o.label,
                    "metric": o.metric,
                    "threshold_s": o.threshold_s,
                    "target": o.target,
                }
                for o in self.objectives
            ],
            "windows_s": list(self.windows_s),
            "observed": observed,
            "burn_rates": self.burn_rates(),
        }
