"""Fleet observability federation (``OBS_FED``).

Every observability plane the repo has grown — request tracing,
routing quality/staleness, the KV-capacity lifecycle/MRC plane, tenant QoS, integrity — is a **per-pod**
``/stats`` or ``/debug/*`` endpoint. The :class:`FleetFederator` is the
scorer-side aggregator that turns N per-pod surfaces into ONE causally
stamped :dfn:`FleetSnapshot`: per-pod tier-ladder occupancy, hit/miss
attribution mix, SLO burn per objective x window (and per tenant), event
staleness, breaker/quarantine/drain state — served at ``/debug/fleet``
with a bounded delta ring for history and one derived
``kvcache_fleet_health_score`` rollup gauge.

Two pod-registration modes share one join path:

- **in-process** (product fleets, tests, bench): ``register_pod(name,
  fetch=fn)`` where ``fn(path) -> dict | None`` returns the pod's own
  payload for ``/stats`` / ``/debug/mrc`` / ... without HTTP;
- **HTTP** (deployed fleets): ``register_pod(name, url=base)`` — each
  surface is fetched with a per-pod timeout so one slow pod cannot stall
  the whole scrape longer than its budget.

``FleetHealth`` supplies liveness (``scrape_views``): a pod the health
plane says is expired/swept/drained is *skipped outright* — a dead pod
costs one skip, not one timeout per surface per scrape. Draining pods
are still scraped (they serve ``/stats`` until the end) but marked.

The snapshot is **causally stamped**: a monotone ``seq`` (one per
scrape, under the ring lock) plus wall/mono clocks, so two snapshots
compare by ``seq`` even across scorer restarts within a process, and
every history row in the delta ring carries the seq of the cut it
summarizes. Off (default) = no federator attached anywhere:
bit-identical legacy ``/stats`` keys, exposition bytes, and wire bytes
(pinned by tests).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils import get_logger

log = get_logger("obs.federation")

#: the per-pod surfaces one scrape joins (the pod may serve any subset;
#: a surface it lacks contributes nothing — same as a knob it never set)
SCRAPE_SURFACES = (
    "/stats",
    "/debug/staleness",
    "/debug/mrc",
    "/debug/lifecycle",
    "/debug/audit",
)


@dataclass
class FederatedPod:
    """One scrape target: exactly one of ``fetch`` (in-process hook,
    ``fn(path) -> dict | None``) or ``url`` (HTTP base) is set."""

    name: str
    fetch: Optional[Callable[[str], Optional[dict]]] = None
    url: Optional[str] = None
    timeout_s: Optional[float] = None


class FleetFederator:
    """Scorer-side fleet scrape-and-join (see module docstring).

    ``scrape()`` is the one write path: it polls every live registered
    pod, joins the per-pod surfaces into a FleetSnapshot dict, stamps it
    with the next ``seq``, and appends a compact delta row to the
    bounded history ring. Reads (``latest``/``history``/``health_score``)
    never block on I/O.
    """

    def __init__(
        self,
        health=None,
        staleness=None,
        ring: int = 256,
        timeout_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        on_scrape: Optional[Callable[..., None]] = None,
    ):
        #: FleetHealth (liveness gate + per-pod health join); optional so
        #: the federator is testable standalone.
        self.health = health
        #: the scorer's own StalenessTracker/MergedStaleness — pods do
        #: not serve /debug/staleness (publish→visibility lag is measured
        #: where events are APPLIED), so the per-pod staleness join reads
        #: the scorer-side tracker and the pod's own fetch of that
        #: surface, whichever answers.
        self.staleness = staleness
        self.timeout_s = float(timeout_s)
        self._clock = clock
        #: called once per scrape with (scrape_s, errors=, skipped=,
        #: health=) — the owning service's metrics mirror
        #: (``collector.observe_fleet_scrape``); optional so the
        #: federator stays dependency-free standalone.
        self.on_scrape = on_scrape
        self._mu = threading.Lock()
        self._pods: dict[str, FederatedPod] = {}  # guarded_by: _mu
        self._ring: deque = deque(maxlen=max(int(ring), 1))  # guarded_by: _mu
        self._seq = 0  # guarded_by: _mu
        self._last: Optional[dict] = None  # guarded_by: _mu
        # Scrape accounting (mirrored into the collector's federation
        # families by the owning service, scrape-driven).
        self.scrapes = 0  # guarded_by: _mu
        self.scrape_errors = 0  # guarded_by: _mu
        self.pods_skipped_dead = 0  # guarded_by: _mu
        self.last_scrape_s: Optional[float] = None  # guarded_by: _mu

    # -- registration --------------------------------------------------------
    def register_pod(
        self,
        name: str,
        fetch: Optional[Callable[[str], Optional[dict]]] = None,
        url: Optional[str] = None,
        timeout_s: Optional[float] = None,
    ) -> None:
        """Add (or replace) one scrape target. ``fetch`` wins when both
        are given — an in-process hook is strictly cheaper and cannot
        time out."""
        if fetch is None and url is None:
            raise ValueError("register_pod needs fetch= or url=")
        with self._mu:
            self._pods[name] = FederatedPod(
                name=name, fetch=fetch, url=url, timeout_s=timeout_s
            )

    def drop_pod(self, name: str) -> None:
        with self._mu:
            self._pods.pop(name, None)

    def pods(self) -> list[str]:
        with self._mu:
            return sorted(self._pods)

    # -- fetch ---------------------------------------------------------------
    def _fetch(self, pod: FederatedPod, path: str) -> Optional[dict]:
        """One surface from one pod; None = the pod does not serve it
        (or the fetch failed — the caller records the error and joins
        what it has: a partial pod row beats no fleet view)."""
        if pod.fetch is not None:
            return pod.fetch(path)
        timeout = pod.timeout_s if pod.timeout_s is not None else self.timeout_s
        with urllib.request.urlopen(
            pod.url.rstrip("/") + path, timeout=timeout
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    # -- the join ------------------------------------------------------------
    @staticmethod
    def _join_pod(stats: dict, mrc, lifecycle, audit) -> dict:
        """One pod's surfaces -> one FleetSnapshot row. Every block is
        presence-gated on what the pod actually reported: a legacy pod
        (knobs off) yields a row with just the tier ladder and queue
        depths — the federation never invents data."""
        total = int(stats.get("total_pages") or 0)
        free = int(stats.get("free_pages") or 0)
        tiers = {
            "tpu_hbm": {"used": max(total - free, 0), "total": total},
        }
        host = stats.get("host")
        if isinstance(host, dict):
            tiers["host_dram"] = {
                "used": int(host.get("cached") or 0),
                "total": int(host.get("host_pages") or 0),
            }
        remote = stats.get("remote")
        if isinstance(remote, dict):
            tiers["remote"] = {
                "used": int(remote.get("store_cached") or 0),
                "total": int(remote.get("store_pages") or 0),
            }
        for t in tiers.values():
            t["fill"] = (
                round(t["used"] / t["total"], 4) if t["total"] else None
            )
        transfer = stats.get("transfer") or {}
        breakers = transfer.get("breakers") or {}
        row = {
            "ok": True,
            "model": stats.get("model"),
            "tiers": tiers,
            "queue": {
                "staged": stats.get("staged"),
                "waiting": stats.get("waiting"),
                "running": stats.get("running"),
            },
            # Hit/miss attribution mix: the pod's own prefill counters
            # (cached vs computed prompt tokens) — the realized side of
            # the scorer's predicted-vs-realized audit loop.
            "attribution": dict(stats.get("prefill") or {}),
            "draining": bool((stats.get("drain") or {}).get("draining")),
            "breakers": {
                ep: b.get("state") for ep, b in breakers.items()
                if isinstance(b, dict)
            },
        }
        slo = stats.get("slo")
        if isinstance(slo, dict):
            # Per objective x window (and per tenant under TENANT_QOS).
            row["slo_burn"] = slo.get("burn_rates") or {}
        tq = stats.get("tenant_qos")
        if isinstance(tq, dict):
            row["tenant_burn"] = tq.get("slo_burn") or {}
            row["tenants"] = {
                t: dict(s)
                for t, s in (tq.get("cache", {}).get("stats") or {}).items()
            }
        integrity = stats.get("integrity")
        if isinstance(integrity, dict):
            row["quarantine"] = {
                "quarantined": integrity.get("quarantined", 0),
                "checks_corrupt": integrity.get("checks_corrupt", 0),
                "bad_blocks_published": integrity.get(
                    "bad_blocks_published", 0
                ),
            }
        flight = stats.get("flight")
        if isinstance(flight, dict):
            row["flight"] = {
                "triggers": flight.get("triggers", 0),
                "events_recorded": flight.get("events_recorded", 0),
                "dumps_written": flight.get("dumps_written", 0),
            }
        if isinstance(mrc, dict) and mrc.get("enabled"):
            row["mrc"] = {
                "sampled": mrc.get("sampled", 0),
                "cold_fraction": mrc.get("cold_fraction"),
            }
        if isinstance(lifecycle, dict) and lifecycle.get("enabled", True):
            trans = lifecycle.get("transitions_recorded")
            if trans is not None:
                row["lifecycle"] = {"transitions_recorded": trans}
        if isinstance(audit, dict) and audit.get("enabled", True):
            joined = audit.get("joined")
            if joined is not None:
                row["audit"] = {
                    "joined": joined,
                    "miss_causes": dict(audit.get("miss_causes") or {}),
                }
        return row

    def scrape(self) -> dict:
        """Poll every live pod, join, stamp, ring. Returns the snapshot."""
        t0 = self._clock()
        with self._mu:
            targets = list(self._pods.values())
        live_views = (
            self.health.scrape_views([p.name for p in targets])
            if self.health is not None
            else {}
        )
        rows: dict[str, dict] = {}
        errors = 0
        skipped = 0
        for pod in targets:
            view = live_views.get(pod.name) or {}
            if view.get("expired"):
                # The liveness gate: a dead pod costs one skip, not one
                # timeout per surface.
                skipped += 1
                rows[pod.name] = {
                    "ok": False,
                    "skipped": "expired",
                    "health": view,
                }
                continue
            surfaces = {}
            err = None
            for path in SCRAPE_SURFACES:
                try:
                    surfaces[path] = self._fetch(pod, path)
                except Exception as exc:  # noqa: BLE001 — any transport error
                    surfaces[path] = None
                    # /stats failing is THE error (every pod serves it);
                    # a missing debug surface is just a knob that's off.
                    if path == "/stats":
                        err = f"{type(exc).__name__}: {exc}"
                        break
            stats = surfaces.get("/stats")
            if not isinstance(stats, dict):
                errors += 1
                rows[pod.name] = {
                    "ok": False,
                    "error": err or "no /stats payload",
                    "health": view,
                }
                continue
            row = self._join_pod(
                stats,
                surfaces.get("/debug/mrc"),
                surfaces.get("/debug/lifecycle"),
                surfaces.get("/debug/audit"),
            )
            if view:
                row["health"] = view
            rows[pod.name] = row
        # Scorer-side staleness join: publish→visibility lag is measured
        # where events are applied, so the per-pod events-behind view
        # lives HERE, not on the pods.
        staleness = None
        if self.staleness is not None:
            try:
                staleness = self.staleness.snapshot()
                for pod_name, behind in (
                    staleness.get("events_behind") or {}
                ).items():
                    if pod_name in rows and rows[pod_name].get("ok"):
                        rows[pod_name]["events_behind"] = behind
            except Exception:
                log.exception("staleness join failed")
        took = self._clock() - t0
        fleet = self._rollup(rows)
        with self._mu:
            self._seq += 1
            self.scrapes += 1
            self.scrape_errors += errors
            self.pods_skipped_dead += skipped
            self.last_scrape_s = took
            snapshot = {
                "seq": self._seq,
                # wall-clock stamp: crosses the wire via /debug/fleet
                "ts": time.time(),  # kvlint: disable=monotonic-time
                "mono": t0,
                "scrape_s": round(took, 6),
                "pods": rows,
                **({"staleness": staleness} if staleness is not None else {}),
                "fleet": fleet,
            }
            self._last = snapshot
            self._ring.append(self._delta_row(snapshot))
        if self.on_scrape is not None:
            try:
                self.on_scrape(
                    took,
                    errors=errors,
                    skipped=skipped,
                    health=fleet["health_score"],
                )
            except Exception:
                log.exception("on_scrape hook failed")
        return snapshot

    @staticmethod
    def _rollup(rows: dict[str, dict]) -> dict:
        """The fleet block: counts, aggregate tier fill, and the derived
        health score in [0, 1] (None on an empty fleet):

        each pod starts at 1.0; an unreachable/expired pod scores 0; a
        draining pod is capped at 0.5; any SLO burn rate >= 1.0 costs
        0.4; any open breaker costs 0.2; HBM fill >= 0.95 costs 0.2;
        any quarantined copy this lifetime costs 0.1. The fleet score is
        the mean. Deterministic on purpose — the same inputs must roll
        up to the same number on every scorer."""
        scores = []
        tier_used: dict[str, int] = {}
        tier_total: dict[str, int] = {}
        ok = failed = 0
        for row in rows.values():
            if not row.get("ok"):
                failed += 1
                scores.append(0.0)
                continue
            ok += 1
            s = 1.0
            burn = row.get("slo_burn") or {}
            if any(
                rate is not None and rate >= 1.0
                for windows in burn.values()
                for rate in windows.values()
            ):
                s -= 0.4
            if any(
                state == "open" for state in (row.get("breakers") or {}).values()
            ):
                s -= 0.2
            hbm = row["tiers"].get("tpu_hbm") or {}
            if (hbm.get("fill") or 0.0) >= 0.95:
                s -= 0.2
            if (row.get("quarantine") or {}).get("quarantined", 0) > 0:
                s -= 0.1
            s = max(s, 0.0)
            if row.get("draining"):
                s = min(s, 0.5)
            scores.append(s)
            for tier, t in row["tiers"].items():
                tier_used[tier] = tier_used.get(tier, 0) + t["used"]
                tier_total[tier] = tier_total.get(tier, 0) + t["total"]
        return {
            "pods_ok": ok,
            "pods_failed": failed,
            "tiers": {
                tier: {
                    "used": tier_used[tier],
                    "total": tier_total[tier],
                    "fill": (
                        round(tier_used[tier] / tier_total[tier], 4)
                        if tier_total[tier]
                        else None
                    ),
                }
                for tier in sorted(tier_used)
            },
            "health_score": (
                round(sum(scores) / len(scores), 4) if scores else None
            ),
        }

    @staticmethod
    def _delta_row(snapshot: dict) -> dict:
        """One compact history-ring row per scrape: enough for kvtop's
        sparklines (health score, per-pod fill + worst burn) without
        retaining N full snapshots."""
        pods = {}
        for name, row in snapshot["pods"].items():
            if not row.get("ok"):
                pods[name] = {"ok": False}
                continue
            burn = row.get("slo_burn") or {}
            rates = [
                rate
                for windows in burn.values()
                for rate in windows.values()
                if rate is not None
            ]
            pods[name] = {
                "ok": True,
                "hbm_fill": (row["tiers"].get("tpu_hbm") or {}).get("fill"),
                "burn_max": round(max(rates), 4) if rates else None,
                "draining": row.get("draining", False),
            }
        return {
            "seq": snapshot["seq"],
            "ts": snapshot["ts"],
            "scrape_s": snapshot["scrape_s"],
            "health_score": snapshot["fleet"]["health_score"],
            "pods": pods,
        }

    # -- read side -----------------------------------------------------------
    def latest(self) -> Optional[dict]:
        with self._mu:
            return self._last

    def history(self, limit: int = 50) -> list[dict]:
        """Most recent delta rows, oldest first. The Tracer limit
        contract: ``limit <= 0`` returns nothing."""
        if limit <= 0:
            return []
        with self._mu:
            rows = list(self._ring)
        return rows[-limit:]

    def health_score(self) -> Optional[float]:
        """The last scrape's rollup score (None before the first scrape
        or on an empty fleet) — the ``kvcache_fleet_health_score`` gauge."""
        with self._mu:
            last = self._last
        if last is None:
            return None
        return last["fleet"]["health_score"]

    def snapshot(self) -> dict:
        """Compact counters for the gated ``/stats`` block (never the
        full fleet join — that is ``/debug/fleet``'s job)."""
        with self._mu:
            return {
                "pods_registered": len(self._pods),
                "scrapes": self.scrapes,
                "scrape_errors": self.scrape_errors,
                "pods_skipped_dead": self.pods_skipped_dead,
                "last_scrape_s": (
                    round(self.last_scrape_s, 6)
                    if self.last_scrape_s is not None
                    else None
                ),
                "seq": self._seq,
                "ring": len(self._ring),
            }


def debug_fleet_payload(
    federator: Optional[FleetFederator], query
) -> tuple[int, dict]:
    """``GET /debug/fleet`` body: a FRESH scrape-and-join (scrape-driven,
    like the occupancy gauges — callers on an event loop must push it to
    an executor) plus the history ring. ``?limit=`` caps history rows
    with the Tracer contract (``limit <= 0`` returns nothing); tolerant
    400 on a bad limit; disabled-shaped when the knob is off."""
    if federator is None:
        return 200, {"enabled": False, "pods": {}, "history": []}
    try:
        limit = int(query.get("limit", "50"))
    except ValueError:
        return 400, {"error": "invalid limit (want an int)"}
    snapshot = federator.scrape()
    return 200, {
        "enabled": True,
        **snapshot,
        "history": federator.history(limit=limit),
        **federator.snapshot(),
    }
