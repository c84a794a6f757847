"""Anomaly-triggered flight recorder (``OBS_FLIGHT``).

An always-on bounded ring of per-step engine telemetry (the
``step_stats`` phase seconds plus occupancy / free-page / loop-lag
gauges) and fleet events (breaker transitions, resyncs, drains,
admission sheds/429s), dumped as ONE causally-ordered timeline when a
trigger fires — an SLO burn-rate threshold crossing (``obs/slo.py``'s
``on_burn`` callback), a transfer-breaker OPEN, or a resync — so every
burn ships its own postmortem instead of whatever gauges happened to be
scraped.

Dumps land in ``OBS_FLIGHT_DIR`` (one JSON file per trigger,
rate-limited so a flapping trigger cannot fill a disk) and the latest
timeline is always readable at ``GET /debug/flight``. Off by default:
with the knob unset nothing here is constructed and the serving path
reads no extra clocks.

Timestamps are wall-clock on purpose: a timeline exists to be laid next
to OTHER pods' timelines and the scorer's logs, and cross-host ordering
needs the shared clock (same rationale as the event-batch publish
timestamps and span start times).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..utils import get_logger

log = get_logger("obs.flight")

#: step-phase keys mirrored from ``Engine.step_stats`` (cumulative
#: seconds; the recorder stores per-step deltas)
_PHASE_KEYS = (
    "schedule_s",
    "prefill_s",
    "decode_s",
    "sample_s",
    "gather_s",
    "demote_s",
    "publish_s",
)


class FlightRecorder:
    """Two bounded rings (engine steps, fleet events) + trigger dumps."""

    def __init__(
        self,
        ring: int = 2048,
        out_dir: Optional[str] = None,
        pod: str = "",
        min_dump_interval_s: float = 5.0,
        clock: Callable[[], float] = time.time,  # kvlint: disable=monotonic-time
    ):
        """``clock`` is the cross-host wall clock timelines are ordered
        by (injectable for deterministic tests); ``min_dump_interval_s``
        rate-limits file dumps per trigger reason — the in-memory
        timeline still updates on every trigger."""
        self.out_dir = out_dir
        self.pod = pod
        self._clock = clock
        self._min_dump_interval_s = float(min_dump_interval_s)
        self._mu = threading.Lock()
        self._steps: deque = deque(maxlen=max(int(ring), 16))  # guarded_by: _mu
        self._events: deque = deque(maxlen=max(int(ring), 16))  # guarded_by: _mu
        #: cumulative step_stats values at the last record_step
        self._phase_seen: dict[str, float] = {}  # guarded_by: _mu
        self._steps_seen = 0  # guarded_by: _mu
        #: reason -> last file-dump wall time (rate limit)
        self._last_dump_at: dict[str, float] = {}  # guarded_by: _mu
        self.steps_recorded = 0  # guarded_by: _mu
        self.events_recorded = 0  # guarded_by: _mu
        self.triggers = 0  # guarded_by: _mu
        self.dumps_written = 0  # guarded_by: _mu
        self.dump_failures = 0  # guarded_by: _mu
        self._last_timeline: Optional[dict] = None  # guarded_by: _mu
        self._dump_seq = 0  # guarded_by: _mu

    # -- write side ----------------------------------------------------------
    def record_step(
        self,
        step_stats: dict,
        occupancy: Optional[float] = None,
        free_pages: Optional[int] = None,
        loop_lag_s: Optional[float] = None,
    ) -> None:
        """One engine iteration: per-phase wall-second DELTAS against the
        cumulative ``step_stats`` counters, plus the engine gauges. Steps
        where the engine recorded nothing new (no timed step ran) are
        skipped so an idle loop does not fill the ring with zeros."""
        now = self._clock()
        with self._mu:
            steps = int(step_stats.get("steps", 0))
            if steps <= self._steps_seen:
                return
            n_steps = steps - self._steps_seen
            self._steps_seen = steps
            phases = {}
            for key in _PHASE_KEYS:
                cur = float(step_stats.get(key, 0.0))
                delta = cur - self._phase_seen.get(key, 0.0)
                self._phase_seen[key] = cur
                if delta > 0:
                    phases[key[:-2]] = round(delta, 6)
            entry = {"kind": "step", "t": round(now, 6), "steps": n_steps,
                     "phases": phases}
            if occupancy is not None:
                entry["occupancy"] = round(occupancy, 4)
            if free_pages is not None:
                entry["free_pages"] = int(free_pages)
            if loop_lag_s is not None:
                entry["loop_lag_s"] = round(loop_lag_s, 6)
            self._steps.append(entry)
            self.steps_recorded += 1

    def record_event(self, kind: str, **attrs) -> None:
        """One fleet event (breaker transition, resync, drain, shed/429,
        SLO burn sample, ...). Attrs must be JSON-serializable."""
        now = self._clock()
        with self._mu:
            self._events.append(
                {"kind": kind, "t": round(now, 6), **attrs}
            )
            self.events_recorded += 1

    # -- triggers ------------------------------------------------------------
    def trigger(self, reason: str, **attrs) -> Optional[str]:
        """A trigger fired: snapshot both rings into one causally-ordered
        timeline (the in-memory copy ``/debug/flight`` serves), and write
        it to ``out_dir`` unless this reason dumped within the rate-limit
        window. Returns the file path written, or None. Never raises —
        the recorder must not take down the path it observes."""
        self.record_event(f"trigger:{reason}", **attrs)
        now = self._clock()
        with self._mu:
            self.triggers += 1
            timeline = sorted(
                list(self._steps) + list(self._events), key=lambda e: e["t"]
            )
            payload = {
                "pod": self.pod,
                "reason": reason,
                "triggered_at": round(now, 6),
                "trigger_attrs": attrs,
                "entries": timeline,
            }
            self._last_timeline = payload
            last = self._last_dump_at.get(reason)
            write = self.out_dir is not None and (
                last is None or now - last >= self._min_dump_interval_s
            )
            if write:
                self._last_dump_at[reason] = now
                self._dump_seq += 1
                seq = self._dump_seq
        if not write:
            return None
        path = os.path.join(
            self.out_dir,
            f"flight-{self.pod or 'pod'}-{int(now)}-{seq}-{reason}.json",
        )
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)  # readers never see a torn file
            with self._mu:
                self.dumps_written += 1
            log.warning(
                "flight recorder dumped timeline",
                reason=reason,
                path=path,
                entries=len(timeline),
            )
            return path
        except OSError:
            with self._mu:
                self.dump_failures += 1
            log.exception("flight recorder dump failed")
            return None

    # -- read side -----------------------------------------------------------
    def timeline(self) -> Optional[dict]:
        """The most recent trigger's causally-ordered timeline (None until
        a trigger fired)."""
        with self._mu:
            return self._last_timeline

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "steps_recorded": self.steps_recorded,
                "events_recorded": self.events_recorded,
                "steps_buffered": len(self._steps),
                "events_buffered": len(self._events),
                "triggers": self.triggers,
                "dumps_written": self.dumps_written,
                "dump_failures": self.dump_failures,
                "out_dir": self.out_dir,
            }


def debug_flight_payload(
    recorder: Optional[FlightRecorder], query=None
) -> tuple[int, dict]:
    """``GET /debug/flight`` body: recorder counters plus the latest
    trigger's timeline; disabled-shaped when the knob is off. ``?limit=``
    caps timeline entries with the Tracer contract (``limit <= 0``
    returns nothing); tolerant 400 on a bad limit. ``query=None`` keeps
    in-process callers limit-free."""
    if recorder is None:
        return 200, {"enabled": False}
    limit = None
    if query is not None:
        try:
            limit = int(query.get("limit", "1000"))
        except ValueError:
            return 400, {"error": "invalid limit (want an int)"}
    timeline = recorder.timeline()
    if limit is not None and timeline is not None:
        timeline = dict(timeline)
        entries = timeline.get("entries", [])
        timeline["entries"] = entries[-limit:] if limit > 0 else []
    return 200, {
        "enabled": True,
        **recorder.snapshot(),
        "timeline": timeline,
    }
