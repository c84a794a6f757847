"""The engine's step record: one bounded ring of every engine step's host
spans, device spans and counters, on one clock.

It is on exactly when ``Engine.obs_step_timing`` is (the pod turns that on
under ``OBS_METRICS`` or ``OBS_FLIGHT``). Off, the engine holds no record,
reads no clock for it and records no CUDA event. ``Engine.step_stats``
(cumulative host seconds a phase), the flight recorder's step ring and the
Prometheus phase counters are all folded from it.

Each entry (``StepEntry``) holds:

- ``index`` and ``kind``: the step's number and ``"prefill"``,
  ``"decode"``, ``"mixed"`` (a prefill and a decode dispatch) or
  ``"idle"`` (neither);
- ``host``: ``(name, start_ns, end_ns)`` spans on ``time.monotonic_ns()``
  (the clock of the ``Sequence`` stamps). ``engine.step`` covers the step;
  the others lie inside it (``HOST_SPANS``), except the pod loop's
  ``pod.admit`` (before the step) and ``pod.resolve`` (after it);
- ``device``: ``(name, start_ns, end_ns)`` intervals of the device's own
  clock placed on ``monotonic_ns`` through the anchor: ``device.decode``, a
  burst from its first kernel (an event its graph records itself) to its
  sampled ids' copy, read once its end has passed at the burst's commit,
  so it adds no host sync. A pipelined burst's span lands in the entry of
  the step that launched it;
- ``counters``: ``prefill_rows`` (rows dispatched, one a scheduled sequence),
  ``prefill_chunk`` and ``prefill_valid_tokens`` of a prefill dispatch
  (computed tokens are rows × chunk); ``decode_steps`` (the model steps of
  the step's decode dispatch) and, when the decode graphs were captured
  with the record on, the routed MoE's ``k4_touched`` (one count a model
  step: the sum over layers of the expert groups holding at least one
  row, padded lanes included, as the grouped matmul receives them); and
  the page moves' ``gather_s`` and ``demote_s`` host seconds.

The anchor: a CUDA event recorded on the drained compute stream at a noted
``monotonic_ns`` instant (on the CPU, ``perf_counter`` against
``monotonic_ns``), taken when the record starts, on ``anchor()``, and again
once it is ``ANCHOR_AGE_NS`` old: at the next drain of the engine's
in-flight burst (where the stream is already empty), or at the next step
once it is ``ANCHOR_MAX_AGE_NS`` old. So the device clock cannot drift far
from the host's, and an interval's float32 milliseconds from the anchor
keep microseconds. ``clock_pair`` is one ``(time.time_ns(),
time.monotonic_ns())`` pair, with which a reader places wall-clock records
(a profiler trace's) on the same clock.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from .sequence import Sequence

#: spans inside ``engine.step``, in the order a step runs them
HOST_SPANS = (
    "engine.schedule",
    "engine.host_prefetch",
    "engine.drain",
    "engine.prefill.prepare",
    "engine.prefill.launch",
    "engine.prefill.sample",
    "engine.prefill.commit",
    "engine.decode.launch",
    "engine.decode.wait",
    "engine.decode.commit",
    "engine.publish",
)
#: steps the ring holds: more than a minute of steps at the card's rates
CAPACITY = 8192
#: the anchor's age at which a drain takes it again, and at which any step
#: does (float32 milliseconds from the anchor keep 8 microseconds at 120 s)
ANCHOR_AGE_NS = 10_000_000_000
ANCHOR_MAX_AGE_NS = 120_000_000_000
#: ``Engine.step_stats``'s phase keys, in their order
PHASE_KEYS = ("schedule_s", "prefill_s", "decode_s", "sample_s", "gather_s", "demote_s",
              "publish_s")


@dataclass
class EngineSequence(Sequence):
    """The engine's sequence: the copied ``Sequence`` with two fields of
    the engine's own. ``num_preemptions`` counts the times the engine
    preempted it (always). ``commit_times`` is None unless the step record
    was on when it arrived: then one ``(monotonic_ns, tokens)`` pair a
    commit (its first token, each burst that committed tokens), which sum
    to ``num_generated``."""

    num_preemptions: int = 0
    commit_times: Optional[list] = None


@dataclass
class StepEntry:
    index: int
    kind: str = "idle"
    host: list = field(default_factory=list)
    device: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    #: this step's seconds a ``step_stats`` phase (keys without ``_s``),
    #: set when the step ends
    phases: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"index": self.index, "kind": self.kind, "host": list(self.host),
                "device": list(self.device), "counters": dict(self.counters),
                "phases": dict(self.phases)}


def _top_level(spans: list) -> list:
    """The spans no other span holds (spans nest: each lies inside its
    parent)."""
    out, reach = [], -1
    for span in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        if span[2] > reach:
            out.append(span)
            reach = span[2]
    return out


def phase_seconds(entry: StepEntry) -> dict:
    """The step's ``step_stats`` phases from its spans: ``schedule``,
    ``prefill`` (the drain before a prefill and the prefill), ``decode``
    (the decode dispatch, the commits after it, and a drain in a step that
    prefilled nothing), ``sample`` (every blocking fetch of sampled ids),
    ``publish``, and the page moves' ``gather`` and ``demote``."""
    spans = [s for s in entry.host if s[0].startswith("engine.") and s[0] != "engine.step"]
    prefilled = entry.kind in ("prefill", "mixed")
    out = dict.fromkeys((k[:-2] for k in PHASE_KEYS), 0.0)
    for name, a, b in _top_level(spans):
        sec = (b - a) / 1e9
        if name == "engine.schedule":
            out["schedule"] += sec
        elif name.startswith("engine.prefill.") or (name == "engine.drain" and prefilled):
            out["prefill"] += sec
        elif name.startswith("engine.decode.") or name == "engine.drain":
            out["decode"] += sec
        elif name == "engine.publish":
            out["publish"] += sec
    for name, a, b in spans:
        if name in ("engine.prefill.sample", "engine.decode.wait"):
            out["sample"] += (b - a) / 1e9
    out["gather"] = entry.counters.get("gather_s", 0.0)
    out["demote"] = entry.counters.get("demote_s", 0.0)
    return out


class StepRecord:
    """The ring and its clock. ``stream`` is the compute stream (None on
    the CPU)."""

    def __init__(self, stream: Optional[torch.cuda.Stream], device: torch.device,
                 step_stats: dict, capacity: int = CAPACITY):
        self._stream, self._device = stream, device
        self.entries: collections.deque = collections.deque(maxlen=capacity)
        #: the ``Engine.step_stats`` dict, folded into as each step ends
        self.step_stats = step_stats
        self.current: Optional[StepEntry] = None
        self._pending: list = []  # pod spans of the next step
        self._pending_counts: dict = {}  # counted outside a step: the next one's
        self._count = 0
        self.anchor()

    @staticmethod
    def now() -> int:
        return time.monotonic_ns()

    # -- the clock -----------------------------------------------------------
    def anchor(self) -> None:
        """Take the anchor again (the compute stream is drained first)."""
        if self._stream is not None:
            self._stream.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            h0 = time.monotonic_ns()
            ev.record(self._stream)
            h1 = time.monotonic_ns()
            ev.synchronize()
            self._anchor = (ev, (h0 + h1) // 2)
        else:
            h0 = time.monotonic_ns()
            p = time.perf_counter()
            self._anchor = (p, (h0 + time.monotonic_ns()) // 2)
        self.clock_pair = (time.time_ns(), time.monotonic_ns())

    def refresh(self, max_age_ns: int) -> None:
        """Take the anchor again if it is older than ``max_age_ns``."""
        if time.monotonic_ns() - self._anchor[1] > max_age_ns:
            self.anchor()

    def to_ns(self, mark) -> int:
        """A device mark on ``monotonic_ns``: a passed CUDA event,
        ``perf_counter`` seconds (the CPU), or a mark already placed
        (``int`` nanoseconds)."""
        if isinstance(mark, int):
            return mark
        ref, ns = self._anchor
        if isinstance(mark, float):
            return ns + round((mark - ref) * 1e9)
        return ns + round(ref.elapsed_time(mark) * 1e6)

    # -- writing -------------------------------------------------------------
    def begin(self) -> int:
        """Open the next step's entry; returns its start."""
        self.refresh(ANCHOR_MAX_AGE_NS)
        self.current = StepEntry(self._count)
        self._count += 1
        if self._pending:
            self.current.host.extend(self._pending)
            self._pending = []
        if self._pending_counts:
            self.current.counters.update(self._pending_counts)
            self._pending_counts = {}
        return time.monotonic_ns()

    def host(self, name: str, start_ns: int) -> int:
        """A host span from ``start_ns`` to now, in the open step (the newest
        when none is open: a commit the pod loop ran outside a step).
        Returns its end, where a following span starts."""
        end = time.monotonic_ns()
        entry = self.current or (self.entries[-1] if self.entries else None)
        if entry is not None:
            entry.host.append((name, start_ns, end))
        return end

    def pod(self, name: str, start_ns: int, before_step: bool) -> None:
        """A pod-loop span: ``before_step`` joins the next step's entry,
        otherwise the newest."""
        span = (name, start_ns, time.monotonic_ns())
        if before_step:
            self._pending.append(span)
        elif self.entries:
            self.entries[-1].host.append(span)

    def device(self, entry: Optional[StepEntry], name: str, start, stop) -> None:
        """A device interval whose end has passed, in ``entry``."""
        if entry is not None:
            entry.device.append((name, self.to_ns(start), self.to_ns(stop)))

    def count(self, name: str, n=1) -> None:
        """Add ``n`` to a counter of the open step (of the next step when
        none is open)."""
        counters = self.current.counters if self.current is not None else self._pending_counts
        counters[name] = counters.get(name, 0) + n

    def end(self, start_ns: int) -> None:
        """Close the open step: its ``engine.step`` span, its kind (from
        the dispatches it counted) and phases, folded into ``step_stats``."""
        entry, self.current = self.current, None
        entry.host.append(("engine.step", start_ns, time.monotonic_ns()))
        prefilled, decoded = "prefill_rows" in entry.counters, "decode_steps" in entry.counters
        entry.kind = ("mixed" if decoded else "prefill") if prefilled else (
            "decode" if decoded else "idle")
        entry.phases = phase_seconds(entry)
        stats = self.step_stats
        for key in PHASE_KEYS:
            stats[key] += entry.phases[key[:-2]]
        stats["steps"] += 1
        self.entries.append(entry)

    # -- reading -------------------------------------------------------------
    def export(self) -> dict:
        """The ring and the clock, as plain values."""
        return {"steps": [e.to_dict() for e in self.entries], "clock_pair": list(self.clock_pair),
                "anchor_monotonic_ns": self._anchor[1]}
