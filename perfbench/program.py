"""What the readers of the program's own step record share.

The port's engine keeps a step record when its step telemetry is on
(``Engine.obs_step_timing``; ``server/step_record.py``): every step's
host spans, device spans and counters on ``time.monotonic_ns()``, the
clock of the harness's own stamps, and one ``(time.time_ns(),
time.monotonic_ns())`` pair. A run carries the record's ``export()`` as
``run.program``, and a profiled slice may carry the profiler's own base
(``trace_start_ns``, wall clock) and its records' raw offsets
(``raw_records``: name, start and end in microseconds from that base).
Everything here returns None for a run without them (a program without the
record, or a run that did not keep it), and never raises for that.
"""

from __future__ import annotations

from typing import Optional

from .probe import merge

#: the host spans whose idle time each ``idle_share.<group>`` reads (the
#: innermost open span decides; ``step_host`` takes the step's own time
#: outside its children); ``loop`` reads the rest: the pod loop's spans and
#: any instant outside a step
GROUPS = {
    "prefill_host": ("engine.drain", "engine.prefill.prepare", "engine.prefill.launch",
                     "engine.prefill.sample", "engine.prefill.commit"),
    "decode_host": ("engine.decode.launch", "engine.decode.wait", "engine.decode.commit"),
    "step_host": ("engine.schedule", "engine.host_prefetch", "engine.publish", "engine.step"),
}


def record(run) -> Optional[dict]:
    prog = getattr(run, "program", None)
    return prog if prog and prog.get("steps") else None


def step_interval(entry: dict) -> tuple[float, float]:
    """The ``engine.step`` span of an entry, in monotonic seconds."""
    for name, a, b in entry["host"]:
        if name == "engine.step":
            return a / 1e9, b / 1e9
    raise ValueError(f"step {entry['index']} has no engine.step span")


def window_entries(run) -> Optional[list[dict]]:
    """Entries of steps wholly inside the measured window and outside the
    profiled slice (as ``Run.window_steps`` takes the harness's steps)."""
    prog = record(run)
    if prog is None:
        return None
    sl = run.slice
    out = []
    for e in prog["steps"]:
        a, b = step_interval(e)
        if run.w0 <= a and b <= run.w1 and not (sl is not None and sl.t0 <= b and a <= sl.t1):
            out.append(e)
    return out


def slice_entries(run) -> Optional[list[dict]]:
    """Entries of steps inside the profiled slice."""
    prog, sl = record(run), run.slice
    if prog is None or sl is None:
        return None
    return [e for e in prog["steps"] if sl.t0 <= step_interval(e)[0] and step_interval(e)[1] <= sl.t1]


def mapped_records(run) -> Optional[list[tuple[str, float, float]]]:
    """The slice's device records placed by the program's clock pair:
    the profiler's base is the wall clock, the pair takes it to monotonic
    seconds."""
    prog, sl = record(run), run.slice
    base = getattr(sl, "trace_start_ns", None)
    raw = getattr(sl, "raw_records", None)
    if prog is None or base is None or raw is None:
        return None
    wall, mono = prog["clock_pair"]
    off = (base - (wall - mono)) / 1e9
    return [(n, off + a / 1e6, off + b / 1e6) for n, a, b in raw]


def idle_by_span(run) -> Optional[tuple[dict, float]]:
    """({innermost open host span: idle seconds}, seconds with work) over
    the profiled slice, on the program's clock. The time with work is the
    slice less the part of each wait for arrivals in which no record runs
    (as ``idle_share.steps`` takes it); each idle instant of it (no record
    running) goes to the innermost host span open then, ``"outside"`` when
    none is (the pod loop between its spans)."""
    recs, prog = mapped_records(run), record(run)
    if recs is None or not run.slice_steps:
        return None
    sl, steps = run.slice, run.slice_steps
    busy = merge([(max(a, sl.t0), min(b, sl.t1)) for _, a, b in recs if b > sl.t0 and a < sl.t1])
    waits = merge([(s.t1, nxt.t0) for s, nxt in zip(steps, steps[1:])
                   if s.idle_after and nxt.t0 > s.t1])
    spans = sorted((a / 1e9, b / 1e9, name) for e in prog["steps"] for name, a, b in e["host"]
                   if b / 1e9 > sl.t0 and a / 1e9 < sl.t1)
    cuts = sorted({sl.t0, sl.t1} | {x for ab in busy + waits for x in ab}
                  | {x for a, b, _ in spans for x in (a, b)})
    cuts = [c for c in cuts if sl.t0 <= c <= sl.t1]
    out: dict[str, float] = {}
    waiting, open_, j, ib, iw = 0.0, [], 0, 0, 0
    for a, b in zip(cuts, cuts[1:]):
        # Every edge is a cut: a piece lies wholly in or out of each set.
        mid = (a + b) / 2
        while j < len(spans) and spans[j][0] <= mid:
            open_.append(spans[j])
            j += 1
        open_ = [s for s in open_ if s[1] > mid]
        ib = _advance(busy, ib, mid)
        if ib < len(busy) and busy[ib][0] <= mid:
            continue
        iw = _advance(waits, iw, mid)
        if iw < len(waits) and waits[iw][0] <= mid:
            waiting += b - a
            continue
        # The innermost: the latest to open (the shorter on a tie).
        inner = max(open_, key=lambda s: (s[0], -s[1]))[2] if open_ else "outside"
        out[inner] = out.get(inner, 0.0) + (b - a)
    return out, (sl.t1 - sl.t0) - waiting


def _advance(intervals: list, i: int, t: float) -> int:
    """The first of ``intervals`` (disjoint, in order) from ``i`` on that
    ends after ``t``."""
    while i < len(intervals) and intervals[i][1] <= t:
        i += 1
    return i


def group_of(span: str) -> str:
    """The ``idle_share.<group>`` an innermost span's idle time goes to."""
    for group, names in GROUPS.items():
        if span in names:
            return group
    return "loop"


def idle_share(run, group: str) -> Optional[float]:
    split = idle_by_span(run)
    if split is None or split[1] <= 0:
        return None
    idle, working = split
    return 100.0 * sum(s for name, s in idle.items() if group_of(name) == group) / working


def commit_gaps_s(seq) -> Optional[list[float]]:
    """Each output token after the first: the time since the request's
    previous commit (0 for a token committed with the one before it)."""
    times = getattr(seq, "commit_times", None)
    if not times:
        return None
    out = [0.0] * (times[0][1] - 1)
    for (t_prev, _), (t, n) in zip(times, times[1:]):
        out += [(t - t_prev) / 1e9] + [0.0] * (n - 1)
    return out
