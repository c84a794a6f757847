"""What the metrics' readers share: per-request latencies from the pod's
own stamps, the profiled slice's kernel time, and the kernel-work sums."""

from __future__ import annotations

import bisect
import math
from typing import Optional

from .probe import merge


def ttft_s(run, r) -> float:
    """First-token time less the time the request was due; a failed
    request misses every limit (``inf``)."""
    if run.failed(r) or r.seq.first_token_time is None:
        return math.inf
    return r.seq.first_token_time - r.due


def tpot_s(run, r) -> float:
    if run.failed(r):
        return math.inf
    s = r.seq
    return (s.finish_time - s.first_token_time) / max(s.num_generated - 1, 1)


def kernel_s(run, patterns: tuple[str, ...]) -> float:
    """Device seconds of the slice's records whose name holds a pattern."""
    if run.slice is None:
        return 0.0
    return sum(b - a for name, a, b in run.slice.records if any(p in name for p in patterns))


def roofline_pct(run, patterns: tuple[str, ...], bound: float) -> Optional[float]:
    """``bound`` (the least seconds the slice's calls need) over the
    device seconds of the kernels named, in percent; None without both."""
    t = kernel_s(run, patterns)
    if t <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / t


def busy_and_working_s(run) -> tuple[float, float]:
    """(seconds the card ran anything in the profiled slice, seconds of the
    slice in which the engine had work). The slice starts and ends at a
    step boundary after a device synchronisation, so every record in it
    was launched by its steps. After a step that ended with no work ready
    the loop waits for arrivals; the card may still run what the step
    launched (a pipelined decode burst), so only the part of each such
    wait in which no record runs is left out."""
    sl, steps = run.slice, run.slice_steps
    if sl is None or not steps:
        return 0.0, 0.0
    busy = merge([(a, b) for _, a, b in sl.records])
    waits = [(s.t1, nxt.t0) for s, nxt in zip(steps, steps[1:]) if s.idle_after]
    idle_waiting = sum((b - a) - covered(a, b, busy) for a, b in waits if b > a)
    return sum(b - a for a, b in busy), (sl.t1 - sl.t0) - idle_waiting


def covered(a: float, b: float, intervals: list[tuple[float, float]]) -> float:
    """Seconds of [a, b] that ``intervals`` (disjoint, in order) cover."""
    i = max(bisect.bisect_right(intervals, (a, math.inf)) - 1, 0)
    out = 0.0
    for x, y in intervals[i:]:
        if x >= b:
            break
        out += max(0.0, min(y, b) - max(x, a))
    return out
