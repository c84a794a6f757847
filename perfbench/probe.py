"""The harness's instrumentation around ``Engine.step``, from its own file.

``StepProbe`` replaces the engine's ``step`` with a wrapper that records,
for every step, its host wall interval, whether it prefilled, the decode
model steps it ran, the contexts of the lanes it decoded (read from the
scheduler before the step), the (chunk, context) of each row it
prefilled, and the running total of output tokens the pod has committed;
in the profiled slice also, for each distinct attention span of the
model, the KV tokens the step's attention reads. Everything is read from
the engine's public state: ``scheduler``, ``prefill_stats``,
``decode_stats`` and the sequences.

With ``arm`` the wrapper also profiles one slice of steps with
``torch.profiler`` (device activity only): it starts at a step boundary
after a device synchronisation, runs until the slice has lasted
``min_s`` and held a prefill and a decode step (or ``max_s``), and stops
after a synchronisation at a step boundary. So the kernels in the trace
are exactly those the slice's steps launched.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

#: seconds the profiler runs idle inside each edge of the slice: it keeps a
#: device record only when its time, mapped onto the host clock, lies
#: inside the trace, and that mapping can read kernels a few ms off
PAD_S = 0.05


@dataclass
class Step:
    t0: float
    t1: float
    prefill: bool
    decode_steps: int
    k: int
    lanes: list[int] = field(default_factory=list)
    rows: list[tuple[int, int]] = field(default_factory=list)
    tokens: int = 0
    in_slice: bool = False
    #: the engine had no ready work when the step ended (the loop then
    #: waits for arrivals)
    idle_after: bool = False
    #: in the profiled slice only, for each attention span of the model:
    #: at each model step j of the burst, the distinct KV tokens the
    #: decoding lanes' attention reads, each lane's last ``span`` positions
    #: at context lane + j (a token two lanes share counts once); and each
    #: prefill row's distinct cached tokens its first query sees (within
    #: span - 1 of it; a token an earlier row of the batch holds counts
    #: once)
    lane_kv_tokens: dict[Optional[int], tuple[int, ...]] = field(default_factory=dict)
    row_ctx_tokens: dict[Optional[int], list[int]] = field(default_factory=dict)

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    @property
    def decode_only(self) -> bool:
        return self.decode_steps > 0 and not self.prefill


@dataclass
class Slice:
    """A profiled slice: its steps' indices, its host interval, and every
    device activity record (name, start s, end s on the host clock)."""

    i0: int
    i1: int
    t0: float
    t1: float
    prof: object = None
    records: list[tuple[str, float, float]] = field(default_factory=list)
    #: seconds the engine loop spent stopping the profiler after the slice
    stop_s: float = 0.0


class StepProbe:
    def __init__(self, engine, spans: tuple[Optional[int], ...]):
        """``spans``: the model's distinct attention spans (None: the
        whole context)."""
        self.engine = engine
        self.spans = spans
        self.steps: list[Step] = []
        self._finished_tokens = 0
        self._orig = engine.step
        self._arm: Optional[tuple[float, float, float]] = None
        self.slice: Optional[Slice] = None
        engine.step = self._step

    def uninstall(self) -> None:
        self.engine.step = self._orig

    def reset(self) -> None:
        """Forget recorded steps (between traffic runs in one process)."""
        self.steps = []
        self.slice = None
        self._arm = None

    def arm(self, at: float, min_s: float, max_s: float) -> None:
        self._arm = (at, min_s, max_s)

    def _live_tokens(self) -> int:
        sch = self.engine.scheduler
        return sum(s.num_generated for group in (sch.running, sch.waiting, sch.prefilling)
                   for s in group)

    def _step(self):
        eng, sch = self.engine, self.engine.scheduler
        if self._arm is not None and self.slice is None and time.monotonic() >= self._arm[0]:
            self._start_slice()
        profiling = self.slice is not None and self.slice.i1 < 0
        lanes = [s.num_tokens for s in sch.running]
        k = eng.config.decode_steps_per_iter
        lane_kv = (_lane_kv_tokens(sch.running, lanes, eng.page_size, self.spans, k)
                   if profiling else {})
        pending = list(sch.waiting) + list(sch.prefilling)
        before = {id(s): s.num_prefilled for s in pending}
        n_pre = eng.prefill_stats["dispatches"]
        n_dec = eng.decode_stats["steps"]
        t0 = time.monotonic()
        finished = self._orig()
        t1 = time.monotonic()
        prefill = eng.prefill_stats["dispatches"] > n_pre
        dsteps = eng.decode_stats["steps"] - n_dec
        rows, row_seqs = [], []
        if prefill:
            for s in pending:
                if s.block_table and s.num_prefilled > before[id(s)]:
                    start = max(before[id(s)], s.num_cached_prompt)
                    rows.append((s.num_prefilled - start, start))
                    row_seqs.append(s)
        self._finished_tokens += sum(s.num_generated for s in finished)
        step = Step(t0, t1, prefill, dsteps, k, lanes if dsteps else [], rows,
                    self._finished_tokens + self._live_tokens(),
                    idle_after=not eng.has_ready_work,
                    lane_kv_tokens=lane_kv if dsteps else {})
        if profiling and rows:
            step.row_ctx_tokens = _row_ctx_tokens(row_seqs, [c for _, c in rows],
                                                  eng.page_size, self.spans)
        self.steps.append(step)
        sl = self.slice
        if sl is not None and sl.i1 < 0:
            step.in_slice = True
            self._maybe_stop_slice(t1)
        return finished

    def _start_slice(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        time.sleep(PAD_S)
        self.slice = Slice(i0=len(self.steps), i1=-1, t0=time.monotonic(), t1=0.0, prof=prof)

    def _maybe_stop_slice(self, now: float) -> None:
        import torch

        sl, (_, min_s, max_s) = self.slice, self._arm
        steps = self.steps[sl.i0:]
        full = any(s.prefill for s in steps) and any(s.decode_only for s in steps)
        if not ((now - sl.t0 >= min_s and full) or now - sl.t0 >= max_s):
            return
        torch.cuda.synchronize()
        sl.t1 = time.monotonic()
        sl.i1 = len(self.steps)
        time.sleep(PAD_S)
        sl.prof.stop()
        sl.stop_s = time.monotonic() - sl.t1

    def read_slice(self) -> Optional[Slice]:
        """The finished slice with its device records (None when none was
        profiled). Reads the trace, which takes a while: call it after the
        measured window."""
        sl = self.slice
        if sl is None or sl.i1 < 0:
            return None
        if sl.prof is not None:
            from torch.autograd import DeviceType

            recs = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                    for e in sl.prof.events()
                    if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
            sl.prof = None
            # The trace's clock has a base of its own: put its first record
            # at the first step's start. Only the idle gaps' labels read
            # these times against the host's; the metrics read durations.
            if recs:
                off = self.steps[sl.i0].t0 - min(a for _, a, _ in recs)
                sl.records = [(n, a + off, b + off) for n, a, b in recs]
        return sl


def _distinct_tokens(seqs, ranges: list[tuple[int, int]], page_size: int) -> list[int]:
    """For each of ``seqs`` in turn, the tokens of its positions [lo, hi)
    (``ranges``) not already counted: a page slot several sequences hold
    (a shared prefix) counts once, for the first that reads it. A window's
    edge may fall inside a page: slots are counted, not pages."""
    seen: dict[int, int] = {}  # page: bit mask of its slots counted
    full = (1 << page_size) - 1
    out = []
    for s, (lo, hi) in zip(seqs, ranges):
        first, last = lo // page_size, min(-(-hi // page_size), len(s.block_table))
        new = 0
        for i, page in enumerate(s.block_table[first:last], first):
            mask = full
            if i == first or i == last - 1:  # the range's edges may cut a page
                mask &= (full << max(lo - i * page_size, 0)) & (full >> max((i + 1) * page_size - hi, 0))
            fresh = mask & ~seen.get(page, 0)
            if fresh:
                new += fresh.bit_count()
                seen[page] = seen.get(page, 0) | fresh
        out.append(new)
    return out


def _lane_kv_tokens(seqs, ctx_lens: list[int], page_size: int, spans, k: int
                    ) -> dict[Optional[int], tuple[int, ...]]:
    """For each span, at each model step j < k of a burst: the distinct KV
    tokens the lanes at contexts ``ctx_lens`` + j read. Positions below a
    lane's context are read from its pages; the j positions it adds in the
    burst are its own, and counted as such."""
    memo: dict[tuple, int] = {}
    out = {}
    for span in spans:
        per_step = []
        for j in range(k):
            ranges = tuple((0 if span is None else max(0, n + j - span), n) for n in ctx_lens)
            if ranges not in memo:
                memo[ranges] = sum(_distinct_tokens(seqs, list(ranges), page_size))
            per_step.append(memo[ranges] + len(ctx_lens) * (j if span is None else min(j, span)))
        out[span] = tuple(per_step)
    return out


def _row_ctx_tokens(seqs, ctx_lens: list[int], page_size: int, spans
                    ) -> dict[Optional[int], list[int]]:
    """For each span, each prefill row's cached tokens that its first query
    sees (those within span - 1 of it) and no earlier row of the batch
    holds."""
    return {span: _distinct_tokens(
        seqs, [(0 if span is None else max(0, n - span + 1), n) for n in ctx_lens], page_size)
        for span in spans}


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``intervals`` as disjoint intervals, in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
