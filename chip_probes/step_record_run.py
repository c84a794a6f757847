"""One benchmark run with the port's step record on or off, its metrics and
its clock checks.

    python3 chip_probes/step_record_run.py --workload <cell> --seed <n> \\
        --seconds 51 --trace <0|1> --record <0|1> [--out <file.json>]

Runs the cell as ``perfbench/run.py`` does and prints the same result line.
With ``--record 1`` the engine's step telemetry (``Engine.obs_step_timing``,
``server/step_record.py``) is switched on before warm-up, so the MoE's
decode graphs capture the expert-group counter; the record is anchored again
where the profiled slice starts; the run carries the record (``program``)
and the slice the profiler's own base (``trace_start_ns``, wall clock) and
raw record offsets (``raw_records``), which ``perfbench/program.py`` reads.
A traced run then also reads the metrics of ``NEW`` beside the cell's own,
and ``--out`` gets the checks of the record against the profiler and the
harness: each burst's ``device.decode`` span against the profiler's records
of it, both placed by the program's clock; the earliest record of each step
against its first launch span; how far the probe's own placement (its first
record at the slice's first step) lies from the program's; the idle split by
innermost span; and the total wall of the window's decode-only steps by the
program's spans and by the harness's wrapper.

A stopgap, not a second harness: its hooks are the two edits that
``perfbench/bench.py`` (the switch before warm-up, ``Run.program``) and
``perfbench/probe.py`` (the profiler's base and raw offsets on ``Slice``)
still lack. It is deleted when those two files make them, and it is not to
grow beyond them.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the metrics that read the step record, with their units
NEW = {"decode_device_ms": "ms", "prefill_pad_share": "%", "k4_decode_roofline": "%",
       "idle_share.loop": "%", "idle_share.prefill_host": "%", "idle_share.decode_host": "%",
       "idle_share.step_host": "%", "preempted_share": "%", "commit_gap_ms_p95": "ms"}
LAST: dict = {}


def install(record: bool) -> None:
    """Hook the harness: the switch before warm-up, the anchor at the
    slice, the profiler's base kept, the record carried by the run."""
    from perfbench import bench, pod, probe

    build = pod.build_pod

    def build_pod(*a, **kw):
        server, engine = build(*a, **kw)
        engine.obs_step_timing = record
        return server, engine

    pod.build_pod = build_pod
    start = probe.StepProbe._start_slice

    def start_slice(self):
        if self.engine.step_record is not None:
            self.engine.step_record.anchor()
        start(self)

    probe.StepProbe._start_slice = start_slice
    read = probe.StepProbe.read_slice

    def read_slice(self):
        sl, base, raw = self.slice, None, None
        if sl is not None and sl.i1 >= 0 and sl.prof is not None:
            from torch.autograd import DeviceType

            base = sl.prof.profiler.kineto_results.trace_start_ns()
            raw = [(e.name, e.time_range.start, e.time_range.end) for e in sl.prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        out = read(self)
        if out is not None and raw is not None:
            out.trace_start_ns, out.raw_records = base, raw
        return out

    probe.StepProbe.read_slice = read_slice
    traffic = bench.Bench.traffic

    def run_traffic(self, plan, seconds, trace):
        run = traffic(self, plan, seconds, trace)
        rec = self.engine.step_record
        run.program = rec.export() if rec is not None else None
        LAST["run"] = run
        return run

    bench.Bench.traffic = run_traffic


def _matched(recs, starts, a: float, b: float) -> list:
    """Records (in order of start, ``starts`` their starts) whose midpoint
    lies in [a, b]."""
    lo, hi = bisect.bisect_left(starts, a - 0.05), bisect.bisect_right(starts, b)
    return [r for r in recs[lo:hi] if a <= (r[1] + r[2]) / 2 <= b]


def checks(run) -> dict:
    """The record against the profiler and the harness (module docstring)."""
    from perfbench import program

    out: dict = {}
    prog = program.record(run)
    if prog is None:
        return out
    win = program.window_entries(run)
    harness = sum(s.wall for s in run.window_steps if s.decode_only)
    prog_wall = sum(b - a for e in win if e["kind"] == "decode"
                    for a, b in [program.step_interval(e)])
    out["decode_only_wall_s"] = {"harness": harness, "program": prog_wall,
                                 "program_over_harness": prog_wall / harness if harness else None}
    out["steps_recorded"] = len(prog["steps"])
    recs = program.mapped_records(run)
    ents = program.slice_entries(run)
    if recs is None or not ents:
        return out
    sl = run.slice
    recs = sorted(recs, key=lambda r: r[1])
    starts_all = [r[1] for r in recs]
    starts, ends, lead = [], [], []
    kinds = {"device.decode": ([], [])}
    for e in ents:
        launch = min((a for name, a, _ in e["host"] if name.endswith(".launch")), default=None)
        for name, a, b in e["device"]:
            a, b = a / 1e9, b / 1e9
            m = _matched(recs, starts_all, a, b)
            if not m:
                continue
            kinds[name][0].append(1e3 * (m[0][1] - a))
            kinds[name][1].append(1e3 * (max(r[2] for r in m) - b))
            if launch is not None:
                lead.append(1e3 * (m[0][1] - launch / 1e9))
    for name, (starts, ends) in kinds.items():
        if starts:
            absd = [abs(x) for x in starts + ends]
            out[name + "_vs_records_ms"] = {
                "spans": len(starts), "median_abs": statistics.median(absd), "max_abs": max(absd),
                "start_median": statistics.median(starts), "start_max": max(starts),
                "start_min": min(starts), "end_median": statistics.median(ends),
                "end_max_abs": max(abs(x) for x in ends)}
    out["earliest_record_after_launch_ms"] = min(lead) if lead else None
    raw0 = min(r[1] for r in sl.raw_records) / 1e6
    off_probe = run.steps[sl.i0].t0 - raw0
    off_prog = recs[0][1] - raw0
    out["probe_minus_program_ms"] = 1e3 * (off_probe - off_prog)
    split = program.idle_by_span(run)
    if split is not None:
        idle, working = split
        busy = sum(b - a for a, b in program.merge(
            [(max(a, sl.t0), min(b, sl.t1)) for _, a, b in recs if b > sl.t0 and a < sl.t1]))
        groups: dict = {}
        for name, s in idle.items():
            groups[program.group_of(name)] = groups.get(program.group_of(name), 0.0) + s
        out["idle_split"] = {
            "working_s": working, "busy_s": busy,
            "idle_share_remapped_pct": 100 * (working - busy) / working,
            "groups_pct": {g: 100 * s / working for g, s in groups.items()},
            "step_self_share_of_idle_pct": 100 * idle.get("engine.step", 0.0) / max(sum(idle.values()), 1e-12),
            "by_span_ms": {k: 1e3 * v for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}}
    touched = [n for e in ents for n in e["counters"].get("k4_touched", [])]
    if touched:
        out["k4_touched_per_layer_mean"] = statistics.mean(touched) / run.m.layers
        out["k4_decode_model_steps"] = len(touched)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench import run as run_mod
    from perfbench import spec
    from perfbench.bench import set_environment

    set_environment()
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    install(bool(args.record))
    have = {m["name"] for m in cell.per_layer}
    cell.per_layer += [{"name": n, "unit": u} for n, u in NEW.items() if n not in have]
    rc = run_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    run = LAST.get("run")
    found = checks(run) if run is not None else {}
    found.update(workload=args.workload, seed=args.seed, trace=args.trace, record=args.record)
    print("record_checks " + json.dumps(found), file=sys.stderr, flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(found, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
