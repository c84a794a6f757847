"""The two readings a cell's check limit is set from: the program's
widest served-token gap on many seeds, and the control's (the reference
in float8) on a few, all at the cell's own load and size, in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2 --seconds 20 \
        [--check-tokens N] [--dump DIR]

Each seed draws its weights into the same buffers (the pod and its graphs
are kept), runs the mix's ramp and a window, drains, and compares a
sample of the window's requests as a run does (``--check-tokens`` served
tokens, the cell's own by default). Prints one JSON line a seed, and for
the first seed how many sessions, requests and decode lanes the pod held
over the ramp and the window. With ``--dump`` each seed's gaps at every
compared position, per request in the order drawn, go to
``DIR/<seed>.json``, so that any statistic of them can be read again.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--check-tokens", type=int, default=0)
    ap.add_argument("--dump", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import check
    from perfbench.bench import Bench, set_environment
    from perfbench.spec import load_cell

    set_environment()
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    bench = Bench(cell, seeds[0], "cuda", T_START)
    print(json.dumps({"setup": bench.setup(bench.plan(seeds[0]))}), flush=True)
    tokens = args.check_tokens or cell.check_tokens
    if args.dump:
        Path(args.dump).mkdir(parents=True, exist_ok=True)
    for seed in seeds + sorted(controls - set(seeds)):
        bench.reseed(seed)
        run = bench.traffic(bench.plan(seed), args.seconds, trace=False)
        if seed == seeds[0]:
            print(json.dumps({"in_flight": in_flight(run)}), flush=True)
        picked = check.pick(run.sample, seed, tokens)
        out = {"seed": seed, "failed": sum(run.failed(r) for r in run.sample)}
        t = time.monotonic()
        served, ctl = check.gaps(bench.arch, bench.m, seed, picked, bench.device,
                                  control=seed in controls)
        if seed in seeds:
            out.update(check.numbers(served), tokens=sum(len(g) for g in served), requests=len(picked))
        if ctl:
            out.update({f"control_{k}": v for k, v in check.numbers(ctl).items()})
        out["reference_s"] = time.monotonic() - t
        print(json.dumps(out), flush=True)
        if args.dump:
            dump = {"seed": seed, "served": [g.tolist() for g in served],
                    "control": [g.tolist() for g in ctl]}
            (Path(args.dump) / f"{seed}.json").write_text(json.dumps(dump))
    bench.close()
    return 0


def in_flight(run, every: float = 5.0) -> list[list[float]]:
    """[seconds from the window's start, sessions in flight, requests in
    the pod, mean decode lanes] every ``every`` seconds from the ramp's
    start to the window's end. A session is in flight from its first
    turn's due time to its last served turn's finish."""
    spans: dict[int, list[float]] = {}
    for r in run.requests:
        end = r.seq.finish_time if r.seq is not None and r.seq.finish_time is not None else run.w1
        a, b = spans.get(r.session, (r.due, end))
        spans[r.session] = [min(a, r.due), max(b, end)]
    t0 = min((r.due for r in run.requests), default=run.w0)
    out, t = [], t0
    while t < run.w1:
        sessions = sum(a <= t < b for a, b in spans.values())
        in_pod = sum(r.submit_t is not None and r.submit_t <= t
                     and (r.seq is None or r.seq.finish_time is None or t < r.seq.finish_time)
                     for r in run.requests)
        lanes = [len(s.lanes) for s in run.steps if t <= s.t0 < t + every and s.decode_steps]
        out.append([round(t - run.w0, 3), sessions, in_pod,
                    round(sum(lanes) / len(lanes), 2) if lanes else 0.0])
        t += every
    return out


if __name__ == "__main__":
    sys.exit(main())
