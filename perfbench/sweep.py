"""Find a cell's knee: the highest session rate at which at least 90 % of
the requests meet both of the mix's latency limits with no growing
backlog. One process, one pod; each rate runs the mix's ramp and a window
on a seed of its own, and drains before the next.

    python3 perfbench/sweep.py --workload <cell> --seed <n> --rates 0.5,1,1.5 --seconds 40

Prints one JSON line a rate. The knee found goes into the cell's file (at
0.8 of it) by hand, once.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def summary(run) -> dict:
    from perfbench.readers import tpot_s, ttft_s
    from perfbench.spec import metric
    from perfbench.stats import percentile

    lim = run.cell.mix["limits"]
    sample = run.sample
    ttft = [ttft_s(run, r) for r in sample]
    tpot = [tpot_s(run, r) for r in sample]
    met = sum(a <= lim["ttft_ms"] / 1e3 and b <= lim["tpot_ms"] / 1e3 for a, b in zip(ttft, tpot))
    half = len(sample) // 2
    by_due = sorted(zip((r.due for r in sample), ttft))
    first = [t for _, t in by_due[:half]]
    second = [t for _, t in by_due[half:]]
    return {
        "requests": len(sample),
        "failed": sum(run.failed(r) for r in sample),
        "met_share": met / len(sample) if sample else 0.0,
        "ttft_p50_ms": 1e3 * percentile(ttft, 50),
        "ttft_p95_ms": 1e3 * percentile(ttft, 95),
        "tpot_p50_ms": 1e3 * percentile(tpot, 50),
        "tpot_p95_ms": 1e3 * percentile(tpot, 95),
        "ttft_p50_ms_first_half": 1e3 * percentile(first, 50) if first else None,
        "ttft_p50_ms_second_half": 1e3 * percentile(second, 50) if second else None,
        "output_tok_per_s": metric("output_tok_per_s").read(run),
        "generator_max_lag_s": run.max_lag_s,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.bench import Bench, set_environment
    from perfbench.spec import load_cell

    set_environment()
    cell = load_cell(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    bench = Bench(cell, args.seed, "cuda", T_START)
    split = bench.setup(bench.plan(args.seed, max(rates)))
    print(json.dumps({"setup": split}), flush=True)
    for i, rate in enumerate(rates):
        seed = args.seed + i
        run = bench.traffic(bench.plan(seed, rate), args.seconds, trace=False)
        print(json.dumps({"rate": rate, "seed": seed, **summary(run)}), flush=True)
    bench.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
