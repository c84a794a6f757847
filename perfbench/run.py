"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the repository root, on a machine with the cell's NVIDIA GPUs. Sets
up the cell's pod (kernels from ``build/kernels/``, weights drawn on the
card from the seed, a started ``PodServer``, every shape the traffic
reaches served once), runs the traffic's ramp, measures ``--seconds``,
drains, frees the program and checks a sample of what it served against
the plain reference. With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (a
slice at the end of the window profiled with ``torch.profiler``). Earlier
lines on standard error give the set-up's parts, the sample counts and
how late the generator ran; the last lines there, and the result's last
key, each number compared beside its limit. Exits non-zero with no result
line when the card or the program is missing, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: nvidia-smi unavailable ({e})"
    return "card: " + out.stdout.strip().replace("\n", "; ")


def _name(kernel: str) -> str:
    return kernel if len(kernel) <= 120 else kernel[:117] + "..."


def breakdown(run) -> dict:
    """The slice's device operations that took most time, and its longest
    idle gaps labelled by the kind of engine step the host was in."""
    from perfbench.probe import merge

    sl = run.slice
    by_name: dict[str, float] = {}
    for name, a, b in sl.records:
        by_name[_name(name)] = by_name.get(_name(name), 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    merged = merge([(a, b) for _, a, b in sl.records])
    edges = [sl.t0] + [x for ab in merged for x in ab] + [sl.t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    steps = run.slice_steps

    def label(t: float) -> str:
        for s in steps:
            if s.t0 <= t < s.t1:
                return "prefill step" if s.prefill else "decode step" if s.decode_steps else "other step"
        return "between steps"

    longest = sorted(gaps, key=lambda ab: ab[0] - ab[1])[:10]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[label((a + b) / 2), b - a] for a, b in longest]}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             out=None, err=None) -> int:
    import torch

    from perfbench import check
    from perfbench.bench import Bench, forbidden_modules
    from perfbench.spec import metric

    out, err = out or sys.stdout, err or sys.stderr

    def note(**kv) -> None:
        print(json.dumps(kv), file=err, flush=True)

    bench = Bench(cell, seed, device, t_start)
    plan = bench.plan(seed)
    split = bench.setup(plan)
    run = bench.traffic(plan, seconds, trace)
    split["ramp_s"] = cell.mix["ramp_s"]
    peak = bench.memory_peak()
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run's process: {bad}", file=err)
        bench.close()
        return 3
    metrics, missing = {}, []
    for entry in cell.per_layer if trace else cell.end_to_end:
        value = metric(entry["name"], cell.root).read(run)
        if value is None:
            missing.append(entry["name"])
        elif not math.isfinite(value):
            print(f"{entry['name']} cannot be read: too many of the window's requests failed",
                  file=err)
            bench.close()
            return 4
        else:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    sample = run.sample
    failed = sum(run.failed(r) for r in sample)
    dev = {"platform": "gpu" if bench.device.type == "cuda" else bench.device.type,
           "kind": torch.cuda.get_device_name(bench.device) if bench.device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    extra = {}
    if trace and run.slice is not None:
        from perfbench.probe import merge

        recs = run.slice.records
        dev["busy_s"] = sum(b - a for a, b in merge([(a, b) for _, a, b in recs]))
        dev["window_s"] = run.slice.t1 - run.slice.t0
        extra["breakdown"] = breakdown(run)
        k1 = sum(1 for name, _, _ in recs if "split_decode_kernel" in name)
        note(profiled_slice={
            "seconds": dev["window_s"], "steps": len(run.slice_steps), "records": len(recs),
            "profiler_stop_s": run.slice.stop_s,
            "decode_model_steps": sum(s.decode_steps for s in run.slice_steps),
            "k1_split_kernels_traced": k1,
            "k1_split_kernels_expected": bench.m.layers * sum(s.decode_steps for s in run.slice_steps if s.lanes)})
    note(card=card_line() if bench.device.type == "cuda" else "cpu")
    note(setup_split=split, setup_s=run.setup_s)
    note(sample={"due_in_window": len(sample), "failed": failed,
                 "submitted_all": len(run.requests),
                 "output_tokens_in_sample": sum(r.answer_len for r in sample)},
         generator_max_lag_s=run.max_lag_s, captures_in_window=run.captures_in_window,
         kv_event_messages=bench.sink.messages, metrics_not_read=missing)
    bench.close()
    t = time.monotonic()
    chk = bench.check(run, seed)
    checks = {name: {"value": chk[name], "limit": limit} for name, limit in cell.check.items()}
    held = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    correct = bool(sample) and failed == 0 and held
    note(check_s=time.monotonic() - t, compared_tokens=chk["tokens"], compared_requests=chk["requests"],
         **{k: chk[k] for k in check.NUMBERS})
    checks["failed_requests"] = {"value": failed, "limit": 0}
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    result = {"correct": correct, "attempted": len(sample), "failed": failed,
              "metrics": metrics, "device": dev, **extra, "checks": checks}
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import spec
    from perfbench.bench import set_environment

    set_environment()

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return 2
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)


if __name__ == "__main__":
    sys.exit(main())
