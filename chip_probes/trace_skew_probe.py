"""Measures where ``torch.profiler`` places device kernels against the host
clock, and how often a window closed right after its closing sync lacks
kernel records. The profiler keeps a device record only when its
timestamps, mapped onto the host clock, lie between the host times the
trace started and stopped, so kernels near a window's edge can be lost
where that mapping is off. Run from the repo root on a card:

    BUDGET_S=240 PADS_MS=0,5,20,50 python chip_probes/trace_skew_probe.py

Each window opens the profiler, marks the host time with a
``record_function`` range, launches ``KERNELS`` tanh kernels at once,
syncs, marks the host time again and closes. Causality fixes the order:
the first kernel starts after the opening mark and the last one ends
before the closing mark. It prints, per ``BUCKET_S`` of process time, the
least ``lead_us`` (first kernel start minus the opening mark's end) and
``tail_us`` (closing mark's start minus the last kernel's end) the trace
shows, and the windows whose traced kernels are fewer than those launched.
A negative lead or tail is the device clock read off the host's by that
much. Windows take the pads of ``PADS_MS`` in turns: a pad is a host sleep
after the opening mark and after the closing sync, before the trace
stops; the summary gives each pad's windows and short windows. Between
windows a few matmuls keep the card busy."""
import json, os, sys, time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

budget = float(os.environ.get("BUDGET_S", "240"))
bucket_s = float(os.environ.get("BUCKET_S", "30"))
n_kernels = int(os.environ.get("KERNELS", "400"))
pads_ms = [float(v) for v in os.environ.get("PADS_MS", "0").split(",")]
if not torch.cuda.is_available():
    sys.exit("trace_skew_probe needs a card")
import subprocess
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
dev = torch.device("cuda", 0)
x = torch.randn(1 << 16, device=dev)
a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)


def window(pad_s: float) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("probe_open"):
            pass
        time.sleep(pad_s)
        y = x
        for _ in range(n_kernels):
            y = torch.tanh(y)
        torch.cuda.synchronize()
        with record_function("probe_close"):
            pass
        time.sleep(pad_s)
    evs = prof.events()
    opened = next(e for e in evs if e.name == "probe_open")
    closed = next(e for e in evs if e.name == "probe_close")
    k = [e for e in evs if e.device_type == DeviceType.CUDA and "tanh" in e.name]
    return {
        "traced": len(k),
        "lead_us": min(e.time_range.start for e in k) - opened.time_range.end if k else None,
        "tail_us": closed.time_range.start - max(e.time_range.end for e in k) if k else None,
    }


t0 = time.perf_counter()
rows, cur, i = [], None, 0
by_pad = {p: {"windows": 0, "short": 0, "min_lead_us": None} for p in pads_ms}
while time.perf_counter() - t0 < budget:
    b = int((time.perf_counter() - t0) // bucket_s)
    if cur is None or cur["bucket"] != b:
        if cur is not None:
            rows.append(cur)
            print(json.dumps(cur), flush=True)
        cur = {"bucket": b, "from_s": b * bucket_s, "windows": 0, "short": 0,
               "min_lead_us": None, "min_tail_us": None, "short_windows": []}
    pad = pads_ms[i % len(pads_ms)]
    i += 1
    r = window(pad / 1e3)
    cur["windows"] += 1
    by_pad[pad]["windows"] += 1
    by_pad[pad]["short"] += r["traced"] != n_kernels
    if r["lead_us"] is not None and (by_pad[pad]["min_lead_us"] is None
                                     or r["lead_us"] < by_pad[pad]["min_lead_us"]):
        by_pad[pad]["min_lead_us"] = r["lead_us"]
    for key in ("lead", "tail"):
        v = r[f"{key}_us"]
        if v is not None and (cur[f"min_{key}_us"] is None or v < cur[f"min_{key}_us"]):
            cur[f"min_{key}_us"] = v
    if r["traced"] != n_kernels:
        cur["short"] += 1
        if len(cur["short_windows"]) < 5:
            cur["short_windows"].append(dict(r, pad_ms=pad))
    for _ in range(20):
        a = (a @ a).clamp_(-1, 1)
    torch.cuda.synchronize()
rows.append(cur)
print(json.dumps(cur), flush=True)
print(json.dumps({"kernels_per_window": n_kernels, "seconds": time.perf_counter() - t0,
                  "windows": sum(r["windows"] for r in rows),
                  "short_windows": sum(r["short"] for r in rows),
                  "min_lead_us": min(r["min_lead_us"] for r in rows if r["min_lead_us"] is not None),
                  "min_tail_us": min(r["min_tail_us"] for r in rows if r["min_tail_us"] is not None),
                  "by_pad_ms": by_pad}),
      flush=True)
