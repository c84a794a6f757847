"""Hunts kernel records missing from ``torch.profiler`` windows: the launch
gate of ``chip_smoke.profile_window`` (the wrappers' counts over a profiled
window must equal the kernels the trace shows) once read 508 of 512 K1
and ``combine_kernel`` launches in a window of four pipelined k=4 graph
bursts at Llama-3.1-8B's 32 layers. Run from the repo root on a card:

    DEPTH=32 BUDGET_S=240 python chip_probes/trace_window_probe.py

It serves 8 lanes of 256-token prompts through an engine with the decode
fast path (``chip_smoke.FAST_KNOBS``), as ``profile_decode`` does, and
profiles windows of 4 engine steps in turns under two forms until the
budget is spent:

- ``edge``: the form ``profile_window`` had — the steps, a device sync,
  the window closed at once;
- ``padded``: the window opened ``PAD_S`` before the first step and closed
  ``PAD_S`` after the closing sync, so no kernel runs near either edge.

For each form it prints the windows profiled and those whose traced counts
differ from the wrappers' counts, and for each differing window where the
traced K1 kernels lie: how many each burst shows (bursts split at gaps over
0.5 ms) and how far the first and last kernel of the window lie from the
window's edges (from the profiler's own clock)."""
import collections, dataclasses, json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
print(json.dumps({"python": sys.version, "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
import chip_smoke as cs
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from llm_d_kv_cache_manager_tpu_torch import models, ops, server
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops import _build

depth = int(os.environ.get("DEPTH", "32"))
budget = float(os.environ.get("BUDGET_S", "240"))
pad = float(os.environ.get("PAD_S", "0.02"))
steps = 4
if not torch.cuda.is_available():
    sys.exit("trace_window_probe needs a card")
print(cs.card_line(), flush=True)
print("build", _build.build(), flush=True)
dev = torch.device("cuda", 0)
cfg = dataclasses.replace(llama.LLAMA_3_8B, n_layers=depth)
params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
eng = server.Engine(server.EngineConfig(
    model=cfg, block_manager=server.BlockManagerConfig(total_pages=4096, page_size=16),
    max_model_len=4096, decode_batch_size=8, seed=0, **cs.FAST_KNOBS), params=params, device=dev)
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, 256).tolist() for _ in range(8)]


def fill():
    eng.abort_all()
    seqs = [eng.add_request(p, server.SamplingParams(max_new_tokens=200)) for p in prompts]
    while any(s.num_generated == 0 for s in seqs):
        eng.step()
    eng.step()
    eng.step()
    return seqs


def window(form: str) -> dict:
    before = {n: w.launches for n, w in ops.COUNTED.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if form == "padded":
            time.sleep(pad)
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        if form == "padded":
            time.sleep(pad)
    counted = {n: w.launches - before[n] for n, w in ops.COUNTED.items()}
    counted["combine_kernel"] = counted["paged_decode"] + counted["paged_decode_int8"]
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    traced = {n: sum(e.count for e in device if any(p in e.key for p in cs.TRACED[n]))
              for n in cs.TRACED}
    traced["combine_kernel"] = sum(e.count for e in device if "::combine_kernel" in e.key)
    out = {"counted": counted, "traced": traced, "equal": counted == traced}
    if not out["equal"]:
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        k1 = sorted(e.time_range.start for e in evs if "split_decode_kernel" in e.name)
        bursts, last = [], None
        for t in k1:
            if last is None or t - last > 500:
                bursts.append(0)
            bursts[-1] += 1
            last = t
        starts = [e.time_range.start for e in evs]
        ends = [e.time_range.end for e in evs]
        cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        out["k1_per_burst"] = bursts
        out["cuda_events"] = len(evs)
        out["first_cuda_us"] = min(starts) if starts else None
        out["last_cuda_end_us"] = max(ends) if ends else None
        out["last_cpu_end_us"] = max((e.time_range.end for e in cpu), default=None)
    return out


seqs = fill()
keys = eng.decode_graphs.keys
stats = collections.defaultdict(lambda: {"windows": 0, "differ": 0, "details": []})
t0 = time.perf_counter()
i = 0
while time.perf_counter() - t0 < budget:
    # Refill before a lane's table outgrows its width bucket (a capture
    # inside a window would launch what its replays count) or it finishes.
    if any(s.num_tokens > 470 for s in seqs):
        seqs = fill()
    form = ("edge", "padded")[i % 2]
    i += 1
    keys_before = eng.decode_graphs.keys
    r = window(form)
    if eng.decode_graphs.keys != keys_before:
        stats["captured_in_window"]["windows"] += 1
        continue
    st = stats[form]
    st["windows"] += 1
    if not r["equal"]:
        st["differ"] += 1
        if len(st["details"]) < 20:
            st["details"].append(r)
        print(json.dumps({"form": form, **r}), flush=True)
print(json.dumps({"depth": depth, "steps_per_window": steps, "pad_s": pad,
                  "graph_keys_changed": eng.decode_graphs.keys != keys,
                  "seconds": time.perf_counter() - t0,
                  "forms": {f: {k: v for k, v in s.items() if k != "details"}
                            for f, s in stats.items()}}), flush=True)
