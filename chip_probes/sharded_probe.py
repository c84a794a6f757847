"""The sharded paths of ``chip_smoke.py`` alone: a short card call for
sharded serving. Run from the repo root:

    DEPTH=32 PATHS=llama_3_8b,qwen3_30b_a3b python chip_probes/sharded_probe.py

On a machine with a card it prints the toolchain and the card, builds the
kernels, then runs ``chip_smoke.run_engine`` on each named entry of
``chip_smoke.PATHS`` (all by default) with only its ``sharded`` and
``sp_prefill`` phases after the tp=1 engine run, at ``DEPTH`` layers (the
presets' own depth by default), every gate applying (``KEEP_GOING=1``:
each failed gate is printed and the run goes on).

Without a card it rehearses the phase on the CPU with TINY_LLAMA standing
in for Llama-3.1-8B and a 16-expert TINY_QWEN3_MOE for Qwen3-30B-A3B, the
CUDA calls it makes stubbed and the profiles skipped, and prints each gate
that fails instead of exiting (a wrapper counts launches only on the card,
and decode bursts are graph replays only there, so those gates fail)."""
import dataclasses, json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
print(json.dumps({"python": sys.version, "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
import chip_smoke as cs
from llm_d_kv_cache_manager_tpu_torch import models, ops, server
from llm_d_kv_cache_manager_tpu_torch.kvcache import kvblock
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.server import decode_graphs, serve

pkg = {"models": models, "llama": llama, "server": server, "serve": serve, "kvblock": kvblock,
       "decode_graphs": decode_graphs}
orig = serve._resolve_model
if torch.cuda.is_available():
    card = cs.card_line(); print(card, flush=True)
    t = time.perf_counter(); print("build", _build.build(), time.perf_counter() - t, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if os.environ.get("KEEP_GOING"):
        cs.fail = lambda msg: print("GATE:", msg[:2000], flush=True)
    depth = os.environ.get("DEPTH")
    if depth:
        serve._resolve_model = lambda name: dataclasses.replace(orig(name), n_layers=int(depth))
else:
    print("no card: rehearsing on the CPU with tiny models", flush=True)
    card, dev = "cpu rehearsal", torch.device("cpu")
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    cs.fail = lambda msg: print("GATE:", msg[:400], flush=True)
    cs.cuda_time_ms = lambda fn, iters=20, warmup=3: (fn(), 0.0)[1]
    cs.reductions_ms = lambda mesh, cfg, dev, lanes=8: None
    cs.profile_decode = lambda eng, prompts, server, ops: {
        "device_idle_share": None, "step_wall_ms": None, "device_busy_ms_per_step": None,
        "top_kernels_ms_per_step": [], "skipped": True}
    tiny = {"meta-llama/Llama-3.1-8B-Instruct": models.TINY_LLAMA,
            "Qwen/Qwen3-30B-A3B": dataclasses.replace(models.TINY_QWEN3_MOE, n_experts=16)}
    serve._resolve_model = lambda name: tiny[name]
    torch.set_num_threads(4)
names = os.environ.get("PATHS")
keep = ("label", "model", "quantize", "kv_quant_hbm", "chunked_prefill", "sharded", "sp_prefill")
paths = [{k: v for k, v in p.items() if k in keep} for p in cs.PATHS
         if not names or p["label"] in names.split(",")]
t = time.perf_counter()
launches = {}
for path in paths:
    launches.update(cs.run_engine(pkg, ops, dev, card, path, {}))
    cs.free_cuda()
print(json.dumps({"launches_by_path": launches}), flush=True)
print("sharded seconds", time.perf_counter() - t, flush=True)
