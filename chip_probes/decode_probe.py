"""The serving paths of ``chip_smoke.run_engine`` cut in depth: a short
first card call for new decode code. Run from the repo root:

    DEPTH=4 PATHS=llama_3_8b,qwen3_30b_a3b_int8 python chip_probes/decode_probe.py

It prints the toolchain, builds the kernels, runs each named path of
``chip_smoke.PATHS`` at ``DEPTH`` layers and full width (every check of
``run_engine`` applies), then the graph memory pools left allocated."""
import dataclasses, json, os, sys, time, traceback
sys.path.insert(0, os.getcwd())
import torch
print(json.dumps({"python": sys.version, "torch": torch.__version__, "cuda": torch.version.cuda,
                  "register_generator_state": hasattr(torch.cuda.CUDAGraph, "register_generator_state")}), flush=True)
import chip_smoke as cs
from llm_d_kv_cache_manager_tpu_torch import models, ops, server
from llm_d_kv_cache_manager_tpu_torch.kvcache import kvblock
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.server import decode_graphs, serve
card = cs.card_line(); print(card, flush=True)
t = time.perf_counter(); print("build", _build.build(), time.perf_counter() - t, flush=True)
depth = int(os.environ.get("DEPTH", "4"))
orig = serve._resolve_model
serve._resolve_model = lambda name: dataclasses.replace(orig(name), n_layers=depth)
pkg = {"models": models, "llama": llama, "server": server, "serve": serve, "kvblock": kvblock,
       "decode_graphs": decode_graphs}
dev = torch.device("cuda", 0)
for label in os.environ.get("PATHS", "llama_3_8b,qwen3_30b_a3b_int8").split(","):
    path = [p for p in cs.PATHS if p["label"] == label][0]
    t = time.perf_counter()
    try:
        cs.run_engine(pkg, ops, dev, card, path, {})
    except SystemExit:
        print("run_engine failed", label, flush=True)
    except Exception:
        traceback.print_exc()
    print("path", label, time.perf_counter() - t, flush=True)
    cs.free_cuda()
seg = torch.cuda.memory_snapshot()
print("snapshot keys", sorted(seg[0].keys()) if seg else None, flush=True)
print("pools", sorted({str(s.get("segment_pool_id")) for s in seg}), flush=True)
