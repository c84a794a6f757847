"""The disagg_tiers phase of ``chip_smoke.py`` cut in depth: a short first
card call for the pod's knob-gated fleet glue (disaggregated roles, the
remote tier, KV-block integrity, tenant QoS). Run from the repo root:

    DEPTH=4 python chip_probes/disagg_tiers_probe.py

On a machine with a card it prints the toolchain and the card, builds the
kernels and runs ``chip_smoke.disagg_tiers`` on Llama-3.1-8B at ``DEPTH``
layers and full width (every gate of the phase applies).

Without a card it rehearses the phase on the CPU at TINY_LLAMA, with the
CUDA calls it makes stubbed, and prints each gate that fails instead of
exiting (a wrapper counts only launches on the card, so the launch gates
fail there)."""
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
depth = int(os.environ.get("DEPTH", "4"))

if torch.cuda.is_available():
    card = cs.card_line(); print(card, flush=True)
    t = time.perf_counter(); print("build", _build.build(), time.perf_counter() - t, flush=True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(llama.LLAMA_3_8B, n_layers=depth)
else:
    print("no card: rehearsing on the CPU at TINY_LLAMA", flush=True)
    card, dev = "cpu rehearsal", torch.device("cpu")
    for name in ("synchronize", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    cs.fail = lambda msg: print("GATE:", msg, flush=True)
    cfg = llama.TINY_LLAMA
    torch.set_num_threads(2)
params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
t = time.perf_counter()
# On a card a failed gate exits non-zero (``chip_smoke.fail``); on the CPU
# it is printed and the phase goes on.
steps, launches = cs.disagg_tiers(pkg, ops, dev, card, params, cfg)
for step in steps:
    cs.emit(step)
print("disagg_tiers seconds", time.perf_counter() - t, flush=True)
