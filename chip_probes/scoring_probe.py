"""The scoring phase of ``chip_smoke.py`` cut in depth: a short first card
call for scoring-plane code. Run from the repo root:

    DEPTH=4 python chip_probes/scoring_probe.py

On a machine with a card it prints the toolchain and the card, builds the
kernels, holds both int8 scale divisions on the card against the CPU
(``chip_smoke.division_checks`` on Llama-3.1-8B's layer 0 and one prefill
at ``DEPTH`` layers), then runs ``chip_smoke.scoring`` on Llama-3.1-8B at
``DEPTH`` layers and full width (every gate of the phase applies).

Without a card it rehearses both on the CPU at TINY_LLAMA (prompts drawn
from its 256 ids), with the CUDA calls they make stubbed, and prints each
gate that fails instead of exiting (the launch-count gate fails there: a
wrapper counts only launches on the card)."""
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
    cs.CHAR_IDS = (0x20, llama.TINY_LLAMA.vocab_size)
    cfg = llama.TINY_LLAMA
params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
prompt = torch.randint(0, cfg.vocab_size, (1024,), generator=torch.Generator().manual_seed(1)).tolist()
t = time.perf_counter()
eng = type("Params", (), {"params": params})()
cs.emit({"int8_division_card_vs_cpu": cs.division_checks(llama, eng, cfg, prompt, 16, dev),
         "seconds": time.perf_counter() - t})
t = time.perf_counter()
try:
    result, launches = cs.scoring(pkg, ops, dev, card, params, cfg)
    cs.emit(result)
except SystemExit:
    print("scoring failed", flush=True)
print("scoring seconds", time.perf_counter() - t, flush=True)
