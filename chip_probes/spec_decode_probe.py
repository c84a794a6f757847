"""The spec_decode phase of ``chip_smoke.py`` and K2's forms, alone: a short
card call for speculative decoding. Run from the repo root:

    DEPTH=32 python chip_probes/spec_decode_probe.py

On a machine with a card it prints the toolchain and the card, builds the
kernels, holds K2 in every ``chip_smoke.PREFILL_FORMS`` form (the
``spec_verify`` form among them) and runs ``chip_smoke.spec_decode`` on
Llama-3.1-8B at ``DEPTH`` layers and full width (every gate of the phase
applies).

Without a card it rehearses the phase on the CPU at TINY_LLAMA (vocabulary
4,096), with the CUDA calls it makes stubbed and the profiles skipped, and
prints each gate that fails instead of exiting (a wrapper counts only
launches on the card, so the launch gates fail there)."""
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
depth = int(os.environ.get("DEPTH", "32"))

if torch.cuda.is_available():
    card = cs.card_line(); print(card, flush=True)
    t = time.perf_counter(); print("build", _build.build(), time.perf_counter() - t, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.emit(cs.check_flash_prefill(ops, dev, torch.Generator(device=dev).manual_seed(cs.SEED)))
    cs.free_cuda()
    cfg = dataclasses.replace(llama.LLAMA_3_8B, n_layers=depth)
else:
    print("no card: rehearsing on the CPU at TINY_LLAMA", flush=True)
    card, dev = "cpu rehearsal", torch.device("cpu")
    for name in ("synchronize", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    cs.fail = lambda msg: print("GATE:", msg, flush=True)
    cs.profile_window = lambda step, steps, model_steps, counted: (step(), {"skipped": True})[1]
    cs.profile_decode = lambda eng, prompts, server_, ops_: {"skipped": True}
    cfg = dataclasses.replace(llama.TINY_LLAMA, vocab_size=4096)
    torch.set_num_threads(2)
params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev)
t = time.perf_counter()
result, launches = cs.spec_decode(pkg, ops, dev, card, params, cfg)
cs.emit(dict(result, launches=launches))
print("spec_decode seconds", time.perf_counter() - t, flush=True)
