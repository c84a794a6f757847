"""The training phase of ``chip_smoke.py`` and K4^T / K6 (the grouped
matmul's backward), alone: a short card call for training. Run from the
repo root:

    python chip_probes/train_probe.py

On a machine with a card it prints the toolchain and the card, builds the
kernels (printing ptxas's report and the SASS tensor-core counts of K6),
holds K4^T and K6 in every ``chip_smoke.GMM_BWD_FORMS`` form at
Qwen3-30B-A3B widths, then runs ``chip_smoke.train_phase`` (every gate of
the phase applies).

Without a card it rehearses the phase on the CPU with a tiny bf16
Qwen3-MoE standing in for Qwen3-30B-A3B (its published fields swapped in
the same way), a 2 x 16 batch, the CUDA calls it makes stubbed and the
profile skipped, and prints each gate that fails instead of exiting (a
wrapper counts only launches on the card, so the launch gate fails
there)."""
import dataclasses, json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
print(json.dumps({"python": sys.version, "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
import chip_smoke as cs
from llm_d_kv_cache_manager_tpu_torch import models, ops, server
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops import _build

pkg = {"models": models, "llama": llama, "server": server}

if torch.cuda.is_available():
    card = cs.card_line(); print(card, flush=True)
    t = time.perf_counter(); print("build", _build.build(), time.perf_counter() - t, flush=True)
    log = _build.library_path("grouped_matmul_tgmm").with_suffix(".log").read_text()
    print("ptxas", [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln], flush=True)
    sass = cs.sass_tensor_core_counts(_build)
    print("sass", sass and sass["grouped_matmul_tgmm"], flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    for entry in cs.check_grouped_matmul_backward(ops, dev, torch.Generator(device=dev).manual_seed(cs.SEED)):
        cs.emit(entry)
    print("kernel checks seconds", time.perf_counter() - t, flush=True)
    cs.free_cuda()
else:
    print("no card: rehearsing on the CPU with a tiny Qwen3-MoE", flush=True)
    card, dev = "cpu rehearsal", torch.device("cpu")
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    cs.fail = lambda msg: print("GATE:", msg, flush=True)
    cs.profile_window = lambda step, steps, model_steps, counted: (step(), step(), {"skipped": True})[2]
    tiny = dataclasses.replace(models.TINY_QWEN3_MOE, dtype=torch.bfloat16)
    models.QWEN3_30B_A3B = tiny
    cs.QWEN3_30B_A3B_HF = dict(
        cs.QWEN3_30B_A3B_HF, vocab_size=tiny.vocab_size, hidden_size=tiny.hidden_size,
        intermediate_size=tiny.intermediate_size, num_hidden_layers=tiny.n_layers,
        num_attention_heads=tiny.n_heads, num_key_value_heads=tiny.n_kv_heads,
        head_dim=tiny.head_dim, rope_theta=tiny.rope_theta, num_experts=tiny.n_experts,
        num_experts_per_tok=tiny.n_experts_per_tok, moe_intermediate_size=tiny.moe_intermediate_size)
    cs.TRAIN_BATCH, cs.TRAIN_SEQ = 2, 16
    torch.set_num_threads(2)
t = time.perf_counter()
result, launches = cs.train_phase(pkg, ops, dev, card)
cs.emit(dict(result, launches_by_path=launches))
print("train seconds", time.perf_counter() - t, flush=True)
