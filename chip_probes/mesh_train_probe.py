"""The mesh lines of ``chip_smoke.py`` alone: training over a (dp=2, tp=2)
mesh (``qwen3_30b_a3b_train_dp2ep2``) and page moves over a tp=2 engine's
sharded pools (``llama_3_8b_tp2_tiers``, ``llama_3_8b_tp2_transfer``), a
short card call for them. Run from the repo root:

    python chip_probes/mesh_train_probe.py

On a machine with a card it prints the toolchain and the card, builds the
kernels, holds K4/K5 and K4^T/K6 in every form (the expert-parallel
training form ``train_ep`` among them), runs ``chip_smoke.train_phase``
(the tp=1 line the mesh line reads beside its own) and
``chip_smoke.train_mesh_phase``, then the two tp=2 page-move lines on
Llama-3.1-8B's weights at ``DEPTH`` layers (its 32 by default), every gate
applying (``KEEP_GOING=1``: each failed gate is printed and the run goes
on). ``LINES=train`` or ``LINES=tiers`` runs one half; ``LINES=grad_split``
reads, with no gate, how far the gathered gradients of one step over
dp=2 × tp=1, dp=1 × tp=2 and dp=2 × tp=2 are from tp=1's (the train line's
weights, tokens and routing, pinned), so the mesh line's gap can be told
apart by axis.

Without a card it rehearses the lines on the CPU with a tiny bf16
Qwen3-MoE of 16 experts standing in for Qwen3-30B-A3B (its published
fields swapped in the same way), a 2 x 16 batch, and TINY_LLAMA for
Llama-3.1-8B, the CUDA calls the lines make stubbed and the profiles
skipped, and prints each gate that fails instead of exiting (a wrapper
counts launches only on the card, and the host slots are pinned only
there, so those gates fail)."""
import dataclasses, json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
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
lines = os.environ.get("LINES", "train,tiers").split(",")
if torch.cuda.is_available():
    card = cs.card_line(); print(card, flush=True)
    t = time.perf_counter(); print("build", _build.build(), time.perf_counter() - t, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if os.environ.get("KEEP_GOING"):
        cs.fail = lambda msg: print("GATE:", msg[:2000], flush=True)
    llama_cfg = serve._resolve_model("meta-llama/Llama-3.1-8B-Instruct")
    if os.environ.get("DEPTH"):
        llama_cfg = dataclasses.replace(llama_cfg, n_layers=int(os.environ["DEPTH"]))
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for entry in cs.check_grouped_matmul(ops, models, dev, gen) + cs.check_grouped_matmul_backward(ops, dev, gen):
        print(json.dumps({"name": entry["name"], "err_over_allowance": entry["err_over_allowance"],
                          "train_ep": {k: v for k, v in entry["forms"].items() if k.startswith("train_ep")}},
                         default=str), flush=True)
    print("kernel checks seconds", time.perf_counter() - t, flush=True)
    cs._L2_FLUSH.clear()
    cs.free_cuda()
else:
    print("no card: rehearsing on the CPU with tiny models", flush=True)
    card, dev = "cpu rehearsal", torch.device("cpu")
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.current_stream = lambda *a, **k: None
    cs.fail = lambda msg: print("GATE:", msg[:400], flush=True)
    cs.profile_window = lambda step, steps, model_steps, counted: (
        step(), step(), {"skipped": True, "device_idle_share": None})[2]
    tiny = dataclasses.replace(models.TINY_QWEN3_MOE, dtype=torch.bfloat16, n_experts=16)
    models.QWEN3_30B_A3B = tiny
    cs.QWEN3_30B_A3B_HF = dict(
        cs.QWEN3_30B_A3B_HF, vocab_size=tiny.vocab_size, hidden_size=tiny.hidden_size,
        intermediate_size=tiny.intermediate_size, num_hidden_layers=tiny.n_layers,
        num_attention_heads=tiny.n_heads, num_key_value_heads=tiny.n_kv_heads,
        head_dim=tiny.head_dim, rope_theta=tiny.rope_theta, num_experts=tiny.n_experts,
        num_experts_per_tok=tiny.n_experts_per_tok, moe_intermediate_size=tiny.moe_intermediate_size)
    cs.TRAIN_BATCH, cs.TRAIN_SEQ = 2, 16
    llama_cfg = models.TINY_LLAMA
    torch.set_num_threads(4)
launches = {}
if "train" in lines:
    t = time.perf_counter()
    tp1, by_path = cs.train_phase(pkg, ops, dev, card)
    launches.update(by_path)
    cs.emit({k: tp1[k] for k in ("model", "losses", "step_ms", "tokens_per_s", "launches")})
    cs.free_cuda()
    result, by_path = cs.train_mesh_phase(pkg, ops, dev, card, tp1)
    launches.update(by_path)
    cs.emit(result)
    print("train seconds", time.perf_counter() - t, flush=True)
if "grad_split" in lines:
    from llm_d_kv_cache_manager_tpu_torch import parallel
    from llm_d_kv_cache_manager_tpu_torch.parallel import train

    cfg = dataclasses.replace(models.QWEN3_30B_A3B, n_layers=cs.TRAIN_LAYERS)
    params = train.trainable(models.init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev))
    rng = np.random.default_rng(cs.SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (cs.TRAIN_BATCH, cs.TRAIN_SEQ))).to(dev)
    with cs.moe_routing(llama) as routing:
        loss_1, grads_1 = cs.grads_of(train, params, cfg, tokens)
    names = cs.leaf_names(params)
    for dp, tp in ((2, 1), (1, 2), (2, 2)):
        mesh = parallel.make_mesh(parallel.MeshConfig(dp=dp, tp=tp), devices=[dev] * (dp * tp))
        sharded = train.trainable(parallel.shard_train_params(params, mesh, cfg))
        rows = cs.TRAIN_BATCH // dp * cs.TRAIN_SEQ
        pinned = [ids[d * rows : (d + 1) * rows] for d in range(dp) for ids, _ in routing]
        with cs.moe_routing(llama, pinned=pinned):
            loss_m, grads_m = cs.grads_of(train, sharded, cfg, tokens)
        errs = cs.rel_errors(grads_m, grads_1)
        cs.emit({"grad_split": f"dp{dp}_tp{tp}", "card": card, "loss_tp1": loss_1, "loss_mesh": loss_m,
                 "max_rel_err": max(errs), "median_rel_err": sorted(errs)[len(errs) // 2],
                 "worst_leaves": sorted(zip(errs, names), reverse=True)[:4]})
        del sharded, grads_m
        cs.free_cuda()
    del params, grads_1
    cs.free_cuda()
if "tiers" in lines:
    t = time.perf_counter()
    params = models.init_params(llama_cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev)
    for label, phase in (("llama_3_8b_tp2_tiers", cs.tp2_tiers), ("llama_3_8b_tp2_transfer", cs.tp2_transfer)):
        t0 = time.perf_counter()
        line, launches[label] = phase(pkg, ops, dev, card, params, llama_cfg)
        cs.emit(dict(line, path=label, phase_wall_s=time.perf_counter() - t0))
        cs.free_cuda()
    print("tiers seconds", time.perf_counter() - t, flush=True)
print(json.dumps({"launches_by_path": launches}), flush=True)
