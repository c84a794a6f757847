"""A/B on one card: decode of a parent tree against this tree, each tree
in its own process, in turns (parent, new, new, parent). Each run serves
8 x 1024-token prompts on Llama-3.1-8B and on Qwen3-30B-A3B with int8
experts (random weights, seed 0), times 12 decode steps, then 4 under
torch.profiler, and prints one JSON line; the run without --one also counts the
requests whose greedy tokens equal the first parent run's.

    python chip_probes/decode_ab.py PARENT_TREE      # all four runs, in turns
    python chip_probes/decode_ab.py --one TREE       # one tree's run

PARENT_TREE is an unpacked ``git archive`` of the parent commit, in a
directory ``.gitignore`` lists (``build/``).
"""
import json, os, subprocess, sys, time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from llm_d_kv_cache_manager_tpu_torch import models, server
    from llm_d_kv_cache_manager_tpu_torch.server import serve
    assert models.__file__.startswith(tree), models.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"tree": tree}
    for label, name, quantize in (("llama_3_8b", "meta-llama/Llama-3.1-8B-Instruct", None),
                                  ("qwen3_30b_a3b_int8", "Qwen/Qwen3-30B-A3B", "int8")):
        cfg = serve._resolve_model(name)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = models.init_params(cfg, gen, dev, quantize=quantize, quantize_experts=quantize is not None)
        eng = server.Engine(server.EngineConfig(
            model=cfg, block_manager=server.BlockManagerConfig(total_pages=1024, page_size=16),
            max_model_len=4096, decode_batch_size=8, seed=0, quantize=quantize,
            quantize_experts=quantize is not None), params=params, device=dev)
        rng = np.random.default_rng(0)
        shared = rng.integers(0, cfg.vocab_size, 512).tolist()
        prompts = [shared + rng.integers(0, cfg.vocab_size, 512).tolist() for _ in range(8)]
        seqs = [eng.add_request(p, server.SamplingParams(max_new_tokens=40)) for p in prompts]
        while any(s.num_generated == 0 for s in seqs):
            eng.step()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        g0 = sum(s.num_generated for s in seqs)
        t = time.perf_counter()
        n = 12
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
        tok_s = (sum(s.num_generated for s in seqs) - g0) / (wall * n / 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(4):
                eng.step()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t) * 1e3 / 4
        busy = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / 4
        eng.run_until_complete()
        out[label] = {"step_wall_ms": wall, "decode_tokens_per_s": tok_s,
                      "step_wall_ms_profiled": prof_wall, "device_busy_ms_per_step": busy,
                      "device_idle_share": 1 - busy / wall, "device_idle_share_profiled": 1 - busy / prof_wall,
                      "tokens": [list(map(int, s.generated_tokens)) for s in seqs]}
        del eng, params, seqs
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(parent):
    trees = {"parent": os.path.abspath(parent), "new": ROOT}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for name in ("parent", "new", "new", "parent"):
        r = subprocess.run([sys.executable, __file__, "--one", trees[name]], capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            print(name, "FAILED", r.stderr[-3000:], flush=True)
            continue
        d = json.loads(r.stdout.strip().splitlines()[-1])
        d["name"] = name
        runs.append(d)
        print(json.dumps({name: {m: {k: v for k, v in d[m].items() if k != "tokens"}
                                 for m in ("llama_3_8b", "qwen3_30b_a3b_int8")}}), flush=True)
    ref = {m: [r[m]["tokens"] for r in runs if r["name"] == "parent"] for m in ("llama_3_8b", "qwen3_30b_a3b_int8")}
    for r in runs:
        for m in ref:
            if ref[m]:
                same = sum(a == b for a, b in zip(r[m]["tokens"], ref[m][0]))
                print(json.dumps({"run": r["name"], "model": m, "requests_equal_to_first_parent": same}))


if __name__ == "__main__":
    if sys.argv[1] == "--one":
        one(sys.argv[2])
    else:
        main(sys.argv[1])
