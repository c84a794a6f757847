"""A/B on one card: K6 and a training step of a parent tree against this
tree, each tree in its own process, in turns (parent, new, new, parent).
Each run, on inputs made from seed 0:

  * times K6 (``grouped_matmul_tgmm``) at Qwen3-30B-A3B's two train forms,
    gate-up (d, f) = (2048, 768) and down (768, 2048), 16,384 rows routed
    top-8 over 128 experts, with the L2 flushed before each call, and
    ``torch._grouped_mm`` on the same operands beside it;
  * hashes the bf16 outputs of K4 and K5 (prefill and decode forms), K4^T
    and K6 (train form), so that the trees' outputs can be compared bit for
    bit;
  * times a training step of Qwen3-30B-A3B cut to 2 layers on 2 x 1024
    tokens (median of 5 steps after 2 warm-up steps).

The run without --one prints the card, each run's JSON line, and whether
each kernel's outputs equal the first parent run's.

    python chip_probes/train_ab.py PARENT_TREE      # all four runs, in turns
    python chip_probes/train_ab.py --one TREE       # one tree's run

PARENT_TREE is an unpacked ``git archive`` of the parent commit's
``llm_d_kv_cache_manager_tpu_torch`` in a directory ``.gitignore`` lists
(``build/``); each tree builds its kernels under its own ``build/``.
"""
import dataclasses, hashlib, importlib.util, json, os, subprocess, sys, time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASHED = ("grouped_matmul_bf16", "grouped_matmul_int8", "grouped_matmul_bf16_t", "grouped_matmul_tgmm")


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import torch
    return hashlib.sha256(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def one(tree):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from llm_d_kv_cache_manager_tpu_torch import models, ops
    from llm_d_kv_cache_manager_tpu_torch.parallel import train
    assert ops.__file__.startswith(tree), ops.__file__
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": tree, "k6": {}, "hash": {}}
    for width, (d, f) in cs.GMM_WIDTHS.items():
        w = (torch.randn((cs.MOE_E, d, f), generator=gen, device=dev) * d**-0.5).to(bf)
        for form in ("prefill", "decode"):
            sizes, rows = cs.gmm_group_sizes(form, gen, dev)
            gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
            lhs = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            q = models.quantize_tensor(w)
            out["hash"][f"grouped_matmul_bf16/{form}/{width}"] = digest(ops.grouped_matmul_bf16(lhs, w, gs))
            out["hash"][f"grouped_matmul_int8/{form}/{width}"] = digest(
                ops.grouped_matmul_int8(lhs, q.q, q.scale, gs))
            del q
        sizes, rows = cs.gmm_bwd_group_sizes("train", gen, dev)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        lhs = torch.randn((rows, d), generator=gen, device=dev).to(bf)
        dout = torch.randn((rows, f), generator=gen, device=dev).to(bf)
        out["hash"][f"grouped_matmul_bf16_t/train/{width}"] = digest(ops.grouped_matmul_bf16_t(dout, w, gs))
        out["hash"][f"grouped_matmul_tgmm/train/{width}"] = digest(ops.grouped_matmul_tgmm(lhs, dout, gs))
        library_ms, note = cs.grouped_mm_library_ms(lhs.t(), dout, gs)
        out["k6"][width] = {"ms": cs.cold_time_ms(lambda: ops.grouped_matmul_tgmm(lhs, dout, gs)),
                            "library_ms": library_ms, "library_note": note}
        del w, lhs, dout
        cs.free_cuda()
    cs._L2_FLUSH.clear()
    cs.free_cuda()

    cfg = dataclasses.replace(models.QWEN3_30B_A3B, n_layers=cs.TRAIN_LAYERS)
    params = train.trainable(models.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    state = train.TrainState(params, train.make_optimizer(params, cs.TRAIN_LR), 0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (cs.TRAIN_BATCH, cs.TRAIN_SEQ))).to(dev)
    step_ms, losses = [], []
    for i in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = train.train_step(state, cfg, tokens, cs.TRAIN_LR)
        losses.append(float(loss))  # syncs
        if i >= 2:
            step_ms.append((time.perf_counter() - t) * 1e3)
    out["train"] = {"step_ms": float(np.median(step_ms)), "steps_ms": step_ms, "losses": losses,
                    "tokens_per_s": cs.TRAIN_BATCH * cs.TRAIN_SEQ / (float(np.median(step_ms)) / 1e3)}
    print(json.dumps(out), flush=True)


def main(parent):
    trees = {"parent": os.path.abspath(parent), "new": ROOT}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for name in ("parent", "new", "new", "parent"):
        r = subprocess.run([sys.executable, __file__, "--one", trees[name]], capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            print(name, "FAILED", r.stderr[-3000:], flush=True)
            sys.exit(1)
        run = json.loads(r.stdout.strip().splitlines()[-1])
        run["name"] = name
        runs.append(run)
        print(json.dumps({name: {"k6": run["k6"], "train": run["train"]}}), flush=True)
    first = runs[0]["hash"]
    for kernel in HASHED:
        keys = [k for k in first if k.startswith(kernel + "/")]
        equal = {r["name"]: all(r["hash"][k] == first[k] for k in keys) for r in runs[1:]}
        print(json.dumps({"kernel": kernel, "forms": keys, "bit_equal_to_first_parent": equal}),
              flush=True)
    summary = {name: {"k6_ms": {w: [r["k6"][w]["ms"] for r in runs if r["name"] == name]
                                for w in runs[0]["k6"]},
                      "library_ms": {w: [r["k6"][w]["library_ms"] for r in runs if r["name"] == name]
                                     for w in runs[0]["k6"]},
                      "step_ms": [r["train"]["step_ms"] for r in runs if r["name"] == name]}
               for name in trees}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--one":
        one(sys.argv[2])
    else:
        main(sys.argv[1])
