"""GPU smoke test of the PyTorch/CUDA port: builds the Hopper kernels, holds
each against its plain PyTorch version at Llama-3.1-8B shapes, then serves
a Llama-3.1-8B workload (random bf16 weights from a seed) through the
port's ``Engine`` and checks what comes out.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Each phase prints one JSON line. The line before the last lists every
kernel (error against its plain version, launches on the main path, its
time beside its bound, the plain version's and a PyTorch library call's
time); the line before that names the card and its power limit; the last
line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before that line. Imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

#: Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
#: Each kernel is held, element by element, against its plain version run
#: in float32 on the same inputs (the result not rounded to bf16):
#:   |out - ref| <= 2^-8 |ref| (+ 2^-8 ref_abs for flash_prefill) + 1e-4.
#: 2^-8 |ref| bounds the kernel's one rounding of its output to bf16 (half an
#: ulp). paged_decode keeps float32 probabilities, so that is all it may
#: lose. flash_prefill rounds each probability to bf16 before p @ v, as the
#: JAX kernel casts it to the V dtype: each term p|v| moves by at most 2^-8
#: of itself, so it may also lose 2^-8 ref_abs, where ref_abs is the same
#: attention over |v|. 1e-4 covers float32 summation-order differences.
HALF_ULP = 2.0**-8
KERNEL_ATOL = 1e-4
TOL = {
    "paged_decode": "2^-8*|ref| + 1e-4 (ref in float32)",
    "flash_prefill": "2^-8*|ref| + 2^-8*ref_abs + 1e-4 (ref in float32)",
}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def held(out: torch.Tensor, ref: torch.Tensor, ref_abs=None) -> dict:
    """A kernel's output against its float32 plain version: the largest
    absolute error and the largest ratio of error to allowance (at most 1)."""
    err = (out.float() - ref).abs()
    allow = HALF_ULP * ref.abs() + KERNEL_ATOL
    if ref_abs is not None:
        allow = allow + HALF_ULP * ref_abs
    return {"max_abs_err": float(err.max()), "err_over_allowance": float((err / allow).max())}


# -- phase 3: kernels against their plain versions ----------------------------
def check_paged_decode(ops, dev, gen):
    """K1 at 8B decode shapes: B=8, 32/8 heads, hd=128, ps=16, a 5-D
    two-layer pool read at layer 1, mixed lengths incl. 0 and a partial
    page, with and without the fresh token."""
    B, n_q, n_kv, hd, ps, layers = 8, 32, 8, 128, 16, 2
    seq_lens_l = [0, 1, 17, 300, 1024, 1500, 2047, 2048]
    max_pages = 2048 // ps
    n_pages = sum(-(-n // ps) for n in seq_lens_l)
    P = n_pages + 64
    bf = torch.bfloat16
    k_pages = torch.randn((layers, P, ps, n_kv, hd), generator=gen, device=dev).to(bf)
    v_pages = torch.randn((layers, P, ps, n_kv, hd), generator=gen, device=dev).to(bf)
    perm = torch.randperm(P - 1, generator=gen, device=dev)[:n_pages] + 1
    bt = torch.zeros((B, max_pages), dtype=torch.int32, device=dev)
    off = 0
    for i, n in enumerate(seq_lens_l):
        k = -(-n // ps)
        bt[i, :k] = perm[off : off + k].to(torch.int32)
        off += k
    seq_lens = torch.tensor(seq_lens_l, dtype=torch.int32, device=dev)
    q = torch.randn((B, n_q, hd), generator=gen, device=dev).to(bf)
    fk = torch.randn((B, n_kv, hd), generator=gen, device=dev).to(bf)
    fv = torch.randn((B, n_kv, hd), generator=gen, device=dev).to(bf)

    cases = {}
    for fresh in (False, True):
        args = (k_pages, v_pages, bt, seq_lens) + ((fk, fv) if fresh else ())
        out = ops.paged_attention(q, *args, layer=1)
        ref = ops.paged_attention_reference(q.float(), *args, layer=1)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"paged_decode produced non-finite values (fresh={fresh})")
        if out[0].float().abs().max() != 0:
            fail("paged_decode: seq_len == 0 row is not zero")
        cases[f"fresh={fresh}"] = held(out, ref)
    worst = max(c["err_over_allowance"] for c in cases.values())
    if worst > 1:
        fail(f"paged_decode differs from its plain version beyond {TOL['paged_decode']}: {cases}")

    # Timing at the engine's call form (fresh token, 5-D pool).
    args = (q, k_pages, v_pages, bt, seq_lens, fk, fv)
    ms = cuda_time_ms(lambda: ops.paged_attention(*args, layer=1))
    plain_ms = cuda_time_ms(lambda: ops.paged_attention_reference(*args, layer=1), iters=5)
    # Library yardstick: SDPA over K/V gathered beforehand into contiguous
    # [B, n_q, T + 1, hd] buffers (GQA heads expanded, fresh token appended).
    T = max_pages * ps
    gk = k_pages[1][bt.long()].reshape(B, T, n_kv, hd)
    gv = v_pages[1][bt.long()].reshape(B, T, n_kv, hd)
    gk = torch.cat([gk, fk[:, None]], 1).transpose(1, 2).repeat_interleave(n_q // n_kv, 1).contiguous()
    gv = torch.cat([gv, fv[:, None]], 1).transpose(1, 2).repeat_interleave(n_q // n_kv, 1).contiguous()
    ar = torch.arange(T + 1, device=dev)
    mask = (ar[None, :] < (seq_lens[:, None] - 1)) | ((ar[None, :] == T) & (seq_lens[:, None] > 0))
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q4, gk, gv, attn_mask=mask))
    hist = sum(max(n - 1, 0) for n in seq_lens_l)
    n_bytes = (
        hist * n_kv * hd * 2 * 2  # K and V history
        + 2 * B * n_q * hd * 2  # q in, out
        + 2 * B * n_kv * hd * 2  # fresh K/V
        + B * max_pages * 4 + B * 4  # block tables, lengths
    )
    flops = 4 * n_q * hd * sum(seq_lens_l)
    b_ms, b_by = bound_ms(n_bytes, flops)
    return {
        "name": "paged_decode",
        "route": "cuda",
        "source": "llm_d_kv_cache_manager_tpu_torch/csrc/paged_decode.cu",
        "replaces": "llm_d_kv_cache_manager_tpu/ops/paged_attention.py:40",
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "err_over_allowance": worst,
        "tol": TOL["paged_decode"],
        "cases": cases,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
        "shape": {"B": B, "n_q": n_q, "n_kv": n_kv, "hd": hd, "ps": ps,
                  "seq_lens": seq_lens_l, "layer": 1},
    }


#: flash_prefill's call forms, each held against its plain version. The
#: first is the one timed. The engine pads a prefill dispatch to 8 rows and
#: its chunk to a multiple of 64: a cold dispatch has a zero-width block
#: table; a warm one (two repeats of a 1024-token prompt, 1008 tokens cached)
#: has six rows with nothing valid and a context that ends inside a key tile.
PREFILL_FORMS = {
    "kernels_phase": dict(b=2, s=512, ctx=[0, 1024], nv=[512, 300], ctx_pages=64),
    "engine_cold": dict(b=8, s=1024, ctx=[0] * 8, nv=[1024] * 6 + [517, 0], ctx_pages=0),
    "engine_warm": dict(b=8, s=64, ctx=[1008] * 2 + [0] * 6, nv=[16] * 2 + [0] * 6, ctx_pages=64),
}


def prefill_inputs(dev, gen, b, s, ctx, nv, ctx_pages, n_q=32, n_kv=8, hd=128, ps=16):
    """Random bf16 inputs at 8B widths; each row's context lies on distinct
    pages of a pool, in a random order, named by its block table."""
    pages = [-(-c // ps) for c in ctx]
    P = sum(pages) + 16
    bf = torch.bfloat16
    q = torch.randn((b, s, n_q, hd), generator=gen, device=dev).to(bf)
    k = torch.randn((b, s, n_kv, hd), generator=gen, device=dev).to(bf)
    v = torch.randn((b, s, n_kv, hd), generator=gen, device=dev).to(bf)
    k_pages = torch.randn((P, ps, n_kv, hd), generator=gen, device=dev).to(bf)
    v_pages = torch.randn((P, ps, n_kv, hd), generator=gen, device=dev).to(bf)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = torch.zeros((b, ctx_pages), dtype=torch.int32, device=dev)
    off = 0
    for i, n in enumerate(pages):
        bt[i, :n] = perm[off : off + n].to(torch.int32)
        off += n
    ctx_lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
    n_valid = torch.tensor(nv, dtype=torch.int32, device=dev)
    return (q, k, v, k_pages, v_pages, bt, ctx_lens, n_valid)


def hold_prefill_form(ops, name, args, nv) -> dict:
    out = ops.flash_prefill_paged(*args)
    q, k, v, k_pages, v_pages, bt, ctx_lens, n_valid = args
    f = [t.float() for t in (q, k, v, k_pages, v_pages)]
    ref = ops.flash_prefill_plain(*f, bt, ctx_lens, n_valid)
    ref_abs = ops.flash_prefill_plain(f[0], f[1], f[2].abs(), f[3], f[4].abs(), bt, ctx_lens, n_valid)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"flash_prefill produced non-finite values ({name})")
    for i, n in enumerate(nv):
        if (out[i, n:] != 0).any():
            fail(f"flash_prefill: padded query rows of row {i} are not zero ({name})")
    return held(out, ref, ref_abs)


def check_flash_prefill(ops, dev, gen):
    """K2 at 8B prefill shapes, in the call forms of ``PREFILL_FORMS``;
    timed in the first: b=2, chunk 512 right-padded, context 0 and 1024
    tokens read through the block table."""
    n_q, n_kv, hd, ps = 32, 8, 128, 16
    cases = {}
    for name, form in PREFILL_FORMS.items():
        form_args = prefill_inputs(dev, gen, form["b"], form["s"], form["ctx"], form["nv"], form["ctx_pages"])
        cases[name] = dict(hold_prefill_form(ops, name, form_args, form["nv"]),
                           **{key: form[key] for key in ("b", "s", "ctx_pages")})
        if name == "kernels_phase":
            args = form_args
        torch.cuda.empty_cache()
    worst = max(c["err_over_allowance"] for c in cases.values())
    if worst > 1:
        fail(f"flash_prefill differs from its plain version beyond {TOL['flash_prefill']}: {cases}")

    form = PREFILL_FORMS["kernels_phase"]
    b, s, ctx_pages, ctx_l, nv_l = form["b"], form["s"], form["ctx_pages"], form["ctx"], form["nv"]
    q, k, v, k_pages, v_pages, bt, ctx_lens, n_valid = args
    ms = cuda_time_ms(lambda: ops.flash_prefill_paged(*args))
    plain_ms = cuda_time_ms(lambda: ops.flash_prefill_plain(*args), iters=5)
    # Library yardstick: SDPA over [context ++ chunk] gathered beforehand
    # into contiguous buffers (GQA heads expanded), with the same mask.
    T = ctx_pages * ps + s
    gk = torch.cat([k_pages[bt.long()].reshape(b, -1, n_kv, hd), k], 1)
    gv = torch.cat([v_pages[bt.long()].reshape(b, -1, n_kv, hd), v], 1)
    gk = gk.transpose(1, 2).repeat_interleave(n_q // n_kv, 1).contiguous()
    gv = gv.transpose(1, 2).repeat_interleave(n_q // n_kv, 1).contiguous()
    qi = torch.arange(s, device=dev)[None, :, None]
    kj = torch.arange(T, device=dev)[None, None, :]
    cp = ctx_pages * ps
    in_ctx = kj < cp
    mask = torch.where(
        in_ctx, kj < ctx_lens[:, None, None], (kj - cp <= qi) & (kj - cp < n_valid[:, None, None])
    ) & (qi < n_valid[:, None, None])
    mask = mask[:, None]
    qt = q.transpose(1, 2).contiguous()
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, gk, gv, attn_mask=mask))
    flops = sum(4 * n_q * hd * nv * (c + (nv + 1) / 2) for c, nv in zip(ctx_l, nv_l))
    n_bytes = (
        2 * q.numel() * 2  # q in, out
        + 2 * k.numel() * 2  # chunk K, V
        + sum(ctx_l) * n_kv * hd * 2 * 2  # context K, V from the pool
        + bt.numel() * 4 + 2 * b * 4
    )
    b_ms, b_by = bound_ms(n_bytes, flops)
    return {
        "name": "flash_prefill",
        "route": "cuda",
        "source": "llm_d_kv_cache_manager_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "llm_d_kv_cache_manager_tpu/ops/flash_prefill.py:66",
        "also_serves": "llm_d_kv_cache_manager_tpu/ops/flash_prefill.py:192",
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "err_over_allowance": worst,
        "tol": TOL["flash_prefill"],
        "cases": cases,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
        "shape": {"b": b, "s": s, "n_q": n_q, "n_kv": n_kv, "hd": hd, "ps": ps,
                  "ctx_lens": ctx_l, "n_valid": nv_l},
    }


# -- phase 4: the engine at full width ----------------------------------------
def run_engine(pkg, ops, dev, card: str):
    models = pkg["models"]
    server = pkg["server"]
    kvblock = pkg["kvblock"]
    cfg = models.LLAMA_3_8B
    ps, n_prompts, prompt_len, shared_len, new_tokens = 16, 8, 1024, 512, 32

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = models.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    events = []
    eng = server.Engine(
        server.EngineConfig(
            model=cfg,
            block_manager=server.BlockManagerConfig(total_pages=4096, page_size=ps),
            max_model_len=4096,
            decode_batch_size=8,
            seed=SEED,
        ),
        params=params,
        on_events=lambda evs: events.extend(evs),
        device=dev,
    )
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, cfg.vocab_size, shared_len).tolist()
    prompts = [
        shared + rng.integers(0, cfg.vocab_size, prompt_len - shared_len).tolist()
        for _ in range(n_prompts)
    ]
    def greedy():
        return server.SamplingParams(max_new_tokens=new_tokens)

    phase = {"prefill_s": 0.0, "decode_s": 0.0, "decode_tokens": 0}

    def drive():
        while eng.has_work:
            d0 = eng.prefill_stats["dispatches"]
            running = len(eng.scheduler.running)
            t = time.perf_counter()
            eng.step()
            dt = time.perf_counter() - t
            if eng.prefill_stats["dispatches"] > d0:
                phase["prefill_s"] += dt
            else:
                phase["decode_s"] += dt
                phase["decode_tokens"] += running

    # The main path: counts are zeroed just before it and read just after.
    ops.paged_attention.launches = 0
    ops.flash_prefill_paged.launches = 0
    first = [eng.add_request(p, greedy()) for p in prompts]
    drive()
    cold_computed = eng.prefill_stats["tokens_computed"]
    repeats = [eng.add_request(prompts[i], greedy()) for i in (0, 1)]
    drive()
    launches = {
        "paged_decode": ops.paged_attention.launches,
        "flash_prefill": ops.flash_prefill_paged.launches,
    }
    torch.cuda.synchronize()

    # Checks on what came out.
    for seq in first + repeats:
        if seq.error or len(seq.generated_tokens) != new_tokens:
            fail(f"request {seq.seq_id} finished with {len(seq.generated_tokens)} tokens, error={seq.error}")
        if not all(0 <= t < cfg.vocab_size for t in seq.generated_tokens):
            fail("generated token id out of range")
    warm_computed = eng.prefill_stats["tokens_computed"] - cold_computed
    for seq in repeats:
        if seq.num_cached_prompt < prompt_len - ps:
            fail(f"repeat served only {seq.num_cached_prompt} cached prompt tokens")
    if warm_computed >= 2 * ps + 1:
        fail(f"repeats recomputed {warm_computed} tokens despite the prefix hit")
    stored = {h for e in events if type(e).__name__ == "BlockStored" for h in e.block_hashes}
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=ps))
    for p in prompts:
        missing = [h for h in db.prefix_hashes(p) if h not in stored]
        if missing:
            fail(f"{len(missing)} prompt block hashes never published as BlockStored")
    n_layers = cfg.n_layers
    prefill_dispatches = eng.prefill_stats["dispatches"]
    decode_dispatches = eng._step_count - prefill_dispatches
    if launches["flash_prefill"] != n_layers * prefill_dispatches or prefill_dispatches == 0:
        fail(f"flash_prefill launches {launches['flash_prefill']} != {n_layers} x {prefill_dispatches}")
    if launches["paged_decode"] != n_layers * decode_dispatches or decode_dispatches == 0:
        fail(f"paged_decode launches {launches['paged_decode']} != {n_layers} x {decode_dispatches}")

    # Warm vs cold first-token logits, straight through the model on a
    # scratch pool: the cold pass prefills the whole prompt; the warm pass
    # prefills all but the last page, then the last page against that
    # context (the flash kernel's block-table path).
    pages = prompt_len // ps + 1
    kp, vp = models.init_kv_pages(cfg, pages + 1, ps, dev)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)

    def run_chunk(tokens, start):
        n = len(tokens)
        pos = torch.arange(start, start + n, dtype=torch.int32, device=dev)[None]
        t = torch.tensor(tokens, dtype=torch.int32, device=dev)[None]
        valid = torch.ones((1, n), dtype=torch.bool, device=dev)
        n_ctx = start // ps
        return models.prefill(
            eng.params, cfg, t, pos, valid, kp, vp,
            table[(pos.long() // ps)], pos % ps,
            table[:n_ctx][None].contiguous() if n_ctx else torch.zeros((1, 0), dtype=torch.int32, device=dev),
            torch.tensor([start], dtype=torch.int32, device=dev),
        )[0][0]

    p0 = prompts[0]
    cold = run_chunk(p0, 0)
    kp.zero_()
    vp.zero_()
    run_chunk(p0[: prompt_len - ps], 0)
    warm = run_chunk(p0[prompt_len - ps :], prompt_len - ps)
    torch.cuda.synchronize()
    if not (torch.isfinite(cold).all() and torch.isfinite(warm).all()):
        fail("non-finite first-token logits")
    scale = float(cold.abs().max())
    logit_err = float((warm - cold).abs().max())
    # bf16 activations through 32 layers: the two passes round at different
    # places; agreement within 5% of the logit range is the bar.
    logit_tol = 0.05 * scale
    if logit_err > logit_tol:
        fail(f"warm vs cold first-token logits differ by {logit_err} > {logit_tol}")

    emit({
        "phase": "engine",
        "model": "LLAMA_3_8B",
        "n_layers": n_layers,
        "card": card,
        "init_params_s": init_s,
        "requests": len(first) + len(repeats),
        "new_tokens_each": new_tokens,
        "prefill_dispatches": prefill_dispatches,
        "decode_dispatches": decode_dispatches,
        "tokens_computed_cold": cold_computed,
        "tokens_computed_repeats": warm_computed,
        "cached_prompt_tokens_repeats": [s.num_cached_prompt for s in repeats],
        "launches": launches,
        "block_stored_hashes": len(stored),
        "first_token_logits": {"max_abs_diff_warm_vs_cold": logit_err,
                               "tol": logit_tol, "max_abs_cold": scale},
        "prefill_tokens_per_s": eng.prefill_stats["tokens_computed"] / phase["prefill_s"],
        "decode_tokens_per_s": phase["decode_tokens"] / phase["decode_s"],
        "prefill_s": phase["prefill_s"],
        "decode_s": phase["decode_s"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    profile_decode(eng, prompts, greedy)
    return launches


def profile_decode(eng, prompts, greedy) -> None:
    """Where a decode step's time goes: torch.profiler over a few steady
    decode steps of 8 lanes (after the main path's counts were read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.add_request(p[:256], greedy())
    eng.step()  # the prefill
    eng.step()  # one decode step outside the window
    steps = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    eng.abort_all()

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        return us / 1e3 / steps

    # Device-side kernel entries only (operator entries repeat their time).
    kernels = sorted(
        (
            e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_ms(e) > 0
        ),
        key=dev_ms,
        reverse=True,
    )
    busy_ms = sum(dev_ms(e) for e in kernels)
    emit({
        "phase": "profile_decode",
        "lanes": len(prompts),
        "context_tokens": 256,
        "step_wall_ms": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "top_kernels_ms_per_step": [
            {"name": e.key[:80], "ms": dev_ms(e), "calls_per_step": e.count / steps}
            for e in kernels[:12]
        ],
    })


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_d_kv_cache_manager_tpu_torch import models, ops, server
    from llm_d_kv_cache_manager_tpu_torch.kvcache import kvblock
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit({
        "phase": "device",
        "nvidia_smi": card,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })

    t0 = time.perf_counter()
    seconds = _build.build()
    regs = {}
    for name in _build.KERNEL_SOURCES:
        log = _build.library_path(name).with_suffix(".log").read_text()
        regs[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "total_s": time.perf_counter() - t0,
          "ptxas": regs})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = [check_paged_decode(ops, dev, gen), check_flash_prefill(ops, dev, gen)]
    emit({"phase": "kernels", "allow_tf32": False, "cudnn_allow_tf32": False,
          "results": kernels})

    launches = run_engine(
        {"models": models, "server": server, "kvblock": kvblock}, ops, dev, card
    )
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the main path")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
