"""GPU smoke test of the PyTorch/CUDA port: builds the Hopper kernels, holds
each against its plain PyTorch version at the shapes the serving paths
give it (Llama-3.1-8B attention, over bf16 and over int8 KV pages, decode
at 8 lanes and at one 4096-token lane, prefill in three call forms;
decode also at a GQA group of 16;
Qwen3-30B-A3B attention at GQA group 8 and its grouped expert matmuls,
bf16 and int8, in five group-size forms) and times the kernels with the L2
cache flushed before each call, runs one routed MoE layer under
``torch.cuda.set_sync_debug_mode("error")``, then serves four workloads
through the port's ``Engine`` and ``PodServer`` — Llama-3.1-8B,
Qwen3-30B-A3B with bf16 experts, Qwen3-30B-A3B with int8 weights and int8
experts, and Llama-3.1-8B on int8 KV pages with chunked prefill (where one
decode step on int8 pages and one on bf16 pages also run under the sync
debug mode), all at full width and depth with random weights from a seed —
and checks what comes out. Every decode burst of the engine is one CUDA
graph replay; the launch counts count the model steps the replays ran.
For Llama-3.1-8B and the int8 Qwen3-30B-A3B, the ``decode_fast_path``
phase then holds one graph replay against the same burst run eagerly (bit
for bit), the engine with the decode fast-path knobs on against it with
them off (equal greedy tokens), and profiles eager, graph k=1 and graph
k=4 pipelined decode. On the 8B path's parameters the ``host_tier`` phase
then serves three rounds of four 1024-token prompts through engines with a
host-DRAM tier (round 3 repeats round 1, which round 2 evicted to pinned
host memory): restored pages are held against round 1's, greedy tokens
against engines that never evict, and the copies' GB/s against PCIe. The
``kv_transfer`` phase, on the same parameters, serves four 1024-token
prompts on a source pod with an export service on 127.0.0.1 and pulls
them into target pods over loopback ZMQ (``pull_prefix`` and
``ASYNC_PULL``; bf16, an int8 wire, int8 pages and a host-tier export):
pulled pages are held against the source's, greedy tokens against the
source's warm repeat, and the wire, export, fetch and import times and the
import's GB/s are reported beside TTFTs and the transfer cost model's
verdict.

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

import contextlib
import dataclasses
import functools
import gc
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
#: in float32 on the same inputs (the result not rounded to bf16; for the
#: int8 pages, over the pool dequantized to float32, whose code * scale
#: products are the float32 values the kernel forms in registers):
#:   |out - ref| <= 2^-8 |ref| (+ 2^-8 ref_abs for flash_prefill) + 1e-4.
#: 2^-8 |ref| bounds the kernel's one rounding of its output to bf16 (half an
#: ulp). paged_decode keeps float32 probabilities, so that is all it may
#: lose. flash_prefill rounds each probability to bf16 before p @ v, as the
#: JAX kernel casts it to the V dtype: each term p|v| moves by at most 2^-8
#: of itself, so it may also lose 2^-8 ref_abs, where ref_abs is the same
#: attention over |v|. 1e-4 covers float32 summation-order differences.
#: The grouped matmuls multiply exact products (bf16 x bf16, or bf16 x an
#: int8 code) on the tensor cores and sum d of them in float32, in another
#: order than the plain version. The tensor cores' float32 accumulation is
#: not specified to round to nearest (it may truncate), so each of the
#: d - 1 additions (and K5's scale multiply) may lose one float32 ulp,
#: 2^-23, of the running sum: they may also lose d 2^-23 ref_abs, where
#: ref_abs = |lhs| @ |rhs[g]| (dequantized for K5).
HALF_ULP = 2.0**-8
F32_ULP = 2.0**-23
KERNEL_ATOL = 1e-4
TOL = {
    "paged_decode": "2^-8*|ref| + 1e-4 (ref in float32)",
    "paged_decode_int8": "2^-8*|ref| + 1e-4 (ref in float32 over the dequantized pool)",
    "flash_prefill": "2^-8*|ref| + 2^-8*ref_abs + 1e-4 (ref in float32)",
    "grouped_matmul_bf16": "2^-8*|ref| + d*2^-23*ref_abs + 1e-4 (ref in float32)",
    "grouped_matmul_int8": "2^-8*|ref| + d*2^-23*ref_abs + 1e-4 (ref in float32, dequantized)",
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


_L2_FLUSH: list = []
#: GPU cycles (~0.1 ms) the card spins before each cold-timed call, so that
#: the host has enqueued the call before its start event is reached
HOST_LEAD_CYCLES = 200_000


def cold_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call with a cold L2: a 256 MiB buffer (over five
    times the H100's 50 MB L2) is read before every call — read, not
    written, so the call does not pay for writing dirty lines back — and
    each call is timed by its own pair of events, recorded after a short
    spin on the card so that the host's own time to enqueue the call is not
    counted. The serving path meets its inputs cold (each of the model's
    layers reads its own slice of the pool), while ``cuda_time_ms`` replays
    the same inputs and may time them from L2."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda"))
    flush = _L2_FLUSH[0]
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.max()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def held(out: torch.Tensor, ref: torch.Tensor, ref_abs=None, abs_coef=HALF_ULP) -> dict:
    """A kernel's output against its float32 plain version: the largest
    absolute error and the largest ratio of error to allowance (at most 1)."""
    err = (out.float() - ref).abs()
    allow = HALF_ULP * ref.abs() + KERNEL_ATOL
    if ref_abs is not None:
        allow = allow + abs_coef * ref_abs
    return {"max_abs_err": float(err.max()), "err_over_allowance": float((err / allow).max())}


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 3: kernels against their plain versions ----------------------------
#: K1 / K1q call forms: each lane's seq_len, the current token included (it
#: rides the call as fresh K/V in the engine's form). "8_lanes": 8 decode
#: lanes of mixed lengths, incl. 0, 1 (history 0) and a partial page, over a
#: 128-page table; "batch1_4096": one lane at 4096 tokens over a 256-page
#: table. The first is the headline; both are held and timed.
DECODE_FORMS = {
    "8_lanes": [0, 1, 17, 300, 1024, 1500, 2047, 2048],
    "batch1_4096": [4096],
}


def decode_inputs(dev, gen, seq_lens_l, n_kv, quantized, llama):
    """Inputs of one decode form at 32 query heads over ``n_kv`` KV heads
    (8: Llama-3.1-8B, GQA group 4; 4: Qwen3-30B-A3B, group 8), hd=128,
    ps=16: a 5-D two-layer pool read at layer 1, each lane's history on
    distinct pages in a random order. For K1q the pages are random bf16
    pages quantized through the port's own write path (every page fresh,
    one scale per page per (layer, kv head))."""
    B, n_q, hd, ps, layers = len(seq_lens_l), 32, 128, 16, 2
    page_counts = [-(-n // ps) for n in seq_lens_l]
    max_pages = max(page_counts)
    P = sum(page_counts) + 64
    bf = torch.bfloat16
    pools = []
    for _ in range(2):  # K, then V
        pages = torch.randn((layers, P, ps, n_kv, hd), generator=gen, device=dev).to(bf)
        if not quantized:
            pools.append((pages, None))
            continue
        codes = torch.zeros((layers, P, ps, n_kv, hd), dtype=torch.int8, device=dev)
        scales = torch.zeros((layers, P, n_kv), dtype=torch.float32, device=dev)
        rows = torch.arange(P, dtype=torch.int32, device=dev)[:, None].expand(P, ps).contiguous()
        slots = torch.arange(ps, dtype=torch.int32, device=dev)[None].expand(P, ps).contiguous()
        llama._quantized_scatter_kv_all_layers(
            codes, scales, pages, rows, slots, torch.ones((P, ps), dtype=torch.bool, device=dev), slots
        )
        pools.append((codes, scales))
        del pages
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = torch.zeros((B, max_pages), dtype=torch.int32, device=dev)
    off = 0
    for i, k in enumerate(page_counts):
        bt[i, :k] = perm[off : off + k].to(torch.int32)
        off += k
    (k, ks), (v, vs) = pools
    return dict(
        q=torch.randn((B, n_q, hd), generator=gen, device=dev).to(bf), k=k, v=v, k_scale=ks,
        v_scale=vs, bt=bt, seq_lens=torch.tensor(seq_lens_l, dtype=torch.int32, device=dev),
        fk=torch.randn((B, n_kv, hd), generator=gen, device=dev).to(bf),
        fv=torch.randn((B, n_kv, hd), generator=gen, device=dev).to(bf),
    )


def decode_form(ops, dev, gen, seq_lens_l, n_kv, quantized, models, llama, timed=True) -> dict:
    """One decode form: held with and without the fresh token against the
    float32 plain version (for K1q over the pool dequantized to float32),
    then (``timed``) timed with a cold L2 in the engine's call form (fresh
    token, 5-D pools) beside SDPA (K1 only), with its bound; with the grid
    the wrapper launched."""
    name = "paged_decode_int8" if quantized else "paged_decode"
    wrapper = ops.paged_decode_int8 if quantized else ops.paged_attention
    x = decode_inputs(dev, gen, seq_lens_l, n_kv, quantized, llama)
    q, k, v, bt, sl, fk, fv = (x[key] for key in ("q", "k", "v", "bt", "seq_lens", "fk", "fv"))
    B, n_q, hd = q.shape
    ps, max_pages = k.shape[2], bt.shape[1]
    scales_kw = dict(k_scale=x["k_scale"], v_scale=x["v_scale"]) if quantized else {}
    if quantized:
        wide_k = models.dequantize_kv_pool(k, x["k_scale"], torch.float32)
        wide_v = models.dequantize_kv_pool(v, x["v_scale"], torch.float32)
    else:
        wide_k, wide_v = k, v
    cases = {}
    for fresh in (False, True):
        extra = (fk, fv) if fresh else ()
        out = ops.paged_attention(q, k, v, bt, sl, *extra, **scales_kw, layer=1)
        ref = ops.paged_attention_reference(q.float(), wide_k, wide_v, bt, sl, *extra, layer=1)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"{name} produced non-finite values (fresh={fresh})")
        for i, n in enumerate(seq_lens_l):
            if n == 0 and out[i].float().abs().max() != 0:
                fail(f"{name}: seq_len == 0 row is not zero")
        cases[f"fresh={fresh}"] = held(out, ref)
    del wide_k, wide_v
    if not timed:
        return dict(cases=cases, seq_lens=seq_lens_l, max_pages=max_pages, group=n_q // n_kv,
                    **launched_plan(wrapper))

    args = (q, k, v, bt, sl, fk, fv)
    ms = cold_time_ms(lambda: ops.paged_attention(*args, **scales_kw, layer=1))
    plan = launched_plan(wrapper)
    plain_ms = cuda_time_ms(lambda: ops.paged_attention_reference(*args, **scales_kw, layer=1), iters=5)
    library_ms = None
    if not quantized:
        # SDPA over K/V gathered beforehand into contiguous [B, n_q, T + 1,
        # hd] buffers (GQA heads expanded, fresh token appended).
        T = max_pages * ps
        gk = k[1][bt.long()].reshape(B, T, n_kv, hd)
        gv = v[1][bt.long()].reshape(B, T, n_kv, hd)
        gk = torch.cat([gk, fk[:, None]], 1).transpose(1, 2).repeat_interleave(n_q // n_kv, 1).contiguous()
        gv = torch.cat([gv, fv[:, None]], 1).transpose(1, 2).repeat_interleave(n_q // n_kv, 1).contiguous()
        ar = torch.arange(T + 1, device=dev)
        mask = (ar[None, :] < (sl[:, None] - 1)) | ((ar[None, :] == T) & (sl[:, None] > 0))
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]
        library_ms = cold_time_ms(lambda: F.scaled_dot_product_attention(q4, gk, gv, attn_mask=mask))
        del gk, gv
    hist = sum(max(n - 1, 0) for n in seq_lens_l)
    pages_read = sum(-(-max(n - 1, 0) // ps) for n in seq_lens_l)
    n_bytes = (
        hist * n_kv * hd * 2 * (1 if quantized else 2)  # K and V history
        + (pages_read * n_kv * 4 * 2 if quantized else 0)  # one f32 K and V scale per page per head
        + 2 * B * n_q * hd * 2  # q in, out
        + 2 * B * n_kv * hd * 2  # fresh K/V
        + B * max_pages * 4 + B * 4  # block tables, lengths
    )
    flops = 4 * n_q * hd * sum(seq_lens_l) + (2 * hist * n_kv * hd if quantized else 0)  # + dequantization
    b_ms, b_by = bound_ms(n_bytes, flops)
    return dict(cases=cases, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, seq_lens=seq_lens_l, max_pages=max_pages, **plan)


def launched_plan(wrapper) -> dict:
    """The split-pass grid and pages a split of the wrapper's last launch."""
    plan = wrapper.last_plan
    grid = list(plan["grid"])
    return dict(grid=grid, blocks=grid[0] * grid[1] * grid[2], splits=grid[2],
                pages_per_split=plan["pages_per_split"])


def check_decode(ops, dev, gen, n_kv=8, *, quantized=False, models=None, llama=None) -> dict:
    """K1 (bf16 pages) or K1q (int8 pages) in every ``DECODE_FORMS`` form,
    each held element by element and timed; the headline is "8_lanes". At
    8 KV heads the 8-lane form is also held (not timed) over 2 KV heads: a
    GQA group of 16, two 8-row query tiles a kv head, which no served model
    has."""
    name = "paged_decode_int8" if quantized else "paged_decode"
    forms = {}
    for form, seq_lens_l in DECODE_FORMS.items():
        forms[form] = decode_form(ops, dev, gen, seq_lens_l, n_kv, quantized, models, llama)
        free_cuda()
    if n_kv == 8:
        forms["8_lanes_group16"] = decode_form(ops, dev, gen, DECODE_FORMS["8_lanes"], 2, quantized,
                                               models, llama, timed=False)
        free_cuda()
    cases = [c for f in forms.values() for c in f["cases"].values()]
    worst = max(c["err_over_allowance"] for c in cases)
    if worst > 1:
        fail(f"{name} differs from its plain version beyond {TOL[name]}: {forms}")
    top = forms["8_lanes"]
    return {
        "name": name,
        "route": "cuda",
        "source": "llm_d_kv_cache_manager_tpu_torch/csrc/paged_decode.cu",
        "replaces": "llm_d_kv_cache_manager_tpu/ops/paged_attention.py:40"
                    + (" (quantized=True)" if quantized else ""),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "err_over_allowance": worst,
        "tol": TOL[name],
        "ms": top["ms"],
        "kernel_ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        **({"library_note": "no single PyTorch call attends over int8 pages with per-page scales"}
           if quantized else {}),
        "headline_form": "8_lanes",
        "timing": "L2 flushed before each call",
        "shape": {"n_q": 32, "n_kv": n_kv, "hd": 128, "ps": 16, "layer": 1},
        "forms": forms,
    }


#: flash_prefill's call forms, each held against its plain version and
#: timed. The first is the headline. The engine pads a prefill dispatch to
#: 8 rows and its chunk to a multiple of 64: a cold dispatch has a
#: zero-width block table; a warm one (two repeats of a 1024-token prompt,
#: 1008 tokens cached) has six rows with nothing valid and a context that
#: ends inside a key tile.
PREFILL_FORMS = {
    "kernels_phase": dict(b=2, s=512, ctx=[0, 1024], nv=[512, 300], ctx_pages=64),
    "engine_cold": dict(b=8, s=1024, ctx=[0] * 8, nv=[1024] * 6 + [517, 0], ctx_pages=0),
    "engine_warm": dict(b=8, s=64, ctx=[1008] * 2 + [0] * 6, nv=[16] * 2 + [0] * 6, ctx_pages=64),
}


def prefill_inputs(dev, gen, b, s, ctx, nv, ctx_pages, n_q=32, n_kv=8, hd=128, ps=16):
    """Random bf16 inputs at 8B (``n_kv=8``) or Qwen3-30B-A3B (``n_kv=4``)
    attention widths; each row's context lies on distinct pages of a pool,
    in a random order, named by its block table."""
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


def time_prefill_form(ops, dev, args, form) -> dict:
    """K2 at one form with a cold L2, beside its plain version, SDPA over
    [context ++ chunk] gathered beforehand into contiguous buffers (GQA
    heads expanded, the same mask), and its bound."""
    q, k, v, k_pages, v_pages, bt, ctx_lens, n_valid = args
    b, s, n_q, hd = q.shape
    n_kv, ps = k.shape[2], k_pages.shape[1]
    ms = cold_time_ms(lambda: ops.flash_prefill_paged(*args))
    plain_ms = cuda_time_ms(lambda: ops.flash_prefill_plain(*args), iters=3, warmup=1)
    cp = form["ctx_pages"] * ps
    gk = torch.cat([k_pages[bt.long()].reshape(b, -1, n_kv, hd), k], 1)
    gv = torch.cat([v_pages[bt.long()].reshape(b, -1, n_kv, hd), v], 1)
    gk = gk.transpose(1, 2).repeat_interleave(n_q // n_kv, 1).contiguous()
    gv = gv.transpose(1, 2).repeat_interleave(n_q // n_kv, 1).contiguous()
    qi = torch.arange(s, device=dev)[None, :, None]
    kj = torch.arange(cp + s, device=dev)[None, None, :]
    mask = torch.where(
        kj < cp, kj < ctx_lens[:, None, None], (kj - cp <= qi) & (kj - cp < n_valid[:, None, None])
    ) & (qi < n_valid[:, None, None])
    mask = mask[:, None]
    qt = q.transpose(1, 2).contiguous()
    library_ms = cold_time_ms(lambda: F.scaled_dot_product_attention(qt, gk, gv, attn_mask=mask))
    del gk, gv, mask, qt
    flops = sum(4 * n_q * hd * nv * (c + (nv + 1) / 2) for c, nv in zip(form["ctx"], form["nv"]))
    n_bytes = (
        2 * q.numel() * 2  # q in, out
        + 2 * k.numel() * 2  # chunk K, V
        + sum(form["ctx"]) * n_kv * hd * 2 * 2  # context K, V from the pool
        + bt.numel() * 4 + 2 * b * 4
    )
    b_ms, b_by = bound_ms(n_bytes, flops)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def check_flash_prefill(ops, dev, gen, n_kv=8):
    """K2 at prefill shapes (32 query heads over ``n_kv`` KV heads), in the
    call forms of ``PREFILL_FORMS`` — the MoE engine pads and buckets as
    the 8B one does, so its cold and warm forms are the same shapes — each
    held and timed; the headline is "kernels_phase": b=2, chunk 512
    right-padded, context 0 and 1024 tokens read through the block table."""
    forms = {}
    for name, form in PREFILL_FORMS.items():
        args = prefill_inputs(dev, gen, form["b"], form["s"], form["ctx"], form["nv"],
                              form["ctx_pages"], n_kv=n_kv)
        forms[name] = dict(hold_prefill_form(ops, name, args, form["nv"]),
                           **time_prefill_form(ops, dev, args, form),
                           **{key: form[key] for key in ("b", "s", "ctx", "nv", "ctx_pages")})
        del args
        free_cuda()
    worst = max(c["err_over_allowance"] for c in forms.values())
    if worst > 1:
        fail(f"flash_prefill differs from its plain version beyond {TOL['flash_prefill']}: {forms}")
    top = forms["kernels_phase"]
    return {
        "name": "flash_prefill",
        "route": "cuda",
        "source": "llm_d_kv_cache_manager_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "llm_d_kv_cache_manager_tpu/ops/flash_prefill.py:66",
        "also_serves": "llm_d_kv_cache_manager_tpu/ops/flash_prefill.py:192",
        "max_abs_err": max(c["max_abs_err"] for c in forms.values()),
        "err_over_allowance": worst,
        "tol": TOL["flash_prefill"],
        "ms": top["ms"],
        "kernel_ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "headline_form": "kernels_phase",
        "timing": "L2 flushed before each call",
        "shape": {"n_q": 32, "n_kv": n_kv, "hd": 128, "ps": 16},
        "forms": forms,
    }


#: Qwen3-30B-A3B expert geometry: 128 experts, top-8; (d, f) of the gate and
#: up products and of the down product.
MOE_E, MOE_TOPK = 128, 8
GMM_WIDTHS = {"gate_up": (2048, 768), "down": (768, 2048)}
#: call forms held against the plain version; the first three also timed
GMM_FORMS = ("prefill", "decode", "edge", "one_expert", "ragged")
GMM_TIMED = ("prefill", "decode", "edge")


def gmm_group_sizes(form: str, gen, dev) -> tuple[list[int], int]:
    """Rows per expert and the row count of one call form. prefill /
    decode: the experts of top-8 over random router logits for 8 x 1024 /
    8 tokens (65,536 / 64 rows). edge: empty first and last groups, one
    group holding most rows, and 11 rows past the last group, 5001 rows in
    all — no multiple of any tile. one_expert: all 65,536 rows in one
    group, the other 127 empty (the persistent walk over many tiles of one
    group). ragged: sizes 1..700 from the seeded generator and 37 rows past
    the last group (tiles that straddle the next group, and the zero
    tail)."""
    if form == "edge":
        sizes = torch.randint(0, 16, (MOE_E,), generator=gen, device=dev).tolist()
        sizes[0] = sizes[-1] = sizes[MOE_E // 2] = 0
        sizes[MOE_E // 2] = 4990 - sum(sizes)
        return sizes, 5001
    if form == "one_expert":
        sizes = [0] * MOE_E
        sizes[MOE_E // 3] = 8 * 1024 * MOE_TOPK
        return sizes, sizes[MOE_E // 3]
    if form == "ragged":
        sizes = torch.randint(1, 701, (MOE_E,), generator=gen, device=dev).tolist()
        return sizes, sum(sizes) + 37
    tokens = 8 * 1024 if form == "prefill" else 8
    logits = torch.randn((tokens, MOE_E), generator=gen, device=dev)
    topi = logits.topk(MOE_TOPK, dim=-1).indices
    sizes = torch.bincount(topi.reshape(-1), minlength=MOE_E).tolist()
    return sizes, tokens * MOE_TOPK


def grouped_mm_library_ms(lhs, rhs, gs):
    """One PyTorch call computing K4's function, where the installed torch
    has one (``torch._grouped_mm``, rows split by cumulative offsets); the
    port never calls it. Returns (ms, why there is none)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        fn(lhs, rhs, offs=offs)
        torch.cuda.synchronize()
        return cold_time_ms(lambda: fn(lhs, rhs, offs=offs)), None
    except Exception as e:  # a yardstick only: record why it is missing
        return None, f"torch._grouped_mm refused: {type(e).__name__}: {str(e)[:160]}"


def host_enqueue_us(fn, calls: int = 50) -> float:
    """Median host time of one call while the card is held busy by a long
    spin queued before them, so that only enqueueing is timed."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~60 ms of GPU cycles ahead of the calls
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def check_grouped_matmul(ops, models, dev, gen) -> list[dict]:
    """K4 (bf16 experts) and K5 (int8 experts) at Qwen3-30B-A3B widths,
    gate/up and down, in every ``GMM_FORMS`` form: each held element by
    element against the float32 plain version, and the ``GMM_TIMED`` forms
    timed with the L2 flushed before each call, beside the plain version
    and, for K4, the library call; each with the plan the wrapper launched.
    At the decode form the host time of one call is read too."""
    bf = torch.bfloat16
    results = {"grouped_matmul_bf16": {}, "grouped_matmul_int8": {}}
    for width, (d, f) in GMM_WIDTHS.items():
        w = (torch.randn((MOE_E, d, f), generator=gen, device=dev) * d**-0.5).to(bf)
        stacks = {"grouped_matmul_bf16": w, "grouped_matmul_int8": models.quantize_tensor(w)}
        for form in GMM_FORMS:
            sizes, rows = gmm_group_sizes(form, gen, dev)
            in_groups = sum(sizes)
            gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
            rgi = torch.repeat_interleave(torch.arange(MOE_E, device=dev), gs.long())
            rgi = torch.cat([rgi, torch.full((rows - in_groups,), MOE_E - 1, device=dev)]).int()
            lhs = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            nonempty = sum(1 for n in sizes if n > 0)
            for name, rhs in stacks.items():
                quantized = name == "grouped_matmul_int8"
                call = lambda: ops.grouped_matmul(lhs, rhs, gs, row_group_ids=rgi)  # noqa: E731
                out = call()
                if quantized:
                    ref = ops.grouped_matmul_plain(lhs.float(), rhs, gs, row_group_ids=rgi)
                    absq = models.QuantizedTensor(q=rhs.q.abs(), scale=rhs.scale)
                    ref_abs = ops.grouped_matmul_plain(lhs.float().abs(), absq, gs, row_group_ids=rgi)
                else:
                    ref = ops.grouped_matmul_plain(lhs.float(), rhs.float(), gs)
                    ref_abs = ops.grouped_matmul_plain(lhs.float().abs(), rhs.float().abs(), gs)
                torch.cuda.synchronize()
                if not torch.isfinite(out.float()).all():
                    fail(f"{name} produced non-finite values ({form}/{width})")
                if (out[in_groups:] != 0).any():
                    fail(f"{name}: rows past the last group are not zero ({form}/{width})")
                case = held(out, ref, ref_abs, abs_coef=d * F32_ULP)
                plan = getattr(ops, name).last_plan
                if not (call() == out).all():
                    fail(f"{name}: two calls on the same inputs differ ({form}/{width})")
                del ref, ref_abs, out
                entry = dict(case, rows=rows, d=d, f=f, nonempty_groups=nonempty,
                             max_group=max(sizes), plan=plan)
                results[name][f"{form}/{width}"] = entry
                if form not in GMM_TIMED:
                    continue
                ms = cold_time_ms(call)
                plain_ms = cuda_time_ms(
                    lambda: ops.grouped_matmul_plain(lhs, rhs, gs, row_group_ids=rgi), iters=3, warmup=1
                )
                if quantized:
                    library_ms, library_note = None, (
                        "no single PyTorch call computes a grouped matmul over int8 "
                        "weights with per-channel scales")
                else:
                    library_ms, library_note = grouped_mm_library_ms(lhs, rhs, gs)
                w_bytes = nonempty * d * f * (1 if quantized else 2)
                n_bytes = (
                    w_bytes + (nonempty * f * 4 if quantized else 0)  # weights (+ scales)
                    + rows * d * 2 + rows * f * 2 + MOE_E * 4  # lhs in, out, group sizes
                )
                b_ms, b_by = bound_ms(n_bytes, 2 * in_groups * d * f)
                entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms, library_note=library_note)
                if form == "decode":
                    entry["host_us"] = host_enqueue_us(call)
            del lhs
        del w, stacks
        free_cuda()
    entries = []
    for name, forms in results.items():
        worst = max(c["err_over_allowance"] for c in forms.values())
        if worst > 1:
            fail(f"{name} differs from its plain version beyond {TOL[name]}: {forms}")
        top = forms["prefill/gate_up"]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "llm_d_kv_cache_manager_tpu_torch/csrc/grouped_matmul.cu",
            "timing": "L2 flushed before each call",
            "replaces": ("llm_d_kv_cache_manager_tpu/ops/gmm.py:115" if name.endswith("bf16")
                         else "llm_d_kv_cache_manager_tpu/ops/gmm.py:149"),
            "max_abs_err": max(c["max_abs_err"] for c in forms.values()),
            "err_over_allowance": worst,
            "tol": TOL[name],
            "ms": top["ms"],
            "kernel_ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library_note": top["library_note"],
            "headline_form": "prefill/gate_up",
            "forms": forms,
        })
    return entries


def check_moe_layer(models, llama, ops, dev, gen) -> dict:
    """One routed MoE layer at Qwen3-30B-A3B width (bf16 experts, then
    int8 experts) at the decode and prefill shapes, run under
    ``torch.cuda.set_sync_debug_mode("error")``: any host synchronisation
    on the path raises. Its output is held against the same layer with
    ``moe_gmm="xla"`` (the plain grouped matmul): within 2 % of the output's
    largest magnitude, since both round each product's output to bf16."""
    cfg = dataclasses.replace(models.QWEN3_30B_A3B, n_layers=1, vocab_size=128)
    plain_cfg = dataclasses.replace(cfg, moe_gmm="xla")
    results = {}
    for quantize in (None, "int8"):
        params = models.init_params(cfg, gen, dev, quantize=quantize,
                                    quantize_experts=quantize is not None)
        layer = params["layers"][0]
        for form, shape in (("decode", (8, 1)), ("prefill", (8, 1024))):
            x = torch.randn((*shape, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
            torch.cuda.synchronize()
            before = ops.grouped_matmul_bf16.launches + ops.grouped_matmul_int8.launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = llama._moe_mlp(layer, cfg, x)
            except RuntimeError as e:
                fail(f"MoE layer ({quantize or 'bf16'}, {form}) synchronised with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            launched = ops.grouped_matmul_bf16.launches + ops.grouped_matmul_int8.launches - before
            ref = llama._moe_mlp(layer, plain_cfg, x).float()
            err = float((out.float() - ref).abs().max())
            scale = float(ref.abs().max())
            key = f"{'int8' if quantize else 'bf16'}/{form}"
            if not torch.isfinite(out.float()).all() or out.shape != x.shape:
                fail(f"MoE layer {key}: bad output")
            if launched != 3 or err > 0.02 * scale:
                fail(f"MoE layer {key}: {launched} grouped-matmul launches, error {err} vs 2% of {scale}")
            results[key] = {"rows": shape[0] * shape[1] * MOE_TOPK, "max_abs_err_vs_plain": err,
                            "max_abs_ref": scale, "grouped_matmul_launches": launched,
                            "layer_ms": cuda_time_ms(lambda: llama._moe_mlp(layer, cfg, x), iters=10)}
        del params, layer
        free_cuda()
    return results


# -- the serving paths at full width ------------------------------------------
#: Each path is driven once, at full width and depth, with every launch
#: count set to 0 just before it and read just after. The pod serves
#: ``model`` (its preset name); ``quantize="int8"`` also quantizes the
#: expert stacks; ``kv_quant_hbm="int8"`` keeps the KV pages as int8 codes
#: and ``chunked_prefill`` sets the per-step prefill token budget (mixed
#: prefill/decode steps).
PATHS = (
    dict(label="llama_3_8b", model="meta-llama/Llama-3.1-8B-Instruct", quantize=None,
         fast_path=True, host_tier=True, kv_transfer=True),
    dict(label="qwen3_30b_a3b", model="Qwen/Qwen3-30B-A3B", quantize=None),
    dict(label="qwen3_30b_a3b_int8", model="Qwen/Qwen3-30B-A3B", quantize="int8",
         fast_path=True),
    dict(label="llama_3_8b_kvq", model="meta-llama/Llama-3.1-8B-Instruct", quantize=None,
         kv_quant_hbm="int8", chunked_prefill=512, same_tokens_as="llama_3_8b"),
)


#: the kernel functions each counted wrapper (``ops.COUNTED``) launches once
#: a call, as the profiler names them (a traced name holds one of the
#: patterns); every K1 call, bf16 or int8 pages, also launches one
#: ``combine_kernel``
TRACED = {
    "paged_decode": ("::split_decode_kernel<__nv_bfloat16",),
    "paged_decode_int8": ("::split_decode_kernel<signed char",),
    "flash_prefill": ("flash_prefill_kernel",),
    "grouped_matmul_bf16": ("::decode_kernel<__nv_bfloat16", "::prefill_kernel<__nv_bfloat16"),
    "grouped_matmul_int8": ("::decode_kernel<signed char", "::prefill_kernel<signed char"),
}


def expected_launches(cfg, quantize, kv_quant_hbm, prefill_dispatches: int,
                      decode_steps: int) -> dict:
    """One attention launch per layer per prefill dispatch and per decode
    model step (decode on the int8 kernel over int8 pages); for an MoE model
    three grouped matmuls (gate, up, down) per layer per dispatch or step,
    on the int8 kernel when the experts are quantized. A decode burst of k
    steps is one graph replay, which counts the launches its capture
    recorded: k per layer."""
    n = cfg.n_layers
    decode = "paged_decode_int8" if kv_quant_hbm else "paged_decode"
    out = {"paged_decode": 0, "paged_decode_int8": 0, "flash_prefill": n * prefill_dispatches,
           "grouped_matmul_bf16": 0, "grouped_matmul_int8": 0}
    out[decode] = n * decode_steps
    if cfg.n_experts:
        gmm = "grouped_matmul_int8" if quantize else "grouped_matmul_bf16"
        out[gmm] = 3 * n * (prefill_dispatches + decode_steps)
    return out


@contextlib.contextmanager
def moe_routing(llama, pinned=None):
    """Within the block, record each MoE layer's routing as the model runs:
    its top-k expert ids ``[rows, k]`` and, per row, the gap between the
    k-th and (k+1)-th router weights (how near a tie the choice was). With
    ``pinned`` — the ids another pass recorded, one per layer in call order,
    cut to this pass's rows — the layers use those ids instead of their own
    top-k, with gate values from this pass's router weights at them."""
    calls, orig = [], llama._moe_gates

    def gates(layer, cfg, x):
        topv, topi = orig(layer, cfg, x)
        weights = torch.softmax((x @ layer["router"]).float(), dim=-1)
        top = weights.topk(cfg.n_experts_per_tok + 1, dim=-1).values
        if pinned is not None:
            topi = pinned[len(calls)]
            topv = weights.gather(-1, topi)
            if cfg.norm_topk_prob:
                topv = topv / topv.sum(dim=-1, keepdim=True)
        calls.append((topi, top[:, -2] - top[:, -1]))
        return topv, topi

    llama._moe_gates = gates
    try:
        yield calls
    finally:
        llama._moe_gates = orig


def routing_flips(a: list, b: list) -> tuple[torch.Tensor, torch.Tensor]:
    """[layers, rows] masks of the rows whose top-k expert set differs
    between two recordings of the same tokens, and the k-th vs (k+1)-th
    weight gaps of the first."""
    flips = torch.stack([(ia.sort(-1).values != ib.sort(-1).values).any(-1)
                         for (ia, _), (ib, _) in zip(a, b)])
    return flips, torch.stack([gap for _, gap in a])


def warm_vs_cold(models, llama, params, cfg, prompt, ps, dev, kv_quant_hbm=None) -> dict:
    """First-token logits of one prompt, straight through the model on a
    scratch pool: the cold pass prefills the whole prompt; the warm pass
    prefills all but the last page, then the last page against that context
    (the flash kernel's block-table path). bf16 activations through every
    layer round at different places in the two passes; agreement within 5 %
    of the logit range is the bar. On an int8 pool (``kv_quant_hbm``) the
    warm pass reads its context as int8 codes widened to bf16 while the
    cold pass reads none, so the bar also covers the quantization.

    In an MoE a rounding-level difference can flip a near-tied top-k choice,
    and a flipped expert moves the result by far more than rounding. So for
    an MoE the warm pass is also run with every token's routing pinned to
    the cold pass's choices, and the bar is held there. The unpinned
    difference is only reported, beside the routing flips that explain it:
    random Qwen3-30B-A3B routers flip some near-tied expert in every run,
    so no bar on the unpinned reading could tell a wrong warm path from a
    flip. The pinned pass is the check."""
    n = len(prompt)
    pages = n // ps + 1
    kp, vp = models.init_kv_pages(cfg, pages + 1, ps, dev, kv_quant_hbm=kv_quant_hbm)
    scales = models.init_kv_scales(cfg, pages + 1, dev) if kv_quant_hbm else ()
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)

    def run_chunk(tokens, start):
        m = len(tokens)
        pos = torch.arange(start, start + m, dtype=torch.int32, device=dev)[None]
        t = torch.tensor(tokens, dtype=torch.int32, device=dev)[None]
        valid = torch.ones((1, m), dtype=torch.bool, device=dev)
        n_ctx = start // ps
        return models.prefill(
            params, cfg, t, pos, valid, kp, vp,
            table[(pos.long() // ps)], pos % ps,
            table[:n_ctx][None].contiguous() if n_ctx else torch.zeros((1, 0), dtype=torch.int32, device=dev),
            torch.tensor([start], dtype=torch.int32, device=dev),
            *scales,
        )[0][0]

    def warm_pass(pinned=None):
        for pool in (kp, vp) + tuple(scales):
            pool.zero_()
        split = n - ps
        ctx_pin = None if pinned is None else [ids[:split] for ids, _ in pinned]
        chunk_pin = None if pinned is None else [ids[split:] for ids, _ in pinned]
        with moe_routing(llama, ctx_pin) as ctx_routing:
            run_chunk(prompt[:split], 0)
        with moe_routing(llama, chunk_pin) as chunk_routing:
            logits = run_chunk(prompt[split:], split)
        return logits, ctx_routing, chunk_routing

    with moe_routing(llama) as cold_routing:
        cold = run_chunk(prompt, 0)
    warm, ctx_routing, chunk_routing = warm_pass()
    torch.cuda.synchronize()
    if not (torch.isfinite(cold).all() and torch.isfinite(warm).all()):
        fail("non-finite first-token logits")
    scale = float(cold.abs().max())
    tol = 0.05 * scale
    out = {"max_abs_diff_warm_vs_cold": float((warm - cold).abs().max()), "tol": tol,
           "max_abs_cold": scale, "argmax_equal": int(cold.argmax()) == int(warm.argmax())}
    if not cold_routing:  # a dense model: nothing to pin
        if out["max_abs_diff_warm_vs_cold"] > tol:
            fail(f"warm vs cold first-token logits differ by {out['max_abs_diff_warm_vs_cold']} > {tol}")
        return out
    flips, gaps = routing_flips(
        cold_routing, [(torch.cat([a, b]), None) for (a, _), (b, _) in zip(ctx_routing, chunk_routing)]
    )
    pinned, _, pinned_chunk = warm_pass(pinned=cold_routing)
    if any((ids != c[0][n - ps:]).any() for (ids, _), c in zip(pinned_chunk, cold_routing)):
        fail("the pinned warm pass did not use the cold pass's routing")
    flipped_gaps = gaps[flips]
    out["routing"] = {
        "layers": len(cold_routing),
        "flipped_rows_context": int(flips[:, : n - ps].sum()),
        "flipped_rows_last_page": int(flips[:, n - ps :].sum()),
        "last_token_flipped_layers": flips[:, -1].nonzero().flatten().tolist(),
        "layers_with_a_flip": int(flips.any(-1).sum()),
        "gap_at_flips_max": float(flipped_gaps.max()) if flipped_gaps.numel() else None,
        "gap_median_all": float(gaps.median()),
    }
    out["pinned_max_abs_diff"] = float((pinned - cold).abs().max())
    out["pinned_argmax_equal"] = int(cold.argmax()) == int(pinned.argmax())
    if out["pinned_max_abs_diff"] > tol:
        fail(f"warm (routing pinned) vs cold first-token logits differ by {out['pinned_max_abs_diff']} > {tol}: {out}")
    return out


def run_engine(pkg, ops, dev, card: str, path: dict, greedy_tokens: dict) -> dict:
    models, server, serve, kvblock = pkg["models"], pkg["server"], pkg["serve"], pkg["kvblock"]
    cfg = serve._resolve_model(path["model"])
    quantize = path["quantize"]
    kv_quant_hbm = path.get("kv_quant_hbm")
    ps, n_prompts, prompt_len, shared_len, new_tokens, n_repeats = 16, 8, 1024, 512, 32, 2

    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = models.init_params(cfg, gen, dev, quantize=quantize,
                                quantize_experts=quantize is not None)
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
            quantize=quantize,
            quantize_experts=quantize is not None,
            kv_quant_hbm=kv_quant_hbm,
            scheduler=server.SchedulerConfig(chunked_prefill_tokens=path.get("chunked_prefill")),
        ),
        params=params,
        on_events=lambda evs: events.extend(evs),
        device=dev,
    )
    param_gib = models.param_bytes(eng.params) / 2**30
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, cfg.vocab_size, shared_len).tolist()
    prompts = [
        shared + rng.integers(0, cfg.vocab_size, prompt_len - shared_len).tolist()
        for _ in range(n_prompts)
    ]
    def greedy():
        return server.SamplingParams(max_new_tokens=new_tokens)

    # Step time by what the step dispatched: a prefill, a decode, or both
    # (a mixed step, with chunked prefill).
    phase = {f"{kind}_{key}": 0 for kind in ("prefill", "decode", "mixed")
             for key in ("s", "steps")}
    phase.update(decode_tokens=0, mixed_decode_tokens=0)

    def drive():
        while eng.has_work:
            p0, d0 = eng.prefill_stats["dispatches"], eng.decode_stats["dispatches"]
            running = len(eng.scheduler.running)
            t = time.perf_counter()
            eng.step()
            dt = time.perf_counter() - t
            prefilled = eng.prefill_stats["dispatches"] > p0
            decoded = eng.decode_stats["dispatches"] > d0
            kind = "mixed" if prefilled and decoded else "prefill" if prefilled else "decode"
            phase[f"{kind}_s"] += dt
            phase[f"{kind}_steps"] += 1
            if decoded:
                phase["mixed_decode_tokens" if prefilled else "decode_tokens"] += running

    # The main path: counts are zeroed just before it and read just after.
    # The first requests go to the engine directly; the repeats, which hit
    # the prefix cache, through the pod server's request API and its
    # engine-loop thread.
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    first = [eng.add_request(p, greedy()) for p in prompts]
    drive()
    cold_computed = eng.prefill_stats["tokens_computed"]
    pod = serve.PodServer(
        serve.PodServerConfig(model_name=path["model"], publish_events=False), engine=eng
    )
    pod.start()
    try:
        futures = [pod.submit(prompts[i], greedy()) for i in range(n_repeats)]
        repeats = [f.result(timeout=600) for f in futures]
    finally:
        pod.shutdown()
    launches = {name: wrapper.launches for name, wrapper in ops.COUNTED.items()}
    torch.cuda.synchronize()
    prefill_dispatches = eng.prefill_stats["dispatches"]
    decode_dispatches = eng.decode_stats["dispatches"]
    # The model steps the replays ran, and the warm-up's eager steps before
    # the first capture (real launches).
    decode_steps = eng.decode_stats["steps"] + eng.decode_graphs.warmup_steps

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
    if warm_computed >= n_repeats * ps + 1:
        fail(f"repeats recomputed {warm_computed} tokens despite the prefix hit")
    stored = {h for e in events if type(e).__name__ == "BlockStored" for h in e.block_hashes}
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=ps))
    for p in prompts:
        missing = [h for h in db.prefix_hashes(p) if h not in stored]
        if missing:
            fail(f"{len(missing)} prompt block hashes never published as BlockStored")
    if prefill_dispatches == 0 or decode_dispatches == 0:
        fail(f"{path['label']}: {prefill_dispatches} prefill and {decode_dispatches} decode dispatches")
    if path.get("chunked_prefill") and phase["mixed_steps"] == 0:
        fail(f"{path['label']}: chunked prefill made no mixed prefill/decode step")
    expected = expected_launches(cfg, quantize, kv_quant_hbm, prefill_dispatches, decode_steps)
    if launches != expected:
        fail(f"{path['label']}: kernel launches {launches} != expected {expected}")
    greedy_tokens[path["label"]] = [list(s.generated_tokens) for s in first + repeats]
    same = path.get("same_tokens_as")
    extra = {}
    if same:
        # Reported without a bar: int8 KV pages may flip greedy tokens.
        pairs = [(a, b) for sa, sb in zip(greedy_tokens[same], greedy_tokens[path["label"]])
                 for a, b in zip(sa, sb)]
        extra["greedy_tokens_equal_share_vs_" + same] = sum(a == b for a, b in pairs) / len(pairs)
        extra["greedy_requests_equal_vs_" + same] = sum(
            a == b for a, b in zip(greedy_tokens[same], greedy_tokens[path["label"]]))
    if kv_quant_hbm:
        extra["sync_free_decode_steps"] = sync_free_decode_steps(models, ops, eng, cfg, prompts, ps, dev)

    logits = warm_vs_cold(models, pkg["llama"], eng.params, cfg, prompts[0], ps, dev, kv_quant_hbm)

    profile = profile_decode(eng, prompts, server, ops)
    emit({
        "phase": "engine",
        "model": path["label"],
        "served_as": path["model"],
        "quantize": quantize,
        "quantize_experts": quantize is not None,
        "kv_quant_hbm": kv_quant_hbm,
        "chunked_prefill_tokens": path.get("chunked_prefill"),
        "n_layers": cfg.n_layers,
        "card": card,
        "init_params_s": init_s,
        "param_gib": param_gib,
        "requests": len(first) + len(repeats),
        "repeats_via_pod_server": len(repeats),
        "new_tokens_each": new_tokens,
        "prefill_dispatches": prefill_dispatches,
        "decode_dispatches": decode_dispatches,
        "decode_steps_with_warmup": decode_steps,
        "decode_graphs": {"keys": eng.decode_graphs.keys,
                          "pool_bytes": eng.decode_graphs.pool_bytes()},
        "tokens_computed_cold": cold_computed,
        "tokens_computed_repeats": warm_computed,
        "cached_prompt_tokens_repeats": [s.num_cached_prompt for s in repeats],
        "launches": launches,
        "block_stored_hashes": len(stored),
        "first_token_logits": logits,
        # Prefill tokens over the steps that prefilled (mixed ones too);
        # decode tokens over the steps that only decoded.
        "prefill_tokens_per_s": cold_computed / (phase["prefill_s"] + phase["mixed_s"]),
        "decode_tokens_per_s": phase["decode_tokens"] / phase["decode_s"],
        **phase,
        "kv_pool_gib": sum(t.numel() * t.element_size() for t in
                           (eng.k_pages, eng.v_pages, eng.k_scales, eng.v_scales)
                           if t is not None) / 2**30,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "phase_wall_s": time.perf_counter() - t_phase,
        **extra,
    })
    emit(dict(profile, model=path["label"]))
    if path.get("fast_path"):
        t0 = time.perf_counter()
        fast = decode_fast_path(pkg, ops, eng, cfg, prompts, ps, dev)
        emit(dict({"phase": "decode_fast_path", "model": path["label"], "card": card},
                  **fast, seconds=time.perf_counter() - t0))
    by_path = {path["label"]: launches}
    if path.get("host_tier"):
        label = path["label"] + "_host_tier"
        result, by_path[label] = host_tier(pkg, ops, dev, card, eng.params, cfg)
        emit(dict(result, path=label))
    if path.get("kv_transfer"):
        label = path["label"] + "_kv_transfer"
        result, by_path[label] = kv_transfer(pkg, ops, dev, card, eng.params, cfg)
        emit(dict(result, path=label))
    return by_path


# -- the host-DRAM tier --------------------------------------------------------
#: PCIe 5.0 x16, one direction, nominal: the bound of a copy between the
#: card and pinned host memory
PCIE_BYTES_S = 64e9
#: The host tier's engines, in the order they run: (label, engine knobs, the
#: label whose greedy tokens this one's must equal). Tiered engines hold 384
#: device pages (about one round of four 1024-token prompts) over 1024 host
#: pages; the references' 1024-page pools never evict over the three rounds.
HOST_TIER_RUNS = (
    ("reference", dict(total_pages=1024, host_pages=0), None),
    ("bf16_always", dict(host_tier_policy="always"), "reference"),
    ("int8_host_always", dict(host_tier_policy="always", kv_quant="int8"), None),
    ("reference_int8_pages", dict(total_pages=1024, host_pages=0, kv_quant_hbm="int8"), None),
    ("int8_pages_always", dict(host_tier_policy="always", kv_quant_hbm="int8"),
     "reference_int8_pages"),
    ("bf16_auto", dict(host_tier_policy="auto"), None),
    ("bf16_prefetch", dict(host_tier_policy="always", host_prefetch=True), "bf16_always"),
)


def plain_int8_codes(pages: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pages ``[L, n, ps, n_kv, hd]`` quantized to int8 with one f32 scale
    per (layer, page, kv head) ``[L, n, 1, n_kv, 1]``, in plain torch (127
    a tensor divisor, so the quotient is the true one: CUDA divides by a
    Python scalar through its reciprocal)."""
    x = pages.float()
    amax = x.abs().amax(dim=(2, 4), keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / amax.new_full((), 127.0)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def plain_int8_round_trip(pages: torch.Tensor) -> torch.Tensor:
    """``plain_int8_codes`` dequantized: what a page restored from an int8
    host tier, or imported from an int8 wire, must hold."""
    q, scale = plain_int8_codes(pages)
    return (q.float() * scale).to(pages.dtype)


def pinned_copy_gb_s(n_bytes: int, to_host: bool) -> float:
    """One plain ``copy_`` of ``n_bytes`` between the card and pinned host
    memory, as GB/s."""
    host = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")

    def copy():
        (host.copy_(card, non_blocking=True) if to_host else card.copy_(host, non_blocking=True))

    return n_bytes / cuda_time_ms(copy, iters=5, warmup=1) / 1e6


def host_tier_engine(server, dev, params, cfg, rounds, knobs) -> dict:
    """Serve ``rounds`` (round 2 evicts round 1 to the host, round 3 repeats
    round 1) on one engine; hold round 3's restored pages against round 1's
    and report its tokens, TTFTs, copies and cost-model state."""
    knobs = dict(knobs)
    total, host_pages = knobs.pop("total_pages", 384), knobs.pop("host_pages", 1024)
    ps, new_tokens = 16, 8
    events = []
    t0 = time.perf_counter()
    eng = server.Engine(
        server.EngineConfig(
            model=cfg, max_model_len=2048, decode_batch_size=8, seed=SEED,
            block_manager=server.BlockManagerConfig(total_pages=total, page_size=ps,
                                                    host_pages=host_pages),
            **knobs,
        ),
        params=params, on_events=lambda evs: events.append(list(evs)), device=dev,
    )
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "total_pages": total, "host_pages": host_pages,
           "knobs": knobs}
    bm = eng.block_manager
    pools = eng._device_pools()
    ptrs = [t.data_ptr() for t in pools]
    if host_pages:
        if not all(t.is_pinned() for t in eng._host_pools()):
            fail("the host slot pools are not pinned")
        if eng._copy_stream == torch.cuda.current_stream(dev):
            fail("the host tier's copies run on the compute stream")
        out["host_pool_gib"] = sum(t.numel() * t.element_size() for t in eng._host_pools()) / 2**30
    out["device_pool_gib"] = sum(t.numel() * t.element_size() for t in pools) / 2**30
    full = len(rounds[0][0]) // ps - 1  # the pages a repeat hits (one is recomputed)
    rows, tokens, keys = [], [], []
    for r, prompts in enumerate(rounds):
        first_event = len(events)
        seqs = [eng.add_request(p, server.SamplingParams(max_new_tokens=new_tokens)) for p in prompts]
        t = time.perf_counter()
        while eng.has_work:
            eng.step()
        torch.cuda.synchronize()
        for s in seqs:
            if s.error or len(s.generated_tokens) != new_tokens:
                fail(f"host tier {knobs}: request finished with {len(s.generated_tokens)} tokens, "
                     f"error={s.error}")
        tokens.append([list(s.generated_tokens) for s in seqs])
        keys.append(eng.decode_graphs.keys)
        rows.append({"wall_s": time.perf_counter() - t,
                     "ttft_ms": [s.ttft * 1e3 for s in seqs],
                     "cached_prompt_tokens": [s.num_cached_prompt for s in seqs]})
        hashes = [h for p in prompts for h in bm.token_db.prefix_hashes(p)[:full]]
        if r == 0:
            idx = torch.tensor([bm._cached[h] for h in hashes], device=dev)
            round1 = [t.index_select(1, idx) for t in pools]
        elif r == 2:
            restored = {h for evs in events[first_event:] for e in evs
                        if type(e).__name__ == "BlockRemoved" and e.medium == "host_dram"
                        for h in e.block_hashes}
            missing = [h for h in hashes if h not in bm._cached]
            if missing:
                fail(f"host tier {knobs}: {len(missing)} round-3 prefix pages are not in HBM")
            idx = torch.tensor([bm._cached[h] for h in hashes], device=dev)
            now = [t.index_select(1, idx) for t in pools]
            was = torch.tensor([h in restored for h in hashes], device=dev)
    if [t.data_ptr() for t in pools] != ptrs or eng.decode_graphs._pools["k_pages"] is not eng.k_pages:
        fail("the page pools were not written in place")
    # A restore brings round 1's bytes back (codes and scales on int8
    # pages); from an int8 tier's slot, plain torch's int8 round trip of
    # them. (A page evicted and restored within one flush window comes from
    # the device page itself, exact on every tier.)
    def equal(expect):
        return torch.stack([(a == b).flatten(2).all(-1) if a.dim() > 3 else (a == b).all(-1)
                            for a, b in zip(now, expect)]).all(0).all(0)  # [pages]

    same = equal(round1)
    via_int8 = torch.zeros_like(same)
    if eng._host_int8 and eng.k_scales is None:
        via_int8 = was & ~same & equal([plain_int8_round_trip(t) for t in round1])
    eng._wait_host_copies()
    out.update({
        "rounds": rows,
        "graph_keys_by_round": keys,
        "pages_restored_in_round_3": int(was.sum()),
        "restored_pages_int8_round_trip": int(via_int8.sum()),
        "restored_pages_unequal": int((was & ~same & ~via_int8).sum()),
        "hbm_hit_pages_unequal": int((~was & ~same).sum()),
        "host_stats": dict(bm.host_stats),
        "host_copy_stats": dict(eng.host_copy_stats),
        "host_prefetch_stats": dict(eng.host_prefetch_stats),
        "block_stored_host_dram": sum(1 for evs in events for e in evs
                                      if type(e).__name__ == "BlockStored" and e.medium == "host_dram"),
        "rates": {"prefill_tokens_s": eng._prefill_rate, "offload_pages_s": eng._offload_rate,
                  "restore_pages_s": eng._restore_rate},
        "prefill_dispatches": eng.prefill_stats["dispatches"],
        "decode_steps_with_warmup": eng.decode_stats["steps"] + eng.decode_graphs.warmup_steps,
        "tokens": tokens,
    })
    del eng, round1, now
    free_cuda()
    return out


def host_tier(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """The host-DRAM tier at full width and depth on the 8B path's
    parameters: three rounds of four 1024-token prompts through each engine
    of ``HOST_TIER_RUNS``; the launch counts are zeroed before the first
    and read after the last. Gates: under "always", round 3 restores pages
    and each restored page equals round 1's (bf16 and int8 pages bit for
    bit, an int8 tier's as plain torch's int8 round trip of it); greedy
    tokens equal the named engine's; spills publish
    ``BlockStored(medium="host_dram")``; the pools are pinned, copied on a
    stream of their own and written in place; exact launch counts."""
    server = pkg["server"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    rounds = [[rng.integers(0, cfg.vocab_size, 1024).tolist() for _ in range(4)] for _ in range(2)]
    rounds.append(rounds[0])
    # A cold and a warm round on a scratch engine first: the first calls of
    # the warm prefill's shapes on this thread (the main path's repeats ran
    # on the pod's thread) would otherwise land in one engine's TTFTs.
    scratch = server.Engine(
        server.EngineConfig(model=cfg, max_model_len=2048, decode_batch_size=8, seed=SEED,
                            block_manager=server.BlockManagerConfig(total_pages=384, page_size=16)),
        params=params, device=dev)
    for _ in range(2):
        for p in rounds[0]:
            scratch.add_request(p, server.SamplingParams(max_new_tokens=2))
        while scratch.has_work:
            scratch.step()
    del scratch
    free_cuda()
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    expected = dict.fromkeys(ops.COUNTED, 0)
    runs = {}
    for label, knobs, same_as in HOST_TIER_RUNS:
        run = runs[label] = host_tier_engine(server, dev, params, cfg, rounds, knobs)
        exp = expected_launches(cfg, None, knobs.get("kv_quant_hbm"), run["prefill_dispatches"],
                                run["decode_steps_with_warmup"])
        expected = {name: expected[name] + n for name, n in exp.items()}
        if same_as is not None and run["tokens"] != runs[same_as]["tokens"]:
            fail(f"host tier {label}: greedy tokens differ from {same_as}'s")
        if knobs.get("host_tier_policy") == "always":
            if run["pages_restored_in_round_3"] == 0 or run["block_stored_host_dram"] == 0:
                fail(f"host tier {label}: {run['pages_restored_in_round_3']} pages restored, "
                     f"{run['block_stored_host_dram']} BlockStored(host_dram)")
        # The graph round 1 captured decodes round 3 over restored pages
        # (with tokens equal to the reference's): restores wrote in place.
        if run["host_pages"] and run["graph_keys_by_round"][2] != run["graph_keys_by_round"][0]:
            fail(f"host tier {label}: round 3 captured a graph: {run['graph_keys_by_round']}")
        if run["restored_pages_unequal"]:
            fail(f"host tier {label}: {run['restored_pages_unequal']} restored pages differ from round 1's")
        # Pages round 3 found in HBM are round 1's, unless "auto" declined
        # their restore and round 3 recomputed them.
        if knobs.get("host_tier_policy") != "auto" and run["hbm_hit_pages_unequal"]:
            fail(f"host tier {label}: {run['hbm_hit_pages_unequal']} pages hit in HBM differ from round 1's")
        if knobs.get("kv_quant") and run["restored_pages_int8_round_trip"] == 0:
            fail(f"host tier {label}: no restored page came through the int8 slots")
        if knobs.get("host_prefetch") and run["host_prefetch_stats"]["pages"] == 0:
            fail(f"host tier {label}: the prefetch brought no page back")
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    if launches != expected:
        fail(f"host tier: kernel launches {launches} != expected {expected}")
    for name in ("flash_prefill", "paged_decode", "paged_decode_int8"):
        if launches[name] == 0:
            fail(f"host tier: {name} was not launched")
    # Copy rates of the bf16 "always" engine against the link's bound and a
    # plain pinned copy of the same bytes.
    bf16 = runs["bf16_always"]["host_copy_stats"]
    link = {}
    for way, to_host in (("d2h", True), ("h2d", False)):
        n, sec = bf16[f"{way}_bytes"], bf16[f"{way}_s"]
        link[way] = {"bytes": n, "pages": bf16[f"{way}_pages"], "device_s": sec,
                     "gb_s": n / sec / 1e9 if sec else None,
                     "bound_gb_s": PCIE_BYTES_S / 1e9, "bound_s": n / PCIE_BYTES_S,
                     "plain_pinned_copy_gb_s": pinned_copy_gb_s(n, to_host)}
    ref, a = runs["reference"]["rounds"], runs["bf16_always"]["rounds"]
    result = {
        "phase": "host_tier",
        "card": card,
        "prompts_per_round": 4,
        "prompt_tokens": 1024,
        "bf16_always_pages": dict(runs["bf16_always"]["host_stats"],
                                  copied_to_host=bf16["d2h_pages"], copied_back=bf16["h2d_pages"]),
        "bf16_always_flushes": {"count": bf16["flushes"], "host_ms": bf16["flush_host_s"] * 1e3},
        "link": link,
        "ttft_ms_median": {
            "round1_cold": float(np.median(a[0]["ttft_ms"])),
            "round3_restored": float(np.median(a[2]["ttft_ms"])),
            "round3_reference_hbm_hit": float(np.median(ref[2]["ttft_ms"])),
            "round3_prefetch": float(np.median(runs["bf16_prefetch"]["rounds"][2]["ttft_ms"])),
        },
        "prefetch_wait_ms": {label: runs[label]["host_copy_stats"]["wait_s"] * 1e3
                             for label in ("bf16_always", "bf16_prefetch")},
        "launches": launches,
        "runs": {label: {k: v for k, v in run.items() if k != "tokens"}
                 for label, run in runs.items()},
        "seconds": time.perf_counter() - t_phase,
    }
    return result, launches


# -- cross-pod KV transfer ------------------------------------------------------
#: the served model's name, which the export service checks on every fetch
TRANSFER_MODEL = "meta-llama/Llama-3.1-8B-Instruct"
#: first-token logits over imported int8 pages against the source's bf16
#: pages: within this share of the source logits' largest magnitude (the
#: int8 bar of ``warm_vs_cold``)
INT8_LOGITS_BAR = 0.05


def free_local_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def transfer_engine(server, dev, params, cfg, knobs):
    knobs = dict(knobs)
    total, host_pages = knobs.pop("total_pages", 1024), knobs.pop("host_pages", 0)
    return server.Engine(
        server.EngineConfig(model=cfg, max_model_len=2048, decode_batch_size=8, seed=SEED,
                            block_manager=server.BlockManagerConfig(
                                total_pages=total, page_size=16, host_pages=host_pages),
                            **knobs),
        params=params, device=dev)


def chain_pages(eng, prompts, n_pages: int) -> list[torch.Tensor]:
    """The first ``n_pages`` pages of each prompt's chain in ``eng``'s
    pools (and scale pools), ``[L, pages, ...]``, prompts in order."""
    bm = eng.block_manager
    idx = torch.tensor([bm._cached[h] for p in prompts for h in bm.token_db.prefix_hashes(p)[:n_pages]],
                       device=eng.device)
    return [t.index_select(1, idx) for t in eng._device_pools()]


def wire_tensor(blocks, field: str, dtype: torch.dtype, shape: tuple, dev) -> torch.Tensor:
    """One payload field of every block as ``[n, *shape]`` on ``dev``."""
    return torch.stack([torch.frombuffer(bytearray(getattr(b, field)), dtype=dtype).reshape(shape)
                        for b in blocks]).to(dev)


def last_page_logits(models, eng, cfg, prompt, dev) -> torch.Tensor:
    """First-token logits of ``prompt``'s last page prefilled against the
    rest of its chain as ``eng``'s pools hold it (context from the pool:
    imported pages on a target), its K/V written into a free page."""
    ps, bm = eng.page_size, eng.block_manager
    n_ctx = (len(prompt) - 1) // ps
    ctx = [bm._cached[h] for h in bm.token_db.prefix_hashes(prompt)[:n_ctx]]
    start = n_ctx * ps
    m = len(prompt) - start
    pos = torch.arange(start, start + m, dtype=torch.int32, device=dev)[None]
    logits = models.prefill(
        eng.params, cfg, torch.tensor([prompt[start:]], dtype=torch.int32, device=dev), pos,
        torch.ones((1, m), dtype=torch.bool, device=dev), eng.k_pages, eng.v_pages,
        torch.full((1, m), bm._free[-1], dtype=torch.int32, device=dev), pos % ps,
        torch.tensor([ctx], dtype=torch.int32, device=dev),
        torch.tensor([start], dtype=torch.int32, device=dev),
        k_scales=eng.k_scales, v_scales=eng.v_scales,
    )[0][0]
    torch.cuda.synchronize()
    return logits


def fetch_blocks(transfer, endpoint: str, eng, prompts) -> tuple[list, list, list]:
    """Each prompt's chain fetched over loopback ZMQ by a plain client, as
    a peer fetches it: the blocks, the wall ms of each fetch, and its MiB.
    The first fetch also dials the socket."""
    client = transfer.KVTransferClient(transfer.TransferClientConfig(endpoint=endpoint, timeout_s=60))
    out, ms, mib = [], [], []
    try:
        for p in prompts:
            t = time.perf_counter()
            blocks, complete = client.fetch(TRANSFER_MODEL, eng.block_manager.token_db.prefix_hashes(p), 64)
            ms.append((time.perf_counter() - t) * 1e3)
            if not complete or not blocks:
                fail(f"kv transfer: fetched {len(blocks)} blocks, complete={complete}")
            out.append(blocks)
            mib.append(sum(b.wire_bytes for b in blocks) / 2**20)
    finally:
        client.close()
    return out, ms, mib


class TransferRun:
    """One source pod (export service on 127.0.0.1) and the target pods
    that pull from it, each on an engine of its own over shared weights."""

    def __init__(self, pkg, dev, params, cfg, knobs):
        self.serve, self.server = pkg["serve"], pkg["server"]
        self.dev, self.params, self.cfg = dev, params, cfg
        self.endpoint = f"tcp://127.0.0.1:{free_local_port()}"
        self.engines = []
        self.src = self.pod(knobs, transfer_endpoint=self.endpoint)
        self.pods = [self.src]

    def pod(self, knobs, cost_model=None, **config):
        eng = transfer_engine(self.server, self.dev, self.params, self.cfg, knobs)
        self.engines.append(eng)
        pod = self.serve.PodServer(
            self.serve.PodServerConfig(model_name=TRANSFER_MODEL, publish_events=False, **config),
            engine=eng, transfer_cost_model=cost_model)
        pod.start()
        return pod

    def target(self, knobs, cost_model=None, **config):
        pod = self.pod(knobs, cost_model, **config)
        self.pods.append(pod)
        return pod

    def close(self):
        for pod in self.pods:
            pod.shutdown()

    def counts(self) -> tuple[dict, dict]:
        """Prefill dispatches and decode model steps (warm-up included) by
        KV page mode, summed over the run's engines."""
        prefill, decode = {}, {}
        for eng in self.engines:
            mode = eng.config.kv_quant_hbm
            prefill[mode] = prefill.get(mode, 0) + eng.prefill_stats["dispatches"]
            decode[mode] = decode.get(mode, 0) + eng.decode_stats["steps"] + eng.decode_graphs.warmup_steps
        return prefill, decode


def serve_each(pod, server, prompts, new_tokens=8, **kw) -> list:
    """The prompts one after another (each alone in the engine, so each
    TTFT is its own)."""
    out = []
    for p in prompts:
        s = pod.submit(p, server.SamplingParams(max_new_tokens=new_tokens), **kw).result(timeout=600)
        if s.error or len(s.generated_tokens) != new_tokens:
            fail(f"kv transfer: request finished with {len(s.generated_tokens)} tokens, error={s.error}")
        out.append(s)
    return out


def pull_each(pod, server, prompts, endpoint) -> tuple[list, list, list]:
    """Each prompt pulled (``pull_prefix``), then served: the sequences,
    the blocks each pull imported and its wall ms."""
    seqs, imported, ms = [], [], []
    for p in prompts:
        t = time.perf_counter()
        imported.append(pod.pull_prefix(p, endpoint))
        ms.append((time.perf_counter() - t) * 1e3)
        seqs += serve_each(pod, server, [p])
    return seqs, imported, ms


def ms_median(seqs) -> float:
    return float(np.median([s.ttft * 1e3 for s in seqs]))


def transfer_copies(stats_before: dict, stats_after: dict) -> dict:
    return {k: stats_after[k] - stats_before[k] for k in stats_after}


def kv_transfer(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """Cross-pod KV transfer at full width and depth on the 8B path's
    parameters: four distinct 1024-token prompts (64 pages each), 8 new
    tokens each. Gates, bf16: a pulled page is bit-equal to the source's;
    the pulled request hits 1008 cached tokens, as the source's own warm
    repeat does, and computes only its last 16; its greedy tokens equal
    that repeat's. Int8 wire from a bf16 pool: the codes and scales on the
    wire are plain torch's quantization of the source pages, the target's
    pages are their dequantization, and first-token logits over them are
    within the int8 bar of the source's. Int8 pages to int8 pages: codes
    and scales bit-equal, tokens equal. Host-tier export: the bytes on the
    wire are the host slots' bytes, and tokens equal the bf16 pull's.
    ``ASYNC_PULL``: four pulls land, tokens equal the bf16 pull's. Exact
    launch counts over the phase's engines."""
    server, models = pkg["server"], pkg["models"]
    from llm_d_kv_cache_manager_tpu_torch.kvcache import transfer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, 1024).tolist() for _ in range(4)]
    # Eight more prompts, 520 pages: they push all of the four prompts'
    # pages out of a 384-page pool into its host tier.
    evictors = [rng.integers(0, cfg.vocab_size, 1024).tolist() for _ in range(8)]
    ps, n_pages = 16, 64
    full = (1024 - 1) // ps  # the pages a pulled request hits (the last is recomputed)
    shape = (cfg.n_layers, ps, cfg.n_kv_heads, cfg.hd)
    sc_shape = (cfg.n_layers, 1, cfg.n_kv_heads, 1)
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    out = {"phase": "kv_transfer", "card": card, "prompts": 4, "prompt_tokens": 1024,
           "blocks_per_pull": n_pages}
    prefill, decode = {}, {}
    extra_prefill = {None: 0}

    def add_counts(run):
        p, d = run.counts()
        for mode, n in p.items():
            prefill[mode] = prefill.get(mode, 0) + n
        for mode, n in d.items():
            decode[mode] = decode.get(mode, 0) + n

    # -- bf16: the source, a blocking pull, an async pull --------------------
    run = TransferRun(pkg, dev, params, cfg, {})
    try:
        src, src_eng = run.src, run.engines[0]
        cold = serve_each(src, server, prompts)
        cold_prefill_rate = src_eng._prefill_rate  # cold 1024-token prefills only
        repeat = serve_each(src, server, prompts)
        export_before = dict(src_eng.transfer_copy_stats)
        blocks, fetch_ms, fetch_mib = fetch_blocks(transfer, run.endpoint, src_eng, prompts)
        fetch_export = transfer_copies(export_before, src_eng.transfer_copy_stats)
        # The fetch's msgpack halves, timed here on the fetched blocks.
        t = time.perf_counter()
        wire = transfer.encode_response(blocks[-1], True)
        pack_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        transfer.decode_response(wire)
        unpack_ms = (time.perf_counter() - t) * 1e3
        del wire
        before = dict(src_eng.transfer_copy_stats)
        cost = transfer.TransferCostModel(transfer.TransferCostModelConfig(
            block_bytes=src_eng.kv_block_bytes, block_size=ps, max_pull_blocks=n_pages))
        tgt = run.target({}, cost_model=cost)
        tgt_eng = run.engines[-1]
        pulled, imported, pull_ms = pull_each(tgt, server, prompts, run.endpoint)
        export = transfer_copies(before, src_eng.transfer_copy_stats)
        if imported != [n_pages] * 4:
            fail(f"kv transfer: pulls imported {imported} blocks, want {n_pages} each")
        if [s.num_cached_prompt for s in pulled] != [s.num_cached_prompt for s in repeat] or \
                pulled[0].num_cached_prompt != full * ps:
            fail(f"kv transfer: pulled requests cached {[s.num_cached_prompt for s in pulled]}, the "
                 f"source's repeats {[s.num_cached_prompt for s in repeat]}")
        if tgt_eng.prefill_stats["tokens_computed"] != 4 * (1024 - full * ps):
            fail(f"kv transfer: the target computed {tgt_eng.prefill_stats['tokens_computed']} tokens")
        torch.cuda.synchronize()
        unequal = sum(int(not torch.equal(a, b)) for a, b in zip(
            chain_pages(tgt_eng, prompts, n_pages), chain_pages(src_eng, prompts, n_pages)))
        if unequal:
            fail(f"kv transfer: {unequal} pools of pulled pages differ from the source's")
        tokens = [list(s.generated_tokens) for s in pulled]
        if tokens != [list(s.generated_tokens) for s in repeat]:
            fail("kv transfer: pulled greedy tokens differ from the source's warm repeat")
        # Device-side copies of the import: one flush per pulled prefill.
        tgt_eng._harvest_copy_spans()
        imp = tgt_eng.transfer_copy_stats
        h2d_gb_s = imp["import_bytes"] / imp["import_h2d_s"] / 1e9 if imp["import_h2d_s"] else None
        # The cost model as the target pod fed it (link samples of its
        # pulls; the prefill rate of its own warm 16-token prefills), and
        # with the source's cold-prefill rate in its place.
        cold_cost = transfer.TransferCostModel(cost.config)
        cold_cost.seed_rates(cost.transfer_rate, cold_prefill_rate)
        verdicts = {}
        for label, model in (("target_fed", cost), ("cold_prefill_rate", cold_cost)):
            verdicts[label] = {
                "transfer_bytes_s": model.transfer_rate, "prefill_tokens_s": model.prefill_rate,
                **{f"warm_load_{load}": model.decide(1024, n_pages, load, 0) for load in (0, 1, 4)},
            }
        # The same pulls with ASYNC_PULL, all four submitted at once.
        atgt = run.target({}, async_pull=True)
        futures = [atgt.submit(p, server.SamplingParams(max_new_tokens=8), pull_source=run.endpoint)
                   for p in prompts]
        async_seqs = [f.result(timeout=600) for f in futures]
        if atgt.async_pulls != 4 or atgt.async_pull_fallbacks:
            fail(f"kv transfer: async_pulls={atgt.async_pulls}, fallbacks={atgt.async_pull_fallbacks}")
        if [list(s.generated_tokens) for s in async_seqs] != tokens:
            fail("kv transfer: async-pulled greedy tokens differ from the blocking pull's")
        if [s.num_cached_prompt for s in async_seqs] != [full * ps] * 4:
            fail(f"kv transfer: async pulls cached {[s.num_cached_prompt for s in async_seqs]}")
        out["bf16"] = {
            "wire_mib_per_pull": fetch_mib,
            "fetch_wall_ms": fetch_ms,
            # one fetch of the last three (socket dialled): the source's
            # export, msgpack encode and decode of the response, the rest
            # (the hops onto the engine loop, ZMQ over loopback, payload
            # objects)
            "fetch_split_ms": {
                "export": sum(fetch_export[f"export_{k}_s"] for k in ("gather", "d2h", "encode"))
                * 1e3 / fetch_export["exports"],
                "msgpack_encode": pack_ms, "msgpack_decode": unpack_ms,
                "fetch_wall_median": float(np.median(fetch_ms[1:])),
            },
            "pull_wall_ms": pull_ms,
            "export_per_pull_ms": {k: export[f"export_{k}_s"] * 1e3 / export["exports"]
                                   for k in ("gather", "d2h", "encode")},
            "export_d2h_gb_s": export["export_bytes"] / export["export_d2h_s"] / 1e9,
            "import": {"pages": imp["import_pages"], "bytes": imp["import_bytes"],
                       "pack_ms": imp["import_pack_s"] * 1e3, "h2d_device_ms": imp["import_h2d_s"] * 1e3,
                       "h2d_gb_s": h2d_gb_s, "bound_gb_s": PCIE_BYTES_S / 1e9,
                       # one pull's bytes in one plain copy
                       "plain_pinned_copy_gb_s": pinned_copy_gb_s(imp["import_bytes"] // 4, to_host=False),
                       "flushes": tgt_eng.host_copy_stats["flushes"],
                       "flush_host_ms_each": tgt_eng.host_copy_stats["flush_host_s"] * 1e3
                       / max(tgt_eng.host_copy_stats["flushes"], 1),
                       "wait_ms": tgt_eng.host_copy_stats["wait_s"] * 1e3},
            "ttft_ms": {"cold_on_source": [s.ttft * 1e3 for s in cold],
                        "warm_repeat_on_source": [s.ttft * 1e3 for s in repeat],
                        "pulled_on_target": [s.ttft * 1e3 for s in pulled],
                        "async_pulled_from_submit": [s.ttft * 1e3 for s in async_seqs]},
            "ttft_ms_median": {"cold": ms_median(cold), "warm_repeat": ms_median(repeat),
                               "pulled": ms_median(pulled),
                               "pull_plus_ttft": float(np.median([a + s.ttft * 1e3
                                                                  for a, s in zip(pull_ms, pulled)]))},
            "cached_prompt_tokens": [s.num_cached_prompt for s in pulled],
            "target_tokens_computed": tgt_eng.prefill_stats["tokens_computed"],
            "cost_model_decide_1024_tokens_64_blocks": verdicts,
            "async_pulls": atgt.async_pulls,
            "transfer_stats": {"source": dict(src_eng.transfer_stats),
                               "target": dict(tgt_eng.transfer_stats)},
        }
    finally:
        run.close()
    add_counts(run)
    del run
    free_cuda()

    # -- an int8 wire from a bf16 pool --------------------------------------
    run = TransferRun(pkg, dev, params, cfg, {"kv_quant": "int8"})
    try:
        src_eng = run.engines[0]
        serve_each(run.src, server, prompts)
        blocks, fetch_ms, fetch_mib = fetch_blocks(transfer, run.endpoint, src_eng, prompts)
        torch.cuda.synchronize()
        src_k, src_v = chain_pages(src_eng, prompts, n_pages)
        codes_unequal = 0
        for pool, (cf, sf) in ((src_k, ("k_data", "k_scale")), (src_v, ("v_data", "v_scale"))):
            q, scale = plain_int8_codes(pool)
            flat = [b for bs in blocks for b in bs]
            codes_unequal += int(not torch.equal(wire_tensor(flat, cf, torch.int8, shape, dev), q.transpose(0, 1)))
            codes_unequal += int(not torch.equal(wire_tensor(flat, sf, torch.float32, sc_shape, dev),
                                                 scale.transpose(0, 1)))
        if codes_unequal:
            fail(f"kv transfer: {codes_unequal} int8 wire fields differ from plain torch's quantization")
        tgt = run.target({})
        tgt_eng = run.engines[-1]
        pulled, imported, pull_ms = pull_each(tgt, server, prompts, run.endpoint)
        torch.cuda.synchronize()
        tgt_eng._harvest_copy_spans()
        pages_unequal = sum(int(not torch.equal(a, plain_int8_round_trip(b))) for a, b in zip(
            chain_pages(tgt_eng, prompts, n_pages), (src_k, src_v)))
        if pages_unequal:
            fail(f"kv transfer: {pages_unequal} pools of pages imported from an int8 wire are not the "
                 f"dequantized codes")
        logits = []
        for p in prompts:
            a = last_page_logits(models, tgt_eng, cfg, p, dev)
            b = last_page_logits(models, src_eng, cfg, p, dev)
            logits.append({"max_abs_diff": float((a - b).abs().max()),
                           "bar": INT8_LOGITS_BAR * float(b.abs().max()),
                           "argmax_equal": int(a.argmax()) == int(b.argmax())})
        extra_prefill[None] += 2 * len(prompts)
        if any(x["max_abs_diff"] > x["bar"] for x in logits):
            fail(f"kv transfer: first-token logits over int8-wire pages miss the bar: {logits}")
        int8_tokens = [list(s.generated_tokens) for s in pulled]
        share = sum(a == b for x, y in zip(int8_tokens, tokens) for a, b in zip(x, y)) / (8 * len(prompts))
        out["int8_wire"] = {
            "wire_mib_per_pull": fetch_mib, "fetch_wall_ms": fetch_ms, "pull_wall_ms": pull_ms,
            "imported": imported, "first_token_logits": logits,
            "greedy_token_share_equal_to_bf16": share,
            "ttft_ms_median_pulled": ms_median(pulled),
            "import_h2d_gb_s": tgt_eng.transfer_copy_stats["import_bytes"]
            / max(tgt_eng.transfer_copy_stats["import_h2d_s"], 1e-12) / 1e9,
        }
    finally:
        run.close()
    add_counts(run)
    del run
    free_cuda()

    # -- int8 pages to int8 pages ---------------------------------------------
    run = TransferRun(pkg, dev, params, cfg, {"kv_quant_hbm": "int8"})
    try:
        src_eng = run.engines[0]
        serve_each(run.src, server, prompts)
        repeat = serve_each(run.src, server, prompts)
        tgt = run.target({"kv_quant_hbm": "int8"})
        tgt_eng = run.engines[-1]
        pulled, imported, pull_ms = pull_each(tgt, server, prompts, run.endpoint)
        torch.cuda.synchronize()
        unequal = sum(int(not torch.equal(a, b)) for a, b in zip(
            chain_pages(tgt_eng, prompts, n_pages), chain_pages(src_eng, prompts, n_pages)))
        if unequal or imported != [n_pages] * 4:
            fail(f"kv transfer int8 pages: {unequal} pools differ, imported {imported}")
        if [list(s.generated_tokens) for s in pulled] != [list(s.generated_tokens) for s in repeat]:
            fail("kv transfer int8 pages: pulled greedy tokens differ from the source's warm repeat")
        out["int8_pages"] = {"pull_wall_ms": pull_ms, "imported": imported,
                             "ttft_ms_median_pulled": ms_median(pulled),
                             "ttft_ms_median_warm_repeat": ms_median(repeat),
                             "wire_bytes_per_pull_mib": n_pages * src_eng.kv_block_bytes / 2**20}
    finally:
        run.close()
    add_counts(run)
    del run
    free_cuda()

    # -- a host-tier export -----------------------------------------------------
    run = TransferRun(pkg, dev, params, cfg, {"total_pages": 384, "host_pages": 1024,
                                              "host_tier_policy": "always"})
    try:
        src_eng = run.engines[0]
        serve_each(run.src, server, prompts)
        serve_each(run.src, server, evictors)  # spills the prompts' pages to the host
        tiers = [t for p in prompts for _, _, t, _ in
                 src_eng.block_manager.lookup_chain(src_eng.block_manager.token_db.prefix_hashes(p))]
        blocks, fetch_ms, fetch_mib = fetch_blocks(transfer, run.endpoint, src_eng, prompts)
        bm = src_eng.block_manager
        slot_unequal, from_slots = 0, 0
        for b in (b for bs in blocks for b in bs):
            slot = bm._host_cached.get(b.block_hash)
            if slot is None:
                continue
            from_slots += 1
            k, v = (t[slot].view(torch.int16).numpy().tobytes() for t in (src_eng._host_k, src_eng._host_v))
            slot_unequal += int(b.k_data != k or b.v_data != v)
        if from_slots != 4 * n_pages or slot_unequal:
            fail(f"kv transfer host tier: {from_slots} blocks served from slots, {slot_unequal} differ")
        tgt = run.target({})
        pulled, imported, pull_ms = pull_each(tgt, server, prompts, run.endpoint)
        if [list(s.generated_tokens) for s in pulled] != tokens:
            fail("kv transfer host tier: pulled greedy tokens differ from the bf16 pull's")
        out["host_tier_export"] = {"source_tiers": {t: tiers.count(t) for t in set(tiers)},
                                   "blocks_from_slots": from_slots, "fetch_wall_ms": fetch_ms,
                                   "wire_mib_per_pull": fetch_mib, "pull_wall_ms": pull_ms,
                                   "imported": imported}
    finally:
        run.close()
    add_counts(run)
    del run
    free_cuda()

    expected = dict.fromkeys(ops.COUNTED, 0)
    for mode in set(prefill) | set(decode):
        exp = expected_launches(cfg, None, mode, prefill.get(mode, 0) + extra_prefill.get(mode, 0),
                                decode.get(mode, 0))
        expected = {name: expected[name] + n for name, n in exp.items()}
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    if launches != expected:
        fail(f"kv transfer: kernel launches {launches} != expected {expected}")
    for name in ("flash_prefill", "paged_decode", "paged_decode_int8"):
        if launches[name] == 0:
            fail(f"kv transfer: {name} was not launched")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


def sync_free_decode_steps(models, ops, eng, cfg, prompts, ps, dev) -> dict:
    """One ``decode_step`` of the engine's model on a scratch int8 pool, then
    one on a bf16 pool (8 lanes, 260-token prompts prefilled first), each
    under ``torch.cuda.set_sync_debug_mode("error")``: the write paths, K1q
    and K1 (whose split count comes from shapes alone) must not synchronise
    with the host. The lanes' last positions sit inside a page, so the int8
    write requantizes carry pages. Then the step's wall time (to a device
    sync) on int8 beside bf16 pages, 30 pairs in alternating order: what
    int8 pages cost a decode step."""
    lanes, n = 8, 256 + 5
    pools = {mode or "bf16": scratch_lanes(models, eng.params, cfg, prompts, ps, dev, mode, n=n)
             for mode in ("int8", None)}

    def step(mode):
        pool, inp = pools[mode]
        return models.decode_step(eng.params, cfg, inp["tokens"], inp["positions"], pool[0],
                                  pool[1], inp["block_tables"], inp["seq_lens"], page_size=ps,
                                  k_scales=pool[2], v_scales=pool[3])[0]

    launched = {}
    for mode, wrapper in (("int8", ops.paged_decode_int8), ("bf16", ops.paged_attention)):
        torch.cuda.synchronize()
        before = wrapper.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = step(mode)
        except RuntimeError as e:
            fail(f"{mode} decode_step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launched[mode] = wrapper.launches - before
        if launched[mode] != cfg.n_layers or not torch.isfinite(logits).all():
            fail(f"{mode} decode_step: {launched[mode]} attention launches, "
                 f"finite={bool(torch.isfinite(logits).all())}")
    wall = {"int8": [], "bf16": []}
    for i in range(30):
        for mode in (("int8", "bf16") if i % 2 else ("bf16", "int8")):
            t = time.perf_counter()
            step(mode)
            torch.cuda.synchronize()
            wall[mode].append((time.perf_counter() - t) * 1e3)
    return {"sync_debug_error_ok": ["int8", "bf16"], "lanes": lanes, "context_tokens": n - 1,
            "paged_decode_int8_launches": launched["int8"],
            "paged_decode_launches": launched["bf16"],
            "step_ms_median": {m: float(np.median(v)) for m, v in wall.items()},
            "step_ms_quartiles": {m: np.percentile(v, [25, 75]).tolist() for m, v in wall.items()},
            "step_ms_min": {m: min(v) for m, v in wall.items()},
            "pairs_int8_slower": sum(a > b for a, b in zip(wall["int8"], wall["bf16"]))}


def profile_window(step, steps: int, model_steps: int, counted: dict) -> dict:
    """Where the time of ``steps`` calls of ``step`` goes. ``model_steps``:
    the model steps (tokens a lane) one call runs. Two windows of ``steps``
    calls, each ended by a device sync: the first unprofiled, for the wall
    time; the second under torch.profiler, for the kernels' own device time
    (graph replays included) and its own wall time, which the profiler's
    per-operation and per-graph-node tracing lengthens. The idle share is
    the share of the unprofiled wall time the device ran no kernel;
    ``device_idle_share_profiled`` reads it against the profiled wall time
    (how earlier versions of this script read it).

    The launch counts of ``counted`` (``ops.COUNTED``) over the profiled
    window must equal the launches the trace shows (``TRACED``): a graph
    replay adds the counts its capture recorded, and here they are held
    against the kernels the device really ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / steps
    before = {name: w.launches for name, w in counted.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t) * 1e3 / steps
    launches = {name: w.launches - before[name] for name, w in counted.items()}

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
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def traced_calls(patterns) -> int:
        return sum(e.count for e in device if any(p in e.key for p in patterns))

    traced = {name: traced_calls(TRACED[name]) for name in launches}
    traced["combine_kernel"] = traced_calls(("::combine_kernel",))
    launches["combine_kernel"] = launches["paged_decode"] + launches["paged_decode_int8"]
    if traced != launches:
        fail(f"launch counts over a profiled window {launches} != the traced kernels {traced}")
    return {
        "model_steps_per_call": model_steps,
        "step_wall_ms": wall_ms,
        "step_wall_ms_profiled": profiled_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "device_idle_share_profiled": max(0.0, 1 - busy_ms / profiled_ms),
        "wall_ms_per_model_step": wall_ms / model_steps,
        "device_ms_per_model_step": busy_ms / model_steps,
        "launches_traced_per_step": {name: n / steps for name, n in traced.items() if n},
        "top_kernels_ms_per_step": [
            {"name": e.key[:80], "ms": dev_ms(e), "calls_per_step": e.count / steps}
            for e in kernels[:12]
        ],
    }


def profile_decode(eng, prompts, server, ops) -> dict:
    """Where a decode step's time goes: ``profile_window`` over steady
    engine steps of 8 lanes (each a graph replay of ``decode_steps_per_iter``
    model steps), after the main path's counts were read. Two steps run
    before the windows (the first may capture); every lane has tokens left
    for all of them, so the lane set holds."""
    seqs = [eng.add_request(p[:256], server.SamplingParams(max_new_tokens=64)) for p in prompts]
    while any(s.num_generated == 0 for s in seqs):
        eng.step()  # the prefill (several chunks with chunked prefill)
    eng.step()
    eng.step()
    keys = eng.decode_graphs.keys
    out = profile_window(eng.step, 4, eng.config.decode_steps_per_iter, ops.COUNTED)
    if eng.decode_graphs.keys != keys:
        fail(f"a graph was captured inside the profiled windows: {keys} -> {eng.decode_graphs.keys}")
    eng.abort_all()
    return dict({"phase": "profile_decode", "lanes": len(prompts), "context_tokens": 256}, **out)


# -- the decode fast path: graph replays against eager, knobs off against on --
#: the fast-path knobs the phase turns on together
FAST_KNOBS = dict(decode_fused_sampling=True, decode_steps_per_iter=4, decode_pipeline=True)
#: the bar for a burst's logits against eager where a capture changed a
#: library's algorithm (tokens still equal, KV pages not bit-equal)
REPLAY_LOGITS_BAR = 1e-4


@contextlib.contextmanager
def logits_tap(llama):
    """Within the block, keep the logits each ``decode_steps`` step samples
    from: the tensors themselves, which under capture are the graph's own
    buffers and hold the latest replay's logits."""
    seen, orig = [], llama.sample_tokens

    def sample(logits, *args):
        seen.append(logits)
        return orig(logits, *args)

    llama.sample_tokens = sample
    try:
        yield seen
    finally:
        llama.sample_tokens = orig


def scratch_lanes(models, params, cfg, prompts, ps, dev, kv_mode, lanes=8, n=300):
    """``lanes`` lanes of ``n``-token prompts, all but each one's last token
    prefilled into a scratch pool (bf16 pages, or int8 pages with their
    scales for ``kv_mode="int8"``), for direct decode calls: the pool
    ``[k_pages, v_pages, k_scales, v_scales]`` (no scales: None) and the
    inputs of the last token's decode."""
    width = -(-(n + 8) // ps)
    pages = lanes * width + 1
    table = torch.arange(1, pages, dtype=torch.int32, device=dev).view(lanes, width)
    tokens = torch.tensor([p[:n] for p in prompts[:lanes]], dtype=torch.int32, device=dev)
    pos = torch.arange(n - 1, dtype=torch.int32, device=dev)[None].expand(lanes, -1).contiguous()
    pool = list(models.init_kv_pages(cfg, pages, ps, dev, kv_quant_hbm=kv_mode))
    pool += list(models.init_kv_scales(cfg, pages, dev)) if kv_mode else [None, None]
    models.prefill(params, cfg, tokens[:, :-1], pos, torch.ones_like(pos, dtype=torch.bool),
                   pool[0], pool[1], torch.gather(table, 1, pos.long() // ps), pos % ps,
                   torch.zeros((lanes, 0), dtype=torch.int32, device=dev),
                   torch.zeros((lanes,), dtype=torch.int32, device=dev),
                   *[t for t in pool[2:] if t is not None])
    last = torch.full((lanes,), n - 1, dtype=torch.int32, device=dev)
    inputs = dict(tokens=tokens[:, -1].contiguous(), positions=last, seq_lens=last + 1,
                  block_tables=table, temperature=torch.zeros(lanes, device=dev),
                  top_k=torch.zeros(lanes, dtype=torch.int32, device=dev),
                  top_p=torch.ones(lanes, device=dev))
    return pool, inputs


def eager_vs_replay(pkg, eng, cfg, prompts, ps, dev, k: int) -> dict:
    """Two bursts of ``k`` steps on identical inputs and twin pools, run
    through ``llama.decode_steps`` eagerly and as ``DecodeGraphs`` replays,
    each side from its own generator seeded alike. Six lanes are greedy, two
    sample at temperature 1. The greedy lanes' tokens and every written KV
    page (and scale) must be bit-equal; page 0 is left out: it is the
    reserved page that padded lanes, and the graphs' warm-up, write. The
    sampled lanes are reported equal or not (a registered generator hands a
    replay the offsets an eager call would take), and the two replays must
    sample differently: the replays advance the generator.

    The one way out of bit-equality: a capture that makes a library pick
    another algorithm than the eager call did. It is taken only where that
    cause shows (a plain capture of one ``decode_step`` differs from eager
    too, ``logits_eager_vs_captured``), the greedy tokens are equal, and the
    first replayed burst's own logits, every step on the greedy lanes, are
    within ``REPLAY_LOGITS_BAR`` of the first eager burst's."""
    models, llama, decode_graphs = pkg["models"], pkg["llama"], pkg["decode_graphs"]
    pool, inp = scratch_lanes(models, eng.params, cfg, prompts, ps, dev, eng.config.kv_quant_hbm)
    inp["temperature"][-2:] = 1.0
    twin = [t.clone() if t is not None else None for t in pool]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lanes, width = inp["block_tables"].shape
    graphs = decode_graphs.DecodeGraphs(
        eng.params, cfg, *twin, lanes=lanes, max_pages=width, page_size=ps,
        generator=torch.Generator(device=dev).manual_seed(SEED), device=dev, chain=False)
    host = {name: t.cpu().numpy() for name, t in inp.items()}
    args = (k, host["tokens"], host["positions"], host["seq_lens"], host["block_tables"],
            host["temperature"], host["top_k"], host["top_p"])
    with logits_tap(llama) as seen:
        eager = [llama.decode_steps(
            eng.params, cfg, inp["tokens"], inp["positions"], pool[0], pool[1],
            inp["block_tables"], inp["seq_lens"], inp["temperature"], inp["top_k"],
            inp["top_p"], gen, page_size=ps, num_steps=k, k_scales=pool[2], v_scales=pool[3],
        )[0].cpu().numpy() for _ in range(2)]
        eager_logits = torch.stack(seen[:k])
        t0 = time.perf_counter()
        replayed = [graphs.dispatch(*args).tokens()]
        first_s = time.perf_counter() - t0
        # The last k logits seen are the capture's buffers (after the
        # warm-up's), holding the first replay's logits.
        burst_logits = torch.stack(seen[-k:])
    replayed.append(graphs.dispatch(*args).tokens())
    torch.cuda.synchronize()
    pools_equal = all(
        a is None or torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(pool, twin)
    )
    greedy_equal = all((e[:-2] == r[:-2]).all() for e, r in zip(eager, replayed))
    burst_diff = float((burst_logits[:, :-2].float() - eager_logits[:, :-2].float()).abs().max())
    del eager_logits, burst_logits
    advanced = bool((replayed[0][-2:] != replayed[1][-2:]).any())
    if not advanced:
        fail(f"two replays sampled the same tokens at temperature 1 (k={k}): the generator "
             "did not advance")
    # Dispatch after dispatch, each waited for: the host time to enqueue
    # one (uploads, replay, copies back) and the wall time to its tokens.
    enqueue, wall = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        b = graphs.dispatch(*args)
        t1 = time.perf_counter()
        b.tokens()
        enqueue.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    out = {"k": k, "lanes": lanes, "context_tokens": int(inp["positions"][0]),
           "tokens_equal": bool(greedy_equal), "kv_pages_equal": pools_equal,
           "burst_logits_max_abs_diff": burst_diff,
           "sampled_lanes_equal": all((e[-2:] == r[-2:]).all() for e, r in zip(eager, replayed)),
           "replays_advance_generator": advanced,
           "capture_and_first_replay_s": first_s, "graph_keys": graphs.keys,
           "pool_bytes": graphs.pool_bytes(),
           "dispatch_enqueue_ms_median": float(np.median(enqueue)),
           "dispatch_to_tokens_ms_median": float(np.median(wall)),
           "replay_device_ms": cuda_time_ms(lambda: graphs.dispatch(*args), iters=10)}
    bit_equal = out["tokens_equal"] and pools_equal
    if k == 1 or not bit_equal:
        out["logits"] = logits_eager_vs_captured(pkg, eng, cfg, prompts, ps, dev)
    if not bit_equal:
        cause = out["logits"]["max_abs_diff"] > 0
        if not (cause and out["tokens_equal"] and burst_diff <= REPLAY_LOGITS_BAR):
            fail(f"eager vs replay not bit-equal at k={k}, and not explained by a library "
                 f"algorithm chosen under capture (a plain capture of one decode_step differs "
                 f"from eager: {cause}; greedy tokens equal: {out['tokens_equal']}; burst "
                 f"logits within {REPLAY_LOGITS_BAR}: {burst_diff}): {out}")
        print(f"chip_smoke: eager vs replay not bit-equal at k={k}: a plain capture of one "
              f"decode_step differs from eager too ({out['logits']}), so a library picked "
              f"another algorithm under capture; held instead with equal greedy tokens and the "
              f"burst's logits within {REPLAY_LOGITS_BAR} ({burst_diff})", flush=True)
    return out


def logits_eager_vs_captured(pkg, eng, cfg, prompts, ps, dev) -> dict:
    """One ``decode_step``'s logits eagerly and from a captured graph of the
    same call, on twin scratch pools."""
    models, llama = pkg["models"], pkg["llama"]
    pool, inp = scratch_lanes(models, eng.params, cfg, prompts, ps, dev, eng.config.kv_quant_hbm)
    twin = [t.clone() if t is not None else None for t in pool]

    def call(p):
        return llama.decode_step(eng.params, cfg, inp["tokens"], inp["positions"], p[0], p[1],
                                 inp["block_tables"], inp["seq_lens"], page_size=ps,
                                 k_scales=p[2], v_scales=p[3])[0]

    eager = call(pool)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call([t.clone() if t is not None else None for t in twin])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call(twin)
    graph.replay()
    torch.cuda.synchronize()
    return {"max_abs_diff": float((captured - eager).abs().max()),
            "max_abs_logit": float(eager.abs().max())}


def serve_greedy(pkg, eng, prompts, new_tokens: int) -> tuple[list, list, dict]:
    """Serve ``prompts`` greedily to the end; the generated tokens, for each
    of them the block-table width of the burst that sampled it (None for
    the first, which prefill sampled), and the decode tokens/s of the steps
    that only decoded, over all of them and over those that captured no
    graph (the steady state)."""
    server = pkg["server"]
    seqs = [eng.add_request(p, server.SamplingParams(max_new_tokens=new_tokens)) for p in prompts]
    index = {s.seq_id: i for i, s in enumerate(seqs)}
    widths = [[None] * new_tokens for _ in seqs]
    commit = eng._commit_burst

    def commit_and_tag(burst):
        before = [s.num_generated for s in burst["active"]]
        commit(burst)
        for s, n in zip(burst["active"], before):
            widths[index[s.seq_id]][n:s.num_generated] = [burst["toks"].key[1]] * (s.num_generated - n)

    eng._commit_burst = commit_and_tag
    t_all = {"s": 0.0, "tokens": 0, "steps": 0}
    t_steady = dict(t_all)
    capture_s = 0.0
    while eng.has_work:
        p0 = eng.prefill_stats["dispatches"]
        g0 = sum(s.num_generated for s in seqs)
        n_keys = len(eng.decode_graphs.keys)
        t = time.perf_counter()
        eng.step()
        dt = time.perf_counter() - t
        if eng.prefill_stats["dispatches"] == p0:
            captured = len(eng.decode_graphs.keys) != n_keys
            capture_s += dt if captured else 0.0
            for acc in (t_all,) if captured else (t_all, t_steady):
                acc["s"] += dt
                acc["tokens"] += sum(s.num_generated for s in seqs) - g0
                acc["steps"] += 1
    for s in seqs:
        if s.error or len(s.generated_tokens) != new_tokens:
            fail(f"request {s.seq_id}: {len(s.generated_tokens)} tokens, error={s.error}")
    del eng._commit_burst
    return [list(s.generated_tokens) for s in seqs], widths, {
        "decode_tokens_per_s": t_all["tokens"] / t_all["s"],
        "decode_tokens_per_s_steady": t_steady["tokens"] / t_steady["s"],
        "decode_steps": t_all["steps"], "steady_steps": t_steady["steps"],
        "capturing_steps_s": capture_s}


def plan_logit_error(pkg, eng, cfg, prompts, ps, dev, widths: tuple[int, int]) -> float:
    """How far one ``decode_step``'s logits move between two block-table
    widths whose split plans differ: 8 scratch lanes (their pages fit the
    narrower table), the table padded with zeros to each width, twin
    pools; the largest absolute logit difference."""
    models, llama = pkg["models"], pkg["llama"]
    n = min(300, min(widths) * ps - 8)
    pool, inp = scratch_lanes(models, eng.params, cfg, prompts, ps, dev, eng.config.kv_quant_hbm, n=n)
    twin = [t.clone() if t is not None else None for t in pool]
    logits = []
    for w, p in zip(widths, (pool, twin)):
        table = torch.zeros((inp["block_tables"].shape[0], w), dtype=torch.int32, device=dev)
        table[:, :inp["block_tables"].shape[1]] = inp["block_tables"]
        logits.append(llama.decode_step(eng.params, cfg, inp["tokens"], inp["positions"], p[0], p[1],
                                        table, inp["seq_lens"], page_size=ps,
                                        k_scales=p[2], v_scales=p[3])[0].float())
    return float((logits[0] - logits[1]).abs().max())


def top2_gap(pkg, eng, cfg, prompt, generated, ps, dev) -> dict:
    """The knobs-off model's top-2 logit gap at the first token of
    ``generated``'s continuation: one cold prefill of prompt ++ generated on
    a scratch pool."""
    models = pkg["models"]
    seq = list(prompt) + list(generated)
    n = len(seq)
    pages = n // ps + 2
    kv_mode = eng.config.kv_quant_hbm
    pool = list(models.init_kv_pages(cfg, pages, ps, dev, kv_quant_hbm=kv_mode))
    if kv_mode:
        pool += list(models.init_kv_scales(cfg, pages, dev))
    table = torch.arange(1, pages, dtype=torch.int32, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    logits = models.prefill(eng.params, cfg, torch.tensor([seq], dtype=torch.int32, device=dev),
                            pos, torch.ones_like(pos, dtype=torch.bool), pool[0], pool[1],
                            table[pos.long() // ps], pos % ps,
                            torch.zeros((1, 0), dtype=torch.int32, device=dev),
                            torch.zeros((1,), dtype=torch.int32, device=dev), *pool[2:])[0][0]
    top = logits.topk(2)
    return {"top2_gap": float(top.values[0] - top.values[1]),
            "logit_range": float(logits.max() - logits.min()),
            "top2_ids": top.indices.tolist()}


def knobs_gate(pkg, eng, cfg, prompts, ps, dev, runs) -> list[dict]:
    """Knobs-on greedy tokens must equal knobs-off. The one way out is K1's
    split plan, which reads the table width: a 4-step reservation can push
    a burst's table into the next width bucket, and another split order
    moves the logits by float rounding. A difference passes only where all
    of these hold: it is the only request that differs; the bursts that
    sampled the token in the two engines ran different plans; and its top-2
    logit gap (the knobs-off model, one cold prefill) is at most twice the
    largest logit difference between those two plans, measured here
    (``plan_logit_error``: a top-2 gap moves by at most twice that). Each
    difference is reported with its widths, plans, gap and measured
    error."""
    off, on = runs["off"], runs["on"]
    diffs = []
    for i, (a, b) in enumerate(zip(off["tokens"], on["tokens"])):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        widths = (off["widths"][i][j], on["widths"][i][j])
        plans = [None if w is None else run["plans"].get(f"{run['k']}x{w}")
                 for w, run in zip(widths, (off, on))]
        d = dict(top2_gap(pkg, eng, cfg, prompts[i], a[:j], ps, dev), request=i, index=j,
                 off=a[j], on=b[j], widths=list(widths), plans=plans)
        if None not in widths and plans[0] != plans[1]:
            d["plan_logit_error"] = plan_logit_error(pkg, eng, cfg, prompts, ps, dev, widths)
        diffs.append(d)
    if len(diffs) > 1:
        fail(f"knobs-on greedy tokens differ from knobs-off in {len(diffs)} requests: {diffs}")
    for d in diffs:
        if "plan_logit_error" not in d:
            fail(f"knobs-on greedy token differs from knobs-off where both engines ran the same "
                 f"plans: {d}")
        if d["top2_gap"] > 2 * d["plan_logit_error"]:
            fail(f"knobs-on greedy token differs from knobs-off with a top-2 gap beyond what the "
                 f"two split plans move the logits by: {d}")
    return diffs


def decode_fast_path(pkg, ops, eng, cfg, prompts, ps, dev) -> dict:
    """The decode fast path on one served model, after its main path:

    - eager against replay: one burst of 1 and of 4 steps, bit-equal tokens
      and KV pages (``eager_vs_replay``);
    - knobs off against on: the 8 prompts served by an engine with the
      fast-path knobs off and one with ``FAST_KNOBS``, sharing the
      parameters; greedy tokens equal (``knobs_gate``);
    - readings: ``profile_window`` over eager decode (direct
      ``llama.decode_steps`` of one step, inputs uploaded and tokens read
      back each call), graph k=1 (knobs off) and graph k=4 pipelined engine
      steps; decode tokens/s of both engines; graphs captured and pool
      bytes."""
    models, llama, server = pkg["models"], pkg["llama"], pkg["server"]
    out = {"eager_vs_replay": [eager_vs_replay(pkg, eng, cfg, prompts, ps, dev, k) for k in (1, 4)]}
    free_cuda()

    def engine(**knobs):
        return server.Engine(
            server.EngineConfig(
                model=cfg, block_manager=server.BlockManagerConfig(total_pages=1024, page_size=ps),
                max_model_len=4096, decode_batch_size=8, seed=SEED,
                quantize=eng.config.quantize, quantize_experts=eng.config.quantize_experts,
                kv_quant_hbm=eng.config.kv_quant_hbm, **knobs),
            params=eng.params, device=dev)

    new_tokens = 32
    runs = {}
    for mode, knobs in (("off", {}), ("on", FAST_KNOBS)):
        e = engine(**knobs)
        tokens, widths, rates = serve_greedy(pkg, e, prompts, new_tokens)
        profile = profile_decode(e, prompts, server, ops)
        plans = {f"{k}x{w}": {name: plan for name, plan in b.plans.items() if plan is not None}
                 for (k, w), b in sorted(e.decode_graphs._graphs.items())}
        runs[mode] = {"tokens": tokens, "widths": widths, **rates, "profile": profile,
                      "graph_keys": e.decode_graphs.keys, "pool_bytes": e.decode_graphs.pool_bytes(),
                      "dispatches": e.decode_stats["dispatches"], "steps": e.decode_stats["steps"],
                      "k": e.config.decode_steps_per_iter, "plans": plans}
        del e
        free_cuda()
    out["knobs_on"] = FAST_KNOBS
    out["greedy_requests_equal"] = sum(a == b for a, b in zip(runs["off"]["tokens"], runs["on"]["tokens"]))
    out["token_differences"] = knobs_gate(pkg, eng, cfg, prompts, ps, dev, runs)
    out["plans"] = {mode: runs[mode].pop("plans") for mode in runs}
    for mode in runs:
        for key in ("tokens", "widths", "k"):
            runs[mode].pop(key)
    out["knobs"] = runs

    # Eager decode, for the idle share the graphs are read against.
    pool, inp = scratch_lanes(models, eng.params, cfg, prompts, ps, dev, eng.config.kv_quant_hbm)
    host = {name: t.cpu().numpy() for name, t in inp.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def eager_step():
        d = {name: torch.from_numpy(a).to(dev) for name, a in host.items()}
        llama.decode_steps(eng.params, cfg, d["tokens"], d["positions"], pool[0], pool[1],
                           d["block_tables"], d["seq_lens"], d["temperature"], d["top_k"],
                           d["top_p"], gen, page_size=ps, num_steps=1,
                           k_scales=pool[2], v_scales=pool[3])[0].cpu()

    eager_step()
    out["eager_profile"] = dict(profile_window(eager_step, 4, 1, ops.COUNTED), lanes=8,
                                context_tokens=int(host["positions"][0]))
    del pool
    free_cuda()
    return out


def attention_checks(ops, models, llama, dev, gen) -> list[dict]:
    """K1, K1q and K2 in every form, at Llama-3.1-8B's attention (32 query
    heads over 8 KV heads) and, under ``group8``, at Qwen3-30B-A3B's (over 4
    KV heads, GQA group 8)."""
    checks = (
        functools.partial(check_decode, quantized=False),
        functools.partial(check_decode, quantized=True, models=models, llama=llama),
        check_flash_prefill,
    )
    entries = []
    for check in checks:
        entry = check(ops, dev, gen)
        free_cuda()
        group8 = check(ops, dev, gen, n_kv=4)
        if group8["err_over_allowance"] > 1:
            fail(f"{entry['name']} (group 8) differs from its plain version")
        entry["group8"] = {k: v for k, v in group8.items()
                           if k not in ("name", "route", "source", "replaces", "also_serves", "tol")}
        free_cuda()
        entries.append(entry)
    return entries


def sass_tensor_core_counts(_build) -> dict | None:
    """Tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) per kernel
    function in the built libraries, from ``cuobjdump -sass``; None where
    the toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = {}
    for name in _build.KERNEL_SOURCES:
        text = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        funcs, cur = {}, None
        for ln in text.splitlines():
            if "Function :" in ln:
                cur = ln.split("Function :", 1)[1].strip()
                funcs[cur] = {"HMMA": 0, "HGMMA": 0}
            elif cur is not None:
                op = "HGMMA" if "HGMMA" in ln else "HMMA" if "HMMA" in ln else None
                if op:
                    funcs[cur][op] += 1
        out[name] = funcs
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_d_kv_cache_manager_tpu_torch import models, ops, server
    from llm_d_kv_cache_manager_tpu_torch.kvcache import kvblock
    from llm_d_kv_cache_manager_tpu_torch.models import llama
    from llm_d_kv_cache_manager_tpu_torch.ops import _build
    from llm_d_kv_cache_manager_tpu_torch.server import decode_graphs, serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t_start = time.perf_counter()
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
        regs[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]

    sass = sass_tensor_core_counts(_build)
    emit({"phase": "build", "seconds": seconds, "total_s": time.perf_counter() - t0,
          "ptxas": regs, "sass_tensor_core_instructions": sass})
    if sass is not None:
        if not any(n for f in sass["flash_prefill"].values() for n in f.values()):
            fail("cuobjdump -sass shows no HMMA/HGMMA in the flash_prefill library")
        gmm_prefill = [f for name, f in sass["grouped_matmul"].items() if "prefill_kernel" in name]
        if len(gmm_prefill) != 2 or not all(f["HGMMA"] for f in gmm_prefill):
            fail(f"cuobjdump -sass shows no HGMMA in a grouped-matmul prefill kernel: {sass['grouped_matmul']}")

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = attention_checks(ops, models, llama, dev, gen) + check_grouped_matmul(ops, models, dev, gen)
    _L2_FLUSH.clear()  # the serving paths' peak memory does not hold it
    emit({"phase": "kernels", "allow_tf32": False, "cudnn_allow_tf32": False,
          "results": kernels, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({"phase": "moe_layer_sync_debug_error", "results": check_moe_layer(models, llama, ops, dev, gen),
          "seconds": time.perf_counter() - t0})
    free_cuda()

    pkg = {"models": models, "llama": llama, "server": server, "serve": serve, "kvblock": kvblock,
           "decode_graphs": decode_graphs}
    by_path, greedy_tokens = {}, {}
    for path in PATHS:
        by_path.update(run_engine(pkg, ops, dev, card, path, greedy_tokens))
        free_cuda()
    for k in kernels:
        k["launches_by_path"] = {label: launches[k["name"]] for label, launches in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the main path")
    emit({"kernels": kernels, "total_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
