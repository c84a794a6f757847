"""GPU smoke test of the PyTorch/CUDA port: builds the Hopper kernels, holds
each against its plain PyTorch version at the shapes the serving paths
give it (Llama-3.1-8B attention, over bf16 and over int8 KV pages, decode
at 8 lanes and at one 4096-token lane, prefill in four call forms, the
speculative verify round's among them;
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
verdict. The ``scoring`` phase, on the same parameters, runs the port's
scoring service in process and routes two pods that publish to it over
ZMQ: repeats go to the pod that served them and hit its prefix cache,
scores follow a pod's evictions, and a simulated fleet of 16 pods × 16,384
blocks is ingested losslessly while score requests are timed under four
index configurations. The ``fleet`` phase routes, sheds, drains and
resyncs two pods behind a ``BlendedRouter``; the ``fleet_controller``
phase burns an SLO into a flight dump, live-migrates in-flight decodes
between pods, and runs a ``FleetController`` scale-down and warm scale-up.
The ``spec_decode`` phase serves eight
512-token prompts on engines with speculative decoding off and at 1 and 3
verify rounds a burst, holding the K1/K2 launch counts and every stream
against spec-off, and profiles a verify round against a decode step.
The int8 KV path also holds both int8 scale divisions on the card
bit-equal to the CPU. Last, the ``qwen3_30b_a3b_train`` phase trains
Qwen3-30B-A3B at full width and 2 of its 48 layers: HF-named weights load
back bit-equal, one step's gradients through the kernels (K4 forward, K4^T
and K6 backward, each also held against its plain version at the training
shapes) are held against the plain grouped matmul's with routing pinned,
five AdamW steps lower the loss with exact launch counts, a train-state
checkpoint round trip is bit-equal, and the restored weights serve the
same greedy tokens as the in-memory ones.

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
import shutil
import subprocess
import sys
import tempfile
import types
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
#: ref_abs = |lhs| @ |rhs[g]| (dequantized for K5). The same holds for the
#: backward's two: K4^T sums f products a row, K6 a group's rows.
HALF_ULP = 2.0**-8
F32_ULP = 2.0**-23
KERNEL_ATOL = 1e-4
TOL = {
    "paged_decode": "2^-8*|ref| + 1e-4 (ref in float32)",
    "paged_decode_int8": "2^-8*|ref| + 1e-4 (ref in float32 over the dequantized pool)",
    "flash_prefill": "2^-8*|ref| + 2^-8*ref_abs + 1e-4 (ref in float32)",
    "grouped_matmul_bf16": "2^-8*|ref| + d*2^-23*ref_abs + 1e-4 (ref in float32)",
    "grouped_matmul_int8": "2^-8*|ref| + d*2^-23*ref_abs + 1e-4 (ref in float32, dequantized)",
    "grouped_matmul_bf16_t": "2^-8*|ref| + f*2^-23*ref_abs + 1e-4 (ref in float32)",
    "grouped_matmul_tgmm": "2^-8*|ref| + (max group rows)*2^-23*ref_abs + 1e-4 (ref in float32)",
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
#: "spec_verify" is the speculative verify round's form (8 lanes, chunk 8,
#: 1-5 valid rows, contexts not page-aligned).
PREFILL_FORMS = {
    "kernels_phase": dict(b=2, s=512, ctx=[0, 1024], nv=[512, 300], ctx_pages=64),
    "engine_cold": dict(b=8, s=1024, ctx=[0] * 8, nv=[1024] * 6 + [517, 0], ctx_pages=0),
    "engine_warm": dict(b=8, s=64, ctx=[1008] * 2 + [0] * 6, nv=[16] * 2 + [0] * 6, ctx_pages=64),
    # A speculative verify round: [last token ++ up to 4 drafts] in a chunk
    # of 8 over contexts (seq_len - 1) that end inside a page.
    "spec_verify": dict(b=8, s=8, ctx=[4095, 1023, 517, 2049, 33, 1, 700, 1500],
                        nv=[5, 1, 5, 3, 5, 2, 1, 5], ctx_pages=256),
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
GMM_FORMS = ("prefill", "decode", "edge", "one_expert", "ragged", "train_ep")
GMM_TIMED = ("prefill", "decode", "edge")
#: the expert-parallel training form: one of two expert shards' groups
EP_SHARDS = 2


def gmm_group_sizes(form: str, gen, dev) -> tuple[list[int], int]:
    """Rows per expert and the row count of one call form. prefill /
    decode: the experts of top-8 over random router logits for 8 x 1024 /
    8 tokens (65,536 / 64 rows). edge: empty first and last groups, one
    group holding most rows, and 11 rows past the last group, 5001 rows in
    all — no multiple of any tile. one_expert: all 65,536 rows in one
    group, the other 127 empty (the persistent walk over many tiles of one
    group). ragged: sizes 1..700 from the seeded generator and 37 rows past
    the last group (tiles that straddle the next group, and the zero
    tail). train_ep: the expert-parallel training form, the training
    batch's 2,048 tokens routed by top-8 of random router logits over 128
    experts and kept for the first of two expert shards: 64 groups, and
    about half the 16,384 rows past the last group (the other shard's)."""
    if form == "train_ep":
        logits = torch.randn((TRAIN_BATCH * TRAIN_SEQ, MOE_E), generator=gen, device=dev)
        ids = logits.topk(MOE_TOPK, dim=-1).indices.reshape(-1)
        sizes = torch.bincount(ids, minlength=MOE_E)[: MOE_E // EP_SHARDS]
        return sizes.tolist(), TRAIN_BATCH * TRAIN_SEQ * MOE_TOPK
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
    """One PyTorch call computing a grouped matmul's function, where the
    installed torch has one (``torch._grouped_mm``, the rows split by
    cumulative offsets: K4's and K4^T's 2-D by 3-D form, and K6's 2-D by
    2-D form with ``lhs`` the transposed rows, a [groups, d, f] result); the
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


def first_groups(models, stack, n: int):
    """The first ``n`` experts of a stack (bf16, or int8 codes with their
    scales): one expert shard's, a view."""
    if n == stack.shape[0]:
        return stack
    if isinstance(stack, models.QuantizedTensor):
        return models.QuantizedTensor(q=stack.q[:n], scale=stack.scale[:n])
    return stack[:n]


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
            n_groups, in_groups = len(sizes), sum(sizes)
            gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
            rgi = torch.repeat_interleave(torch.arange(n_groups, device=dev), gs.long())
            rgi = torch.cat([rgi, torch.full((rows - in_groups,), n_groups - 1, device=dev)]).int()
            lhs = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            nonempty = sum(1 for n in sizes if n > 0)
            for name, full in stacks.items():
                quantized = name == "grouped_matmul_int8"
                rhs = first_groups(models, full, n_groups)
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
                entry = dict(case, rows=rows, in_groups=in_groups, groups=n_groups, d=d, f=f,
                             nonempty_groups=nonempty, max_group=max(sizes), plan=plan)
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


#: the training phase's batch: 2 x 1024 tokens at top-8, 16,384 expert rows
TRAIN_BATCH, TRAIN_SEQ = 2, 1024
#: K4^T / K6 forms: the training path's routing, and decode / edge / ragged
#: from ``gmm_group_sizes`` (64 rows over 128 groups; empty groups, one
#: large group, rows past the last group); "nan_neighbours": the ragged
#: sizes with NaN in every row of the odd groups and past the last group,
#: held on the even groups (K6's slices, K4^T's rows), so a value of a
#: neighbouring group must not leak into a held one; all held, the first
#: also timed
GMM_BWD_FORMS = ("train", "train_ep", "decode", "edge", "ragged", "nan_neighbours")
#: an off-tile width (d, f): multiples of 8 but of neither K6's 128 x 256
#: output tile nor its 64-wide boxes, held in the forms after it
GMM_BWD_OFF_TILE = ((200, 264), ("ragged", "nan_neighbours"))


def gmm_bwd_group_sizes(form: str, gen, dev) -> tuple[list[int], int]:
    """Rows per expert and the row count: "train" routes the training
    batch's 2,048 tokens by top-8 of random router logits (16,384 rows, all
    in groups, as ``_moe_mlp_routed`` routes them); the others as in
    ``gmm_group_sizes`` ("nan_neighbours" as "ragged"; "train_ep" one expert
    shard's 64 groups, about half the rows past the last)."""
    if form != "train":
        return gmm_group_sizes("ragged" if form == "nan_neighbours" else form, gen, dev)
    logits = torch.randn((TRAIN_BATCH * TRAIN_SEQ, MOE_E), generator=gen, device=dev)
    sizes = torch.bincount(logits.topk(MOE_TOPK, dim=-1).indices.reshape(-1), minlength=MOE_E)
    return sizes.tolist(), TRAIN_BATCH * TRAIN_SEQ * MOE_TOPK


def check_grouped_matmul_backward(ops, dev, gen) -> list[dict]:
    """K4^T (``dlhs = dout @ rhs[g]^T``) and K6 (``drhs[g] = lhs[rows_g]^T @
    dout[rows_g]``), the backward of K4 that training runs, at Qwen3-30B-A3B
    widths, gate/up (d, f) = (2048, 768) and down (768, 2048), in every
    ``GMM_BWD_FORMS`` form, and at ``GMM_BWD_OFF_TILE``: each held element by
    element against its float32 plain version (the "nan_neighbours" form on
    its held groups and rows, which must be finite), called twice and
    required bit-equal; K4^T's rows past the last group must be zero. The
    "train" form is timed with the L2 flushed before each call, beside the
    plain version, the library call (``torch._grouped_mm``, where it takes
    the operands)."""
    bf = torch.bfloat16
    results = {"grouped_matmul_bf16_t": {}, "grouped_matmul_tgmm": {}}
    off_tile, off_tile_forms = GMM_BWD_OFF_TILE
    for width, (d, f) in dict(GMM_WIDTHS, off_tile=off_tile).items():
        stack = (torch.randn((MOE_E, d, f), generator=gen, device=dev) * d**-0.5).to(bf)
        for form in off_tile_forms if width == "off_tile" else GMM_BWD_FORMS:
            sizes, rows = gmm_bwd_group_sizes(form, gen, dev)
            n_groups = len(sizes)
            rhs = stack[:n_groups]
            in_groups, nonempty, max_group = sum(sizes), sum(1 for n in sizes if n > 0), max(sizes)
            gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
            lhs = torch.randn((rows, d), generator=gen, device=dev).to(bf)
            dout = torch.randn((rows, f), generator=gen, device=dev).to(bf)
            # The held part of each output: K6's groups and K4^T's rows.
            keep = {"grouped_matmul_tgmm": torch.arange(n_groups, device=dev),
                    "grouped_matmul_bf16_t": torch.arange(rows, device=dev)}
            if form == "nan_neighbours":
                owner = torch.full((rows,), -1, dtype=torch.long, device=dev)
                owner[:in_groups] = torch.repeat_interleave(torch.arange(n_groups, device=dev), gs.long())
                poisoned = (owner < 0) | (owner % 2 == 1)
                lhs[poisoned] = float("nan")
                dout[poisoned] = float("nan")
                keep = {"grouped_matmul_tgmm": keep["grouped_matmul_tgmm"][0::2],
                        "grouped_matmul_bf16_t": torch.nonzero(~poisoned).squeeze(1)}
            calls = {
                "grouped_matmul_bf16_t": (lambda: ops.grouped_matmul_bf16_t(dout, rhs, gs)),
                "grouped_matmul_tgmm": (lambda: ops.grouped_matmul_tgmm(lhs, dout, gs)),
            }
            plains = {
                "grouped_matmul_bf16_t": (lambda a, b, w: ops.grouped_matmul_plain(b, w.transpose(1, 2), gs)),
                "grouped_matmul_tgmm": (lambda a, b, w: ops.grouped_matmul_tgmm_plain(a, b, gs, torch.float32)),
            }
            for name, call in calls.items():
                out = call()
                idx = keep[name]
                ref = plains[name](lhs.float(), dout.float(), rhs.float()).index_select(0, idx)
                ref_abs = plains[name](lhs.float().abs(), dout.float().abs(),
                                       rhs.float().abs()).index_select(0, idx)
                torch.cuda.synchronize()
                if not torch.isfinite(out.index_select(0, idx).float()).all():
                    fail(f"{name} produced non-finite values ({form}/{width})")
                if name == "grouped_matmul_bf16_t" and (out[in_groups:] != 0).any():
                    fail(f"{name}: rows past the last group are not zero ({form}/{width})")
                coef = (f if name == "grouped_matmul_bf16_t" else max_group) * F32_ULP
                case = held(out.index_select(0, idx), ref, ref_abs, abs_coef=coef)
                if not torch.equal(call().view(torch.int16), out.view(torch.int16)):
                    fail(f"{name}: two calls on the same inputs differ ({form}/{width})")
                del ref, ref_abs, out
                entry = dict(case, rows=rows, in_groups=in_groups, groups=n_groups, d=d, f=f,
                             nonempty_groups=nonempty, max_group=max_group, held=int(idx.numel()),
                             plan=getattr(ops, name).last_plan)
                results[name][f"{form}/{width}"] = entry
                if form != "train":
                    continue
                ms = cold_time_ms(call)
                plain_ms = cuda_time_ms(lambda: plains[name](lhs, dout, rhs), iters=3, warmup=1)
                if name == "grouped_matmul_bf16_t":
                    library_ms, library_note = grouped_mm_library_ms(dout, rhs.transpose(1, 2), gs)
                    n_bytes = rows * f * 2 + nonempty * d * f * 2 + rows * d * 2 + MOE_E * 4
                else:
                    library_ms, library_note = grouped_mm_library_ms(lhs.t(), dout, gs)
                    # the whole stack is written, empty groups' zeros too
                    n_bytes = rows * d * 2 + rows * f * 2 + MOE_E * d * f * 2 + MOE_E * 4
                b_ms, b_by = bound_ms(n_bytes, 2 * in_groups * d * f)
                entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms, library_note=library_note)
            del lhs, dout
        del rhs, stack
        free_cuda()
    entries = []
    for name, forms in results.items():
        worst = max(c["err_over_allowance"] for c in forms.values())
        if worst > 1:
            fail(f"{name} differs from its plain version beyond {TOL[name]}: {forms}")
        top = forms["train/gate_up"]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": ("llm_d_kv_cache_manager_tpu_torch/csrc/grouped_matmul.cu"
                       if name.endswith("_t") else
                       "llm_d_kv_cache_manager_tpu_torch/csrc/grouped_matmul_tgmm.cu"),
            "design": ("K4's prefill kernel, B read K-major from rhs in place (route (a))"
                       if name.endswith("_t") else
                       "persistent warp-specialised wgmma/TMA, one block an SM over (group, "
                       "128 d x 256 f) tiles, the group's rows the contraction, TMA-store epilogue"),
            "timing": "L2 flushed before each call",
            "replaces": ("jax/experimental/pallas/ops/tpu/megablox/ops.py:79 "
                         "(gmm transpose_rhs=True, pallas_call megablox/gmm.py:526), via "
                         "llm_d_kv_cache_manager_tpu/ops/gmm.py:115"
                         if name.endswith("_t") else
                         "jax/experimental/pallas/ops/tpu/megablox/ops.py:90 "
                         "(tgmm, pallas_call megablox/gmm.py:763), via "
                         "llm_d_kv_cache_manager_tpu/ops/gmm.py:115"),
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
            "headline_form": "train/gate_up",
            "forms": forms,
        })
    return entries


# -- the serving paths at full width ------------------------------------------
#: Each path is driven once, at full width and depth, with every launch
#: count set to 0 just before it and read just after. The pod serves
#: ``model`` (its preset name); ``quantize="int8"`` also quantizes the
#: expert stacks; ``kv_quant_hbm="int8"`` keeps the KV pages as int8 codes
#: and ``chunked_prefill`` sets the per-step prefill token budget (mixed
#: prefill/decode steps). ``sharded`` names the path that serves the same
#: workload again at tp=2 on the same weights, after every other phase of
#: its path (``sharded_path``); ``sp_prefill`` runs the sp=2 prefill
#: (``sp_prefill``) on the path's weights; ``tp2_tiers`` and
#: ``tp2_transfer`` move pages between a tp=2 engine's sharded pools and
#: the host tier (``tp2_tiers``) or the wire (``tp2_transfer``).
PATHS = (
    dict(label="llama_3_8b", model="meta-llama/Llama-3.1-8B-Instruct", quantize=None,
         fast_path=True, host_tier=True, kv_transfer=True, scoring=True, fleet=True,
         fleet_controller=True, disagg_tiers=True, spec_decode=True,
         sharded="llama_3_8b_tp2", sp_prefill="llama_3_8b_sp2",
         tp2_tiers="llama_3_8b_tp2_tiers", tp2_transfer="llama_3_8b_tp2_transfer"),
    dict(label="qwen3_30b_a3b", model="Qwen/Qwen3-30B-A3B", quantize=None,
         sharded="qwen3_30b_a3b_ep2"),
    dict(label="qwen3_30b_a3b_int8", model="Qwen/Qwen3-30B-A3B", quantize="int8",
         fast_path=True, sharded="qwen3_30b_a3b_int8_ep2"),
    dict(label="llama_3_8b_kvq", model="meta-llama/Llama-3.1-8B-Instruct", quantize=None,
         kv_quant_hbm="int8", chunked_prefill=512, same_tokens_as="llama_3_8b",
         sharded="llama_3_8b_kvq_tp2"),
)


#: the kernel functions each counted wrapper (``ops.COUNTED``) launches once
#: a call, as the profiler names them (a traced name holds one of the
#: patterns); every K1 call, bf16 or int8 pages, also launches one
#: ``combine_kernel``
TRACED = {
    "paged_decode": ("::split_decode_kernel<__nv_bfloat16",),
    "paged_decode_int8": ("::split_decode_kernel<signed char",),
    "flash_prefill": ("flash_prefill_kernel",),
    "grouped_matmul_bf16": ("::decode_kernel<__nv_bfloat16", "::prefill_kernel<__nv_bfloat16, false"),
    "grouped_matmul_int8": ("::decode_kernel<signed char", "::prefill_kernel<signed char"),
    "grouped_matmul_bf16_t": ("::prefill_kernel<__nv_bfloat16, true",),
    "grouped_matmul_tgmm": ("tgmm_kernel",),
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
           "grouped_matmul_bf16": 0, "grouped_matmul_int8": 0,
           "grouped_matmul_bf16_t": 0, "grouped_matmul_tgmm": 0}
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


#: the engine paths' workload: 8 prompts of 1024 tokens sharing a 512-token
#: prefix, 32 greedy tokens each, then 2 of them again through the pod
#: server (prefix-cache hits), on a 4096-page pool of 16-token pages
PS, N_PROMPTS, PROMPT_LEN, SHARED_LEN, NEW_TOKENS, N_REPEATS = 16, 8, 1024, 512, 32, 2


def workload_prompts(cfg) -> list:
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, cfg.vocab_size, SHARED_LEN).tolist()
    return [shared + rng.integers(0, cfg.vocab_size, PROMPT_LEN - SHARED_LEN).tolist()
            for _ in range(N_PROMPTS)]


def workload_knobs(server, path: dict) -> dict:
    """A path's engine knobs (``PATHS``)."""
    quantize = path["quantize"]
    return dict(quantize=quantize, quantize_experts=quantize is not None,
                kv_quant_hbm=path.get("kv_quant_hbm"),
                scheduler=server.SchedulerConfig(chunked_prefill_tokens=path.get("chunked_prefill")))


def workload_engine(server, cfg, params, dev, events: list, mesh=None, **knobs):
    """The engine the workload runs on (``mesh``: sharded, its first device
    the engine's)."""
    return server.Engine(
        server.EngineConfig(
            model=cfg,
            block_manager=server.BlockManagerConfig(total_pages=4096, page_size=PS),
            max_model_len=4096, decode_batch_size=8, seed=SEED, **knobs,
        ),
        params=params, on_events=lambda evs: events.extend(evs),
        device=None if mesh is not None else dev, mesh=mesh,
    )


def serve_workload(pkg, ops, eng, cfg, model_name: str, label: str, events: list) -> dict:
    """The main path of an engine path: every launch count set to 0, the
    workload's first requests served by the engine directly, the repeats
    through the pod server's request API and its engine-loop thread, the
    counts read. Checks that every request got its tokens, that the
    repeats hit the prefix cache and that every prompt block was published
    as ``BlockStored``. Returns the requests, the launches, the dispatch
    counts and the host time of each kind of step."""
    server, serve, kvblock = pkg["server"], pkg["serve"], pkg["kvblock"]
    prompts = workload_prompts(cfg)

    def greedy():
        return server.SamplingParams(max_new_tokens=NEW_TOKENS)

    # Step time by what the step dispatched: a prefill, a decode, or both
    # (a mixed step, with chunked prefill).
    phase = {f"{kind}_{key}": 0 for kind in ("prefill", "decode", "mixed")
             for key in ("s", "steps")}
    # The decode-only steps that captured a graph (its warm-up included),
    # a share of the decode ones: where a decode rate's host time went.
    phase.update(decode_tokens=0, mixed_decode_tokens=0, decode_capture_s=0,
                 decode_capture_steps=0, decode_capture_tokens=0)

    def drive():
        while eng.has_work:
            p0, d0 = eng.prefill_stats["dispatches"], eng.decode_stats["dispatches"]
            running = len(eng.scheduler.running)
            n_keys = len(eng.decode_graphs.keys)
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
            if kind == "decode" and len(eng.decode_graphs.keys) > n_keys:
                phase["decode_capture_s"] += dt
                phase["decode_capture_steps"] += 1
                phase["decode_capture_tokens"] += running

    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    first = [eng.add_request(p, greedy()) for p in prompts]
    drive()
    cold_computed = eng.prefill_stats["tokens_computed"]
    pod = serve.PodServer(serve.PodServerConfig(model_name=model_name, publish_events=False),
                          engine=eng)
    pod.start()
    try:
        futures = [pod.submit(prompts[i], greedy()) for i in range(N_REPEATS)]
        repeats = [f.result(timeout=600) for f in futures]
    finally:
        pod.shutdown()
    launches = {name: wrapper.launches for name, wrapper in ops.COUNTED.items()}
    torch.cuda.synchronize()
    out = dict(
        prompts=prompts, first=first, repeats=repeats, launches=launches, phase=phase,
        cold_computed=cold_computed,
        warm_computed=eng.prefill_stats["tokens_computed"] - cold_computed,
        prefill_dispatches=eng.prefill_stats["dispatches"],
        decode_dispatches=eng.decode_stats["dispatches"],
        # The model steps the replays ran, and the warm-up's eager steps
        # before the first capture (real launches).
        decode_steps=eng.decode_stats["steps"] + eng.decode_graphs.warmup_steps,
        tokens=[list(s.generated_tokens) for s in first + repeats],
    )

    # Checks on what came out.
    for seq in first + repeats:
        if seq.error or len(seq.generated_tokens) != NEW_TOKENS:
            fail(f"request {seq.seq_id} finished with {len(seq.generated_tokens)} tokens, error={seq.error}")
        if not all(0 <= t < cfg.vocab_size for t in seq.generated_tokens):
            fail("generated token id out of range")
    for seq in repeats:
        if seq.num_cached_prompt < PROMPT_LEN - PS:
            fail(f"repeat served only {seq.num_cached_prompt} cached prompt tokens")
    if out["warm_computed"] >= N_REPEATS * PS + 1:
        fail(f"repeats recomputed {out['warm_computed']} tokens despite the prefix hit")
    out["stored"] = [h for e in events if type(e).__name__ == "BlockStored" for h in e.block_hashes]
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=PS))
    for p in prompts:
        missing = [h for h in db.prefix_hashes(p) if h not in set(out["stored"])]
        if missing:
            fail(f"{len(missing)} prompt block hashes never published as BlockStored")
    if out["prefill_dispatches"] == 0 or out["decode_dispatches"] == 0:
        fail(f"{label}: {out['prefill_dispatches']} prefill and {out['decode_dispatches']} "
             f"decode dispatches")
    return out


def decode_rates(phase: dict) -> dict:
    """Decode tokens over the steps that only decoded, all of them and
    those that captured no graph."""
    return {
        "decode_tokens_per_s": phase["decode_tokens"] / phase["decode_s"],
        "decode_tokens_per_s_replays": (phase["decode_tokens"] - phase["decode_capture_tokens"])
        / (phase["decode_s"] - phase["decode_capture_s"]),
    }


def run_engine(pkg, ops, dev, card: str, path: dict, greedy_tokens: dict) -> dict:
    models, server = pkg["models"], pkg["server"]
    cfg = pkg["serve"]._resolve_model(path["model"])
    quantize = path["quantize"]
    kv_quant_hbm = path.get("kv_quant_hbm")
    ps = PS

    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = models.init_params(cfg, gen, dev, quantize=quantize,
                                quantize_experts=quantize is not None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    events = []
    t_serve = time.perf_counter()
    eng = workload_engine(server, cfg, params, dev, events, **workload_knobs(server, path))
    param_gib = models.param_bytes(eng.params) / 2**30
    run = serve_workload(pkg, ops, eng, cfg, path["model"], path["label"], events)
    run.update(seconds=time.perf_counter() - t_serve,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               dispatch=eng.decode_stats["dispatch"])
    prompts, first, repeats, launches, phase = (
        run[k] for k in ("prompts", "first", "repeats", "launches", "phase"))
    cold_computed, warm_computed = run["cold_computed"], run["warm_computed"]
    prefill_dispatches, decode_dispatches = run["prefill_dispatches"], run["decode_dispatches"]
    decode_steps = run["decode_steps"]
    stored = set(run["stored"])
    if path.get("chunked_prefill") and phase["mixed_steps"] == 0:
        fail(f"{path['label']}: chunked prefill made no mixed prefill/decode step")
    expected = expected_launches(cfg, quantize, kv_quant_hbm, prefill_dispatches, decode_steps)
    if launches != expected:
        fail(f"{path['label']}: kernel launches {launches} != expected {expected}")
    greedy_tokens[path["label"]] = run["tokens"]
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
        extra["int8_division_card_vs_cpu"] = division_checks(pkg["llama"], eng, cfg, prompts[0], ps, dev)

    logits = warm_vs_cold(models, pkg["llama"], eng.params, cfg, prompts[0], ps, dev, kv_quant_hbm)

    profile = run["profile"] = profile_decode(eng, prompts, server, ops)
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
        "new_tokens_each": NEW_TOKENS,
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
        **decode_rates(phase),
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
    if path.get("scoring"):
        label = path["label"] + "_scoring"
        result, by_path[label] = scoring(pkg, ops, dev, card, eng.params, cfg)
        emit(dict(result, path=label))
    if path.get("fleet"):
        label = path["label"] + "_fleet"
        result, by_path[label] = fleet(pkg, ops, dev, card, eng.params, cfg)
        emit(dict(result, path=label))
    if path.get("fleet_controller"):
        label = path["label"] + "_fleet_controller"
        result, by_path[label] = fleet_controller(pkg, ops, dev, card, eng.params, cfg)
        emit(dict(result, path=label))
    if path.get("disagg_tiers"):
        label = path["label"] + "_disagg_tiers"
        steps, by_path[label] = disagg_tiers(pkg, ops, dev, card, eng.params, cfg)
        for step in steps:
            emit(dict(step, path=label))
    if path.get("spec_decode"):
        label = path["label"] + "_spec_decode"
        result, by_path[label] = spec_decode(pkg, ops, dev, card, eng.params, cfg)
        emit(dict(result, path=label))
    del eng
    free_cuda()
    if path.get("sharded"):
        t0 = time.perf_counter()
        line, by_path[path["sharded"]] = sharded_path(pkg, ops, dev, card, path, params, cfg, run)
        emit(dict(line, phase_wall_s=time.perf_counter() - t0))
    if path.get("sp_prefill"):
        t0 = time.perf_counter()
        line, by_path[path["sp_prefill"]] = sp_prefill(pkg, ops, dev, card, params, cfg)
        emit(dict(line, path=path["sp_prefill"], phase_wall_s=time.perf_counter() - t0))
    for key, phase in (("tp2_tiers", tp2_tiers), ("tp2_transfer", tp2_transfer)):
        if path.get(key):
            t0 = time.perf_counter()
            line, by_path[path[key]] = phase(pkg, ops, dev, card, params, cfg)
            emit(dict(line, path=path[key], phase_wall_s=time.perf_counter() - t0))
            free_cuda()
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


def host_tier_engine(server, dev, params, cfg, rounds, knobs, mesh=None) -> dict:
    """Serve ``rounds`` (round 2 evicts round 1 to the host, round 3 repeats
    round 1) on one engine (``mesh``: sharded over it, at its tp); hold
    round 3's restored pages against round 1's, shard by shard, and report
    its tokens, TTFTs, copies, cost-model state and ``BlockStored`` stream."""
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
            tp=mesh.shape["tp"] if mesh is not None else 1,
            **knobs,
        ),
        params=params, on_events=lambda evs: events.append(list(evs)),
        device=None if mesh is not None else dev, mesh=mesh,
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
        "stored": [(h, e.medium) for evs in events for e in evs
                   if type(e).__name__ == "BlockStored" for h in e.block_hashes],
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
        "runs": {label: {k: v for k, v in run.items() if k not in ("tokens", "stored")}
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


# -- the scoring plane ---------------------------------------------------------
SCORING_MODEL = TRANSFER_MODEL
#: simulated fleet of the scale part: pods x prompts a pod, 64 blocks each
SIM_PODS, SIM_PROMPTS = 16, 256
SCORE_REQUESTS = 1000
#: (NATIVE_INDEX, SCORER_SHARDS) of the timed configurations; the first is
#: the service's default and also serves the route and remove parts
SCORING_CONFIGS = ((True, 0), (True, 4), (False, 0), (False, 4))
#: the metric families the pod exposes with ``OBS_METRICS`` on that the
#: fleet phase requires in ``/metrics`` where prometheus_client is
#: importable: the JAX pod's pinned latency-decomposition and step
#: families and its admission and drain counters
POD_METRIC_FAMILIES = (
    "tpu_pod_requests_total", "tpu_pod_ttft_seconds",
    "kvcache_admission_rejected_total", "kvcache_admission_draining_rejected_total",
    "kvcache_drain_started_total", "kvcache_drain_completed_total",
    "kvcache_request_ttft_seconds", "kvcache_request_itl_seconds",
    "kvcache_request_queue_seconds", "kvcache_request_e2e_seconds",
    "kvcache_transfer_pull_seconds", "kvcache_transfer_pull_overlap_seconds",
    "kvcache_engine_steps_total", "kvcache_engine_step_phase_seconds_total",
    "kvcache_engine_batch_occupancy", "kvcache_engine_free_pages",
    "kvcache_engine_loop_lag_seconds", "kvcache_host_pages", "kvcache_host_hits_total",
    "kvcache_host_prefetch_seconds", "kvcache_slo_burn_rate",
)
#: the code points the scoring phase's prompts are drawn from (below the
#: UTF-16 surrogates, which a UTF-8 prompt cannot carry)
CHAR_IDS = (0x20, 0xD800)


class CharTokenizer:
    """Token id = the character's code point, offsets in UTF-8 bytes (what
    the tokenization pool's prefix store reads). Prompts are drawn from
    ``CHAR_IDS``, so the ids are the token ids the pods get, all below
    Llama-3.1's vocabulary."""

    def encode(self, prompt, model_name):
        ids = [ord(c) for c in prompt]
        ends = np.cumsum([1 if i < 0x80 else 2 if i < 0x800 else 3 for i in ids])
        starts = np.concatenate(([0], ends[:-1]))
        return ids, list(zip(starts.tolist(), ends.tolist()))


def char_prompts(rng, n: int, length: int) -> list[list[int]]:
    return rng.integers(*CHAR_IDS, (n, length)).tolist()


def as_text(tokens) -> str:
    return "".join(map(chr, tokens))


class HttpApp:
    """An aiohttp app on 127.0.0.1, served by an event loop in a thread of
    its own. ``call`` opens a connection of its own, so threads may call
    concurrently."""

    def __init__(self, app, port: int, name: str = "http"):
        import asyncio
        import threading

        from aiohttp import web

        self.port = port
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.runner.setup())
            self.loop.run_until_complete(web.TCPSite(self.runner, "127.0.0.1", port).start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, name=name, daemon=True)
        self.thread.start()
        if not started.wait(30):
            fail(f"{name}: the HTTP server did not start")

    def call(self, method: str, path: str, body=None, headers=None, timeout: float = 600):
        """(status, response headers, parsed JSON or text)."""
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            data = json.dumps(body) if body is not None else None
            conn.request(method, path, data, {"Content-Type": "application/json", **(headers or {})})
            resp = conn.getresponse()
            raw = resp.read()
            kind = resp.getheader("Content-Type", "")
            payload = json.loads(raw) if "json" in kind else raw.decode()
            return resp.status, dict(resp.getheaders()), payload
        finally:
            conn.close()

    def close(self):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


class ScoringHttp(HttpApp):
    """A scoring service's app (``HttpApp``) and one keep-alive client
    connection to it."""

    def __init__(self, service, port: int):
        import http.client

        super().__init__(service.build_app(), port, "scoring-http")
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)

    def score(self, tokens, pods=None) -> dict:
        body = {"prompt": as_text(tokens), "model": SCORING_MODEL}
        if pods:
            body["pod_identifiers"] = pods
        self.conn.request("POST", "/score_completions", json.dumps(body),
                          {"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        payload = json.loads(resp.read())
        if resp.status != 200 or "degraded" in payload:
            fail(f"scoring: /score_completions answered {resp.status} {payload}")
        return payload["scores"]

    def close(self):
        self.conn.close()
        super().close()


class Scorer:
    """The port's ``ScoringService`` in process: its SUB socket on one free
    loopback port, its HTTP API on another."""

    def __init__(self, api, native_index: bool, shards: int, pod_ttl_s: float = 0.0, **svc_kw):
        """``svc_kw``: further ``ServiceConfig`` fields."""
        self.endpoint = f"tcp://127.0.0.1:{free_local_port()}"
        self.service = api.ScoringService(
            api.ServiceConfig(zmq_endpoint=self.endpoint, block_size=16,
                              native_index=native_index, scorer_shards=shards,
                              pod_ttl_s=pod_ttl_s, **svc_kw),
            tokenizer=CharTokenizer())
        self.service.start()
        self.http = ScoringHttp(self.service, free_local_port())
        index = self.service.indexer.kv_block_index
        inner = getattr(index, "inner", index)
        self.backend = type(inner).__name__
        if self.service.sharded_index is not None:
            shard_types = {type(s).__name__ for s in self.service.sharded_index.shards}
            self.backend += "[" + ",".join(sorted(shard_types)) + "]"

    def size(self) -> dict:
        return self.service._refresh_index_gauges()

    def close(self):
        self.http.close()
        self.service.shutdown()


def join_fleet(publishers: dict, scorer: Scorer, timeout: float = 30.0) -> None:
    """Publish empty batches (they change no index or counter) from every
    publisher until the scorer's fleet health has seen each one's pod:
    events published after this reach the index."""
    health = scorer.service.fleet_health
    deadline = time.monotonic() + timeout
    while not all(pod in health.snapshot()["pods"] for pod in publishers):
        if time.monotonic() > deadline:
            fail(f"scoring: publishers never reached the scorer: {sorted(publishers)}")
        for pod, pub in publishers.items():
            if pod not in health.snapshot()["pods"]:
                pub.publish([])
        time.sleep(0.01)
    scorer.service.events_pool.drain(timeout)


def scorable_lag_ms(scorer: Scorer, kvblock, pod: str, last_hash: int) -> float:
    """Milliseconds from now until ``last_hash`` is in the index under
    ``pod`` (10 s deadline)."""
    index = scorer.service.indexer.kv_block_index
    key = kvblock.Key(SCORING_MODEL, last_hash)
    t = time.perf_counter()
    while pod not in index.lookup([key], {pod}).get(key, []):
        if time.perf_counter() - t > 10:
            fail(f"scoring: {pod}'s last block not scorable 10 s after its request ended")
        time.sleep(0.0002)
    return (time.perf_counter() - t) * 1e3


def synthetic_fleet(kvblock, events_mod, rng):
    """Batches of ``SIM_PODS`` simulated pods, as a pod publishes them: one
    batch a prompt, one ``BlockStored`` an HBM page (its hash, parent and
    16 token ids). Returns (batches by pod, one prompt's tokens by
    (pod, prompt index), block count)."""
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=16))
    batches, prompts = {}, {}
    for i in range(SIM_PODS):
        pod = f"sim-pod-{i:02d}"
        batches[pod] = []
        for j, tokens in enumerate(char_prompts(rng, SIM_PROMPTS, 1024)):
            hashes = db.prefix_hashes(tokens)
            batches[pod].append([
                events_mod.BlockStored(block_hashes=[h], parent_block_hash=hashes[b - 1] if b else None,
                                       token_ids=tokens[b * 16:(b + 1) * 16], block_size=16,
                                       medium="tpu_hbm")
                for b, h in enumerate(hashes)])
            prompts[pod, j] = tokens
    return batches, prompts, SIM_PODS * SIM_PROMPTS * 64


def ingest_and_time(pkg, scorer: Scorer, batches, prompts, n_blocks, base_blocks, rng) -> dict:
    """Publish the simulated fleet into ``scorer`` over ZMQ (one publisher a
    pod), wait until every entry is admitted, hold the index's entry count
    against what was published, then time ``SCORE_REQUESTS`` HTTP score
    requests of 1088 tokens: a published prompt and 64 fresh tokens, each
    of which must score 64 on the pod that published it."""
    kvevents, collector = pkg["kvevents"], pkg["collector"]
    pubs = {pod: kvevents.ZMQPublisher(kvevents.ZMQPublisherConfig(
        endpoint=scorer.endpoint, pod_identifier=pod, model_name=SCORING_MODEL)) for pod in batches}
    try:
        join_fleet(pubs, scorer)
        admitted0 = collector.snapshot()["admissions"]
        t0 = time.perf_counter()
        for pod, pub in pubs.items():
            for events in batches[pod]:
                if pub.publish(events) < 0:
                    fail(f"scoring: {pod}'s publisher dropped a batch")
        publish_s = time.perf_counter() - t0
        deadline = t0 + 60
        while collector.snapshot()["admissions"] - admitted0 < n_blocks:
            if time.perf_counter() > deadline:
                fail(f"scoring: {collector.snapshot()['admissions'] - admitted0} of {n_blocks} "
                     f"published entries admitted after 60 s")
            time.sleep(0.005)
        ingest_s = time.perf_counter() - t0
    finally:
        for pub in pubs.values():
            pub.close()
    size = scorer.size()
    if size["blocks"] != base_blocks + n_blocks:
        fail(f"scoring: the index holds {size['blocks']} blocks, {base_blocks} + {n_blocks} published")
    keys = list(prompts)
    # Distinct prompts: each request's text is new to the tokenization
    # pool's prefix store, which would otherwise answer a repeated prefix
    # from its cache with the tokens of whole cached chunks only.
    picks = rng.choice(len(keys), SCORE_REQUESTS, replace=False)
    suffixes = char_prompts(rng, SCORE_REQUESTS, 64)
    ms, wrong = [], 0
    for n, (i, suffix) in enumerate(zip(picks.tolist(), suffixes)):
        pod, _ = keys[i]
        t = time.perf_counter()
        scores = scorer.http.score(prompts[keys[i]] + suffix)
        ms.append((time.perf_counter() - t) * 1e3)
        wrong += scores != {pod: 64}
    if wrong:
        fail(f"scoring: {wrong} of {SCORE_REQUESTS} score requests missed their pod's 64 blocks")
    return {
        "backend": scorer.backend,
        "entries_published": n_blocks,
        "index_blocks": size["blocks"],
        "index_pods": size["pods"],
        "publish_s": publish_s,
        "ingest_s": ingest_s,
        "ingest_events_per_s": n_blocks / ingest_s,
        "score_ms_p50": float(np.percentile(ms, 50)),
        "score_ms_p99": float(np.percentile(ms, 99)),
        "score_ms_mean": float(np.mean(ms)),
    }


def route_and_remove(pkg, ops, dev, params, cfg, scorer: Scorer, out: dict, rng) -> dict:
    """The route and remove parts of the scoring phase (below), on two pods
    publishing into ``scorer``; returns the kernel launches they made."""
    server, serve, kvblock = pkg["server"], pkg["serve"], pkg["kvblock"]
    prompts = char_prompts(rng, 8, 1024)
    fresh = char_prompts(rng, 4, 1024)
    suffixes = char_prompts(rng, 8, 64)
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=16))
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    engines, pods = [], {}
    try:
        for name, pages in (("pod-a", 1024), ("pod-b", 384)):
            eng = transfer_engine(server, dev, params, cfg, {"total_pages": pages})
            engines.append(eng)
            pods[name] = serve.PodServer(serve.PodServerConfig(
                model_name=SCORING_MODEL, pod_identifier=name, zmq_endpoint=scorer.endpoint),
                engine=eng)
            pods[name].start()
        join_fleet({name: pod._publisher for name, pod in pods.items()}, scorer)

        # -- route -------------------------------------------------------------
        owner = ["pod-a" if i % 2 == 0 else "pod-b" for i in range(8)]
        lag_ms = []
        for p, name in zip(prompts, owner):
            serve_each(pods[name], server, [p])
            lag_ms.append(scorable_lag_ms(scorer, kvblock, name, db.prefix_hashes(p)[-1]))
        wrong = []
        for i, (p, name) in enumerate(zip(prompts, owner)):
            scores = scorer.http.score(p + suffixes[i])
            if scores != {name: 64}:
                wrong.append({"prompt": i, "served_by": name, "scores": scores})
        if wrong:
            fail(f"scoring: repeats not routed to the pod that served them: {wrong}")
        routed, cold = [], []
        for i, (p, name) in enumerate(zip(prompts, owner)):
            routed += serve_each(pods[name], server, [p + suffixes[i]])
        for i, (p, name) in enumerate(zip(prompts, owner)):
            cold += serve_each(pods["pod-b" if name == "pod-a" else "pod-a"], server, [p + suffixes[i]])
        cached = [s.num_cached_prompt for s in routed]
        if cached != [1024] * 8:
            fail(f"scoring: routed repeats hit {cached} cached prompt tokens, not 1024 each")
        out["route"] = {
            "prompts": 8, "prompt_tokens": 1024, "new_tokens": 8, "repeat_tokens": 1088,
            "routed_to_server": 8, "scores": 64,
            "lag_request_end_to_last_block_scorable_ms": lag_ms,
            "cached_prompt_tokens_routed": cached,
            "cached_prompt_tokens_cold": [s.num_cached_prompt for s in cold],
            "ttft_ms_routed_median": ms_median(routed), "ttft_ms_cold_median": ms_median(cold),
        }

        # -- remove ------------------------------------------------------------
        serve_each(pods["pod-b"], server, fresh)
        bm = pods["pod-b"].engine.block_manager
        # The 4 prompts pod-b served first, then every other token list it
        # served: the controls (pod-a's prompts with their suffixes) and the
        # fresh prompts.
        first_b = [p for p, name in zip(prompts, owner) if name == "pod-b"]
        served_b = first_b + [p + s for p, s, name in zip(prompts, suffixes, owner)
                              if name == "pod-a"] + fresh
        held = [len(bm.lookup_chain(db.prefix_hashes(p))) for p in served_b]
        t = time.perf_counter()
        # Scored as token ids (the indexer's own entry point): the texts are
        # prefixes of ones the tokenization pool has seen, which its prefix
        # store would answer with the tokens of whole cached chunks only.
        indexer = scorer.service.indexer

        def pod_b_scores():
            return [indexer.score_tokens(p, SCORING_MODEL, ["pod-b"]).get("pod-b", 0) for p in served_b]

        while (scores := pod_b_scores()) != held:
            if time.perf_counter() - t > 10:
                fail(f"scoring: pod-b's scores {scores} != the blocks it holds {held} after 10 s")
            time.sleep(0.01)
        if all(h == 64 for h in held[:4]):
            fail("scoring: pod-b evicted none of the prompts it served first")
        out["remove"] = {"order": "pod-b's first 4 prompts, 4 controls, 4 fresh prompts",
                         "pod_b_scores": scores, "pod_b_held_consecutive_blocks": held,
                         "settled_ms": (time.perf_counter() - t) * 1e3}
    finally:
        for pod in pods.values():
            pod.shutdown()
    prefill = sum(e.prefill_stats["dispatches"] for e in engines)
    decode = sum(e.decode_stats["steps"] + e.decode_graphs.warmup_steps for e in engines)
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    expected = expected_launches(cfg, None, None, prefill, decode)
    if launches != expected:
        fail(f"scoring: kernel launches {launches} != expected {expected}")
    return launches


def scoring(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """The port's scoring plane routing two Llama-3.1-8B pods at full width
    and depth on the 8B path's parameters (one copy on the card): the
    port's ``ScoringService`` in process (SUB socket and HTTP API on
    loopback ports, the char tokenizer above), ``pod-a`` with 1024 pages of
    16 and ``pod-b`` with 384, both publishing over ZMQ.

    Route: 8 distinct 1024-token prompts, alternating pods, 8 new tokens
    each; every block becomes scorable (the lag from a request's end to its
    last block's visibility is reported); each prompt plus 64 fresh tokens
    scores 64 on the pod that served it and 0 elsewhere; sent there it hits
    1024 cached tokens; sent to the other pod as a control it is cold.
    Remove: ``pod-b`` serves 4 fresh prompts; its scores for the 4 prompts
    it served first (and for the controls and fresh prompts it served)
    equal the consecutive blocks its block manager holds.
    Scale: 16 simulated pods publish 16,384 blocks each over the same
    socket; every entry lands, and 1,000 HTTP score requests of 1,088
    tokens (1,000 distinct published prompts, each with 64 fresh tokens)
    are timed under ``NATIVE_INDEX`` 1/0 x ``SCORER_SHARDS`` 0/4.
    Exact launch counts over both pods' engines."""
    kvblock = pkg["kvblock"]
    from llm_d_kv_cache_manager_tpu_torch.kvcache import kvevents
    from llm_d_kv_cache_manager_tpu_torch.kvcache.metrics import collector
    from llm_d_kv_cache_manager_tpu_torch.server import api

    pkg = dict(pkg, kvevents=kvevents, collector=collector)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    out = {"phase": "scoring", "card": card, "http": True,
           "host_times": "score, ingest and lag times are host CPU wall times on the card's machine"}

    scorer = Scorer(api, *SCORING_CONFIGS[0])
    try:
        out["index_backend"] = scorer.backend
        if scorer.backend != "NativeMemoryIndex":
            fail(f"scoring: the default service runs the {scorer.backend} backend, not the native index")
        launches = route_and_remove(pkg, ops, dev, params, cfg, scorer, out, rng)
        free_cuda()

        # -- scale -------------------------------------------------------------
        t = time.perf_counter()
        batches, sim_prompts, n_blocks = synthetic_fleet(kvblock, kvevents, rng)
        out["scale"] = {"simulated_pods": SIM_PODS, "blocks_per_pod": SIM_PROMPTS * 64,
                        "events_per_batch": 64, "score_requests": SCORE_REQUESTS,
                        "score_prompt_tokens": 1088, "make_batches_s": time.perf_counter() - t,
                        "configs": {}}
        for i, (native, shards) in enumerate(SCORING_CONFIGS):
            if i:
                scorer = Scorer(api, native, shards)
            base = scorer.size()["blocks"]
            result = ingest_and_time(pkg, scorer, batches, sim_prompts, n_blocks, base, rng)
            out["scale"]["configs"][f"NATIVE_INDEX={int(native)},SCORER_SHARDS={shards}"] = result
            scorer.close()
            scorer = None
    finally:
        if scorer is not None:
            scorer.close()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


# -- the fleet contract: routing, admission, drain, resync, tracing ------------
#: the caller's W3C trace context of the fleet phase's traced request
FLEET_TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


class FleetPod:
    """One pod of the fleet phase: a ``PodServer`` on its own engine, its
    HTTP app on a loopback port, publishing to the scorer over ZMQ."""

    def __init__(self, pkg, dev, params, cfg, scorer: Scorer, name: str, pages: int,
                 profile_dir: str, engine_knobs=None, **knobs):
        """``engine_knobs``: further ``EngineConfig`` fields (``host_pages``
        among them); ``knobs``: further ``PodServerConfig`` fields."""
        server, serve = pkg["server"], pkg["serve"]
        self.name = name
        self.engine = transfer_engine(server, dev, params, cfg,
                                      dict(FAST_KNOBS, total_pages=pages, **(engine_knobs or {})))
        self.pod = serve.PodServer(serve.PodServerConfig(
            model_name=SCORING_MODEL, pod_identifier=name, zmq_endpoint=scorer.endpoint,
            heartbeat_interval_s=0.2, resync_interval_s=0.0, obs_tracing=True,
            obs_metrics=True, obs_profile_dir=profile_dir, **knobs), engine=self.engine)
        self.pod.start()
        self.http = HttpApp(self.pod.build_app(), free_local_port(), name)
        #: the token lists this pod served (prompt + generated): the
        #: universe its index view is read over
        self.served: list[list[int]] = []

    def complete(self, tokens, new_tokens: int, headers=None):
        """POST /v1/completions: (status, headers, body)."""
        status, hdrs, body = self.http.call(
            "POST", "/v1/completions", {"prompt_token_ids": tokens, "max_tokens": new_tokens},
            headers)
        if status == 200:
            self.served.append(list(tokens) + body["choices"][0]["token_ids"])
        return status, hdrs, body

    def close(self):
        self.http.close()
        self.pod.shutdown()


def expect_length(body, new_tokens: int, what: str) -> None:
    choice = body["choices"][0]
    if choice["finish_reason"] != "length" or len(choice["token_ids"]) != new_tokens:
        fail(f"fleet: {what} finished {choice['finish_reason']!r} with "
             f"{len(choice['token_ids'])} of {new_tokens} tokens")


def index_view(scorer: Scorer, kvblock, name: str, token_lists) -> set[int]:
    """The chain hashes of ``token_lists`` the scorer's index attributes to
    pod ``name``."""
    index = scorer.service.indexer.kv_block_index
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=16))
    view = set()
    for tokens in token_lists:
        for h in db.prefix_hashes(tokens):
            key = kvblock.Key(SCORING_MODEL, h)
            if name in index.lookup([key], set()).get(key, []):
                view.add(h)
    return view


def fleet_route(pods: dict, router, health, scorer, kvblock, rng, out: dict) -> dict:
    """The route step of ``fleet`` (below); returns each group's owner."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(pods)
    prefixes = char_prompts(rng, 4, 768)
    groups = [[prefix + own for own in char_prompts(rng, 4, 256)] for prefix in prefixes]
    decision_ms, first, owner = [], [], []

    def route(tokens):
        t = time.perf_counter()
        d = router.route(tokens, [n for n in names if health.is_routable(n)])
        decision_ms.append((time.perf_counter() - t) * 1e3)
        return d

    with ThreadPoolExecutor(4) as pool:
        futures = []
        for g in range(4):
            d = route(groups[g][0])
            depth = pods[d.pod].pod.queue_depth
            futures.append(pool.submit(pods[d.pod].complete, groups[g][0], 16,
                                       {"X-Route-Action": d.action}))
            # Back to back: the next decision reads this request's load.
            deadline = time.monotonic() + 30
            while pods[d.pod].pod.queue_depth <= depth and not futures[-1].done():
                if time.monotonic() > deadline:
                    fail("fleet: a routed request never showed in its pod's queue depth")
                time.sleep(0.0005)
            owner.append(d.pod)
        for g, fut in enumerate(futures):
            status, _, body = fut.result()
            if status != 200:
                fail(f"fleet: group {g}'s first request answered {status} {body}")
            expect_length(body, 16, f"group {g}'s first request")
            first.append(body)
    if set(owner) != set(names):
        fail(f"fleet: the load term did not spread the groups over both pods: {owner}")
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=16))
    for g in range(4):
        scorable_lag_ms(scorer, kvblock, owner[g], db.prefix_hashes(groups[g][0])[-1])
    warm, repeats, misses = 0, [], []
    for r in range(1, 4):
        for g in range(4):
            d = route(groups[g][r])
            status, _, body = pods[d.pod].complete(groups[g][r], 16, {"X-Route-Action": d.action})
            if status != 200:
                fail(f"fleet: group {g} request {r} answered {status} {body}")
            expect_length(body, 16, f"group {g} request {r}")
            cached = body["usage"]["cached_prompt_tokens"]
            ok = d.pod == owner[g] and d.action == "route_warm" and cached >= 768
            warm += ok
            repeats.append(body)
            if not ok:
                misses.append({"group": g, "request": r, "pod": d.pod, "owner": owner[g],
                               "action": d.action, "index_score": d.index_score,
                               "cached": cached})
    if warm != 12:
        fail(f"fleet: {warm} of 12 repeats routed warm with >= 768 cached tokens: {misses}")
    out["route"] = {
        "groups": 4, "requests_per_group": 4, "prefix_tokens": 768, "own_tokens": 256,
        "new_tokens": 16, "owners": owner, "warm_share": f"{warm}/12",
        "cached_prompt_tokens_warm": [b["usage"]["cached_prompt_tokens"] for b in repeats],
        "router_decision_ms_p50": float(np.percentile(decision_ms, 50)),
        "router_decision_ms_p99": float(np.percentile(decision_ms, 99)),
        "ttft_ms_placed_median": float(np.median([b["ttft_s"] * 1e3 for b in first])),
        "ttft_ms_routed_warm_median": float(np.median([b["ttft_s"] * 1e3 for b in repeats])),
    }
    return {"groups": groups, "owner": owner}


def fleet_overload(pod_b: FleetPod, rng, out: dict) -> None:
    """The overload step of ``fleet`` (below)."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    _, _, before = pod_b.http.call("GET", "/stats")
    prompts = char_prompts(rng, 14, 1024)
    with ThreadPoolExecutor(14) as pool:
        answers = list(pool.map(lambda p: pod_b.complete(p, 64), prompts))
    rejected = [(h, b) for s, h, b in answers if s == 429]
    admitted = [b for s, _, b in answers if s == 200]
    if len(rejected) + len(admitted) != 14:
        fail(f"fleet: overload answers {[s for s, _, _ in answers]} are not all 200 or 429")
    if not rejected:
        fail("fleet: 14 concurrent requests on pod-b drew no 429")
    message = re.compile(r"overloaded: \d+ requests waiting >= ADMISSION_MAX_WAITING=2")
    for hdrs, body in rejected:
        if not message.fullmatch(body["error"]) or int(hdrs["Retry-After"]) < 1 \
                or str(int(hdrs["Retry-After"])) != hdrs["Retry-After"]:
            fail(f"fleet: a 429 carried {hdrs.get('Retry-After')!r} and {body}")
    for b in admitted:
        expect_length(b, 64, "an admitted overload request")
    _, _, after = pod_b.http.call("GET", "/stats")
    counted = after["admission"]["rejected"] - before["admission"]["rejected"]
    if counted != len(rejected):
        fail(f"fleet: /stats counted {counted} rejections, the clients {len(rejected)}")
    if after["admission"]["pending_requests"] != 0:
        fail(f"fleet: {after['admission']['pending_requests']} requests pending after the overload")
    out["overload"] = {
        "requests": 14, "prompt_tokens": 1024, "new_tokens": 64, "admitted": len(admitted),
        "rejected_429": len(rejected), "stats_rejected": counted,
        "retry_after_s": sorted({b["retry_after_s"] for _, b in rejected}),
        "retry_after_header": sorted({h["Retry-After"] for h, _ in rejected}),
        "message": rejected[0][1]["error"],
    }


def fleet_drain(pods: dict, router, routed: dict, scorer: Scorer, kvblock, rng,
                out: dict) -> None:
    """The drain step of ``fleet`` (below)."""
    from concurrent.futures import ThreadPoolExecutor

    pod_b, health = pods["pod-b"], scorer.service.fleet_health
    prompts = char_prompts(rng, 2, 1024)
    with ThreadPoolExecutor(2) as pool:
        inflight = [pool.submit(pod_b.complete, p, 128) for p in prompts]
        deadline = time.monotonic() + 30
        while pod_b.pod.queue_depth < 2:
            if time.monotonic() > deadline:
                fail("fleet: the drain step's requests never reached pod-b")
            time.sleep(0.001)
        # Held before the drain: what pod-b served scores on the scorer.
        groups, owner = routed["groups"], routed["owner"]
        b_lists = [t for g, o in enumerate(owner) if o == "pod-b" for t in groups[g]] \
            + list(pod_b.served)
        scored_before = max(scorer.service.indexer.score_tokens(
            t, SCORING_MODEL, ["pod-b"]).get("pod-b", 0) for t in b_lists)
        t_post = time.perf_counter()
        status, _, body = pod_b.http.call("POST", "/drain")
        if status != 202 or body != {"status": "draining", "drain_timeout_s": 60.0}:
            fail(f"fleet: POST /drain answered {status} {body}")
        while not health.snapshot()["pods"]["pod-b"]["draining"]:
            if time.perf_counter() - t_post > 10:
                fail("fleet: the scorer never saw pod-b's draining heartbeat")
            time.sleep(0.0005)
        unrouted_s = time.perf_counter() - t_post
        drained_at_unroute = health.snapshot()["pods_drained"]
        if drained_at_unroute != 0 or health.is_routable("pod-b"):
            fail(f"fleet: pod-b unrouted with pods_drained={drained_at_unroute}")
        status, _, body = pod_b.http.call("GET", "/healthz")
        if status != 503 or body != {"status": "draining"}:
            fail(f"fleet: /healthz answered {status} {body} while draining")
        status, _, body = pod_b.complete(char_prompts(rng, 1, 64)[0], 4)
        if status != 503 or body != {"error": "pod is draining; retry against another pod"}:
            fail(f"fleet: a submit while draining answered {status} {body}")
        for fut in inflight:
            status, _, body = fut.result()
            if status != 200:
                fail(f"fleet: an in-flight request answered {status} {body} through the drain")
            expect_length(body, 128, "an in-flight request through the drain")
    while not pod_b.pod._drain_done.is_set():
        if time.perf_counter() - t_post > 90:
            fail("fleet: pod-b's drain did not end")
        time.sleep(0.001)
    drain_s = time.perf_counter() - t_post
    if pod_b.pod._drain_clean is not True:
        fail("fleet: pod-b's drain was not clean")
    # The goodbye is published before the drain ends, but it crosses a ZMQ
    # socket: until the subscriber hands it to the pool, the pool has
    # nothing queued and ``drain`` returns at once. Wait for the scorer to
    # apply it (the pool evicts the pod's entries before counting it).
    while health.snapshot()["pods_drained"] == 0:
        if time.perf_counter() - t_post > drain_s + 10:
            fail("fleet: the scorer never applied pod-b's PodDrained goodbye")
        time.sleep(0.0005)
    goodbye_s = time.perf_counter() - t_post
    scorer.service.events_pool.drain(30)
    fleet_stats = health.snapshot()
    if fleet_stats["pods_drained"] != 1:
        fail(f"fleet: pods_drained is {fleet_stats['pods_drained']}")
    b_lists = [t for g, o in enumerate(owner) if o == "pod-b" for t in groups[g]] + pod_b.served
    scores = [scorer.service.indexer.score_tokens(t, SCORING_MODEL, ["pod-b"]).get("pod-b", 0)
              for t in b_lists]
    view = index_view(scorer, kvblock, "pod-b", b_lists)
    still_held = sum(len(v) for v in pod_b.engine.block_digest().values())
    if any(scores) or view or not still_held or not scored_before:
        fail(f"fleet: after the drain pod-b scores {sorted(set(scores))}, the index holds "
             f"{len(view)} of its blocks (held {still_held}, scored {scored_before} before)")
    names = list(pods)
    picks = [router.route(groups[g][0], [n for n in names if health.is_routable(n)]).pod
             for g in range(4)]
    if picks != ["pod-a"] * 4:
        fail(f"fleet: after the drain the router picked {picks}")
    out["drain"] = {
        "inflight": 2, "new_tokens": 128, "clean": True, "healthz": 503, "submit": 503,
        "seconds_post_to_unrouted": unrouted_s, "drain_seconds": drain_s,
        "seconds_post_to_goodbye_applied": goodbye_s, "pods_drained": fleet_stats["pods_drained"], "pod_b_score_before": scored_before,
        "pod_b_scores_after": sorted(set(scores)), "pod_b_blocks_still_held": still_held,
        "router_picks_after": picks,
    }


def fleet_profile(pod_a: FleetPod, profile_dir: str, rng, out: dict) -> None:
    """The profile step of ``fleet`` (below)."""
    import glob
    from concurrent.futures import ThreadPoolExecutor

    keys = pod_a.engine.decode_graphs.keys
    with ThreadPoolExecutor(5) as pool:
        prof = pool.submit(pod_a.http.call, "POST", "/debug/profile?seconds=1")
        time.sleep(0.1)
        answers = list(pool.map(lambda p: pod_a.complete(p, 48), char_prompts(rng, 4, 1024)))
        status, _, body = prof.result()
    if status != 200 or body != {"profile_dir": profile_dir, "seconds": 1.0}:
        fail(f"fleet: /debug/profile answered {status} {body}")
    for s, _, b in answers:
        if s != 200:
            fail(f"fleet: a profiled request answered {s} {b}")
        expect_length(b, 48, "a profiled request")
    (path,) = glob.glob(os.path.join(profile_dir, "pod-a-*.pt.trace.json"))
    with open(path) as f:
        text = f.read()
    found = {k: text.count(k) for k in ("split_decode_kernel", "flash_prefill_kernel",
                                         "combine_kernel")}
    if not found["split_decode_kernel"] or not found["flash_prefill_kernel"]:
        fail(f"fleet: the profile's trace names {found}")
    out["profile"] = {"seconds": 1.0, "requests": 4, "trace_bytes": len(text),
                      "kernel_name_mentions": found,
                      "graph_captured_in_window": pod_a.engine.decode_graphs.keys != keys}


def fleet(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """The pod's fleet contract at full width and depth on the 8B path's
    parameters (one copy on the card): the port's ``ScoringService`` in
    process with a huge ``pod_ttl_s`` (only a goodbye can evict), two pods
    publishing to it over ZMQ with their HTTP apps on loopback — ``pod-a``
    with 1024 pages of 16, ``pod-b`` with 384 and
    ``admission_max_waiting=2`` and ``drain_timeout_s=60``, both with 8
    lanes, the decode fast path (``FAST_KNOBS``: pipelined graph bursts of
    4), heartbeats every 0.2 s, tracing, ``OBS_METRICS`` and a profile
    directory — and a ``BlendedRouter`` over them (the scorer's index
    scores, routed affinity, each pod's ``queue_depth``; the pods the
    scorer's fleet health holds routable).

    Route: 4 groups of 4 requests, each a 768-token group prefix plus 256
    tokens of its own, 16 greedy new tokens, sent over HTTP with the
    decision's ``X-Route-Action``. The groups' first requests are routed
    back to back and must land on both pods; the 12 repeats go
    ``route_warm`` to their group's pod and hit >= 768 cached tokens.
    Overload: 14 concurrent 1024-token requests (64 new tokens) on pod-b:
    at least one 429 with the JAX pod's message and an integer
    ``Retry-After`` >= 1, every admitted request finishes ``"length"``,
    ``/stats`` counts the 429s, nothing stays pending. Drain: 2 requests on
    pod-b, then ``POST /drain``: both finish ``"length"`` (a clean drain),
    ``/healthz`` and a new submit answer 503, the scorer unroutes pod-b on
    its draining heartbeat before the goodbye, ``pods_drained`` is 1,
    pod-b's blocks leave the index (its engine still holds them) and the
    router's next 4 decisions pick pod-a. Resync: ``pod-a``'s snapshot
    leaves the scorer's view of pod-a equal to its engine's digest. Trace:
    a request with a ``traceparent`` is served from ``/debug/traces``
    under the caller's trace id; ``/stats`` and ``/metrics`` answer.
    Profile: ``POST /debug/profile?seconds=1`` on pod-a while 4 requests
    run writes a trace naming K1's and K2's kernels. Forced drain: pod-a
    drains with a 0.5 s budget while 4 long requests decode in pipelined
    bursts; the abort commits the burst in flight and every page comes
    back. Exact launch counts over both pods' engines."""
    import shutil
    import tempfile

    kvblock = pkg["kvblock"]
    from llm_d_kv_cache_manager_tpu_torch import kvcache
    from llm_d_kv_cache_manager_tpu_torch.server import api

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 4)
    out = {"phase": "fleet", "card": card, "http": True,
           "host_times": "decision, TTFT, drain and unroute times are host wall times"}
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    profile_dir = tempfile.mkdtemp(prefix="fleet-profile-")
    scorer = Scorer(api, True, 0, pod_ttl_s=1e9)
    pods: dict = {}
    try:
        pods["pod-a"] = FleetPod(pkg, dev, params, cfg, scorer, "pod-a", 1024, profile_dir)
        pods["pod-b"] = FleetPod(pkg, dev, params, cfg, scorer, "pod-b", 384, profile_dir,
                                 admission_max_waiting=2, drain_timeout_s=60.0)
        join_fleet({name: p.pod._publisher for name, p in pods.items()}, scorer)
        health = scorer.service.fleet_health
        indexer = scorer.service.indexer
        router = kvcache.BlendedRouter(
            score_fn=lambda toks, names: indexer.score_tokens(toks, SCORING_MODEL, names),
            affinity=kvcache.PrefixAffinityTracker(
                2, 1024, token_processor=kvblock.ChunkedTokenDatabase(
                    kvblock.TokenProcessorConfig(block_size=16))),
            loads_fn=lambda names: [pods[n].pod.queue_depth for n in names],
        )
        routed = fleet_route(pods, router, health, scorer, kvblock, rng, out)
        fleet_overload(pods["pod-b"], rng, out)
        fleet_drain(pods, router, routed, scorer, kvblock, rng, out)
        pod_a = pods["pod-a"]

        # -- resync ---------------------------------------------------------
        resyncs = health.snapshot()["resyncs_applied"]
        t_resync = time.perf_counter()
        if not pod_a.pod.publish_index_snapshot(wait=True):
            fail("fleet: pod-a's index snapshot was not published")
        # As with the goodbye: the snapshot is in the pool only once the
        # subscriber has read it off the socket, so wait for it to apply.
        while health.snapshot()["resyncs_applied"] == resyncs:
            if time.perf_counter() - t_resync > 10:
                fail("fleet: the scorer never applied pod-a's index snapshot")
            time.sleep(0.0005)
        scorer.service.events_pool.drain(30)
        digest = {h for hashes in pod_a.engine.block_digest().values() for h in hashes}
        view = index_view(scorer, kvblock, "pod-a",
                          pod_a.served + [t for g in routed["groups"] for t in g])
        if view != digest:
            fail(f"fleet: after the resync the scorer holds {len(view)} of pod-a's blocks, "
                 f"its engine {len(digest)} ({len(view ^ digest)} differ)")
        out["resync"] = {"digest_blocks": len(digest), "index_view_blocks": len(view),
                         "equal": True, "snapshots_published": pod_a.pod.snapshots_published}

        # -- trace and metrics ----------------------------------------------
        trace_id, parent = FLEET_TRACEPARENT.split("-")[1:3]
        status, hdrs, body = pod_a.complete(char_prompts(rng, 1, 512)[0], 8,
                                            {"traceparent": FLEET_TRACEPARENT})
        if status != 200 or hdrs.get("traceparent", "").split("-")[1:2] != [trace_id]:
            fail(f"fleet: the traced request answered {status} with {hdrs.get('traceparent')}")
        _, _, traces = pod_a.http.call("GET", f"/debug/traces?trace_id={trace_id}")
        spans = [s for t in traces["traces"] for s in t["spans"]]
        req = [s for s in spans if s["name"] == "pod.request"]
        names = sorted(s["name"] for s in spans)
        if len(req) != 1 or req[0]["parent_span_id"] != parent or names != [
                "pod.decode", "pod.prefill", "pod.queue", "pod.request"] or any(
                s["trace_id"] != trace_id for s in spans):
            fail(f"fleet: /debug/traces gave {names} for the caller's trace id")
        try:
            import prometheus_client  # noqa: F401
            prom = True
        except ImportError:
            prom = False
        answers = {}
        for name, p in pods.items():
            s_stats, _, _ = p.http.call("GET", "/stats")
            s_metrics, _, text = p.http.call("GET", "/metrics")
            answers[name] = [s_stats, s_metrics]
            if s_stats != 200 or s_metrics != (200 if prom else 501):
                fail(f"fleet: {name}'s /stats and /metrics answered {s_stats}, {s_metrics}")
            if prom:
                missing = [f for f in POD_METRIC_FAMILIES if f"# TYPE {f} " not in text]
                if missing:
                    fail(f"fleet: {name}'s /metrics lacks {missing}")
        _, _, stats_a = pod_a.http.call("GET", "/stats")
        out["trace"] = {"trace_id": trace_id, "spans": names,
                        "pod_request_parent": req[0]["parent_span_id"]}
        out["metrics"] = {"prometheus_client": prom, "stats_metrics_status": answers,
                          "families_checked": len(POD_METRIC_FAMILIES) if prom else 0,
                          "pod_a_step_stats": stats_a["obs"]["step_stats"],
                          "step_stats_clock": "host clocks; decode_s of a graph burst is its launch"}

        fleet_profile(pod_a, profile_dir, rng, out)

        # -- forced drain over pipelined bursts -------------------------------
        bm = pod_a.engine.block_manager
        free0 = bm.num_free
        futures = [pod_a.pod.submit(p, pkg["server"].SamplingParams(max_new_tokens=512))
                   for p in char_prompts(rng, 4, 1024)]
        deadline = time.monotonic() + 60
        while not (len(pod_a.engine.scheduler.running) == 4 and all(
                s.num_generated >= 16 for s in list(pod_a.engine.scheduler.running))):
            if time.monotonic() > deadline:
                fail("fleet: the forced drain's requests never reached decode")
            time.sleep(0.001)
        t = time.perf_counter()
        clean = pod_a.pod.drain(timeout_s=0.5)
        forced_s = time.perf_counter() - t
        seqs = [f.result(timeout=60) for f in futures]
        if clean or any(s.finish_reason != "abort" for s in seqs):
            fail(f"fleet: the forced drain was clean={clean}, "
                 f"{[s.finish_reason for s in seqs]}")
        deadline = time.monotonic() + 30
        while pod_a.engine.has_work or bm.num_free != free0:
            if time.monotonic() > deadline:
                fail(f"fleet: after the forced drain {bm.num_free} pages are free, "
                     f"{free0} before it")
            time.sleep(0.001)
        if pod_a.engine._inflight is not None:
            fail("fleet: a decode burst stayed in flight through the forced drain")
        out["forced_drain"] = {"requests": 4, "generated_at_abort": [s.num_generated for s in seqs],
                               "seconds": forced_s, "free_pages_restored": True,
                               "forced_requests": pod_a.pod.drain_forced_requests}
        engines = [p.engine for p in pods.values()]
    finally:
        for p in pods.values():
            p.close()
        scorer.close()
        shutil.rmtree(profile_dir, ignore_errors=True)
    torch.cuda.synchronize()
    prefill = sum(e.prefill_stats["dispatches"] for e in engines)
    decode = sum(e.decode_stats["steps"] + e.decode_graphs.warmup_steps for e in engines)
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    expected = expected_launches(cfg, None, None, prefill, decode)
    if launches != expected:
        fail(f"fleet: kernel launches {launches} != expected {expected}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


# -- the fleet's control loops ---------------------------------------------------
#: the TTFT objective of the fleet_controller phase's pods: a placed 8B
#: prompt's TTFT reads ~0.5 s on the card, so its cold requests burn it
FC_SLO = "ttft:0.2:0.99"
#: prompt tokens, greedy new tokens, and the tokens each request has
#: decoded before the migration step freezes it
FC_PROMPT, FC_NEW, FC_FREEZE_AT = 1024, 64, 16
#: a TTFT bucket of an OpenMetrics exposition that carries a trace-id
#: exemplar
EXEMPLAR_RE = r'kvcache_request_ttft_seconds_bucket\{[^}]*\}\s+\S+\s+#\s+\{trace_id="([0-9a-f]{32})"\}'


class StepGate:
    """Holds a pod's engine steps: while ``running`` is clear, and from the
    first step at which ``park_when()`` holds until ``release``, the engine
    loop's step does nothing (the loop still serves its queues: admissions,
    freezes, settles). So the point at which a migration freezes a request
    is a function of the requests, not of timing, and two pods fed the same
    requests freeze them alike."""

    def __init__(self, engine):
        import threading

        self.engine, self._step = engine, engine.step
        self.running = threading.Event()
        self.parked = threading.Event()
        self.park_when = None
        engine.step = self.step

    def step(self):
        if not self.parked.is_set() and self.park_when is not None and self.park_when():
            self.parked.set()
        if not self.running.is_set() or self.parked.is_set():
            time.sleep(0.001)
            return []
        return self._step()

    def release(self):
        self.park_when = None
        self.parked.clear()
        self.running.set()
        del self.engine.step


def live_seqs(eng, rids) -> list:
    """The engine's running and prefilling sequences among ``rids`` (a
    read from another thread: retried when a list changes under it)."""
    while True:
        try:
            sch = eng.scheduler
            return [s for s in list(sch.running) + list(sch.prefilling) if s.request_id in rids]
        except RuntimeError:
            continue


def frozen_batch(pkg, pod: FleetPod, prompts, rids, new_tokens: int = FC_NEW,
                 freeze_at: int = FC_FREEZE_AT):
    """Submit ``prompts`` to ``pod`` with its steps held until all are
    admitted, then let them run together until each has decoded
    ``freeze_at`` tokens, and park the engine there. Returns the futures
    and the parked gate."""
    gate = StepGate(pod.engine)
    sp = pkg["server"].SamplingParams
    futs = [pod.pod.submit(p, sp(max_new_tokens=new_tokens), request_id=rid)
            for p, rid in zip(prompts, rids)]
    deadline = time.monotonic() + 30
    while len(pod.engine.scheduler.waiting) < len(prompts):
        if time.monotonic() > deadline:
            fail(f"fleet_controller: {pod.name} never admitted the migration batch")
        time.sleep(0.001)
    rid_set = set(rids)

    def all_decoded() -> bool:
        seqs = live_seqs(pod.engine, rid_set)
        return len(seqs) == len(rids) and all(s.num_generated >= freeze_at for s in seqs)

    gate.park_when = all_decoded
    gate.running.set()
    if not gate.parked.wait(120):
        fail(f"fleet_controller: {pod.name}'s batch never decoded {freeze_at} tokens")
    return futs, gate


def migration_logit_move(pkg, params, cfg, tokens, cached: int, ps, dev,
                         n_prompt: int = FC_PROMPT) -> float:
    """How far one token's logits move between the two ways a migration
    computes them: the source decodes every token after the prompt
    (``decode_step`` over a pool its prefill wrote), the target re-prefills
    the context past its ``cached`` imported tokens over those pages (one
    warm prefill). ``tokens`` is the folded context (prompt and the tokens
    generated before the freeze, after an ``n_prompt``-token prompt); the
    largest absolute difference of the next token's logits."""
    models, llama = pkg["models"], pkg["llama"]
    pages = len(tokens) // ps + 2
    pool = list(models.init_kv_pages(cfg, pages, ps, dev))
    table = torch.arange(1, pages, dtype=torch.int32, device=dev)

    def prefill(pool_, toks, start):
        pos = torch.arange(start, start + len(toks), dtype=torch.int32, device=dev)[None]
        return models.prefill(params, cfg, torch.tensor([toks], dtype=torch.int32, device=dev),
                              pos, torch.ones_like(pos, dtype=torch.bool), pool_[0], pool_[1],
                              table[pos.long() // ps], pos % ps, table[: -(-start // ps)][None],
                              torch.tensor([start], dtype=torch.int32, device=dev))[0][0]

    prefill(pool, tokens[:n_prompt], 0)
    for i in range(n_prompt, len(tokens)):
        logits_dec = llama.decode_step(
            params, cfg, torch.tensor([tokens[i]], dtype=torch.int32, device=dev),
            torch.tensor([i], dtype=torch.int32, device=dev), pool[0], pool[1], table[None],
            torch.tensor([i + 1], dtype=torch.int32, device=dev), page_size=ps)[0][0]
    warm = [t.clone() for t in pool]
    logits_warm = prefill(warm, tokens[cached:], cached)
    return float((logits_dec.float() - logits_warm.float()).abs().max())


def migration_parity(pkg, eng, cfg, prompts, migrated, reference, frozen_at, cached, ps,
                     dev, phase: str = "fleet_controller") -> list[dict]:
    """Migrated greedy tokens against a never-migrated run's: equal, or the
    first difference comes after the freeze and the model's top-2 logit gap
    there (one cold prefill) is at most twice the logit move a migration makes
    (``migration_logit_move``: a top-2 gap moves by at most twice that).
    Each difference is reported with its gap and measured move."""
    diffs = []
    for i, (a, b) in enumerate(zip(reference, migrated)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        d = dict(top2_gap(pkg, eng, cfg, prompts[i], a[:j], ps, dev),
                 request=i, index=j, never_migrated=a[j], migrated=b[j], frozen_at=frozen_at[i])
        if j < frozen_at[i]:
            fail(f"{phase}: a request's tokens differ before its freeze: {d}")
        context = list(prompts[i]) + list(a[: frozen_at[i]])
        d["migration_logit_move"] = migration_logit_move(pkg, eng.params, cfg, context,
                                                         cached[i], ps, dev)
        if d["top2_gap"] > 2 * d["migration_logit_move"]:
            fail(f"{phase}: greedy tokens differ from the reference run's with a top-2 gap "
                 f"beyond what the change of kernel moves the logits by: {d}")
        diffs.append(d)
    return diffs


def wait_for(predicate, what: str, timeout: float = 30.0) -> float:
    """Poll ``predicate`` every 0.5 ms; seconds it took. Fails the phase
    with ``what`` after ``timeout``."""
    t = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t > timeout:
            fail(f"fleet_controller: {what}")
        time.sleep(0.0005)
    return time.perf_counter() - t


def fc_slo_flight(pod_a: FleetPod, flight_dir: str, rng, out: dict) -> None:
    """Step 1 of ``fleet_controller``: SLO burn, the flight dump and the
    lifecycle/MRC endpoints."""
    import glob
    import re

    firsts = []
    for p in char_prompts(rng, 3, FC_PROMPT):
        status, _, body = pod_a.complete(p, 8)
        if status != 200:
            fail(f"fleet_controller: a cold request answered {status} {body}")
        expect_length(body, 8, "a cold request")
        firsts.append(body["ttft_s"])
    _, _, stats = pod_a.http.call("GET", "/stats")
    burn = stats["slo"]["burn_rates"]["ttft_le_0.2s_p0.99"]
    threshold = pod_a.pod.config.obs_flight_burn
    if not burn["60s"] or burn["60s"] < threshold:
        fail(f"fleet_controller: /stats slo burn {burn} under the flight threshold {threshold}")
    dumps = glob.glob(os.path.join(flight_dir, "flight-pod-a-*-slo_burn.json"))
    if not dumps:
        fail(f"fleet_controller: no slo_burn flight dump in {os.listdir(flight_dir)}")
    _, _, flight = pod_a.http.call("GET", "/debug/flight")
    kinds = [e["kind"] for e in (flight.get("timeline") or {}).get("entries", [])]
    if flight["timeline"]["reason"] != "slo_burn" or "step" not in kinds \
            or "trigger:slo_burn" not in kinds or "slo_burn" not in kinds:
        fail(f"fleet_controller: /debug/flight served {flight.get('timeline', {}).get('reason')} "
             f"with {sorted(set(kinds))}")
    _, _, led = pod_a.http.call("GET", "/debug/lifecycle")
    _, _, mrc = pod_a.http.call("GET", "/debug/mrc")
    if not (led["enabled"] and led["recent"] and led["transitions"] > 0):
        fail(f"fleet_controller: /debug/lifecycle answered {led.get('enabled')} with "
             f"{led.get('transitions')} transitions")
    if not (mrc["enabled"] and mrc["curve"] and mrc["accesses"] > 0):
        fail(f"fleet_controller: /debug/mrc answered {mrc}")
    status, hdrs, text = pod_a.http.call("GET", "/metrics")
    if status != 200 or "# TYPE kvcache_slo_burn_rate gauge" not in text \
            or not re.search(r'kvcache_slo_burn_rate\{objective="ttft_le_0.2s_p0.99"', text):
        fail(f"fleet_controller: /metrics answered {status} without the SLO burn gauge")
    out["slo_flight"] = {
        "slo": FC_SLO, "cold_requests": 3, "ttft_ms": [t * 1e3 for t in firsts],
        "burn_rates": stats["slo"]["burn_rates"], "flight_burn_threshold": threshold,
        "flight_dumps": len(dumps), "timeline_entries": len(kinds),
        "timeline_kinds": sorted(set(kinds)), "flight": stats["flight"],
        "lifecycle_transitions": led["transitions"], "mrc_accesses": mrc["accesses"],
        "mrc_tiers": mrc["tiers"], "metrics_content_type": hdrs.get("Content-Type"),
    }


def fc_migrate(pkg, pods: dict, prompts, rng, out: dict) -> dict:
    """Step 2 of ``fleet_controller``: live migration of four decodes from
    pod-b to pod-a. Returns what the parity and fallback checks need."""
    pod_a, pod_b = pods["pod-a"], pods["pod-b"]
    ep_a = pod_a.pod.config.transfer_endpoint
    bm_b = pod_b.engine.block_manager
    free_b = bm_b.num_free
    rids = [f"mig-{i}" for i in range(len(prompts))]
    futs, gate = frozen_batch(pkg, pod_b, prompts, rids)
    page_mib = sum(t[:, 0].numel() * t.element_size()
                   for t in (pod_b.engine.k_pages, pod_b.engine.v_pages)) / 2**20
    service = pod_a.pod._transfer_service
    moves = []
    for rid in rids:
        blocks0 = service.migration_blocks_accepted
        t = time.perf_counter()
        resumed = pod_b.pod.migrate_out(rid, ep_a)
        ms = (time.perf_counter() - t) * 1e3
        blocks = service.migration_blocks_accepted - blocks0
        moves.append({"request": rid, "resumed": resumed, "ms": ms, "blocks": blocks,
                      "mib": blocks * page_mib})
        if not resumed:
            fail(f"fleet_controller: the migration of {rid} did not resume: {moves[-1]}")
    gate.release()
    local = [f.result(timeout=60) for f in futs]
    if any(s.finish_reason != "migrated" for s in local):
        fail(f"fleet_controller: the source's futures finished {[s.finish_reason for s in local]}")
    conts = [pod_a.pod.migrated_future(rid).result(timeout=120) for rid in rids]
    for s, c in zip(local, conts):
        if c.error or c.finish_reason not in (None, "length") or len(c.generated_tokens) != FC_NEW:
            fail(f"fleet_controller: a continuation finished {c.finish_reason!r} with "
                 f"{len(c.generated_tokens)} of {FC_NEW} tokens")
        if c.generated_tokens[: len(s.generated_tokens)] != s.generated_tokens:
            fail("fleet_controller: a continuation does not continue its source's tokens")
    wait_for(lambda: pod_a.pod.queue_depth == 0 and pod_b.pod.queue_depth == 0,
             f"queue depths {pod_a.pod.queue_depth}, {pod_b.pod.queue_depth} after the migrations")
    if bm_b.num_free != free_b or pod_b.engine.has_work:
        fail(f"fleet_controller: pod-b has {bm_b.num_free} free pages after the migrations, "
             f"{free_b} before")
    drain_s = pod_b.pod.config.drain_timeout_s
    out["migration"] = {
        "requests": len(rids), "prompt_tokens": FC_PROMPT, "new_tokens": FC_NEW,
        "frozen_at_tokens": [len(s.generated_tokens) for s in local],
        "resumed": f"{sum(m['resumed'] for m in moves)}/{len(moves)}", "moves": moves,
        "ms_median": float(np.median([m["ms"] for m in moves])),
        "drain_timeout_s": drain_s,
        "ms_max_over_drain_timeout": max(m["ms"] for m in moves) / (drain_s * 1e3),
        "cached_prompt_tokens_on_target": [c.num_cached_prompt for c in conts],
        "pod_b_free_pages_restored": True, "queue_depth_after": [0, 0],
        "host_times": "migration ms are host wall times, freeze to settle",
    }
    return {"frozen_at": [len(s.generated_tokens) for s in local],
            "migrated": [list(c.generated_tokens) for c in conts],
            "cached": [c.num_cached_prompt for c in conts]}


def fc_fallback(pkg, pod_f: FleetPod, prompts, migrated: dict, out: dict) -> None:
    """Step 2's fallback: the same batch on a fresh pod, one request frozen
    at the same point and migrated to an endpoint where nothing listens; it
    resumes locally, bit-equal to its migrated run."""
    rids = [f"fb-{i}" for i in range(len(prompts))]
    futs, gate = frozen_batch(pkg, pod_f, prompts, rids)
    dead = f"tcp://127.0.0.1:{free_local_port()}"
    t = time.perf_counter()
    if pod_f.pod.migrate_out(rids[0], dead):
        fail("fleet_controller: a migration to a dead endpoint resumed")
    fallback_ms = (time.perf_counter() - t) * 1e3
    gate.release()
    seqs = [f.result(timeout=120) for f in futs]
    if seqs[0].finish_reason == "migrated" or pod_f.pod.migration_fallbacks != 1:
        fail(f"fleet_controller: the dead-endpoint migration finished {seqs[0].finish_reason!r} "
             f"with {pod_f.pod.migration_fallbacks} fallbacks")
    if list(seqs[0].generated_tokens) != migrated["migrated"][0]:
        fail("fleet_controller: the local fallback's tokens differ from the migrated run's")
    out["fallback"] = {"endpoint": "dead", "ms": fallback_ms, "bit_equal_to_migrated": True,
                       "tokens": len(seqs[0].generated_tokens),
                       "lifecycle": {k: pod_f.engine.lifecycle_stats.get(k)
                                     for k in ("migration_frozen", "migration_fallback")}}


def fc_audit_pull(pkg, pods: dict, scorer: Scorer, router, prefixes, rng, out: dict) -> None:
    """Step 4 of ``fleet_controller``: route audits (four requests, each a
    512-token prefix of ``prefixes``, which pod-a holds, plus 256 tokens of
    its own), a pull span and an exemplar."""
    import re

    auditor = scorer.service.route_auditor
    health = scorer.service.fleet_health
    names = list(pods)
    rids = [f"audit-{i}" for i in range(4)]
    chosen = []
    prompts = [list(pre[:512]) + own for pre, own in zip(prefixes, char_prompts(rng, 4, 256))]
    for rid, p in zip(rids, prompts):
        d = router.route(p, [n for n in names if health.is_routable(n)], request_id=rid)
        chosen.append(d.pod)
        seq = pods[d.pod].pod.submit(p, pkg["server"].SamplingParams(max_new_tokens=8),
                                     request_id=rid).result(timeout=120)
        if seq.error:
            fail(f"fleet_controller: audited request {rid} failed: {seq.error}")
    rows = {}

    def joined() -> bool:
        for rid in rids:
            got = auditor.recent(request_id=rid)
            if len(got) == 1:
                rows[rid] = got[0]
        return len(rows) == len(rids)

    wait_for(joined, f"the route auditor joined {len(rows)} of {len(rids)} routed requests")
    # The pull span: pod-b serves a prompt, pod-a pulls its prefix through
    # ASYNC_PULL on an X-Pull-Source request.
    pod_a, pod_b = pods["pod-a"], pods["pod-b"]
    prefix = char_prompts(rng, 1, FC_PROMPT)[0]
    status, _, body = pod_b.complete(prefix, 1)
    if status != 200:
        fail(f"fleet_controller: pod-b answered {status} {body}")
    status, hdrs, body = pod_a.complete(prefix + char_prompts(rng, 1, 64)[0], 8,
                                        {"X-Pull-Source": pod_b.pod.config.transfer_endpoint})
    if status != 200 or body["usage"]["cached_prompt_tokens"] < FC_PROMPT:
        fail(f"fleet_controller: the pulled request answered {status} with "
             f"{body.get('usage')}")
    trace_id = hdrs["traceparent"].split("-")[1]
    _, _, traces = pod_a.http.call("GET", f"/debug/traces?trace_id={trace_id}")
    spans = {s["span_id"]: s for t in traces["traces"] for s in t["spans"]}
    pulls = [s for s in spans.values() if s["name"] == "pod.pull_prefix"]
    if len(pulls) != 1 or spans.get(pulls[0]["parent_span_id"], {}).get("name") != "pod.request" \
            or pulls[0]["attrs"].get("outcome") != "ok" or not pulls[0]["attrs"].get("async"):
        fail(f"fleet_controller: the pulled request's trace holds {pulls}")
    # The exemplar: a TTFT bucket names a trace /debug/traces resolves.
    status, hdrs, text = pod_a.http.call("GET", "/metrics")
    match = re.search(EXEMPLAR_RE, text)
    if status != 200 or not hdrs.get("Content-Type", "").startswith(
            "application/openmetrics-text") or not match:
        fail(f"fleet_controller: /metrics answered {status} {hdrs.get('Content-Type')} "
             f"without a TTFT exemplar")
    _, _, ex = pod_a.http.call("GET", f"/debug/traces?trace_id={match.group(1)}")
    if not any(s["name"] == "pod.request" for t in ex["traces"] for s in t["spans"]):
        fail("fleet_controller: the exemplar's trace id resolves to no pod.request span")
    out["audit_pull_exemplar"] = {
        "routed": len(rids), "pods": chosen, "audits_joined": len(rows),
        "audit_rows": [{k: r.get(k) for k in ("chosen_pod", "realized_pod", "predicted_blocks",
                                              "realized_blocks", "ratio", "cause")}
                       for r in rows.values()],
        "auditor": {k: auditor.snapshot().get(k) for k in ("joined", "unmatched_realized")},
        "pull_span": {k: pulls[0]["attrs"].get(k) for k in ("async", "outcome",
                                                            "imported_blocks", "overlap")},
        "pulled_cached_prompt_tokens": body["usage"]["cached_prompt_tokens"],
        "metrics_content_type": hdrs.get("Content-Type"), "exemplar_trace_id": match.group(1),
    }


def steered_mrc(hit) -> dict:
    """A fleet MRC payload whose predicted hit rate at capacity ``c`` is
    ``hit(c)`` (the steered signal of ``fc_controller``)."""
    from llm_d_kv_cache_manager_tpu_torch.obs.lifecycle import REUSE_DISTANCE_BUCKETS

    return {"enabled": True, "sampled": 1000, "accesses": 1000, "cold": 10,
            "curve": [{"capacity_blocks": c, "predicted_hit_rate": round(hit(c), 4),
                       "miss_ratio": round(1 - hit(c), 4)} for c in REUSE_DISTANCE_BUCKETS]}


def fc_controller(pkg, dev, params, cfg, pods: dict, scorer: Scorer, knobs: dict, extra: list,
                  known: list, rng, out: dict) -> None:
    """Step 3 of ``fleet_controller``: a ``FleetController`` over an
    ``InProcessFleet`` of pod-a and pod-b, with the burn and MRC signals
    steered (the decision is the test's; migration, drain, provisioning and
    revival run for real): a scale-down of pod-b with live decodes, then a
    scale-up that provisions pod-c and revives pod-a's warm chains on it.
    ``known``: token lists pod-a served before; the warm request on pod-c
    reuses the one whose revived prefix is longest."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache import controller

    class SteeredFleet(controller.InProcessFleet):
        steer_burn = steer_mrc = None

        def observe(self):
            signals = super().observe()
            for s in signals:
                s.burn_rates, s.mrc = self.steer_burn, self.steer_mrc
            return signals

    def make_pod(pod_id):
        fp = FleetPod(pkg, dev, params, cfg, scorer, pod_id, 384, None, **knobs)
        extra.append(fp)
        return fp.pod, None

    health = scorer.service.fleet_health
    pod_a, pod_b = pods["pod-a"], pods["pod-b"]
    fleet = SteeredFleet(make_pod=make_pod, fleet_health=health, drain_timeout_s=60.0)
    for name, p in pods.items():
        fleet.register(name, p.pod, p.pod.config.transfer_endpoint)
    ctl = controller.FleetController(
        controller.FleetControllerConfig(enabled=True, min_pods=1, max_pods=4, hysteresis_s=0.0,
                                         revive_chains=2), fleet)
    # Scale-down: pod-b holds two live decodes, pod-a three (pod-b is the
    # cheaper victim), each parked after its first decoded token so all
    # stay live through the decision.
    fut_a, gate_a = frozen_batch(pkg, pod_a, char_prompts(rng, 3, 512),
                                 [f"live-{i}" for i in range(3)], 256, 1)
    down = [f"down-{i}" for i in range(2)]
    fut_b, gate_b = frozen_batch(pkg, pod_b, char_prompts(rng, 2, 512), down, 256, 1)
    drained0 = health.snapshot()["pods_drained"]
    fleet.steer_burn = {"ttft_le_0.2s_p0.99": {"60s": 0.1, "300s": 0.2}}
    fleet.steer_mrc = steered_mrc(lambda c: 0.9)
    t = time.perf_counter()
    d1 = ctl.reconcile()
    down_s = time.perf_counter() - t
    gate_a.release()
    gate_b.release()
    if (d1.action, d1.pod_id, d1.migrated, d1.migration_fallbacks) != ("scale_down", "pod-b", 2, 0):
        fail(f"fleet_controller: the scale-down reconcile decided {d1.as_attrs()}")
    if fleet.pod_ids() != ["pod-a"] or health.is_routable("pod-b"):
        fail(f"fleet_controller: after the scale-down the fleet is {fleet.pod_ids()}")
    if [f.result(timeout=60).finish_reason for f in fut_b] != ["migrated"] * 2:
        fail("fleet_controller: pod-b's live requests did not finish migrated")
    conts = [pod_a.pod.migrated_future(rid).result(timeout=120) for rid in down]
    for seq in conts + [f.result(timeout=120) for f in fut_a]:
        if seq.error or len(seq.generated_tokens) != 256:
            fail(f"fleet_controller: a request finished with {len(seq.generated_tokens)} of 256 "
                 f"tokens through the scale-down ({seq.error})")
    goodbye_s = wait_for(lambda: health.snapshot()["pods_drained"] == drained0 + 1,
                         "the scorer never applied pod-b's goodbye")
    # Scale-up: pod-c is provisioned and pod-a's warm chains revived on it.
    fleet.steer_burn = {"ttft_le_0.2s_p0.99": {"60s": 5.0, "300s": 3.0}}
    # Still climbing past pod-a's 1023 blocks: one more pod buys hit rate.
    fleet.steer_mrc = steered_mrc(lambda c: min(c / 8192.0, 0.95))
    t = time.perf_counter()
    d2 = ctl.reconcile()
    up_s = time.perf_counter() - t
    if d2.action != "scale_up" or d2.revived_blocks < 1 or health.pods_added < 1:
        fail(f"fleet_controller: the scale-up reconcile decided {d2.as_attrs()}")
    pod_c = next(fp for fp in extra if fp.name == d2.pod_id)
    known = known + [list(s.prompt_tokens) for s in conts] + [
        list(f.result().prompt_tokens) for f in fut_a]
    held = {h for hashes in pod_c.engine.block_digest().values() for h in hashes}
    db = pod_c.engine.block_manager.token_db

    def revived(tokens) -> int:
        return next((i for i, h in enumerate(db.prefix_hashes(tokens)) if h not in held),
                    len(db.prefix_hashes(tokens)))

    warm_src = max(known, key=revived)
    n_cached = min(revived(warm_src) * 16, FC_PROMPT)
    if n_cached < 16:
        fail("fleet_controller: no known prompt's prefix was revived on pod-c")
    warm = list(warm_src[:n_cached]) + char_prompts(rng, 1, FC_PROMPT + 64 - n_cached)[0]
    cold = char_prompts(rng, 1, FC_PROMPT + 64)[0]
    # A new pod's first request also pays its engine's first-use costs, not
    # its prefill's (100-230 ms in this phase on an H100): a short request
    # takes them, so the warm and the cold request compare prefills alone.
    first = char_prompts(rng, 1, 16)[0]
    answers = {}
    for kind, tokens, new in (("first", first, 1), ("warm", warm, 8), ("cold", cold, 8)):
        status, _, body = pod_c.complete(tokens, new)
        if status != 200:
            fail(f"fleet_controller: pod-c's {kind} request answered {status} {body}")
        expect_length(body, new, f"pod-c's {kind} request")
        answers[kind] = body
    warm_ms, cold_ms = (answers[k]["ttft_s"] * 1e3 for k in ("warm", "cold"))
    if answers["warm"]["usage"]["cached_prompt_tokens"] < 16 or not warm_ms < cold_ms:
        fail(f"fleet_controller: pod-c's first warm request hit "
             f"{answers['warm']['usage']['cached_prompt_tokens']} tokens in {warm_ms:.1f} ms "
             f"against {cold_ms:.1f} ms cold")
    out["controller"] = {
        "scale_down": dict(d1.as_attrs(), seconds=down_s, goodbye_applied_s=goodbye_s,
                           pods_drained=health.snapshot()["pods_drained"],
                           pods_removed=health.pods_removed),
        "scale_up": dict(d2.as_attrs(), seconds=up_s, pods_added=health.pods_added),
        "pod_c": d2.pod_id, "revived_blocks": d2.revived_blocks,
        "pod_c_first_request_ttft_ms": answers["first"]["ttft_s"] * 1e3,
        "pod_c_first_warm_ttft_ms": warm_ms, "pod_c_cold_ttft_ms": cold_ms,
        "pod_c_warm_cached_prompt_tokens": answers["warm"]["usage"]["cached_prompt_tokens"],
        "prompt_tokens": FC_PROMPT + 64,
    }


def fleet_controller(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """The fleet's control loops at full width and depth on the 8B path's
    parameters (one copy on the card): the port's ``ScoringService`` in
    process (route audit on, a huge ``pod_ttl_s``), pod-a (1024 pages of
    16) and pod-b (384) publishing to it, each with 8 lanes and pipelined
    graph bursts of 4, ``FLEET_CONTROLLER``, a transfer endpoint,
    ``OBS_LIFECYCLE``, ``OBS_FLIGHT`` with a dump directory,
    ``OBS_SLO=ttft:0.2:0.99``, ``OBS_AUDIT``, ``OBS_EXEMPLARS`` and
    ``ASYNC_PULL``, and a ``BlendedRouter`` over them that records its
    decisions with the scorer's route auditor.

    SLO and flight: three cold requests on pod-a burn the TTFT budget past
    ``OBS_FLIGHT_BURN``; a flight dump lands, ``/debug/flight`` serves the
    timeline (steps and the burn), ``/debug/lifecycle`` and ``/debug/mrc``
    a ledger and a curve, ``/metrics`` the burn gauge. Live migration: four
    1024-token requests (64 greedy new tokens) on pod-b, parked once each
    has decoded 16 tokens (``StepGate``), migrate to pod-a one by one: each
    resumes, the source's futures finish ``"migrated"``, the continuations
    finish with all 64 tokens, pod-b's pages and both queue depths come
    back; a fresh pod fed the same batch migrates one request to a dead
    endpoint and resumes it locally, bit-equal to its migrated run; and the
    migrated tokens hold against a never-migrated engine's by the near-tie
    rule (``migration_parity``). Audit, pull and exemplar: four routed
    requests each join one ``RequestAudit``; an ``X-Pull-Source`` request's
    trace holds an async ``pod.pull_prefix`` span; ``/metrics`` answers
    OpenMetrics with a TTFT exemplar that resolves in ``/debug/traces``.
    Controller: ``fc_controller``. Exact launch counts over every engine."""
    import shutil
    import tempfile

    kvblock, server = pkg["kvblock"], pkg["server"]
    from llm_d_kv_cache_manager_tpu_torch import kvcache
    from llm_d_kv_cache_manager_tpu_torch.server import api

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 5)
    out = {"phase": "fleet_controller", "card": card, "http": True,
           "host_times": "TTFT, migration, drain and reconcile times are host wall times"}
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    flight_dir = tempfile.mkdtemp(prefix="fleet-flight-")
    knobs = dict(fleet_controller=True, obs_lifecycle=True, obs_flight=True,
                 obs_flight_dir=flight_dir, obs_slo=FC_SLO, obs_audit=True, obs_exemplars=True,
                 async_pull=True)
    scorer = Scorer(api, True, 0, pod_ttl_s=1e9, obs_audit=True)
    pods, extra, engines = {}, [], []
    try:
        for name, pages in (("pod-a", 1024), ("pod-b", 384)):
            pods[name] = FleetPod(pkg, dev, params, cfg, scorer, name, pages, None,
                                  transfer_endpoint=f"tcp://127.0.0.1:{free_local_port()}",
                                  **knobs)
        join_fleet({name: p.pod._publisher for name, p in pods.items()}, scorer)
        indexer = scorer.service.indexer
        router = kvcache.BlendedRouter(
            score_fn=lambda toks, names: indexer.score_tokens(toks, SCORING_MODEL, names),
            affinity=kvcache.PrefixAffinityTracker(
                2, 1024, token_processor=kvblock.ChunkedTokenDatabase(
                    kvblock.TokenProcessorConfig(block_size=16))),
            loads_fn=lambda names: [pods[n].pod.queue_depth for n in names],
            auditor=scorer.service.route_auditor,
        )
        seconds = {}
        t = time.perf_counter()
        fc_slo_flight(pods["pod-a"], flight_dir, rng, out)
        seconds["slo_flight"] = time.perf_counter() - t
        t = time.perf_counter()
        prompts = char_prompts(rng, 4, FC_PROMPT)
        migrated = fc_migrate(pkg, pods, prompts, rng, out)
        seconds["migration"] = time.perf_counter() - t
        t = time.perf_counter()
        pod_f = FleetPod(pkg, dev, params, cfg, scorer, "pod-f", 384, None,
                         transfer_timeout_s=0.5, **knobs)
        extra.append(pod_f)
        fc_fallback(pkg, pod_f, prompts, migrated, out)
        ref_eng = transfer_engine(server, dev, params, cfg, dict(FAST_KNOBS, total_pages=384))
        engines.append(ref_eng)
        reference, _, _ = serve_greedy(pkg, ref_eng, prompts, FC_NEW)
        seconds["fallback_and_reference"] = time.perf_counter() - t
        t = time.perf_counter()
        fc_audit_pull(pkg, pods, scorer, router, prompts, rng, out)
        seconds["audit_pull_exemplar"] = time.perf_counter() - t
        t = time.perf_counter()
        served = [list(p) + m for p, m in zip(prompts, migrated["migrated"])]
        fc_controller(pkg, dev, params, cfg, pods, scorer, knobs, extra, served, rng, out)
        seconds["controller"] = time.perf_counter() - t
        engines += [p.engine for p in list(pods.values()) + extra]
    finally:
        for p in list(pods.values()) + extra:
            p.close()
        scorer.close()
        shutil.rmtree(flight_dir, ignore_errors=True)
    torch.cuda.synchronize()
    prefill = sum(e.prefill_stats["dispatches"] for e in engines)
    decode = sum(e.decode_stats["steps"] + e.decode_graphs.warmup_steps for e in engines)
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    expected = expected_launches(cfg, None, None, prefill, decode)
    if launches != expected:
        fail(f"fleet_controller: kernel launches {launches} != expected {expected} over "
             f"{len(engines)} engines")
    # Near-tie rule against the never-migrated run (its scratch computations
    # launch kernels of their own, after the count above).
    t = time.perf_counter()
    diffs = migration_parity(pkg, ref_eng, cfg, prompts, migrated["migrated"], reference,
                             migrated["frozen_at"], migrated["cached"], 16, dev)
    seconds["parity"] = time.perf_counter() - t
    out["never_migrated"] = {
        "equal_requests": f"{len(prompts) - len(diffs)}/{len(prompts)}", "differences": diffs,
        "rule": "equal, or the first difference follows the freeze with a top-2 gap within "
                "twice the measured migration logit move"}
    out["launches"] = launches
    out["engines"] = len(engines)
    out["step_seconds"] = seconds
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


# -- the fleet's knob-gated glue: roles, the remote tier, integrity, tenants ---------
#: prompt tokens of every request of ``disagg_tiers``, and greedy new tokens:
#: a disaggregated request's, a tier round's, the tenant step's batch and
#: premium requests'
DT_PROMPT, DT_NEW, DT_ROUND_NEW, DT_BATCH_NEW, DT_PREMIUM_NEW = 1024, 32, 8, 64, 32
#: two classes; batch's rate budget is 8 requests in the 10 s window
DT_QOS = "premium:prio=0,weight=4;batch:prio=1,rps=0.8"
#: the tenant step's pool: eight batch decodes (66 pages each when premium
#: arrives) leave 31 pages, fewer than a 1024-token premium prompt needs
DT_QOS_PAGES = 560
#: the kvstore pod's store: the ~400 blocks three rounds demote, plus the
#: 256 that the pull-back's own imports evict and demote while round 1 comes
#: back (a 512-page store would rotate out round-1 blocks not yet pulled)
DT_STORE_PAGES = 1024


def dt_wait(predicate, what: str, timeout: float = 60.0) -> float:
    """Poll ``predicate`` every millisecond; seconds it took. Fails the
    phase with ``what`` after ``timeout``."""
    t = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t > timeout:
            fail(f"disagg_tiers: {what}")
        time.sleep(0.001)
    return time.perf_counter() - t


class DtCounts:
    """The prefill dispatches and decode model steps (graph warm-ups
    included) of every engine the phase ran, read as each one retires."""

    def __init__(self):
        self.prefill = self.decode = self.engines = 0

    def add(self, eng) -> None:
        torch.cuda.synchronize()
        self.prefill += eng.prefill_stats["dispatches"]
        self.decode += eng.decode_stats["steps"] + eng.decode_graphs.warmup_steps
        self.engines += 1


def dt_round(pod: FleetPod, server, prompts, new_tokens: int, **kw) -> list:
    """Submit ``prompts`` together; their finished sequences, each whole."""
    futs = [pod.pod.submit(p, server.SamplingParams(max_new_tokens=new_tokens), **kw)
            for p in prompts]
    seqs = [f.result(timeout=600) for f in futs]
    for s in seqs:
        if s.error or len(s.generated_tokens) != new_tokens:
            fail(f"disagg_tiers: a request finished with {len(s.generated_tokens)} of "
                 f"{new_tokens} tokens, error={s.error}")
    return seqs


def dt_reference(pkg, dev, params, cfg, counts: DtCounts, batches) -> list:
    """A mixed engine's greedy tokens for each (prompts, new tokens) of
    ``batches``, served in order on one engine (a repeat hits its cache)."""
    eng = transfer_engine(pkg["server"], dev, params, cfg, dict(FAST_KNOBS, total_pages=1024))
    out = [serve_greedy(pkg, eng, prompts, n)[0] for prompts, n in batches]
    counts.add(eng)
    del eng
    return out


def dt_disagg(pkg, dev, params, cfg, scorer: Scorer, counts: DtCounts, rng, parity: list) -> dict:
    """Step 1: a prefill pod and a decode pod behind the port's
    ``DisaggCoordinator`` (``TwoHopPlanner`` over the scorer's index), and a
    mixed pod serving the same requests."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache.disagg import DisaggConfig, DisaggCoordinator

    server = pkg["server"]
    endpoint = f"tcp://127.0.0.1:{free_local_port()}"
    pods = {
        "pod-p": FleetPod(pkg, dev, params, cfg, scorer, "pod-p", 1024, None,
                          pod_role="prefill", transfer_endpoint=endpoint),
        "pod-d": FleetPod(pkg, dev, params, cfg, scorer, "pod-d", 1024, None,
                          pod_role="decode", async_pull=True),
        "pod-m": FleetPod(pkg, dev, params, cfg, scorer, "pod-m", 1024, None),
    }
    try:
        join_fleet({n: p.pod._publisher for n, p in pods.items()}, scorer)
        # A short request on each pod first: a new pod's first request pays
        # its engine's first-use costs, which the TTFT split must not carry.
        for pod in pods.values():
            pod.pod.submit(rng.integers(0, cfg.vocab_size, 16).tolist(),
                           server.SamplingParams(max_new_tokens=8)).result(timeout=600)
        health = scorer.service.fleet_health
        dt_wait(lambda: health.snapshot().get("prefills_completed", 0) == 1,
                "the prefill pod's warm-up PrefillComplete never reached the scorer")
        prefix = rng.integers(0, cfg.vocab_size, DT_PROMPT // 2).tolist()
        prompts = [prefix + rng.integers(0, cfg.vocab_size, DT_PROMPT // 2).tolist()
                   for _ in range(4)]
        indexer = scorer.service.indexer
        co = DisaggCoordinator(
            {n: pods[n].pod for n in ("pod-p", "pod-d")}, DisaggConfig(),
            score_fn=lambda toks, names: indexer.score_tokens(toks, SCORING_MODEL, names),
        )
        hops = []
        run_hop = co._run_hop

        def recorded_hop(pod, fut, deadline):
            seq = run_hop(pod, fut, deadline)
            hops.append(seq)
            return seq

        co._run_hop = recorded_hop
        free0 = {n: pods[n].engine.block_manager.num_free for n in ("pod-p", "pod-d")}
        results, decode_seqs = [], []
        for p in prompts:
            n_hops = len(hops)
            r = co.generate(p, server.SamplingParams(max_new_tokens=DT_NEW))
            if r.mode != "disagg" or r.prefill_pod != "pod-p" or r.decode_pod != "pod-d":
                fail(f"disagg_tiers: a request was not planned two-hop: {r}")
            if r.decode_cached_tokens != DT_PROMPT or len(r.tokens) != DT_NEW:
                fail(f"disagg_tiers: the decode hop hit {r.decode_cached_tokens} of {DT_PROMPT} "
                     f"imported prompt tokens and served {len(r.tokens)} tokens")
            results.append(r)
            decode_seqs.append(hops[n_hops + 1])
        dt_wait(lambda: health.snapshot().get("prefills_completed", 0) == 1 + len(prompts),
                f"the scorer saw {health.snapshot().get('prefills_completed', 0) - 1} of the "
                f"requests' {len(prompts)} PrefillComplete events")
        for n in free0:
            bm = pods[n].engine.block_manager
            dt_wait(lambda bm=bm, n=n: bm.num_free == free0[n],
                    f"{n}'s pages did not come back to baseline ({free0[n]})")
        if pods["pod-d"].pod._pull_jobs:
            fail("disagg_tiers: the decode pod holds import jobs after the traffic")
        mixed = [pods["pod-m"].pod.submit(p, server.SamplingParams(max_new_tokens=DT_NEW))
                 .result(timeout=600) for p in prompts]
        parity.append(dict(step="disaggregation", prompts=prompts,
                           got=[r.tokens for r in results],
                           reference=[s.generated_tokens for s in mixed],
                           frozen_at=[1] * len(prompts), cached=[DT_PROMPT] * len(prompts)))
        ms = lambda xs: [x * 1e3 for x in xs]  # noqa: E731
        return {
            "step": "disaggregation", "requests": len(prompts), "two_hop": len(results),
            "decode_cached_tokens": [r.decode_cached_tokens for r in results],
            "prefill_complete_events": health.snapshot()["prefills_completed"] - 1,
            "ttft_split_ms": {
                "prefill_hop": ms([r.ttft_s for r in results]),
                "handoff": ms([r.handoff_s for r in results]),
                "decode_first_token": ms([s.first_token_time - s.prefill_start_time
                                          for s in decode_seqs]),
            },
            "decode_itl_ms": ms([s.mean_itl for s in decode_seqs]),
            "mixed_ttft_ms": ms([s.ttft for s in mixed]),
            "mixed_itl_ms": ms([s.mean_itl for s in mixed]),
            "coordinator": co.stats(),
        }
    finally:
        for p in pods.values():
            p.close()
            counts.add(p.engine)


def dt_remote(pkg, dev, params, cfg, scorer: Scorer, counts: DtCounts, rng) -> dict:
    """Step 2: pod-r (the remote tier, 384 pages) demotes into pod-s
    (``POD_ROLE=kvstore``, a store of ``DT_STORE_PAGES``); round 1 comes
    back through ``X-Pull-Source``."""
    server, kvblock = pkg["server"], pkg["kvblock"]
    store_ep = f"tcp://127.0.0.1:{free_local_port()}"
    pod_s = FleetPod(pkg, dev, params, cfg, scorer, "pod-s", 64, None,
                     engine_knobs=dict(remote_tier=True, remote_store_pages=DT_STORE_PAGES),
                     pod_role="kvstore", remote_tier=True, remote_store_pages=DT_STORE_PAGES,
                     transfer_endpoint=store_ep)
    pod_r = FleetPod(pkg, dev, params, cfg, scorer, "pod-r", 384, None,
                     engine_knobs=dict(remote_tier=True), remote_tier=True,
                     remote_peers=store_ep, async_pull=True)
    try:
        join_fleet({"pod-s": pod_s.pod._publisher, "pod-r": pod_r.pod._publisher}, scorer)
        eng, store = pod_r.engine, pod_s.engine.remote_store
        rounds = [[rng.integers(0, cfg.vocab_size, DT_PROMPT).tolist() for _ in range(4)]
                  for _ in range(3)]
        n_pages = DT_PROMPT // 16
        tokens = [[s.generated_tokens for s in dt_round(pod_r, server, rounds[0], DT_ROUND_NEW)]]
        before = pod_r.pod._controller_read(lambda: chain_pages(eng, rounds[0], n_pages))
        for prompts in rounds[1:]:
            tokens.append([s.generated_tokens for s in dt_round(pod_r, server, prompts,
                                                                DT_ROUND_NEW)])
        demoter = pod_r.pod
        dt_wait(lambda: not demoter._demote_queue and demoter.demote_pushed_blocks
                + demoter.demote_failed_blocks + demoter.demote_dropped
                == eng.remote_stats["demoted_blocks"], "the pusher did not drain its queue")
        demoted = eng.remote_stats["demoted_blocks"]
        if demoter.demote_failed_blocks or demoter.demote_dropped or len(store) != demoted:
            fail(f"disagg_tiers: {demoted} blocks demoted, {demoter.demote_pushed_blocks} pushed, "
                 f"{demoter.demote_failed_blocks} failed, {demoter.demote_dropped} dropped, "
                 f"{len(store)} in the store")
        db = eng.block_manager.token_db
        round1 = {h for p in rounds[0] for h in db.prefix_hashes(p)}
        if not round1 <= set(store.hashes()):
            fail(f"disagg_tiers: {len(round1 - set(store.hashes()))} of round 1's blocks are not "
                 "in the kvstore pod's store")
        health = scorer.service.fleet_health
        dt_wait(lambda: index_view(scorer, kvblock, "pod-s", rounds[0]) == round1,
                "the scorer does not list pod-s as the holder of round 1's blocks")
        dt_wait(lambda: health.headroom_of("pod-s") == DT_STORE_PAGES - demoted,
                f"pod-s's heartbeat headroom {health.headroom_of('pod-s')} is not "
                f"{DT_STORE_PAGES - demoted}")
        # Round 1 again, each request pulling its prefix from pod-s: the
        # pulled pages are round 1's bytes, and the tokens those of a warm
        # repeat on one engine.
        pulled, unequal, ttft = [], 0, []
        for i, p in enumerate(rounds[0]):
            status, _, body = pod_r.complete(p, DT_ROUND_NEW, {"X-Pull-Source": store_ep})
            if status != 200:
                fail(f"disagg_tiers: a pulled request answered {status}: {body}")
            pulled.append(body["choices"][0]["token_ids"])
            now = pod_r.pod._controller_read(lambda p=p: chain_pages(eng, [p], n_pages))
            was = [t[:, i * n_pages:(i + 1) * n_pages] for t in before]
            unequal += sum(int((a != b).flatten(2).any(-1).any(0).sum()) for a, b in zip(now, was))
        if unequal:
            fail(f"disagg_tiers: {unequal} pulled pages differ from the pages gathered before "
                 "the eviction")
        cold, warm = dt_reference(pkg, dev, params, cfg, counts,
                                  [(rounds[0], DT_ROUND_NEW), (rounds[0], DT_ROUND_NEW)])
        if tokens[0] != cold or pulled != warm:
            fail("disagg_tiers: the remote tier's tokens differ from one engine's cold and warm "
                 f"runs: {tokens[0]} / {cold}, pulled {pulled} / warm {warm}")
        batches = demoter.demote_push_batches
        return {
            "step": "remote_tier", "demoted_blocks_rounds": demoted,
            "demoted_blocks_with_pull_back": eng.remote_stats["demoted_blocks"],
            "demoted_mib": demoted * eng.kv_block_bytes / 2**20,
            "pushed_blocks": demoter.demote_pushed_blocks, "push_batches": batches,
            "push_ms_per_batch": demoter.demote_push_s / batches * 1e3 if batches else None,
            "demote_s": eng.step_stats["demote_s"], "store_blocks": len(store),
            "store_headroom": health.headroom_of("pod-s"),
            "pulled_requests": len(pulled), "pulled_pages_unequal": unequal,
            "pulls": demoter.async_pulls, "pull_fallbacks": demoter.async_pull_fallbacks,
        }
    finally:
        for p in (pod_r, pod_s):
            p.close()
            counts.add(p.engine)


def dt_integrity(pkg, dev, params, cfg, scorer: Scorer, counts: DtCounts, rng) -> dict:
    """Step 3: pod-i (``KV_INTEGRITY``, 384 device pages over 1024 host
    pages, a scrub every 0.25 s) and its twin without digests serve two
    clean spill/restore rounds; then one byte of one host slot flips."""
    server, kvblock = pkg["server"], pkg["kvblock"]
    tier = dict(host_pages=1024, host_tier_policy="always")
    pod_i = FleetPod(pkg, dev, params, cfg, scorer, "pod-i", 384, None,
                     engine_knobs=dict(tier, kv_integrity=True), kv_integrity=True,
                     integrity_scrub_interval_s=0.25, integrity_scrub_pages=128)
    pod_o = FleetPod(pkg, dev, params, cfg, scorer, "pod-o", 384, None, engine_knobs=tier)
    try:
        join_fleet({"pod-i": pod_i.pod._publisher, "pod-o": pod_o.pod._publisher}, scorer)
        a, b = ([rng.integers(0, cfg.vocab_size, DT_PROMPT).tolist() for _ in range(4)]
                for _ in range(2))
        out = {"step": "integrity"}
        tokens = {}
        for pod in (pod_i, pod_o):
            tokens[pod.name] = [[s.generated_tokens for s in
                                 dt_round(pod, server, prompts, DT_ROUND_NEW)]
                                for prompts in (a, b, a, b)]
        if tokens["pod-i"] != tokens["pod-o"]:
            fail("disagg_tiers: digests changed the tokens of the spill/restore rounds")
        eng, integrity = pod_i.engine, pod_i.engine.integrity
        clean = pod_i.pod._controller_read(lambda: (eng._wait_host_copies(), integrity.snapshot())[1])
        restored = eng.block_manager.host_stats["restored"]
        d2h = eng.host_copy_stats["d2h_pages"]
        # Every slot a copy filled has its digest, taken once the copy landed
        # (a digest of the slot's old bytes would read corrupt at its
        # restore); a restore of a block whose spill had not flushed yet reads
        # the device page and checks unverified, as in the JAX engine.
        if clean["checks_corrupt"] or clean["quarantined"] or clean["recorded"] != d2h \
                or not clean["checks_ok"] or restored == 0:
            fail(f"disagg_tiers: the clean rounds' checks {clean} over {restored} restores and "
                 f"{d2h} slot copies")
        for pod in (pod_i, pod_o):
            st = pod.engine.host_copy_stats
            out[f"flush_host_ms_{'digests_on' if pod is pod_i else 'digests_off'}"] = {
                "flushes": st["flushes"], "total": st["flush_host_s"] * 1e3,
                "per_flush": st["flush_host_s"] / st["flushes"] * 1e3, "d2h_pages": st["d2h_pages"]}

        def digest_and_scrub():
            eng._wait_host_copies()
            slots = list(eng.block_manager._host_info)[:64]
            t = time.perf_counter()
            for slot in slots:
                eng._slot_digest(slot)
            digest_s = (time.perf_counter() - t) / len(slots)
            t = time.perf_counter()
            n = eng.scrub_host_pages(512)
            return digest_s, n, time.perf_counter() - t

        digest_s, scrubbed, scrub_s = pod_i.pod._controller_read(digest_and_scrub)
        page_mib = eng.kv_block_bytes / 2**20
        out.update({"clean_checks": clean, "restored_pages": restored, "slot_copies": d2h,
                    "digest_ms_per_page": digest_s * 1e3, "page_mib": page_mib,
                    "scrub_pages": scrubbed, "scrub_pages_per_s": scrubbed / scrub_s})
        h0 = eng.block_manager.token_db.prefix_hashes(a[0])[0]

        def flip() -> bool:
            eng._flush_page_moves()
            eng._wait_host_copies()
            slot = eng.block_manager._host_cached.get(h0)
            if slot is None:
                return False
            eng._host_k[slot].reshape(-1).view(torch.uint8)[0] ^= 0xFF
            return True

        if not pod_i.pod._controller_read(flip):
            fail("disagg_tiers: the first block of the drill's prompt is not in the host tier")
        out["scrub_detect_s"] = dt_wait(lambda: integrity.stats["quarantined"] >= 1,
                                        "the scrub never quarantined the flipped slot")
        health = scorer.service.fleet_health
        dt_wait(lambda: health.bad_blocks_reported >= 1, "no BadBlock reached the scorer")
        dt_wait(lambda: h0 not in index_view(scorer, kvblock, "pod-i", [a[0]]),
                "the scorer still lists pod-i for the quarantined block")
        again = dt_round(pod_i, server, [a[0]], DT_ROUND_NEW)[0]
        after = integrity.snapshot()
        if after["quarantined"] != 1 or after["checks_corrupt"] != 1 \
                or health.bad_blocks_reported != 1:
            fail(f"disagg_tiers: the flip gave {after['quarantined']} quarantines, "
                 f"{after['checks_corrupt']} corrupt checks and {health.bad_blocks_reported} "
                 "BadBlock hashes, not one each")
        if again.generated_tokens != tokens["pod-i"][0][0]:
            fail(f"disagg_tiers: the recomputed request's tokens {again.generated_tokens} differ "
                 f"from the clean run's {tokens['pod-i'][0][0]}")
        out.update({"after_flip": after, "bad_block_hashes": health.bad_blocks_reported,
                    "recomputed_prefill_tokens": DT_PROMPT - again.num_cached_prompt})
        return out
    finally:
        for p in (pod_i, pod_o):
            p.close()
            counts.add(p.engine)


def dt_qos(pkg, dev, params, cfg, scorer: Scorer, counts: DtCounts, rng, parity: list) -> dict:
    """Step 4: ``TENANT_QOS`` on a pool that eight 1024-token batch decodes
    fill; two premium requests arrive while they decode, then a ninth
    batch request over batch's rate budget."""
    server = pkg["server"]
    pod_q = FleetPod(pkg, dev, params, cfg, scorer, "pod-q", DT_QOS_PAGES, None, tenant_qos=DT_QOS)
    eng = pod_q.engine
    per_step, folds = [], {}
    step, run_prefill = eng.step, eng._run_prefill

    def counted_step():
        n = eng.lifecycle_stats.get("priority_preempted", 0)
        done = step()
        per_step.append(eng.lifecycle_stats.get("priority_preempted", 0) - n)
        return done

    def noted_prefill(seqs, chunks=None):
        # A re-prefill of a preempted request: where its tokens folded, and
        # the prompt tokens its pages still held.
        for s in seqs:
            if s.num_generated and s.request_id not in folds:
                folds[s.request_id] = (s.num_generated, s.num_prefilled)
        return run_prefill(seqs, chunks)

    eng.step, eng._run_prefill = counted_step, noted_prefill
    try:
        join_fleet({"pod-q": pod_q.pod._publisher}, scorer)
        batch = [rng.integers(0, cfg.vocab_size, DT_PROMPT).tolist() for _ in range(8)]
        premium = [rng.integers(0, cfg.vocab_size, DT_PROMPT).tolist() for _ in range(2)]
        sp = server.SamplingParams
        bfuts = [pod_q.pod.submit(p, sp(max_new_tokens=DT_BATCH_NEW), tenant="batch",
                                  request_id=f"batch-{i}") for i, p in enumerate(batch)]
        status, hdrs, body = pod_q.complete(batch[0], DT_BATCH_NEW, {"X-Tenant": "batch"})
        if status != 429 or int(hdrs.get("Retry-After", "0")) < 1 or "'batch'" not in body["error"]:
            fail(f"disagg_tiers: the over-budget request answered {status} {hdrs} {body}")
        dt_wait(lambda: len(live_seqs(eng, {f"batch-{i}" for i in range(8)})) == 8 and all(
            s.num_generated >= 8 for s in live_seqs(eng, {f"batch-{i}" for i in range(8)})),
            "the eight batch requests never decoded together")
        pfuts = [pod_q.pod.submit(p, sp(max_new_tokens=DT_PREMIUM_NEW), tenant="premium",
                                  request_id=f"premium-{i}") for i, p in enumerate(premium)]
        bseqs = [f.result(timeout=600) for f in bfuts]
        pseqs = [f.result(timeout=600) for f in pfuts]
        for s in bseqs + pseqs:
            want = DT_PREMIUM_NEW if s.request_id.startswith("premium") else DT_BATCH_NEW
            if s.error or s.finish_reason is not None or len(s.generated_tokens) != want:
                fail(f"disagg_tiers: {s.request_id} finished {s.finish_reason!r} with "
                     f"{len(s.generated_tokens)} tokens, error={s.error}")
        preempted = eng.lifecycle_stats.get("priority_preempted", 0)
        if preempted < 1 or max(per_step) > 1:
            fail(f"disagg_tiers: {preempted} priority preemptions, at most {max(per_step)} a step")
        ref_batch, ref_premium = dt_reference(pkg, dev, params, cfg, counts,
                                              [(batch, DT_BATCH_NEW), (premium, DT_PREMIUM_NEW)])
        seqs, refs = bseqs + pseqs, ref_batch + ref_premium
        for s, ref in zip(seqs, refs):
            if s.request_id not in folds and s.generated_tokens != ref:
                fail(f"disagg_tiers: {s.request_id}, never preempted, differs from the reference")
        victims = [i for i, s in enumerate(seqs) if s.request_id in folds]
        parity.append(dict(step="tenant_qos", prompts=[(batch + premium)[i] for i in victims],
                           got=[seqs[i].generated_tokens for i in victims],
                           reference=[refs[i] for i in victims],
                           frozen_at=[folds[seqs[i].request_id][0] for i in victims],
                           cached=[folds[seqs[i].request_id][1] for i in victims]))
        return {
            "step": "tenant_qos", "pool_pages": DT_QOS_PAGES,
            "priority_preempted": preempted, "max_priority_preemptions_a_step": max(per_step),
            "preempted_requests": sorted(folds), "qos": pod_q.pod.qos.snapshot()["tenants"],
            "over_budget": {"status": status, "retry_after": hdrs.get("Retry-After")},
            "ttft_ms_median": {"premium": float(np.median([s.ttft * 1e3 for s in pseqs])),
                               "batch": float(np.median([s.ttft * 1e3 for s in bseqs]))},
        }
    finally:
        del eng.step, eng._run_prefill
        pod_q.close()
        counts.add(eng)


def disagg_tiers(pkg, ops, dev, card: str, params, cfg) -> tuple[list, dict]:
    """The pod's knob-gated fleet glue at full width and depth on the 8B
    path's parameters: pods of 8 lanes with pipelined graph bursts of 4,
    HTTP, ZMQ and the transfer plane on loopback, publishing to the port's
    ``ScoringService`` in process. Four steps, one line each:
    disaggregation (``POD_ROLE`` prefill and decode behind the
    ``DisaggCoordinator``), the remote tier (``REMOTE_TIER`` into a
    ``POD_ROLE=kvstore`` pod), integrity (``KV_INTEGRITY`` over a host tier)
    and tenant QoS (``TENANT_QOS``). Exact launch counts over every engine,
    K1 and K2 among them; greedy tokens against a mixed engine's, where a
    kernel change (K2 in place of K1) moves the logits by the near-tie rule
    of ``migration_parity``."""
    from llm_d_kv_cache_manager_tpu_torch.server import api

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 6)
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    counts, parity, steps, seconds = DtCounts(), [], [], {}
    scorer = Scorer(api, True, 0, pod_ttl_s=1e9)
    try:
        for name, run in (("disaggregation", lambda: dt_disagg(pkg, dev, params, cfg, scorer,
                                                               counts, rng, parity)),
                          ("remote_tier", lambda: dt_remote(pkg, dev, params, cfg, scorer,
                                                            counts, rng)),
                          ("integrity", lambda: dt_integrity(pkg, dev, params, cfg, scorer,
                                                             counts, rng)),
                          ("tenant_qos", lambda: dt_qos(pkg, dev, params, cfg, scorer, counts,
                                                        rng, parity))):
            t = time.perf_counter()
            steps.append(dict(run(), phase="disagg_tiers", card=card,
                              host_times="TTFTs, gaps and copy times are host wall times"))
            seconds[name] = steps[-1]["seconds"] = time.perf_counter() - t
            free_cuda()
    finally:
        scorer.close()
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    expected = expected_launches(cfg, None, None, counts.prefill, counts.decode)
    if launches != expected:
        fail(f"disagg_tiers: kernel launches {launches} != expected {expected} over "
             f"{counts.engines} engines")
    if not launches["paged_decode"] or not launches["flash_prefill"]:
        fail(f"disagg_tiers: K1 or K2 was not launched: {launches}")
    # The near-tie rule (its scratch computations launch kernels of their
    # own, after the count above).
    probe = types.SimpleNamespace(params=params, config=types.SimpleNamespace(kv_quant_hbm=None))
    for job, step in zip(parity, [s for s in steps if s["step"] in ("disaggregation",
                                                                    "tenant_qos")]):
        diffs = migration_parity(pkg, probe, cfg, job["prompts"], job["got"], job["reference"],
                                 job["frozen_at"], job["cached"], 16, dev, phase="disagg_tiers")
        step["against_mixed_engine"] = {
            "equal_requests": f"{len(job['got']) - len(diffs)}/{len(job['got'])}",
            "differences": diffs,
            "rule": "equal, or the first difference follows the kernel change (the handoff, or "
                    "a preemption's fold) with a top-2 gap within twice the measured logit move"}
    steps[-1].update(launches=launches, engines=counts.engines, phase_seconds=seconds,
                     total_seconds=time.perf_counter() - t_phase)
    return steps, launches


def division_checks(llama, eng, cfg, prompt, ps, dev) -> dict:
    """Both int8 scale divisions on the card held bit for bit against the
    same function on the CPU. ``quantize_tensor`` on every matrix of the
    8B's layer 0: codes and scales. The int8 KV write: one 1024-token
    prefill of the model into small int8 pools, each call of
    ``_quantized_scatter_kv_all_layers`` replayed on the CPU from copies of
    its inputs: scales (and codes, reported). Beside each, how many scales
    the old Python-scalar divisor (which CUDA turns into a product with
    its float32 reciprocal) would have moved."""
    from llm_d_kv_cache_manager_tpu_torch.models import quant

    weights = {}
    for name, w in eng.params["layers"][0].items():
        if not isinstance(w, torch.Tensor) or w.ndim != 2:
            continue
        on_card, on_cpu = quant.quantize_tensor(w), quant.quantize_tensor(w.cpu())
        amax = w.float().abs().amax(dim=-2, keepdim=True)
        scalar = (torch.clamp(amax, min=1e-8) / 127.0).cpu()
        weights[name] = {
            "shape": list(w.shape),
            "codes_equal": torch.equal(on_card.q.cpu(), on_cpu.q),
            "scales_equal": torch.equal(on_card.scale.cpu(), on_cpu.scale),
            "scalar_divisor_scales_unequal": int((scalar != on_cpu.scale).sum()),
        }
    calls = []
    real = llama._quantized_scatter_kv_all_layers

    def recorded(pages_q, scales, fresh, page_ids, slot_ids, valid, positions):
        inputs = [None if t is None else t.cpu() for t in
                  (pages_q, scales, fresh, page_ids, slot_ids, valid, positions)]
        out = real(pages_q, scales, fresh, page_ids, slot_ids, valid, positions)
        calls.append((inputs, pages_q.cpu(), scales.cpu()))
        return out

    n_pages = len(prompt) // ps + 1
    pools = [torch.zeros((cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.hd), dtype=torch.int8,
                         device=dev) for _ in range(2)]
    scales = [torch.zeros((cfg.n_layers, n_pages, cfg.n_kv_heads), dtype=torch.float32, device=dev)
              for _ in range(2)]
    pos = torch.arange(len(prompt), dtype=torch.int32, device=dev)[None]
    llama._quantized_scatter_kv_all_layers = recorded
    try:
        llama.prefill(eng.params, cfg, torch.tensor([prompt], dtype=torch.int32, device=dev), pos,
                      torch.ones_like(pos, dtype=torch.bool), pools[0], pools[1], 1 + pos // ps, pos % ps,
                      torch.zeros((1, 1), dtype=torch.int32, device=dev),
                      torch.zeros((1,), dtype=torch.int32, device=dev),
                      k_scales=scales[0], v_scales=scales[1])
        torch.cuda.synchronize()
    finally:
        llama._quantized_scatter_kv_all_layers = real
    writes = []
    for (pages_q, sc, *rest), card_pages, card_scales in calls:
        real(pages_q, sc, *rest)
        fresh = rest[0].float()
        amax = fresh.abs().amax(dim=-1).clamp(min=1e-8)
        writes.append({
            "scales_equal": torch.equal(sc, card_scales),
            "codes_equal": torch.equal(pages_q, card_pages),
            "token_scales": amax.numel(),
            "scalar_divisor_scales_unequal": int((amax.to(dev) / 127.0).cpu().ne(amax / amax.new_full((), 127.0)).sum()),
        })
    out = {"quantize_tensor_layer0": weights, "int8_kv_write": writes}
    if len(writes) != 2 or not all(w["scales_equal"] for w in writes):
        fail(f"int8 KV write scales on the card differ from the CPU's: {writes}")
    if not all(w["codes_equal"] and w["scales_equal"] for w in weights.values()):
        fail(f"quantize_tensor on the card differs from the CPU's: {weights}")
    return out


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


#: Seconds of host time between a profiled window's edges and its steps
#: (see ``profile_window``).
TRACE_PAD_S = 0.05


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
    against the kernels the device really ran. Where they differ, the
    failure names how many K1 launches each burst of the trace shows.

    The profiled steps run ``TRACE_PAD_S`` inside each edge of the trace:
    the profiler keeps a device record only when its timestamps, mapped
    onto the host clock, lie between the trace's start and stop, and that
    mapping reads kernels up to ~5 ms off the host's order.
    ``chip_probes/trace_skew_probe.py`` lost the last kernels' records in
    7 of 461 windows closed at the sync and in none of 461 each padded by
    5, 20 or 50 ms."""
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
        time.sleep(TRACE_PAD_S)
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t) * 1e3 / steps
        time.sleep(TRACE_PAD_S)
    launches = {name: w.launches - before[name] for name, w in counted.items()}

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        return us / 1e3 / steps

    # Device-side kernel entries only (operator entries repeat their time;
    # a user annotation such as ``Optimizer.step#AdamW.step`` spans the
    # kernels it encloses).
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    kernels = sorted((e for e in device if dev_ms(e) > 0), key=dev_ms, reverse=True)
    busy_ms = sum(dev_ms(e) for e in kernels)

    def traced_calls(patterns) -> int:
        return sum(e.count for e in device if any(p in e.key for p in patterns))

    traced = {name: traced_calls(TRACED[name]) for name in launches}
    traced["combine_kernel"] = traced_calls(("::combine_kernel",))
    launches["combine_kernel"] = launches["paged_decode"] + launches["paged_decode_int8"]
    if traced != launches:
        k1 = sorted(e.time_range.start for e in prof.events()
                    if e.device_type == DeviceType.CUDA and "split_decode_kernel" in e.name)
        bursts, last = [], None
        for start in k1:
            if last is None or start - last > 500:  # us: a gap between bursts
                bursts.append(0)
            bursts[-1] += 1
            last = start
        fail(f"launch counts over a profiled window {launches} != the traced kernels {traced} "
             f"(K1 launches the trace shows a burst: {bursts})")
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


def cold_logits(models, params, cfg, tokens, ps, dev, kv_mode=None, mesh=None) -> torch.Tensor:
    """Next-token logits after ``tokens``: one cold prefill on a scratch
    pool (per-shard pools under ``mesh``)."""
    n = len(tokens)
    pages = n // ps + 2
    if mesh is not None:
        from llm_d_kv_cache_manager_tpu_torch.parallel import init_kv_pools

        pool = [p for p in init_kv_pools(cfg, pages, ps, mesh, kv_quant_hbm=kv_mode) if p is not None]
    else:
        pool = list(models.init_kv_pages(cfg, pages, ps, dev, kv_quant_hbm=kv_mode))
        if kv_mode:
            pool += list(models.init_kv_scales(cfg, pages, dev))
    table = torch.arange(1, pages, dtype=torch.int32, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    return models.prefill(params, cfg, torch.tensor([list(tokens)], dtype=torch.int32, device=dev),
                          pos, torch.ones_like(pos, dtype=torch.bool), pool[0], pool[1],
                          table[pos.long() // ps], pos % ps,
                          torch.zeros((1, 0), dtype=torch.int32, device=dev),
                          torch.zeros((1,), dtype=torch.int32, device=dev), *pool[2:],
                          mesh=mesh)[0][0]


def top2_gap(pkg, eng, cfg, prompt, generated, ps, dev) -> dict:
    """The knobs-off model's top-2 logit gap at the first token of
    ``generated``'s continuation: one cold prefill of prompt ++ generated on
    a scratch pool."""
    logits = cold_logits(pkg["models"], eng.params, cfg, list(prompt) + list(generated), ps, dev,
                         eng.config.kv_quant_hbm)
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


# -- speculative decoding -------------------------------------------------------
#: the phase's requests: 8 prompts of 512 tokens, six of them a random
#: 32-token pattern repeated 16 times (prompt lookup finds proposals) and
#: two random (lookup mostly misses), 64 new tokens each
SD_PROMPT, SD_PATTERN, SD_ECHO, SD_NEW = 512, 32, 6, 64
#: the three engines: spec off, then spec on at 1 and 3 verify rounds a
#: burst, with JAX's defaults otherwise (spec_k=4, spec_ngram=3, the gate)
SD_RUNS = (
    ("spec_off", {}),
    ("rounds1", dict(spec_decode="prompt_lookup", spec_rounds=1)),
    ("rounds3", dict(spec_decode="prompt_lookup", spec_rounds=3)),
)
SD_PAGES = 1024


def sd_drive(server, ops, eng, prompts, samplings) -> tuple[list, dict, dict]:
    """Serve ``prompts`` through ``eng.step`` with every launch count zeroed
    just before and read just after; host wall time by kind of step
    (prefill, plain decode, speculative verify burst) and the tokens each
    decode kind emitted."""
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    seqs = [eng.add_request(p, sp) for p, sp in zip(prompts, samplings)]
    t = {f"{kind}_{key}": 0 for kind in ("prefill", "decode", "verify") for key in ("s", "steps")}
    t.update(decode_tokens=0, verify_tokens=0, capture_s=0, capture_tokens=0)
    while eng.has_work:
        before = (eng.prefill_stats["dispatches"], eng.spec_stats["bursts"],
                  eng.decode_stats["dispatches"], len(eng.decode_graphs.keys))
        g0 = sum(s.num_generated for s in seqs)
        t0 = time.perf_counter()
        eng.step()
        dt = time.perf_counter() - t0
        gen = sum(s.num_generated for s in seqs) - g0
        if eng.prefill_stats["dispatches"] > before[0]:
            kind = "prefill"
        elif eng.spec_stats["bursts"] > before[1]:
            kind = "verify"
        elif eng.decode_stats["dispatches"] > before[2]:
            kind = "decode"
        else:
            continue
        t[f"{kind}_s"] += dt
        t[f"{kind}_steps"] += 1
        if kind != "prefill":
            t[f"{kind}_tokens"] += gen
        if len(eng.decode_graphs.keys) > before[3]:
            t["capture_s"] += dt
            t["capture_tokens"] += gen
    launches = {name: wrapper.launches for name, wrapper in ops.COUNTED.items()}
    torch.cuda.synchronize()
    return seqs, t, launches


def sd_parity(pkg, eng_off, cfg, prompts, off, on, ps, dev, cache: dict, what: str) -> list[dict]:
    """Spec-on tokens against spec-off: equal, or the first difference is a
    near tie — the spec-off model's top-2 logit gap there (one cold
    prefill) is at most twice the logit move between the two kernels that
    score that token (``migration_logit_move``: decode through K1 against a
    one-token verify through K2 over the same pages), the rule
    ``migration_parity`` applies."""
    diffs = []
    for i, (a, b) in enumerate(zip(off, on)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        if j == 0:
            fail(f"spec_decode ({what}): request {i}'s first token (from prefill) differs")
        if (i, j) not in cache:
            d = top2_gap(pkg, eng_off, cfg, prompts[i], a[:j], ps, dev)
            context = list(prompts[i]) + list(a[:j])
            d["logit_move"] = migration_logit_move(pkg, eng_off.params, cfg, context,
                                                   len(context) - 1, ps, dev,
                                                   n_prompt=len(prompts[i]))
            cache[(i, j)] = d
        d = dict(cache[(i, j)], request=i, index=j, spec_off=a[j], spec_on=b[j])
        if d["top2_gap"] > 2 * d["logit_move"]:
            fail(f"spec_decode ({what}): tokens differ from spec-off with a top-2 gap beyond "
                 f"what the change of kernel moves the logits by: {d}")
        diffs.append(d)
    return diffs


def sd_verify_profile(pkg, ops, params, cfg, dev, rng) -> dict:
    """``profile_window`` over one verify round as the engine dispatches it
    (the packed upload, ``spec_decode_steps`` at one round, the packed
    fetch) for 8 lanes whose windows hold a 32-token pattern over 576
    tokens, so every lane proposes 4 drafts; on a scratch pool."""
    models, llama = pkg["models"], pkg["llama"]
    ps, k, n, lanes = 16, 4, 3, 8
    hist = SD_PROMPT + SD_NEW
    table_w = -(-(hist + k + 1) // (16 * ps)) * 16  # pages, a multiple of 16
    kp, vp = models.init_kv_pages(cfg, lanes * table_w + 1, ps, dev)
    scan_need = 4096
    W = scan_need + k + 1
    packed = np.zeros((lanes, W + table_w + 5), np.int32)
    for i in range(lanes):
        packed[i, :hist] = np.tile(rng.integers(0, cfg.vocab_size, SD_PATTERN), hist // SD_PATTERN)
        packed[i, W : W + table_w] = 1 + i * table_w + np.arange(table_w)
        packed[i, W + table_w :] = [hist, hist, SD_NEW, 1, 0]
    fparams = np.tile(np.array([[0.0, 1.0]], np.float32), (lanes, 1))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    last = []

    def verify():
        out = llama.spec_decode_steps(
            params, cfg, torch.from_numpy(packed).to(dev), torch.from_numpy(fparams).to(dev),
            kp, vp, gen, page_size=ps, num_rounds=1, s_chunk=8, ngram=n, spec_k=k,
            max_scan=scan_need, table_w=table_w, sampled=False)[0]
        last[:] = [out.cpu().numpy()]

    verify()
    if not (last[0][0, :, k + 2] == k).all():
        fail(f"spec_decode: the verify profile's lanes did not all propose {k}: {last[0][0]}")
    verify()
    out = profile_window(verify, 4, 1, ops.COUNTED)
    del kp, vp
    free_cuda()
    return dict(out, lanes=lanes, context_tokens=hist - 1, valid_rows_per_lane=k + 1)


def spec_decode(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """Speculative decoding on the 8B parameters through ``Engine.step``:
    the same eight requests on three engines (spec off, 1 and 3 verify
    rounds a burst; in the 3-round run the first lane samples at
    temperature 0.9, top_k 1). Held: proposals happened, verify_steps =
    rounds x bursts, 64 tokens each, K2 launched once a layer a prefill
    dispatch and a verify round and K1 once a layer a plain decode step
    (exact), and every stream equal to spec-off but at a near tie
    (``sd_parity``). Then one verify round profiled against a plain decode
    step (``profile_decode`` on the spec-off engine)."""
    server = pkg["server"]
    ps = 16
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, SD_PATTERN), SD_PROMPT // SD_PATTERN).tolist()
               for _ in range(SD_ECHO)]
    prompts += [rng.integers(0, cfg.vocab_size, SD_PROMPT).tolist() for _ in range(8 - SD_ECHO)]
    runs, engines, launches_sum, cache = {}, {}, {}, {}
    for label, knobs in SD_RUNS:
        eng = server.Engine(
            server.EngineConfig(
                model=cfg, block_manager=server.BlockManagerConfig(total_pages=SD_PAGES, page_size=ps),
                max_model_len=4096, decode_batch_size=8, seed=SEED, **knobs),
            params=params, device=dev)
        samplings = [server.SamplingParams(max_new_tokens=SD_NEW) for _ in prompts]
        if label == "rounds3":
            samplings[0] = server.SamplingParams(max_new_tokens=SD_NEW, temperature=0.9, top_k=1)
        seqs, t, launches = sd_drive(server, ops, eng, prompts, samplings)
        for seq in seqs:
            if seq.error or len(seq.generated_tokens) != SD_NEW:
                fail(f"spec_decode ({label}): request {seq.seq_id} finished with "
                     f"{len(seq.generated_tokens)} tokens, error={seq.error}")
        stats = dict(eng.spec_stats)
        rounds = knobs.get("spec_rounds", 0)
        if knobs:
            if stats["proposed"] == 0:
                fail(f"spec_decode ({label}): no proposal in {stats}")
            if stats["verify_steps"] != rounds * stats["bursts"]:
                fail(f"spec_decode ({label}): verify_steps != rounds x bursts: {stats}")
        decode_steps = eng.decode_stats["steps"] + eng.decode_graphs.warmup_steps
        expected = expected_launches(cfg, None, None,
                                     eng.prefill_stats["dispatches"] + stats["verify_steps"],
                                     decode_steps)
        if launches != expected:
            fail(f"spec_decode ({label}): kernel launches {launches} != expected {expected}")
        for name, count in launches.items():
            launches_sum[name] = launches_sum.get(name, 0) + count
        tokens = [list(s.generated_tokens) for s in seqs]
        decode_s = t["decode_s"] + t["verify_s"]
        decode_tokens = t["decode_tokens"] + t["verify_tokens"]
        runs[label] = dict(
            spec_stats=stats,
            acceptance_rate=stats["accepted"] / stats["proposed"] if stats["proposed"] else None,
            prefill_dispatches=eng.prefill_stats["dispatches"],
            plain_decode_steps=decode_steps,
            launches=launches,
            decode_tokens_per_s=decode_tokens / decode_s,
            decode_tokens_per_s_without_captures=(decode_tokens - t["capture_tokens"])
            / (decode_s - t["capture_s"]),
            verify_ms_per_burst=1e3 * t["verify_s"] / t["verify_steps"] if t["verify_steps"] else None,
            tokens_per_verify_burst=t["verify_tokens"] / t["verify_steps"] if t["verify_steps"] else None,
            plain_decode_ms_per_step=1e3 * t["decode_s"] / t["decode_steps"] if t["decode_steps"] else None,
            **t,
        )
        if label != "spec_off":
            runs[label]["parity"] = sd_parity(pkg, engines["spec_off"], cfg, prompts,
                                              runs["spec_off"]["tokens"], tokens, ps, dev, cache,
                                              label)
            runs[label]["requests_equal_to_spec_off"] = sum(
                a == b for a, b in zip(runs["spec_off"]["tokens"], tokens))
        runs[label]["tokens"] = tokens
        engines[label] = eng
    for label in ("rounds1", "rounds3"):
        del engines[label]
    free_cuda()
    t0 = time.perf_counter()
    verify = sd_verify_profile(pkg, ops, params, cfg, dev, rng)
    decode = profile_decode(engines["spec_off"], prompts, server, ops)
    profile_s = time.perf_counter() - t0
    del engines
    free_cuda()
    for run in runs.values():
        del run["tokens"]
    return {
        "phase": "spec_decode",
        "card": card,
        "n_layers": cfg.n_layers,
        "requests": len(prompts),
        "echo_prompts": SD_ECHO,
        "prompt_tokens": SD_PROMPT,
        "new_tokens_each": SD_NEW,
        "spec_k": 4,
        "spec_ngram": 3,
        "runs": runs,
        "verify_round_profile": verify,
        "plain_decode_step_profile": decode,
        "profile_s": profile_s,
        "phase_wall_s": time.perf_counter() - t_phase,
    }, launches_sum


# -- sharded serving: tensor, expert and sequence parallelism ----------------
#: the sharded paths' tp: each path named by a ``PATHS`` entry's
#: ``sharded`` serves that entry's workload again at this tp on the same
#: weights, every shard on the card's one device
SHARDED_TP = 2
#: the sp path: one warm prefill of SP_CHUNK tokens over SP_CONTEXT tokens
SP_CHUNK, SP_CONTEXT = 2048, 1024
#: sharded logits against unsharded on the same input: the warm-vs-cold bar
#: (a share of the unsharded logits' range); every reduction and every
#: kernel call splits differently, so bf16 activations round at other places
SHARDED_LOGITS_BAR = 0.05


def same_device_mesh(tp: int = 1, sp: int = 1, dev=None):
    from llm_d_kv_cache_manager_tpu_torch.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(tp=tp, sp=sp), devices=[dev] * (tp * sp))


def tp_logit_check(pkg, params, sharded, cfg, mesh, tokens, dev, kv_mode=None) -> dict:
    """Next-token logits after ``tokens`` through the unsharded and the
    sharded model (cold prefills). For an MoE also with the sharded pass's
    routing pinned to the unsharded pass's: a near-tied router choice can
    flip between the two, and a flipped expert moves the logits by far more
    than rounding; the pinned reading is what the bar holds."""
    models, llama = pkg["models"], pkg["llama"]
    with moe_routing(llama) as routing:
        one = cold_logits(models, params, cfg, tokens, PS, dev, kv_mode).float()
    with moe_routing(llama) as routing_two:
        two = cold_logits(models, sharded, cfg, tokens, PS, dev, kv_mode, mesh=mesh).float()
    top = one.topk(2)
    out = {"top2_gap": float(top.values[0] - top.values[1]), "top2_ids": top.indices.tolist(),
           "logit_range": float(one.max() - one.min()),
           "max_abs_diff": float((one - two).abs().max()),
           "argmax_equal": int(one.argmax()) == int(two.argmax()), "routing_flips": 0}
    out["pinned_max_abs_diff"] = out["max_abs_diff"]
    if routing:
        flips, gaps = routing_flips(routing, routing_two)
        out["routing_flips"] = int(flips.sum())
        out["router_gap_at_flips_max"] = float(gaps[flips].max()) if flips.any() else None
        with moe_routing(llama, pinned=[ids for ids, _ in routing]):
            pinned = cold_logits(models, sharded, cfg, tokens, PS, dev, kv_mode, mesh=mesh).float()
        out["pinned_max_abs_diff"] = float((one - pinned).abs().max())
    out["bar"] = SHARDED_LOGITS_BAR * out["logit_range"]
    if not torch.isfinite(two).all() or out["pinned_max_abs_diff"] > out["bar"]:
        fail(f"sharded logits differ from unsharded beyond {SHARDED_LOGITS_BAR} of the range: {out}")
    return out


def near_tie_gate(pkg, params, sharded, cfg, mesh, prompts, tok1, tok2, dev, kv_mode) -> list:
    """tp=2 greedy tokens against tp=1's, by the near-tie rule: a request
    may leave tp=1's stream only where the unsharded model's top-2 gap (one
    cold prefill of the prompt and the tokens both agreed on) is at most
    twice how far the sharded model's logits move from it on that input
    with the MoE routing pinned (rounding alone), and where that move stays
    within ``tp_logit_check``'s bar. In an MoE a request may also leave it
    where the unpinned sharded pass flipped a near-tied router choice on
    that input and the unpinned move is at least half the gap."""
    diffs = []
    for i, (a, b) in enumerate(zip(tok1, tok2)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        prompt = prompts[i % len(prompts)]
        d = dict(tp_logit_check(pkg, params, sharded, cfg, mesh, list(prompt) + a[:j], dev, kv_mode),
                 request=i, index=j, tp1=a[j], tp2=b[j])
        diffs.append(d)
        if d["top2_gap"] <= 2 * d["pinned_max_abs_diff"]:
            d["explained_by"] = "logit near tie"
        elif d["routing_flips"] and d["top2_gap"] <= 2 * d["max_abs_diff"]:
            d["explained_by"] = "router near tie"
        else:
            fail(f"a tp=2 greedy token differs from tp=1's beyond a near tie: {d}")
    return diffs


def shard_kernel_holds(pkg, ops, cfg, sharded, mesh, dev, kv_mode=None) -> dict:
    """Each kernel of the sharded path held against its plain version at a
    shard's shapes: one warm prefill (2 rows, 512 and 300 tokens, the first
    over 256 tokens of context) and one decode step through the sharded
    model on a scratch pool, the first layer's calls of every shard (K2 in
    the prefill, K1 or K1q in the decode step, and for an MoE the three K4
    products in each) recorded as the model makes them, then each run
    again through the kernel and, in float32, through its plain version
    (tolerances as the kernels phase)."""
    from llm_d_kv_cache_manager_tpu_torch.ops import gmm
    from llm_d_kv_cache_manager_tpu_torch.parallel import init_kv_pools

    models, llama = pkg["models"], pkg["llama"]
    tp = mesh.shape["tp"]
    pools = [p for p in init_kv_pools(cfg, 130, PS, mesh, kv_quant_hbm=kv_mode) if p is not None]
    gen = torch.Generator().manual_seed(SEED)
    tok = torch.randint(0, cfg.vocab_size, (2, 768), generator=gen).int().to(dev)

    def prefill(tokens, starts, lens, s):
        b = tokens.shape[0]
        pos = torch.stack([torch.arange(st, st + s) for st in starts]).int().to(dev)
        valid = (torch.arange(s)[None] < torch.tensor(lens)[:, None]).to(dev)
        rows = torch.arange(b, device=dev)[:, None] * 64 + 1  # row r owns pages 64r + 1 ..
        n_ctx = max(starts) // PS
        ctx = (rows + torch.arange(n_ctx, device=dev)[None]).int()
        ctx[torch.tensor(starts, device=dev) == 0] = 0
        return models.prefill(sharded, cfg, tokens, pos, valid, *pools[:2],
                              (rows + pos.long() // PS).int(), pos % PS, ctx,
                              torch.tensor(starts, dtype=torch.int32, device=dev), *pools[2:],
                              mesh=mesh)

    prefill(tok[:1, :256], [0], [256], 256)  # row 0's context
    recorded = {"flash_prefill": [], "paged_decode": [], "grouped_matmul": []}
    originals = {"flash_prefill": llama.flash_prefill_paged, "paged_decode": llama.paged_attention,
                 "grouped_matmul": gmm.grouped_matmul}
    limits = {"flash_prefill": tp, "paged_decode": tp, "grouped_matmul": 3 * tp}
    stage, taken = ["prefill"], {}

    def recorder(kind):
        def call(*args, **kw):
            key = (kind, stage[0])
            if taken.get(key, 0) < limits[kind]:
                taken[key] = taken.get(key, 0) + 1
                recorded[kind].append((args, kw))
            return originals[kind](*args, **kw)
        return call

    llama.flash_prefill_paged = recorder("flash_prefill")
    llama.paged_attention = recorder("paged_decode")
    gmm.grouped_matmul = recorder("grouped_matmul")
    try:
        warm = torch.stack([tok[0, 256:768], tok[1, :512]])
        prefill(warm, [256, 0], [512, 300], 512)
        stage[0] = "decode"
        lens = torch.tensor([769, 301], dtype=torch.int32, device=dev)
        rows = torch.arange(2, device=dev)[:, None] * 64 + 1
        tables = (rows + torch.arange(64, device=dev)[None]).int()
        models.decode_step(sharded, cfg, tok[:, 0], lens - 1, *pools[:2], tables, lens,
                           page_size=PS, k_scales=pools[2] if kv_mode else None,
                           v_scales=pools[3] if kv_mode else None, mesh=mesh)
    finally:
        llama.flash_prefill_paged = originals["flash_prefill"]
        llama.paged_attention = originals["paged_decode"]
        gmm.grouped_matmul = originals["grouped_matmul"]

    out = {}
    for args, kw in recorded["flash_prefill"]:
        name = "flash_prefill"
        case = hold_prefill_form(ops, name, args, args[7].tolist())
        out.setdefault(name, []).append(dict(case, q=list(args[0].shape), pool=list(args[3].shape)))
    for args, kw in recorded["paged_decode"]:
        q, k_pages, v_pages, bt, sl, fk, fv = args
        quantized = kw.get("k_scale") is not None
        name = "paged_decode_int8" if quantized else "paged_decode"
        outk = originals["paged_decode"](*args, **kw)
        wide_k, wide_v = ((models.dequantize_kv_pool(k_pages, kw["k_scale"], torch.float32),
                           models.dequantize_kv_pool(v_pages, kw["v_scale"], torch.float32))
                          if quantized else (k_pages, v_pages))
        ref = ops.paged_attention_reference(q.float(), wide_k, wide_v, bt, sl, fk, fv, layer=kw["layer"])
        out.setdefault(name, []).append(dict(held(outk, ref), q=list(q.shape),
                                             pool=list(k_pages.shape)))
    for args, kw in recorded["grouped_matmul"]:
        lhs, rhs, gs = args
        outk = originals["grouped_matmul"](*args, **kw)
        if isinstance(rhs, models.QuantizedTensor):
            name, rgi = "grouped_matmul_int8", kw["row_group_ids"]
            ref = ops.grouped_matmul_plain(lhs.float(), rhs, gs, row_group_ids=rgi)
            ref_abs = ops.grouped_matmul_plain(
                lhs.float().abs(), models.QuantizedTensor(q=rhs.q.abs(), scale=rhs.scale), gs,
                row_group_ids=rgi)
        else:
            name = "grouped_matmul_bf16"
            ref = ops.grouped_matmul_plain(lhs.float(), rhs.float(), gs)
            ref_abs = ops.grouped_matmul_plain(lhs.float().abs(), rhs.float().abs(), gs)
        out.setdefault(name, []).append(dict(
            held(outk, ref, ref_abs, abs_coef=lhs.shape[1] * F32_ULP), lhs=list(lhs.shape),
            rhs=list(rhs.shape), nonempty_groups=int((gs > 0).sum())))
    torch.cuda.synchronize()
    if [len(c) for c in recorded.values()] != [tp, tp, 6 * tp if cfg.n_experts else 0]:
        fail(f"recorded shard calls {[len(c) for c in recorded.values()]} for tp={tp}")
    for name, cases in out.items():
        if max(c["err_over_allowance"] for c in cases) > 1:
            fail(f"{name} differs from its plain version at a shard's shapes beyond {TOL[name]}: {cases}")
    del pools
    return out


def block_stored_match(pkg, prompts, one: dict, two: dict) -> dict:
    """Two runs' ``BlockStored`` streams: the prompts' blocks, in order,
    and the whole stream. A block that holds generated tokens differs where
    the tokens do (the near-tie gate reads those; a repeat whose tokens
    leave its first run's adds a block), so the whole stream must be equal
    only when every token is."""
    kvblock = pkg["kvblock"]
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=PS))
    prompt_blocks = {h for p in prompts for h in db.prefix_hashes(p)}

    def of_prompts(stored):
        return [h for h in stored if h in prompt_blocks]

    a, b = one["stored"], two["stored"]
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return {"hashes": [len(a), len(b)], "prompt_blocks": len(of_prompts(a)),
            "prompt_blocks_equal": of_prompts(a) == of_prompts(b),
            "all_equal": a == b, "first_difference": first}


def reductions_ms(mesh, cfg, dev, lanes: int = 8) -> float:
    """Device ms of one decode step's cross-shard work at ``lanes`` lanes:
    the embedding sum, the ``wo`` and FFN sums of every layer, and the
    gather of the vocabulary slices of the logits, captured as one CUDA
    graph (as a decode burst runs them) and its replays timed by CUDA
    events."""
    coll = mesh.collective
    tp = mesh.shape["tp"]
    h = [torch.randn((lanes, 1, cfg.hidden_size), device=dev).to(cfg.dtype) for _ in range(tp)]
    logits = [torch.randn((lanes, 1, cfg.vocab_size // tp), device=dev) for _ in range(tp)]

    def step():
        for _ in range(2 * cfg.n_layers + 1):
            coll.sum(h, cfg.dtype)
        coll.cat(logits, dim=-1)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()  # allocations made outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return cuda_time_ms(graph.replay)


def sharded_path(pkg, ops, dev, card: str, path: dict, params, cfg, one: dict) -> tuple[dict, dict]:
    """One sharded path: ``path``'s workload at ``SHARDED_TP`` (every shard
    on ``dev``) on the weights its tp=1 run (``one``, ``run_engine``'s)
    served, with its exact launch counts (tp times tp=1's a layer) and a
    decode profile; then its greedy tokens against tp=1's by the near-tie
    rule, the same ``BlockStored`` stream, the sharded logits within the
    bar, and each kernel held at a shard's shapes."""
    from llm_d_kv_cache_manager_tpu_torch.parallel import shard_params

    server = pkg["server"]
    kv_mode, quantize, tp = path.get("kv_quant_hbm"), path["quantize"], SHARDED_TP
    label = path["sharded"]
    mesh = same_device_mesh(tp=tp, dev=dev)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    events = []
    eng = workload_engine(server, cfg, params, dev, events, mesh=mesh, tp=tp,
                          **workload_knobs(server, path))
    two = serve_workload(pkg, ops, eng, cfg, path["model"], f"{label}", events)
    expected = {k: v * tp for k, v in expected_launches(
        cfg, quantize, kv_mode, two["prefill_dispatches"], two["decode_steps"]).items()}
    if two["launches"] != expected:
        fail(f"{label}: kernel launches {two['launches']} != expected {expected}")
    two.update(seconds=time.perf_counter() - t, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               dispatch=eng.decode_stats["dispatch"])
    two["profile"] = profile_decode(eng, two["prompts"], server, ops)
    del eng
    free_cuda()
    if two["dispatch"] != "graph":
        fail(f"{label}: decode bursts on one device ran {two['dispatch']}, not as graphs")
    sharded = shard_params(params, mesh, cfg)
    prompts = one["prompts"]
    logits = tp_logit_check(pkg, params, sharded, cfg, mesh, prompts[0], dev, kv_mode)
    diffs = near_tie_gate(pkg, params, sharded, cfg, mesh, prompts, one["tokens"], two["tokens"],
                          dev, kv_mode)
    stream = block_stored_match(pkg, prompts, one, two)
    if not stream["prompt_blocks_equal"] or (not diffs and not stream["all_equal"]):
        fail(f"{label}: the BlockStored stream differs from tp=1's: {stream}")
    holds = shard_kernel_holds(pkg, ops, cfg, sharded, mesh, dev, kv_mode)
    pairs = [(a, b) for sa, sb in zip(one["tokens"], two["tokens"]) for a, b in zip(sa, sb)]

    def reading(run):
        prof = run["profile"]
        phase = run["phase"]
        return dict(decode_rates(phase), seconds=run["seconds"],
                    prefill_tokens_per_s=run["cold_computed"] / (phase["prefill_s"] + phase["mixed_s"]),
                    peak_mem_gib=run["peak_mem_gib"], launches=run["launches"],
                    prefill_dispatches=run["prefill_dispatches"], decode_steps=run["decode_steps"],
                    device_idle_share=prof["device_idle_share"],
                    step_wall_ms=prof["step_wall_ms"],
                    device_busy_ms_per_step=prof["device_busy_ms_per_step"],
                    top_kernels_ms_per_step=prof["top_kernels_ms_per_step"][:6])

    line = {
        "phase": "sharded", "path": label, "served_as": path["model"], "card": card,
        "tp1_path": path["label"],
        "tp": tp, "quantize": quantize, "kv_quant_hbm": kv_mode,
        "chunked_prefill_tokens": path.get("chunked_prefill"),
        "n_layers": cfg.n_layers, "devices": [str(d) for d in mesh.devices],
        "collective": mesh.collective.name, "decode_dispatch": two["dispatch"],
        "note": (f"every shard runs on {dev}: tp={tp} does the same work in smaller launches "
                 "plus the reductions, so here it can only cost; readings, not a claim"),
        "requests": len(one["tokens"]), "new_tokens_each": NEW_TOKENS,
        "greedy_tokens_equal_share": sum(a == b for a, b in pairs) / len(pairs),
        "greedy_requests_equal": sum(a == b for a, b in zip(one["tokens"], two["tokens"])),
        "near_tie_diffs": diffs,
        "block_stored": stream,
        "cached_prompt_tokens_repeats": [s.num_cached_prompt for s in two["repeats"]],
        "first_token_logits": logits,
        "tp1": reading(one), f"tp{tp}": reading(two),
        "reductions_device_ms_per_decode_step": reductions_ms(mesh, cfg, dev),
        "shard_kernel_holds": holds,
    }
    return line, two["launches"]


def sp_prefill(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """The sp path: one warm prefill of ``SP_CHUNK`` tokens over
    ``SP_CONTEXT`` tokens of context at sp=2 (ring attention over the two
    rows, both on ``dev``), its counts zeroed just before and read just
    after, its logits held against the same prefill at sp=1 (K2) within
    the sharded bar, and against the plain attention at sp=1 (reported).
    The ring is plain PyTorch, as JAX's runs no Pallas kernel: the path
    launches no counted kernel."""
    from llm_d_kv_cache_manager_tpu_torch.parallel import shard_params

    models = pkg["models"]
    mesh = same_device_mesh(sp=2, dev=dev)
    sharded = shard_params(params, mesh, cfg)
    gen = torch.Generator().manual_seed(SEED)
    n = SP_CONTEXT + SP_CHUNK
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen).int().to(dev)
    pages = n // PS + 1
    kp, vp = models.init_kv_pages(cfg, pages, PS, dev)
    table = torch.arange(1, pages, dtype=torch.int32, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]

    def chunk(kp, vp, lo, hi, mesh=None, **kw):
        p = pos[:, lo:hi]
        return models.prefill(params if mesh is None else sharded, cfg, tokens[:, lo:hi], p,
                              torch.ones_like(p, dtype=torch.bool),
                              kp, vp, table[p.long() // PS], p % PS,
                              table[: lo // PS][None].contiguous(),
                              torch.tensor([lo], dtype=torch.int32, device=dev), mesh=mesh,
                              **kw)[0][0]

    chunk(kp, vp, 0, SP_CONTEXT)  # the context, at sp=1
    pools = {name: (kp.clone(), vp.clone()) for name in ("sp2", "sp1", "sp1_xla")}
    del kp, vp
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    sp2 = chunk(*pools["sp2"], SP_CONTEXT, n, mesh=mesh).float()
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    sp1 = chunk(*pools["sp1"], SP_CONTEXT, n).float()
    xla = chunk(*pools["sp1_xla"], SP_CONTEXT, n, attn_impl="xla").float()
    rng = float(sp1.max() - sp1.min())
    out = {"phase": "sharded", "path": "llama_3_8b_sp2", "card": card, "sp": 2,
           "devices": [str(d) for d in mesh.devices], "collective": mesh.collective.name,
           "n_layers": cfg.n_layers, "chunk_tokens": SP_CHUNK, "context_tokens": SP_CONTEXT,
           "launches": launches,
           "max_abs_diff_vs_sp1": float((sp2 - sp1).abs().max()),
           "max_abs_diff_vs_sp1_xla": float((sp2 - xla).abs().max()),
           "bar": SHARDED_LOGITS_BAR * rng, "logit_range": rng,
           "argmax_equal": int(sp2.argmax()) == int(sp1.argmax()),
           "pools_max_abs_diff_vs_sp1": max(float((a.float() - b.float()).abs().max())
                                            for a, b in zip(pools["sp2"], pools["sp1"]))}
    if not torch.isfinite(sp2).all() or out["max_abs_diff_vs_sp1"] > out["bar"]:
        fail(f"sp=2 prefill logits differ from sp=1's beyond the bar: {out}")
    if any(launches.values()):
        fail(f"the sp=2 prefill launched counted kernels: {launches}")
    out["sp2_ms"] = cuda_time_ms(lambda: chunk(*pools["sp2"], SP_CONTEXT, n, mesh=mesh), iters=3, warmup=1)
    out["sp1_ms"] = cuda_time_ms(lambda: chunk(*pools["sp1"], SP_CONTEXT, n), iters=3, warmup=1)
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del pools
    free_cuda()
    return out, launches


# -- page moves over sharded pools: the host tier and the wire at tp=2 --------
#: the tp=2 tiers line's engines: (label, engine knobs, tp); the tiered ones
#: hold 384 device pages over 1024 host pages, as ``host_tier``'s do
TP2_TIER_RUNS = (
    ("tp2_reference", dict(total_pages=1024, host_pages=0), SHARDED_TP),
    ("tp2_always", dict(host_tier_policy="always"), SHARDED_TP),
    ("tp1_always", dict(host_tier_policy="always"), 1),
)


def tp2_tiers(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """The host-DRAM tier over sharded pools, on the 8B path's resident
    weights: ``host_tier``'s three rounds of four 1024-token prompts on a
    tp=2 engine without the tier, with it ("always": round 2 demotes round
    1's pages, round 3 restores them) and on a tp=1 engine with it. Gates:
    pages restored, each restored page bit-equal on every shard to what was
    demoted (and every page hit in HBM too), greedy tokens equal to the
    untiered tp=2 engine's, the prompts' ``BlockStored`` events (hash and
    medium, in order) equal to tp=1's, the pools written in place, exact
    launch counts (tp times the kernels of a tp=1 engine's dispatches)."""
    server = pkg["server"]
    mesh = same_device_mesh(tp=SHARDED_TP, dev=dev)
    rng = np.random.default_rng(SEED + 1)
    rounds = [[rng.integers(0, cfg.vocab_size, 1024).tolist() for _ in range(4)] for _ in range(2)]
    rounds.append(rounds[0])
    torch.cuda.reset_peak_memory_stats()
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    expected = dict.fromkeys(ops.COUNTED, 0)
    runs = {}
    for label, knobs, tp in TP2_TIER_RUNS:
        run = runs[label] = host_tier_engine(server, dev, params, cfg, rounds, knobs,
                                             mesh=mesh if tp > 1 else None)
        exp = expected_launches(cfg, None, None, run["prefill_dispatches"],
                                run["decode_steps_with_warmup"])
        expected = {name: expected[name] + n * tp for name, n in exp.items()}
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    if launches != expected:
        fail(f"tp2 tiers: kernel launches {launches} != expected {expected}")
    tiered, ref, one = runs["tp2_always"], runs["tp2_reference"], runs["tp1_always"]
    if tiered["pages_restored_in_round_3"] == 0 or tiered["block_stored_host_dram"] == 0:
        fail(f"tp2 tiers: {tiered['pages_restored_in_round_3']} pages restored, "
             f"{tiered['block_stored_host_dram']} BlockStored(host_dram)")
    if tiered["restored_pages_unequal"] or tiered["hbm_hit_pages_unequal"]:
        fail(f"tp2 tiers: {tiered['restored_pages_unequal']} restored and "
             f"{tiered['hbm_hit_pages_unequal']} HBM-hit pages differ from round 1's on a shard")
    if tiered["tokens"] != ref["tokens"]:
        fail("tp2 tiers: greedy tokens through the host tier differ from the untiered tp=2 engine's")
    kvblock = pkg["kvblock"]
    db = kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=16))
    prompt_blocks = {h for r in rounds for p in r for h in db.prefix_hashes(p)}
    streams = [[x for x in run["stored"] if x[0] in prompt_blocks] for run in (tiered, one)]
    if streams[0] != streams[1]:
        first = next((i for i, (a, b) in enumerate(zip(*streams)) if a != b), None)
        fail(f"tp2 tiers: the prompts' BlockStored events differ from tp=1's at {first} "
             f"({len(streams[0])} / {len(streams[1])} events)")
    pairs = [(a, b) for ra, rb in zip(one["tokens"], tiered["tokens"]) for sa, sb in zip(ra, rb)
             for a, b in zip(sa, sb)]
    out = {
        "phase": "sharded", "card": card, "tp": SHARDED_TP, "devices": [str(d) for d in mesh.devices],
        "collective": mesh.collective.name, "n_layers": cfg.n_layers,
        "prompts_per_round": 4, "prompt_tokens": 1024, "launches": launches,
        "pages_restored_in_round_3": tiered["pages_restored_in_round_3"],
        "restored_pages_unequal_per_shard": tiered["restored_pages_unequal"],
        "tokens_equal_untiered_tp2": True,
        "greedy_tokens_equal_share_vs_tp1": sum(a == b for a, b in pairs) / len(pairs),
        "block_stored_prompt_events": len(streams[0]), "block_stored_equal_tp1": True,
        "runs": {label: {k: v for k, v in run.items() if k not in ("tokens", "stored")}
                 for label, run in runs.items()},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return out, launches


def tp2_transfer(pkg, ops, dev, card: str, params, cfg) -> tuple[dict, dict]:
    """KV export and import over sharded pools, on the 8B path's resident
    weights: four 1024-token prompts served cold and then warm (each alone)
    on a tp=2 exporter with ``kv_integrity``; each prompt's 64 blocks
    exported, sent through the wire's encoding and imported into a fresh
    tp=2 engine and a fresh tp=1 engine (both checking the digests), which
    then serve the prompts warm. Gates: every payload byte for byte the
    exporter's pages gathered over its shards, at a tp=1 pod's block size,
    its digest verified; nothing rejected; the imported pages bit-equal to
    the exporter's (gathered); the tp=1 importer's own export byte for byte
    the tp=2 exporter's; the tp=2 importer's greedy tokens equal to the
    exporter's warm repeat, the tp=1 importer's equal or leaving it only at
    a near tie (``near_tie_gate``); exact launch counts."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache import transfer
    from llm_d_kv_cache_manager_tpu_torch.kvcache.integrity import page_digest
    from llm_d_kv_cache_manager_tpu_torch.parallel import shard_params

    server = pkg["server"]
    mesh = same_device_mesh(tp=SHARDED_TP, dev=dev)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, 1024).tolist() for _ in range(4)]
    ps, new_tokens = 16, 8
    torch.cuda.reset_peak_memory_stats()
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0

    def engine(tp):
        return server.Engine(
            server.EngineConfig(model=cfg, max_model_len=2048, decode_batch_size=8, seed=SEED,
                                tp=tp, kv_integrity=True,
                                block_manager=server.BlockManagerConfig(total_pages=1024, page_size=ps)),
            params=params, device=None if tp > 1 else dev, mesh=mesh if tp > 1 else None)

    def serve(eng, batch):
        seqs = [eng.add_request(p, server.SamplingParams(max_new_tokens=new_tokens)) for p in batch]
        eng.run_until_complete()
        for s in seqs:
            if s.error or len(s.generated_tokens) != new_tokens:
                fail(f"tp2 transfer: a request finished with {len(s.generated_tokens)} tokens, "
                     f"error={s.error}")
        return seqs

    def chain(eng, p):
        hashes = eng.block_manager.token_db.prefix_hashes(p)
        links = eng.block_manager.lookup_chain(hashes, None)
        if [tier for _, _, tier, _ in links] != ["tpu_hbm"] * len(hashes):
            fail("tp2 transfer: a prompt's chain is not resident in HBM")
        return hashes, eng._gather_pages([idx for _, _, _, idx in links])

    engines = {"src": engine(SHARDED_TP)}
    src = engines["src"]
    serve(src, prompts)
    warm_src = [serve(src, [p])[0] for p in prompts]
    shape = (cfg.n_layers, ps, cfg.n_kv_heads, cfg.hd)
    payloads, wire_mib, digests_ok = [], 0.0, 0
    t = time.perf_counter()
    for p in prompts:
        hashes, pages = chain(src, p)
        blocks = src.export_kv_blocks(hashes)
        if len(blocks) != len(hashes):
            fail(f"tp2 transfer: exported {len(blocks)} of {len(hashes)} blocks")
        for field, want in (("k_data", pages[0]), ("v_data", pages[1])):
            if not torch.equal(wire_tensor(blocks, field, cfg.dtype, shape, dev), want):
                fail(f"tp2 transfer: the payloads' {field} are not the exporter's gathered pages")
        for b in blocks:
            if len(b.k_data) + len(b.v_data) != src.kv_block_bytes:
                fail(f"tp2 transfer: a payload is {len(b.k_data) + len(b.v_data)} bytes, "
                     f"not a block's {src.kv_block_bytes}")
            digests_ok += b.digest == page_digest(b.k_data, b.v_data, b.k_scale, b.v_scale)
        wire = transfer.encode_response(blocks, True)
        wire_mib += len(wire) / 2**20
        payloads.append(transfer.decode_response(wire)[0])
    export_s = time.perf_counter() - t
    if digests_ok != 4 * 64:
        fail(f"tp2 transfer: {digests_ok} of {4 * 64} digests verify")
    out = {"phase": "sharded", "card": card, "tp": SHARDED_TP, "devices": [str(d) for d in mesh.devices],
           "collective": mesh.collective.name, "n_layers": cfg.n_layers, "prompts": 4,
           "prompt_tokens": 1024, "blocks": 4 * 64, "wire_mib": wire_mib,
           "block_bytes": src.kv_block_bytes, "digests_verified": digests_ok,
           "export_and_wire_s": export_s}
    tokens = {"src": [list(s.generated_tokens) for s in warm_src]}
    for label, tp in (("tp2_importer", SHARDED_TP), ("tp1_importer", 1)):
        eng = engines[label] = engine(tp)
        installed = sum(eng.import_kv_blocks(blocks, source_pod="src") for blocks in payloads)
        if installed != 4 * 64 or eng.transfer_stats["import_rejected"]:
            fail(f"tp2 transfer: {label} installed {installed} blocks, "
                 f"rejected {eng.transfer_stats['import_rejected']}")
        eng._flush_page_moves()
        for p in prompts:
            (a, b) = (chain(src, p)[1], chain(eng, p)[1])
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail(f"tp2 transfer: {label}'s imported pages differ from the exporter's")
        seqs = [serve(eng, [p])[0] for p in prompts]
        if any(s.num_cached_prompt != w.num_cached_prompt for s, w in zip(seqs, warm_src)):
            fail(f"tp2 transfer: {label} hit {[s.num_cached_prompt for s in seqs]} cached tokens, "
                 f"the exporter's repeat {[s.num_cached_prompt for s in warm_src]}")
        tokens[label] = [list(s.generated_tokens) for s in seqs]
        out[label] = {"installed": installed, "cached_prompt_tokens": [s.num_cached_prompt for s in seqs],
                      "integrity": eng.integrity.snapshot() if eng.integrity is not None else None}
    if tokens["tp2_importer"] != tokens["src"]:
        fail("tp2 transfer: the tp=2 importer's greedy tokens differ from the exporter's warm repeat")
    back = engines["tp1_importer"]
    for p, blocks in zip(prompts, payloads):
        again = back.export_kv_blocks(back.block_manager.token_db.prefix_hashes(p))
        if [(b.k_data, b.v_data) for b in again] != [(b.k_data, b.v_data) for b in blocks]:
            fail("tp2 transfer: the tp=1 importer's export differs from the tp=2 exporter's bytes")
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    expected = dict.fromkeys(ops.COUNTED, 0)
    for label, eng in engines.items():
        tp = eng.mesh.shape["tp"] if eng.mesh is not None else 1
        exp = expected_launches(cfg, None, None, eng.prefill_stats["dispatches"],
                                eng.decode_stats["steps"] + eng.decode_graphs.warmup_steps)
        expected = {name: expected[name] + n * tp for name, n in exp.items()}
    if launches != expected:
        fail(f"tp2 transfer: kernel launches {launches} != expected {expected}")
    # After the counts: the gate's cold prefills launch K2 too.
    diffs = near_tie_gate(pkg, params, shard_params(params, mesh, cfg), cfg, mesh, prompts,
                          tokens["tp1_importer"], tokens["src"], dev, None)
    out.update(launches=launches, tokens_equal_tp2_importer=True,
               tp1_importer_requests_equal=sum(a == b for a, b in zip(tokens["tp1_importer"], tokens["src"])),
               near_tie_diffs=diffs, tp1_export_bytes_equal=True,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del engines, src, back, eng, payloads
    free_cuda()
    return out, launches


# -- training through the routed MoE -------------------------------------------
#: Qwen3-30B-A3B at full width, cut to 2 of its 48 layers (param, grad and
#: AdamW's two moments in bf16 are 8 bytes a parameter: 15 GB at 2 layers,
#: ~240 GB at 48); 5 AdamW steps at JAX's default lr on one batch
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR = 2, 5, 1e-4
#: the kernels a training step launches (K4, K4^T, K6)
TRAIN_KERNELS = ("grouped_matmul_bf16", "grouped_matmul_bf16_t", "grouped_matmul_tgmm")
#: per-leaf relative error (L2) between one step's gradients through the
#: kernels and through the plain grouped matmul (``moe_gmm="xla"``), with
#: the plain pass's routing pinned to the kernel pass's: K4 and the plain
#: version round their bf16 outputs alike up to a last bit, and the
#: backward rounds to bf16 at every step; 2^-6 is four bf16 half-ulps.
#: Unpinned, a last-bit change in the second layer's bf16 router logits
#: flips near-tied top-8 choices, and a flipped token's gradient changes
#: wholesale (the first card run read 0.022-0.061 a leaf that way); that
#: reading is reported with no bar.
GRAD_REL_BAR = 2.0**-6
#: the losses of the two: within bf16 rounding of the loss
LOSS_REL_BAR = 2.0**-8


class Qwen3MoeConfig:
    """A stand-in for transformers' ``Qwen3MoeConfig`` (the card's machine
    has no transformers): Qwen/Qwen3-30B-A3B's published config.json fields
    that ``config_from_hf`` reads, under the class name it dispatches on."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


QWEN3_30B_A3B_HF = dict(
    vocab_size=151_936, hidden_size=2048, intermediate_size=6144, num_hidden_layers=48,
    num_attention_heads=32, num_key_value_heads=4, head_dim=128, rope_theta=1_000_000.0,
    rope_scaling=None, rms_norm_eps=1e-6, attention_bias=False, tie_word_embeddings=False,
    num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768, norm_topk_prob=True,
    hidden_act="silu", decoder_sparse_step=1, mlp_only_layers=[],
)


def hf_state_dict(params, cfg) -> dict:
    """The HF-named state dict of ``params`` (``[out, in]`` views, no
    copies; Qwen3-MoE's per-expert names)."""
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].T}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = layer["attn_norm"]
        sd[p + "post_attention_layernorm.weight"] = layer["mlp_norm"]
        for key, name in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
            sd[f"{p}self_attn.{name}.weight"] = layer[key].T
        sd[p + "self_attn.q_norm.weight"] = layer["q_norm"]
        sd[p + "self_attn.k_norm.weight"] = layer["k_norm"]
        sd[p + "mlp.gate.weight"] = layer["router"].T
        for key, name in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            for j in range(cfg.n_experts):
                sd[f"{p}mlp.experts.{j}.{name}.weight"] = layer[key][j].T
    return sd


def leaves_equal(a, b) -> bool:
    from llm_d_kv_cache_manager_tpu_torch.parallel.train import param_leaves

    la, lb = param_leaves(a), param_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.detach(), y.detach())
        for x, y in zip(la, lb))


def leaf_names(tree, prefix: str = "") -> list[str]:
    """The names of a parameter tree's leaves, in ``param_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def grads_of(train, params, cfg, tokens) -> tuple[float, list]:
    """One forward and backward (no optimizer step): the loss and every
    leaf's gradient, in ``param_leaves`` order; of sharded params, reduced
    over their copies and gathered whole (``train.gather_grads``)."""
    leaves = train.param_leaves(params)
    for p in leaves:
        p.grad = None
    loss = train.loss_fn(params, cfg, tokens)
    loss.backward()
    if hasattr(params, "replicas"):
        train.reduce_grads(params)
        grads = train.gather_grads(params)
    else:
        grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return float(loss.detach()), grads


def rel_errors(a: list, b: list) -> list[float]:
    return [float((x.detach().float() - y.detach().float()).norm()
                  / y.detach().float().norm().clamp_min(1e-30)) for x, y in zip(a, b)]


def checkpoint_dir(need_bytes: int) -> str:
    """A directory with room for the checkpoints: the process's temporary
    directory, else the checkout's ignored ``build/``; fails when neither
    has ``need_bytes`` free (with a quarter to spare)."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    free = {}
    for root in (tempfile.gettempdir(), build):
        free[root] = shutil.disk_usage(root).free
        if free[root] >= need_bytes * 1.25:
            return tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root)
    fail(f"no directory has {need_bytes / 1e9:.1f} GB free for the checkpoints: {free}")


def serve_tokens(server, params, cfg, dev, prompts, new_tokens: int, mesh=None) -> list:
    eng = server.Engine(
        server.EngineConfig(model=cfg, block_manager=server.BlockManagerConfig(
            total_pages=256, page_size=16), max_model_len=1024, decode_batch_size=8, seed=SEED,
            tp=mesh.shape["tp"] if mesh is not None else 1),
        params=params, device=None if mesh is not None else dev, mesh=mesh)
    seqs = [eng.add_request(p, server.SamplingParams(max_new_tokens=new_tokens)) for p in prompts]
    eng.run_until_complete()
    out = [list(s.generated_tokens) for s in seqs]
    del eng
    free_cuda()
    return out


def train_phase(pkg, ops, dev, card: str) -> tuple[dict, dict]:
    """Qwen3-30B-A3B at full width and ``TRAIN_LAYERS`` layers, trained on
    the card: HF loading held bit-equal, one step's gradients through the
    kernels held against the plain grouped matmul's, ``TRAIN_STEPS`` AdamW
    steps with exact launch counts (the path's main run: 3 K4, 3 K4^T and 3
    K6 a layer a step, nothing else counted), a falling loss, a train-state
    checkpoint round trip (bit-equal, and the next step from either state
    alike), and the trained weights, restored from a params checkpoint,
    served with the same greedy tokens as the in-memory ones."""
    from llm_d_kv_cache_manager_tpu_torch import parallel
    from llm_d_kv_cache_manager_tpu_torch.parallel import train

    models, server = pkg["models"], pkg["server"]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(models.QWEN3_30B_A3B, n_layers=TRAIN_LAYERS)
    out = {"phase": "train", "model": "qwen3_30b_a3b_train", "card": card,
           "reduced": {"n_layers": f"{TRAIN_LAYERS} of 48"},
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "lr": TRAIN_LR}

    # 1. HF loading: an HF-named state dict of init_params' weights loads
    # back bit-equal, and the published config gives back the preset.
    t0 = time.perf_counter()
    params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    hf_cfg = models.config_from_hf(Qwen3MoeConfig(**QWEN3_30B_A3B_HF))
    if hf_cfg != models.QWEN3_30B_A3B:
        fail(f"config_from_hf gave {hf_cfg}, not the QWEN3_30B_A3B preset")
    loaded = models.load_hf_state_dict(hf_state_dict(params, cfg), cfg, device=dev)
    if not leaves_equal(loaded, params):
        fail("load_hf_state_dict did not give back init_params' weights bit for bit")
    del loaded
    free_cuda()
    out["hf_load"] = {"bit_equal": True, "config_equal": True, "s": time.perf_counter() - t0}
    out["param_count"] = sum(p.numel() for p in train.param_leaves(params))

    # 3. Gradients through the kernels against the plain grouped matmul.
    train.trainable(params)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to(dev)
    plain_cfg = dataclasses.replace(cfg, moe_gmm="xla")
    with moe_routing(pkg["llama"]) as routing:
        loss_k, grads_k = grads_of(train, params, cfg, tokens)
    with moe_routing(pkg["llama"], pinned=[ids for ids, _ in routing]):
        loss_x, grads_x = grads_of(train, params, plain_cfg, tokens)
    errs = rel_errors(grads_k, grads_x)
    del grads_x
    with moe_routing(pkg["llama"]) as routing_u:
        loss_u, grads_u = grads_of(train, params, plain_cfg, tokens)
    errs_u = rel_errors(grads_k, grads_u)
    flips, _ = routing_flips(routing, routing_u)
    del grads_k, grads_u, routing, routing_u
    free_cuda()
    names = leaf_names(params)
    out["grad_hold"] = {"loss_kernels": loss_k, "loss_plain": loss_x, "max_rel_err": max(errs),
                        "bar": GRAD_REL_BAR, "loss_bar": LOSS_REL_BAR,
                        "worst_leaf": names[int(np.argmax(errs))], "routing": "pinned",
                        "unpinned": {"loss_plain": loss_u, "max_rel_err": max(errs_u),
                                     "worst_leaf": names[int(np.argmax(errs_u))],
                                     "tokens_flipped_by_layer": flips.sum(dim=1).tolist()}}
    if not all(np.isfinite(errs)) or max(errs) > GRAD_REL_BAR:
        fail(f"train: gradients through the kernels differ from the plain ones: {errs}")
    if abs(loss_k - loss_x) > LOSS_REL_BAR * abs(loss_x):
        fail(f"train: loss {loss_k} through the kernels vs {loss_x} plain")

    # 4./5. The main path: TRAIN_STEPS AdamW steps, counts zeroed just
    # before and read just after.
    state = train.TrainState(params, train.make_optimizer(params, TRAIN_LR), 0)
    losses, step_s = [], []
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = train.train_step(state, cfg, tokens, TRAIN_LR)
        losses.append(float(loss))  # syncs
        step_s.append(time.perf_counter() - t)
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    expected = dict.fromkeys(ops.COUNTED, 0)
    for name in TRAIN_KERNELS:
        expected[name] = 3 * cfg.n_layers * TRAIN_STEPS
    if launches != expected:
        fail(f"train: kernel launches {launches} != expected {expected}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} are not finite and falling")
    step_ms = float(np.median(step_s[1:])) * 1e3
    out.update(losses=losses, step_s=step_s, step_ms=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3), launches=launches)
    out["profile"] = profile_window(lambda: train.train_step(state, cfg, tokens, TRAIN_LR), 1, 1,
                                    ops.COUNTED)
    state = state._replace(step=state.step + 2)  # the profile's two steps
    out["peak_mem_gib_training"] = torch.cuda.max_memory_allocated() / 2**30

    # 6. Checkpoint round trip; 7. serve the trained weights.
    n_bytes = out["param_count"] * 2 * 4  # params, the params file, two moments
    ckpt = checkpoint_dir(n_bytes)
    try:
        disk_free = shutil.disk_usage(ckpt).free
        t = time.perf_counter()
        parallel.save_train_state(os.path.join(ckpt, "train.pt"), state)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        restored = parallel.load_train_state(os.path.join(ckpt, "train.pt"), cfg, TRAIN_LR, device=dev)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t
        file_gb = os.path.getsize(os.path.join(ckpt, "train.pt")) / 1e9
        moments_equal = all(
            all(torch.equal(state.optimizer.state[p][k], restored.optimizer.state[q][k])
                for k in ("step", "exp_avg", "exp_avg_sq"))
            for p, q in zip(train.param_leaves(state.params), train.param_leaves(restored.params)))
        if not (leaves_equal(state.params, restored.params) and moments_equal
                and restored.step == state.step):
            fail("train: the restored train state is not bit-equal to the saved one")
        parallel.save_params(os.path.join(ckpt, "params.pt"), state.params)
        served = parallel.load_params(os.path.join(ckpt, "params.pt"), cfg, device=dev)
        prompts = [rng.integers(0, cfg.vocab_size, 64).tolist() for _ in range(2)]
        tokens_restored = serve_tokens(server, served, cfg, dev, prompts, 8)
        tokens_memory = serve_tokens(server, train.detached(state.params), cfg, dev, prompts, 8)
        if tokens_restored != tokens_memory:
            fail(f"train: restored weights serve {tokens_restored}, in-memory {tokens_memory}")
        del served
        state, loss_a = train.train_step(state, cfg, tokens, TRAIN_LR)
        restored, loss_b = train.train_step(restored, cfg, tokens, TRAIN_LR)
        resume_errs = rel_errors(train.param_leaves(restored.params), train.param_leaves(state.params))
        if max(resume_errs) > GRAD_REL_BAR or abs(float(loss_a) - float(loss_b)) > LOSS_REL_BAR * abs(float(loss_a)):
            fail(f"train: a step from the restored state differs: losses {float(loss_a)} / "
                 f"{float(loss_b)}, params rel err {max(resume_errs)}")
        out["checkpoint"] = {"dir_free_gb": disk_free / 1e9, "train_state_gb": file_gb,
                             "write_s": write_s, "read_s": read_s, "bit_equal": True,
                             "next_step_losses": [float(loss_a), float(loss_b)],
                             "next_step_params_max_rel_err": max(resume_errs)}
        out["served"] = {"requests": len(prompts), "new_tokens_each": 8, "tokens_equal": True,
                         "tokens": tokens_restored}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del state, restored, params
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out, {"qwen3_30b_a3b_train": launches}


#: the mesh training line: dp replicas of the batch, each over tp expert
#: shards (64 experts a shard, 16 query heads over 2 KV heads), every shard
#: on the card's one GPU
TRAIN_MESH = {"dp": 2, "tp": 2}


def copies_bit_equal(train, sharded) -> bool:
    """Every dp replica's leaves equal the first replica's, and every copy
    of a replicated leaf the first shard's, bit for bit."""
    from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import leaf_specs

    first = [train.param_leaves(tree) for tree in sharded.replicas[0][0]]
    for grid in sharded.replicas[1:]:
        for a, tree in zip(first, grid[0]):
            if not all(torch.equal(x, y) for x, y in zip(a, train.param_leaves(tree))):
                return False
    specs = leaf_specs(sharded.replicas[0][0][0], sharded.specs)
    return all(torch.equal(leaves[i], first[0][i]) for i, spec in enumerate(specs)
               if "tp" not in spec for leaves in first[1:])


def states_bit_equal(train, a, b) -> bool:
    """Two train states' parameters (every shard's) and AdamW states."""
    la, lb = train.param_leaves(a.params), train.param_leaves(b.params)
    return a.step == b.step and len(la) == len(lb) and all(
        torch.equal(x.detach(), y.detach())
        and all(torch.equal(a.optimizer.state[x][k], b.optimizer.state[y][k])
                for k in ("step", "exp_avg", "exp_avg_sq"))
        for x, y in zip(la, lb))


def saved_files_equal(path_a: str, path_b: str) -> bool:
    """Two checkpoint files hold the same tree, tensor for tensor (read
    memory-mapped on the host)."""
    def flat(x):
        if isinstance(x, dict):
            return [(k, v) for key in x for k, v in flat_prefixed(key, x[key])]
        if isinstance(x, (list, tuple)):
            return [(k, v) for i, item in enumerate(x) for k, v in flat_prefixed(i, item)]
        return [("", x)]

    def flat_prefixed(key, x):
        return [(f"{key}/{k}", v) for k, v in flat(x)]

    a = flat(torch.load(path_a, map_location="cpu", weights_only=True, mmap=True))
    b = flat(torch.load(path_b, map_location="cpu", weights_only=True, mmap=True))
    return len(a) == len(b) and all(
        ka == kb and (torch.equal(va, vb) if isinstance(va, torch.Tensor) and isinstance(vb, torch.Tensor)
                      else va == vb)
        for (ka, va), (kb, vb) in zip(a, b))


def train_mesh_phase(pkg, ops, dev, card: str, tp1: dict) -> tuple[dict, dict]:
    """``train_phase``'s model, weights and tokens trained over a (dp=2,
    tp=2) mesh of shards on the card's one GPU: each replica one sequence,
    each shard 64 of the 128 experts (K4, K4^T and K6 on every shard, about
    half of a shard's rows past its last group). Gates: one step's loss and
    every gathered gradient against tp=1's (``train_phase``'s initial
    weights) with routing pinned to tp=1's, under the tp=1 line's bars (the
    unpinned reading reported with none); ``TRAIN_STEPS`` AdamW steps with
    exact launch counts (3 a layer a shard a step of each kernel, nothing
    else counted), a falling loss, every replica and every copy of a
    replicated leaf bit-equal; a train-state checkpoint saved from the mesh
    equal, tensor for tensor, to the mesh-free save of the gathered state,
    restored onto the mesh and onto no mesh bit-equal, the next step from
    either restore against the in-memory state's under the tp=1 line's
    bars; a params checkpoint restored straight onto a tp=2 mesh serving
    the greedy tokens of the in-memory weights at tp=2."""
    from llm_d_kv_cache_manager_tpu_torch import parallel
    from llm_d_kv_cache_manager_tpu_torch.parallel import train

    models, server, llama = pkg["models"], pkg["server"], pkg["llama"]
    dp, tp = TRAIN_MESH["dp"], TRAIN_MESH["tp"]
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(models.QWEN3_30B_A3B, n_layers=TRAIN_LAYERS)
    mesh = parallel.make_mesh(parallel.MeshConfig(dp=dp, tp=tp), devices=[dev] * (dp * tp))
    out = {"phase": "train", "model": "qwen3_30b_a3b_train_dp2ep2", "card": card,
           "dp": dp, "tp": tp, "devices": [str(d) for d in mesh.devices],
           "collective": mesh.collective.name, "reduced": {"n_layers": f"{TRAIN_LAYERS} of 48"},
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "lr": TRAIN_LR,
           "note": (f"every shard runs on {dev}: the mesh does the work of tp=1 in {dp * tp} "
                    "shards plus the reductions and a second replica's update; readings, not a claim")}

    # 1. One step against tp=1's, on train_phase's initial weights and tokens.
    params = train.trainable(models.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to(dev)
    with moe_routing(llama) as routing:
        loss_1, grads_1 = grads_of(train, params, cfg, tokens)
    sharded = train.trainable(parallel.shard_train_params(params, mesh, cfg))
    names = leaf_names(params)
    del params
    free_cuda()
    rows = TRAIN_BATCH // dp * TRAIN_SEQ  # the rows a replica routes
    pinned = [ids[d * rows : (d + 1) * rows] for d in range(dp) for ids, _ in routing]
    with moe_routing(llama, pinned=pinned):
        loss_m, grads_m = grads_of(train, sharded, cfg, tokens)
    errs = rel_errors(grads_m, grads_1)
    del grads_m
    with moe_routing(llama) as routing_u:
        loss_u, grads_u = grads_of(train, sharded, cfg, tokens)
    errs_u = rel_errors(grads_u, grads_1)
    by_layer = [(torch.cat([routing_u[d * cfg.n_layers + layer][0] for d in range(dp)]), None)
                for layer in range(cfg.n_layers)]
    flips, _ = routing_flips(routing, by_layer)
    del grads_1, grads_u, routing, routing_u, by_layer
    free_cuda()
    out["grad_hold_vs_tp1"] = {
        "loss_tp1": loss_1, "loss_mesh": loss_m, "max_rel_err": max(errs), "bar": GRAD_REL_BAR,
        "loss_bar": LOSS_REL_BAR, "worst_leaf": names[int(np.argmax(errs))], "routing": "pinned",
        "worst_leaves": sorted(zip(errs, names), reverse=True)[:6],
        "median_rel_err": float(np.median(errs)),
        "unpinned": {"loss_mesh": loss_u, "max_rel_err": max(errs_u),
                     "worst_leaf": names[int(np.argmax(errs_u))],
                     "tokens_flipped_by_layer": flips.sum(dim=1).tolist()}}
    if not all(np.isfinite(errs)) or max(errs) > GRAD_REL_BAR:
        fail(f"train dp2ep2: gathered gradients differ from tp=1's: {errs}")
    if abs(loss_m - loss_1) > LOSS_REL_BAR * abs(loss_1):
        fail(f"train dp2ep2: loss {loss_m} over the mesh vs {loss_1} at tp=1")

    # 2. The main path: TRAIN_STEPS AdamW steps, counts zeroed just before
    # and read just after.
    state = train.TrainState(sharded, train.make_optimizer(sharded, TRAIN_LR), 0)
    losses, step_s = [], []
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = train.train_step(state, cfg, tokens, TRAIN_LR)
        losses.append(float(loss))  # syncs
        step_s.append(time.perf_counter() - t)
    launches = {name: w.launches for name, w in ops.COUNTED.items()}
    expected = dict.fromkeys(ops.COUNTED, 0)
    for name in TRAIN_KERNELS:
        expected[name] = 3 * cfg.n_layers * dp * tp * TRAIN_STEPS
    if launches != expected:
        fail(f"train dp2ep2: kernel launches {launches} != expected {expected}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train dp2ep2: losses {losses} are not finite and falling")
    if not copies_bit_equal(train, state.params):
        fail("train dp2ep2: replicas or copies of a replicated leaf differ after the steps")
    step_ms = float(np.median(step_s[1:])) * 1e3
    out.update(losses=losses, step_s=step_s, step_ms=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3), launches=launches,
               copies_bit_equal=True)
    out["profile"] = profile_window(lambda: train.train_step(state, cfg, tokens, TRAIN_LR), 1, 1,
                                    ops.COUNTED)
    state = state._replace(step=state.step + 2)  # the profile's two steps
    if not copies_bit_equal(train, state.params):
        fail("train dp2ep2: replicas or copies differ after the profiled steps")
    out["peak_mem_gib_training"] = torch.cuda.max_memory_allocated() / 2**30
    out["tp1"] = {"step_ms": tp1["step_ms"], "tokens_per_s": tp1["tokens_per_s"],
                  "device_idle_share": tp1["profile"]["device_idle_share"],
                  "peak_mem_gib_training": tp1["peak_mem_gib_training"]}
    for wrapper in ops.COUNTED.values():
        wrapper.launches = 0  # what follows is checked, not counted

    # 3. Checkpoints.
    n_params = tp1["param_count"]
    state_bytes = n_params * 2 * 3  # params and two moments, bf16
    ckpt = checkpoint_dir(2 * state_bytes + n_params * 2)
    paths = {k: os.path.join(ckpt, f"{k}.pt") for k in ("mesh", "free", "params")}
    try:
        t = time.perf_counter()
        parallel.save_train_state(paths["mesh"], state)
        write_s = time.perf_counter() - t
        gathered = parallel.gather_train_state(state)
        parallel.save_train_state(paths["free"], gathered)
        del gathered
        free_cuda()
        if not saved_files_equal(paths["mesh"], paths["free"]):
            fail("train dp2ep2: the mesh save differs from the mesh-free save of the gathered state")
        os.remove(paths["free"])
        t = time.perf_counter()
        free = parallel.load_train_state(paths["mesh"], cfg, TRAIN_LR, device=dev)
        torch.cuda.synchronize()
        read_free_s = time.perf_counter() - t
        if not states_bit_equal(train, free, parallel.gather_train_state(state)):
            fail("train dp2ep2: the mesh-free restore is not bit-equal to the gathered state")
        free, loss_f = train.train_step(free, cfg, tokens, TRAIN_LR)
        params_f = train.detached(free.params)
        del free
        free_cuda()
        t = time.perf_counter()
        on_mesh = parallel.load_train_state(paths["mesh"], cfg, TRAIN_LR, mesh=mesh)
        torch.cuda.synchronize()
        read_mesh_s = time.perf_counter() - t
        if not states_bit_equal(train, on_mesh, state):
            fail("train dp2ep2: the restore onto the mesh is not bit-equal to the saved state")
        on_mesh, loss_r = train.train_step(on_mesh, cfg, tokens, TRAIN_LR)
        params_r = parallel.gather_params(on_mesh.params)
        del on_mesh
        free_cuda()
        state, loss_a = train.train_step(state, cfg, tokens, TRAIN_LR)
        state.optimizer.zero_grad(set_to_none=True)
        params_a = parallel.gather_params(state.params)
        resume = {}
        for label, params_x, loss_x in (("mesh", params_r, loss_r), ("no_mesh", params_f, loss_f)):
            e = rel_errors(train.param_leaves(params_x), train.param_leaves(params_a))
            resume[label] = {"loss": float(loss_x), "params_max_rel_err": max(e),
                             "bit_equal": leaves_equal(params_x, params_a)}
            if max(e) > GRAD_REL_BAR or abs(float(loss_x) - float(loss_a)) > LOSS_REL_BAR * abs(float(loss_a)):
                fail(f"train dp2ep2: a step from the restore {label} differs: {resume[label]}, "
                     f"in-memory loss {float(loss_a)}")
        del params_r, params_f
        parallel.save_params(paths["params"], state.params)
        serve_mesh = same_device_mesh(tp=tp, dev=dev)
        served = parallel.load_params(paths["params"], cfg, device=dev, mesh=serve_mesh)
        prompts = [rng.integers(0, cfg.vocab_size, 64).tolist() for _ in range(2)]
        tokens_restored = serve_tokens(server, served, cfg, dev, prompts, 8, mesh=serve_mesh)
        del served
        tokens_memory = serve_tokens(server, params_a, cfg, dev, prompts, 8, mesh=serve_mesh)
        if tokens_restored != tokens_memory:
            fail(f"train dp2ep2: restored weights serve {tokens_restored} at tp=2, in-memory "
                 f"{tokens_memory}")
        out["checkpoint"] = {"train_state_gb": os.path.getsize(paths["mesh"]) / 1e9,
                             "write_s": write_s, "read_no_mesh_s": read_free_s,
                             "read_mesh_s": read_mesh_s, "mesh_save_equals_mesh_free_save": True,
                             "restores_bit_equal": True, "in_memory_next_loss": float(loss_a),
                             "next_step_from_restore": resume}
        out["served"] = {"tp": tp, "requests": len(prompts), "new_tokens_each": 8,
                         "tokens_equal": True, "tokens": tokens_restored}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del state, params_a
    free_cuda()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out, {"qwen3_30b_a3b_train_dp2ep2": launches}


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
        if len(gmm_prefill) != 3 or not all(f["HGMMA"] for f in gmm_prefill):
            fail(f"cuobjdump -sass shows no HGMMA in a grouped-matmul prefill kernel: {sass['grouped_matmul']}")
        tgmm = [f for name, f in sass["grouped_matmul_tgmm"].items() if "tgmm_kernel" in name]
        if len(tgmm) != 1 or not tgmm[0]["HGMMA"]:
            fail(f"cuobjdump -sass shows no HGMMA in the tgmm kernel: {sass['grouped_matmul_tgmm']}")

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = (attention_checks(ops, models, llama, dev, gen) + check_grouped_matmul(ops, models, dev, gen)
               + check_grouped_matmul_backward(ops, dev, gen))
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
    result, launches = train_phase(pkg, ops, dev, card)
    by_path.update(launches)
    result["kernel_ms"] = {k["name"]: {key: k[key] for key in ("headline_form", "ms", "bound_ms",
                                                               "plain_ms", "library_ms")}
                           for k in kernels if k["name"] in TRAIN_KERNELS}
    emit(result)
    free_cuda()
    mesh_result, launches = train_mesh_phase(pkg, ops, dev, card, result)
    by_path.update(launches)
    emit(mesh_result)
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
