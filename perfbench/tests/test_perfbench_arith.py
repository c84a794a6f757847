"""The metrics' arithmetic on synthetic stamps and hand-worked shapes."""

import math
from types import SimpleNamespace

import pytest

from perfbench.bench import Run
from perfbench.load import Request
from perfbench.probe import Slice, Step, merge
from perfbench.spec import architecture, metric
from perfbench.stats import percentile
from perfbench.work import PEAK_BF16_FLOPS, PEAK_BYTES_S, bound_s, decode_flops, prefill_flops

QWEN3_MOE = dict(vocab_size=151936, hidden_size=2048, intermediate_size=6144, num_hidden_layers=48,
                 num_attention_heads=32, num_key_value_heads=4, head_dim=128, rms_norm_eps=1e-6,
                 rope_theta=1e6, model_type="qwen3_moe", num_experts=128, num_experts_per_tok=8,
                 moe_intermediate_size=768, norm_topk_prob=True, tie_word_embeddings=False,
                 torch_dtype="bfloat16")
M = architecture("qwen3_moe").dims(QWEN3_MOE)


def _req(due, first=None, finish=None, n=10, error=None, cached=0, prompt=100, start=None, arrival=None):
    seq = None
    if first is not None:
        seq = SimpleNamespace(first_token_time=first, finish_time=finish, num_generated=n,
                              num_cached_prompt=cached, user_prompt_len=prompt,
                              prefill_start_time=start, arrival_time=arrival)
    r = Request(session=0, turn=0, due=due, prompt=[0] * prompt, answer_len=n,
                submit_t=due, seq=seq, error=error, finished=seq is not None or error is not None)
    return r


def _run(requests=(), steps=(), w0=10.0, w1=20.0, sl=None, setup=42.0):
    cell = SimpleNamespace(mix={"limits": {}})
    return Run(cell, M, w0, w1, list(requests), list(steps), sl, setup_s=setup)


def test_percentile_nearest_rank_failures_last():
    assert percentile([3, 1, 2, 4], 50) == 2
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([1.0, math.inf], 50) == 1.0
    assert percentile([1.0, math.inf], 95) == math.inf


def test_ttft_counts_from_due_time_and_only_window_requests():
    reqs = [_req(9.0, first=9.5, finish=10.0),  # due before the window: not in the sample
            _req(10.0, first=10.2, finish=11.0),
            _req(11.0, first=11.1, finish=12.0),
            _req(12.0, first=12.6, finish=13.0),
            _req(20.0, first=20.1, finish=21.0)]  # due at the window's end: not in it
    run = _run(reqs)
    assert [r.due for r in run.sample] == [10.0, 11.0, 12.0]
    assert metric("ttft_p50_ms").read(run) == pytest.approx(200.0)
    assert metric("ttft_p95_ms").read(run) == pytest.approx(600.0)


def test_failed_request_sorts_last():
    reqs = [_req(10.0 + i / 2, first=10.1 + i / 2, finish=11.0 + i / 2) for i in range(19)]
    reqs.append(_req(15.5, error="engine failed"))
    run = _run(reqs)
    assert metric("ttft_p50_ms").read(run) == pytest.approx(100.0)
    assert metric("ttft_p95_ms").read(run) == pytest.approx(100.0)
    reqs.append(_req(16.5, error="refused"))
    assert metric("ttft_p95_ms").read(_run(reqs)) == math.inf
    assert metric("tpot_p95_ms").read(_run(reqs)) == math.inf


def test_tpot_is_span_over_tokens_after_the_first():
    run = _run([_req(10.0, first=10.5, finish=11.5, n=11)])
    assert metric("tpot_p95_ms").read(run) == pytest.approx(100.0)


def test_output_tokens_counted_inside_the_window_only():
    steps = [Step(8.0, 9.0, False, 4, 4, tokens=100),
             Step(9.5, 10.0, False, 4, 4, tokens=140),  # ends at the window's start
             Step(12.0, 13.0, False, 4, 4, tokens=200),
             Step(19.0, 20.0, False, 4, 4, tokens=300),  # ends at the window's end
             Step(20.0, 21.0, False, 4, 4, tokens=900)]
    assert metric("output_tok_per_s").read(_run(steps=steps)) == pytest.approx((300 - 140) / 10.0)


def test_queue_wait_and_prefix_hits():
    reqs = [_req(10.0 + i, first=10.5 + i, finish=11.0 + i, start=10.2 + i, arrival=10.0 + i,
                 cached=60, prompt=100) for i in range(3)]
    run = _run(reqs)
    assert metric("queue_wait_ms_p95").read(run) == pytest.approx(200.0)
    assert metric("prefix_hit_share").read(run) == pytest.approx(60.0)


def test_decode_step_and_mfu_hand_worked():
    steps = [Step(11.0, 11.1, False, 4, 4, lanes=[1000, 3000]),
             Step(11.2, 11.3, True, 0, 4, rows=[(500, 2000)]),
             Step(12.0, 12.1, False, 4, 4, lanes=[1000, 3000], in_slice=True)]
    run = _run(steps=steps)
    assert metric("decode_step_ms").read(run) == pytest.approx(100.0 / 4)
    flops = sum(decode_flops(M, c + j) for j in range(4) for c in (1000, 3000))
    assert metric("mfu.decode").read(run) == pytest.approx(100 * flops / 0.1 / PEAK_BF16_FLOPS)
    assert metric("mfu.prefill").read(run) == pytest.approx(
        100 * prefill_flops(M, 500, 2000) / 0.1 / PEAK_BF16_FLOPS)


def test_model_flops_hand_worked():
    # Qwen3-30B-A3B: attention 2048*(32+8)*128 + 4096*2048 = 18,874,368 a layer;
    # router 2048*128 = 262,144 and 8 experts of 3*2048*768 = 37,748,736;
    # 48 layers = 2,730,491,904 active parameters below the head.
    body = 48 * (18_874_368 + 262_144 + 37_748_736)
    head = 2048 * 151_936
    attn = 48 * 4 * 32 * 128 * 100  # one query over 99 earlier tokens and itself
    assert decode_flops(M, 100) == pytest.approx(2 * (body + head) + attn)
    causal = 48 * 4 * 32 * 128 * (10 * 50 + 10 * 11 / 2)
    assert prefill_flops(M, 10, 50) == pytest.approx(2 * body * 10 + 2 * head + causal)


def test_kernel_work_hand_worked():
    k1, k2 = metric("k1_decode_roofline"), metric("k2_prefill_roofline")
    # two lanes at 100 and 300 tokens: K and V of 400 tokens over 4 KV heads of
    # 128 in bf16, plus 2 lanes' queries and outputs over 32 heads
    assert k1.work(M, [100, 300], 400) == (400 * 2 * 4 * 128 * 2 + 2 * 2 * 32 * 128 * 2,
                                          4.0 * 32 * 128 * 400)
    # the two lanes share a 64-token prefix: its pages are read once
    assert k1.work(M, [100, 300], 336)[0] == 336 * 2 * 4 * 128 * 2 + 2 * 2 * 32 * 128 * 2
    n_bytes, flops = k2.work(M, [(64, 1024)], [1024])
    assert n_bytes == 64 * (2 * 32 + 2 * 4) * 128 * 2 + 1024 * 2 * 4 * 128 * 2
    assert flops == 4.0 * 32 * 128 * (64 * 1024 + 64 * 65 / 2)
    assert bound_s(3.35e9, 1.0) == pytest.approx(1e-3)
    assert bound_s(1.0, 989e9) == pytest.approx(1e-3)
    assert PEAK_BYTES_S == 3.35e12


def test_distinct_tokens_count_shared_pages_once():
    from perfbench.probe import _lane_kv_tokens, _row_ctx_tokens

    a = SimpleNamespace(block_table=[1, 2, 3, 4])
    b = SimpleNamespace(block_table=[1, 2, 7])
    # a: 50 tokens over pages 1-4 (16+16+16+2); b: 40 over 1, 2 and 7 (8 in 7);
    # each model step of a burst adds one token to each lane
    assert _lane_kv_tokens([a, b], [50, 40], 16, (None,), 2) == {None: (58, 60)}
    assert _row_ctx_tokens([a, b], [48, 32], 16, (None,)) == {None: [48, 0]}


def test_rooflines_and_idle_from_a_slice():
    steps = [Step(1.0, 1.1, False, 1, 1, lanes=[1000], lane_kv_tokens={None: (1000,)}),
             Step(1.1, 1.2, True, 0, 1, rows=[(256, 0)], row_ctx_tokens={None: [0]}, idle_after=True),
             Step(1.3, 1.4, False, 0, 1)]
    recs = [("void (anonymous namespace)::split_decode_kernel<__nv_bfloat16>", 1.00, 1.02),
            ("void (anonymous namespace)::combine_kernel(...)", 1.02, 1.03),
            ("flash_prefill_kernel<128>", 1.10, 1.15),
            ("gemm", 1.14, 1.16)]
    sl = Slice(i0=0, i1=3, t0=1.0, t1=1.4, records=recs)
    run = _run(steps=steps, sl=sl, w0=0.0, w1=5.0)
    k1, k2 = metric("k1_decode_roofline"), metric("k2_prefill_roofline")
    b1 = 48 * bound_s(*k1.work(M, [1000], 1000))
    assert k1.read(run) == pytest.approx(100 * b1 / 0.03)
    b2 = 48 * bound_s(*k2.work(M, [(256, 0)], [0]))
    assert k2.read(run) == pytest.approx(100 * b2 / 0.05)
    # busy: [1.00, 1.03] and [1.10, 1.16] = 0.09 s of the slice's 0.4 s, less
    # the 0.1 s the engine waited for work after the second step
    assert metric("idle_share.steps").read(run) == pytest.approx(70.0)
    assert k1.read(_run(steps=steps, sl=None)) is None


@pytest.mark.parametrize("extra, want", [
    # a burst launched before the wait runs 0.04 s inside it: that is work,
    # so the slice less the wait's 0.06 s the card sat idle
    ([("decode_burst", 1.22, 1.26)], 100 * (1 - 0.13 / 0.34)),
    # the card busy the whole wait: nothing of it is left out
    ([("decode_burst", 1.19, 1.31)], 100 * (1 - (0.03 + 0.06 + 0.12) / 0.4)),
    # records past the slice's end: busy over the time with work, not read
    ([("late", 1.16, 1.6)], None),
])
def test_idle_counts_device_work_inside_waits(extra, want):
    steps = [Step(1.0, 1.1, False, 1, 1, lanes=[1000]),
             Step(1.1, 1.2, True, 0, 1, rows=[(256, 0)], idle_after=True),
             Step(1.3, 1.4, False, 0, 1)]
    recs = [("k1", 1.00, 1.03), ("k2", 1.10, 1.16)] + extra
    run = _run(steps=steps, sl=Slice(i0=0, i1=3, t0=1.0, t1=1.4, records=recs), w0=0.0, w1=5.0)
    got = metric("idle_share.steps").read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_covered():
    from perfbench.readers import covered

    ivs = [(0.0, 1.0), (2.0, 3.0), (4.0, 5.0)]
    assert covered(0.5, 4.5, ivs) == pytest.approx(0.5 + 1.0 + 0.5)
    assert covered(1.0, 2.0, ivs) == 0.0
    assert covered(5.5, 6.0, ivs) == 0.0


def test_check_numbers_from_gaps():
    import torch

    from perfbench import check

    gaps = [torch.tensor([0.0, 0.3, 0.1]), torch.tensor([0.0, 0.25, 0.0, 0.0, 0.2])]
    got = check.numbers(gaps)
    assert set(got) == set(check.NUMBERS)
    assert got["logit_gap"] == pytest.approx(0.3)
    assert got["mean_logit_gap"] == pytest.approx(0.85 / 8)
    # 0.3 and 0.25 pass 0.2; 0.2 itself does not
    assert got["wide_gap_pct"] == pytest.approx(100 * 2 / 8)


def test_merge():
    assert merge([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


# --- Golden values: on both cells' configurations, every count and reader
# returns what the harness returned before it counted layer by layer
# (computed once with that code on the same runs, which counted every layer
# as full attention with one FFN kind).

PS = 16
SHARED = list(range(1, 129))  # 2,048 tokens of a shared system prompt


def _table(base, shared=True, n=600):
    return (SHARED if shared else []) + list(range(base, base + n))


#: (lanes' contexts, their tables' bases, shared prefix?) of the slice's
#: decode steps, and (rows of (chunk, context), bases, shared?) of its
#: prefills
SLICE_DECODE = [([2100, 3000, 4500], [1000, 2000, 3000], True),
                ([100, 2052], [5000, 6000], False),
                ([8000, 6000, 2500, 17], [7000, 8000, 9000, 10000], True)]
SLICE_PREFILL = [([(300, 2048), (250, 2048), (64, 4096)], [11000, 12000, 13000], True),
                 ([(512, 0)], [14000], False)]
K4_TOUCHED = [[4800, 5000, 4900, 5100], [4700, 4750, 4800, 4850]]
K1_NAME = "void (anonymous namespace)::split_decode_kernel<__nv_bfloat16, 128, 8>(Params)"
K2_NAME = "void (anonymous namespace)::flash_prefill_kernel<128>(Params)"
K4_NAME = "void (anonymous namespace)::decode_kernel<__nv_bfloat16, __nv_bfloat16>(Params)"
RECORDS = [(K1_NAME, 1.00, 1.02), ("void (anonymous namespace)::combine_kernel(Params)", 1.02, 1.025),
           (K4_NAME, 1.03, 1.09), (K2_NAME, 1.10, 1.16), (K1_NAME, 1.20, 1.23), (K2_NAME, 1.23, 1.26),
           (K4_NAME, 1.26, 1.35), (K1_NAME, 1.30, 1.36), ("gemm", 1.36, 1.39)]
WINDOW_DECODE = [(11.0, 11.1, [1000, 3000, 7000]), (12.0, 12.05, [50]), (12.5, 12.6, [8190, 4096])]
WINDOW_PREFILL = [(13.0, 13.2, [(500, 2000), (8000, 0), (64, 8128)], []),
                  (14.0, 14.1, [(100, 4096)], [300])]
DECODE_CTX = [1, 2, 100, 2048, 2049, 4097, 8192]
PREFILL = [(1, 0), (10, 50), (64, 2048), (300, 2048), (2048, 0), (4096, 4096), (8000, 0)]

GOLDEN = {
    "qwen3_30b_a3b": {
        "body_params": 2730491904,
        "decode_flops": [6084100096.0, 6084886528.0, 6161956864.0, 7693926400.0, 7694712832.0,
                         9305325568.0, 12525764608.0],
        "prefill_flops": [6084100096.0, 55668637696.0, 454840287232.0, 2157608697856.0,
                          12834789916672.0, 42161631920128.0, 68857462521856.0],
        "lane_kv_tokens": [5504, 2152, 12404], "row_ctx_tokens": [[2048, 0, 2048], [0]],
        "k1_work": [10289152, 157286400.0], "k2_work": [15097856, 15135113216.0],
        "k4_work": [47305457664, 115964116992.0],
        "k1_decode_roofline": 2.0562058216742374, "k2_prefill_roofline": 1.4465170905770461,
        "k4_decode_roofline": 73.24632018149246,
        "mfu.decode": 0.08875087890637007, "mfu.prefill": 24.977142167253206},
    "qwen3_8b": {
        "body_params": 6945767424,
        "decode_flops": [15136784384.0, 15137374208.0, 15195176960.0, 16344154112.0, 16344743936.0,
                         17552703488.0, 19968032768.0],
        "prefill_flops": [15136784384.0, 140487360512.0, 968839135232.0, 4557723533312.0,
                          29688662589440.0, 71745586331648.0, 130010250739712.0],
        "lane_kv_tokens": [5504, 2152, 12404], "row_ctx_tokens": [[2048, 0, 2048], [0]],
        "k1_work": [20529152, 157286400.0], "k2_work": [24231936, 15135113216.0], "k4_work": None,
        "k1_decode_roofline": 3.0787970741077224, "k2_prefill_roofline": 1.097408128380546,
        "k4_decode_roofline": None,
        "mfu.decode": 0.1691997713083923, "mfu.prefill": 47.33882116469447},
}


def _cell_dims(name):
    import json

    from perfbench.spec import HERE

    hf = json.loads((HERE / "configs" / f"{name}.json").read_text())["config"]
    return architecture(hf["model_type"]).dims(hf)


def golden_run(m, k=4):
    """A run whose profiled slice holds decode steps over a shared prefix
    and private contexts, multi-row prefills over a shared prefix, and
    step-record entries with K4's touched counts; its window holds
    decode-only, prefill and mixed steps. The slice's KV counts come from
    the probe's own counting on the lanes' block tables."""
    from perfbench.probe import _lane_kv_tokens, _row_ctx_tokens

    spans = tuple(m.spans)
    steps, t = [], 1.0
    for ctx, bases, shared in SLICE_DECODE:
        seqs = [SimpleNamespace(block_table=_table(b, shared)) for b in bases]
        steps.append(Step(t, t + 0.1, False, k, k, lanes=list(ctx), in_slice=True,
                          lane_kv_tokens=_lane_kv_tokens(seqs, ctx, PS, spans, k)))
        t += 0.1
    for rows, bases, shared in SLICE_PREFILL:
        seqs = [SimpleNamespace(block_table=_table(b, shared)) for b in bases]
        steps.append(Step(t, t + 0.1, True, 0, k, rows=list(rows), in_slice=True,
                          row_ctx_tokens=_row_ctx_tokens(seqs, [c for _, c in rows], PS, spans)))
        t += 0.1
    sl = Slice(i0=0, i1=len(steps), t0=1.0, t1=t, records=list(RECORDS))
    for a, b, lanes in WINDOW_DECODE:
        steps.append(Step(a, b, False, k, k, lanes=list(lanes)))
    for a, b, rows, lanes in WINDOW_PREFILL:
        steps.append(Step(a, b, True, k if lanes else 0, k, lanes=list(lanes), rows=list(rows)))
    cell = SimpleNamespace(pod={"decode_batch_size": 32}, mix={"limits": {}})
    run = Run(cell, m, 0.0, 30.0, [], steps, sl)
    run.program = {"clock_pair": [0, 0], "steps": [
        {"index": i, "kind": "decode", "device": [], "phases": {}, "counters": {"k4_touched": list(c)},
         "host": [("engine.step", int((1.0 + 0.1 * i) * 1e9), int((1.05 + 0.1 * i) * 1e9))]}
        for i, c in enumerate(K4_TOUCHED)]}
    return run


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_counts_equal_the_parents_on_both_cells(name):
    from perfbench import work

    want, m = GOLDEN[name], _cell_dims(name)
    run = golden_run(m)
    approx = lambda v: pytest.approx(v, rel=1e-9, abs=0)  # noqa: E731
    k1, k2, k4 = metric("k1_decode_roofline"), metric("k2_prefill_roofline"), metric("k4_decode_roofline")
    assert work.body_params(m) == want["body_params"]
    assert [work.decode_flops(m, c) for c in DECODE_CTX] == approx(want["decode_flops"])
    assert [work.prefill_flops(m, q, c) for q, c in PREFILL] == approx(want["prefill_flops"])
    lanes = [s for s in run.slice_steps if s.lanes]
    assert [s.lane_kv_tokens for s in lanes] == [
        {None: tuple(n + j * len(s.lanes) for j in range(4))} for n, s in zip(want["lane_kv_tokens"], lanes)]
    assert [s.row_ctx_tokens for s in run.slice_steps if s.rows] == [{None: r} for r in want["row_ctx_tokens"]]
    assert list(k1.work(m, [2100, 3000, 4500], 5000)) == approx(want["k1_work"])
    assert list(k2.work(m, [(300, 2048), (64, 4096)], [2048, 2048])) == approx(want["k2_work"])
    if want["k4_work"] is not None:
        assert list(k4.work(m, 32, 5000)) == approx(want["k4_work"])
    for reader in ("k1_decode_roofline", "k2_prefill_roofline", "k4_decode_roofline", "mfu.decode",
                   "mfu.prefill"):
        got = metric(reader).read(run)
        assert got == (None if want[reader] is None else approx(want[reader])), reader


# --- Windowed layers: a hand-built record of the 30B's attention widths
# whose first layer sees the whole context and the other three a window.

W = 64


def _windowed(spans, ffns=None):
    from perfbench.model import Dims, Ffn, Layer

    ffns = ffns or [Ffn(768, 128, 8)] * len(spans)
    attn = 2048 * (32 + 2 * 4) * 128 + 32 * 128 * 2048
    return Dims(vocab=151936, d=2048, heads=32, kv_heads=4, hd=128, eps=1e-6, theta=1e6, tie=False,
                dtype="bfloat16", stack=tuple(Layer(s, attn, f) for s, f in zip(spans, ffns)))


MIXED = _windowed((None, W, W, W))
FULL = _windowed((None, None, None, None))


def _decode_run(m, ctx, tables, k=4):
    from perfbench.probe import _lane_kv_tokens

    seqs = [SimpleNamespace(block_table=t) for t in tables]
    steps = [Step(1.0, 1.1, False, k, k, lanes=list(ctx), in_slice=True,
                  lane_kv_tokens=_lane_kv_tokens(seqs, ctx, PS, tuple(m.spans), k))]
    sl = Slice(i0=0, i1=1, t0=1.0, t1=1.2, records=[(K1_NAME, 1.0, 1.01)])
    return Run(SimpleNamespace(pod={}, mix={}), m, 0.0, 30.0, [], steps, sl)


def test_window_at_short_context_counts_as_full():
    """Every lane's context, through the burst, within the window: K1's
    bytes and FLOPs, and the model's FLOPs, are the all-full model's."""
    from perfbench import work

    tables = [[1, 2, 3, 20], [1, 2, 21]]  # a 32-token shared prefix
    ctx = [W - 10, 40]
    k1 = metric("k1_decode_roofline")
    assert k1.read(_decode_run(MIXED, ctx, tables)) == k1.read(_decode_run(FULL, ctx, tables))
    assert work.decode_flops(MIXED, W) == work.decode_flops(FULL, W)
    assert work.prefill_flops(MIXED, 30, W - 30) == work.prefill_flops(FULL, 30, W - 30)
    assert k1.work(MIXED, ctx, 100, W) == k1.work(MIXED, ctx, 100, None)


def test_window_past_its_span_counts_span_tokens():
    """A lone lane at 1,000 tokens: each windowed layer reads W tokens at
    every model step of the burst, the full layer the whole context."""
    from perfbench import work
    from perfbench.probe import _lane_kv_tokens

    table = [SimpleNamespace(block_table=list(range(100, 170)))]
    got = _lane_kv_tokens(table, [1000], PS, (None, W), 4)
    assert got == {None: (1000, 1001, 1002, 1003), W: (W, W, W, W)}
    assert metric("k1_decode_roofline").work(MIXED, [1000, 1003], 2 * W, W) == (
        2 * W * 2 * 4 * 128 * 2 + 2 * 2 * 32 * 128 * 2, 4.0 * 32 * 128 * 2 * W)
    def attention(m, ctx):
        return work.decode_flops(m, ctx) - 2.0 * (work.body_params(m) + m.d * m.vocab)

    assert attention(MIXED, 1000) == 4.0 * 32 * 128 * (1000 + 3 * W)
    # a 32-layer model with one full layer in four and a 2,048 window, at
    # 8,192 tokens: counting every layer full would read 2.29 x too much
    trinity_like = _windowed((2048, 2048, 2048, None) * 8)
    full = attention(_windowed((None,) * 32), 8192)
    assert full / attention(trinity_like, 8192) == pytest.approx(32 * 8192 / (8 * 8192 + 24 * 2048))


@pytest.mark.parametrize("queries, ctx, span", [
    (1, 0, W), (1, 200, W), (10, 50, W), (64, 0, W), (100, 0, W), (100, 30, W), (7, 60, W),
    (200, 500, W), (3, 2, 1), (5, 0, 2), (50, 10, None), (1, 99, None)])
def test_prefill_keys_match_a_causal_window_mask(queries, ctx, span):
    import torch

    from perfbench.work import attended_keys

    q = torch.arange(ctx, ctx + queries)[:, None]
    kpos = torch.arange(ctx + queries)[None, :]
    mask = kpos <= q
    if span is not None:
        mask &= q - kpos < span
    assert attended_keys(queries, ctx, span) == int(mask.sum())


def test_windowed_probe_counts_a_shared_page_once_edge_inside_it():
    """Two lanes share a 64-token prefix (pages 1-4); A is at 70 tokens
    (its own page 10), B at 75 (page 11). A window of 20 reads A's
    positions 50-69 and B's 55-74: page 4 (positions 48-63) is shared,
    its slots 2-15 read by A and 7-15 by B, so 14 tokens of it count, not
    a page each."""
    from perfbench.probe import _lane_kv_tokens, _row_ctx_tokens

    a = SimpleNamespace(block_table=[1, 2, 3, 4, 10])
    b = SimpleNamespace(block_table=[1, 2, 3, 4, 11])
    got = _lane_kv_tokens([a, b], [70, 75], PS, (None, 20), 2)
    assert got[20] == (14 + 6 + 11, (13 + 6 + 11) + 2)
    assert got[None] == (64 + 6 + 11, 64 + 6 + 11 + 2)
    # prefill rows at context 64 over the same prefix: the first query
    # sees 19 cached tokens (positions 45-63), the second row none new
    assert _row_ctx_tokens([a, b], [64, 64], PS, (None, 20)) == {None: [64, 0], 20: [19, 0]}


def test_k4_and_body_count_routed_layers_only():
    """Two leading dense layers of 6,144 and two routed layers (128 experts
    of 1,024, top 8, a shared expert of 1,024): K4 counts the routed
    layers at their width; the body counts every layer's own FFN."""
    from perfbench.model import Ffn
    from perfbench.work import body_params

    dense, routed = Ffn(6144), Ffn(1024, 128, 8, shared=1024)
    m = _windowed((None, None, W, None), [dense, dense, routed, routed])
    n_bytes, flops = metric("k4_decode_roofline").work(m, 32, 500)
    assert n_bytes == 500 * 3 * 2048 * 1024 * 2 + 2 * 256 * (2 * 2048 + 1024) * 2
    assert flops == 2 * 2.0 * 256 * 2048 * 1024 * 3
    attn = 2048 * 40 * 128 + 32 * 128 * 2048
    assert body_params(m) == 4 * attn + 2 * 3 * 2048 * 6144 + 2 * (2048 * 128 + 9 * 3 * 2048 * 1024)
