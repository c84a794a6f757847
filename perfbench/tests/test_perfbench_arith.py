"""The metrics' arithmetic on synthetic stamps and hand-worked shapes."""

import math
from types import SimpleNamespace

import pytest

from perfbench.bench import Run
from perfbench.load import Request
from perfbench.model import dims
from perfbench.probe import Slice, Step, merge
from perfbench.spec import metric
from perfbench.stats import percentile
from perfbench.work import PEAK_BF16_FLOPS, PEAK_BYTES_S, bound_s, decode_flops, prefill_flops

QWEN3_MOE = dict(vocab_size=151936, hidden_size=2048, intermediate_size=6144, num_hidden_layers=48,
                 num_attention_heads=32, num_key_value_heads=4, head_dim=128, rms_norm_eps=1e-6,
                 rope_theta=1e6, model_type="qwen3_moe", num_experts=128, num_experts_per_tok=8,
                 moe_intermediate_size=768, norm_topk_prob=True, tie_word_embeddings=False,
                 torch_dtype="bfloat16")
M = dims(QWEN3_MOE)


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
    from perfbench.probe import _distinct_ctx_per_row, _distinct_tokens

    a = SimpleNamespace(block_table=[1, 2, 3, 4])
    b = SimpleNamespace(block_table=[1, 2, 7])
    # a: 50 tokens over pages 1-4 (16+16+16+2); b: 40 over 1, 2 and 7 (8 in 7)
    assert _distinct_tokens([a, b], [50, 40], 16) == 16 + 16 + 16 + 2 + 8
    assert _distinct_ctx_per_row([a, b], [48, 32], 16) == [48, 0]


def test_rooflines_and_idle_from_a_slice():
    steps = [Step(1.0, 1.1, False, 1, 1, lanes=[1000], lane_kv_tokens=1000),
             Step(1.1, 1.2, True, 0, 1, rows=[(256, 0)], row_ctx_tokens=[0], idle_after=True),
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
