"""The readers of the program's step record on synthetic runs: the clock
mapping, the idle split, K4's kernel match and bound, the padding and
commit-gap arithmetic, and that each reads nothing (and raises nothing) for
a run without the record."""

import math
from types import SimpleNamespace

import pytest

from perfbench import program
from perfbench.probe import Step
from perfbench.spec import architecture, metric
from perfbench.work import bound_s

MS = 1_000_000  # ns
NEW = ("decode_device_ms", "prefill_pad_share", "k4_decode_roofline", "idle_share.loop",
       "idle_share.prefill_host", "idle_share.decode_host", "idle_share.step_host",
       "preempted_share", "commit_gap_ms_p95")

#: the K4 and K1 decode kernels' names as the profiler gives them (the
#: ledger prints these with their punctuation turned to ``_``:
#: ``void__anonymous_namespace_::decode_kernel___nv_bfloat16____nv_bf`` and
#: ``void__anonymous_namespace_::split_decode_kernel___nv_bfloat16___``)
K4_NAME = "void (anonymous namespace)::decode_kernel<__nv_bfloat16, __nv_bfloat16>(Params)"
K1_NAME = "void (anonymous namespace)::split_decode_kernel<__nv_bfloat16, 128, 8>(Params)"

M30 = architecture("qwen3_moe").dims(dict(
    vocab_size=151936, hidden_size=2048, intermediate_size=6144, num_hidden_layers=48,
    num_attention_heads=32, num_key_value_heads=4, head_dim=128, rope_theta=1e6, rms_norm_eps=1e-6,
    model_type="qwen3_moe", tie_word_embeddings=False, num_experts=128, num_experts_per_tok=8,
    moe_intermediate_size=768, norm_topk_prob=True, torch_dtype="bfloat16"))


def _entry(index, kind, host, device=(), **counters):
    return {"index": index, "kind": kind, "host": list(host), "device": list(device),
            "counters": counters, "phases": {}}


def _run(steps=(), slice_=None, slice_steps=(), w=(0.0, 100.0), sample=(), m=M30, lanes=32,
         clock_pair=(5_000 * 10**9, 0)):
    run = SimpleNamespace(w0=w[0], w1=w[1], slice=slice_, slice_steps=list(slice_steps),
                          layer_sample=list(sample), m=m,
                          cell=SimpleNamespace(pod={"decode_batch_size": lanes}),
                          failed=lambda r: r.seq is None)
    run.program = {"steps": list(steps), "clock_pair": list(clock_pair), "anchor_monotonic_ns": 0}
    return run


@pytest.mark.parametrize("name", NEW)
def test_reads_nothing_without_the_record(name):
    run = _run()
    run.program = None
    run.layer_sample = [SimpleNamespace(seq=SimpleNamespace(num_generated=3))]
    assert metric(name).read(run) is None


def test_k4_match_takes_only_k4s_decode_kernel():
    mod = metric("k4_decode_roofline")
    assert any(p in K4_NAME for p in mod.KERNELS)
    assert not any(p in K1_NAME for p in mod.KERNELS)
    assert not any(p in "void (anonymous namespace)::prefill_kernel<__nv_bfloat16, false>"
                   for p in mod.KERNELS)


def test_k4_roofline_from_the_touched_count():
    """Two decode model steps touching 4,800 and 5,000 expert groups; K4's
    decode kernel ran 30 ms in the slice."""
    sl = SimpleNamespace(t0=1.0, t1=2.0, records=[(K4_NAME, 1.1, 1.115), (K4_NAME, 1.2, 1.215),
                                                  (K1_NAME, 1.3, 1.4)])
    entry = _entry(0, "decode", [("engine.step", int(1.05e9), int(1.3e9))],
                   decode_steps=2, k4_touched=[4800, 5000])
    run = _run([entry], slice_=sl)
    w = 3 * 2048 * 768 * 2
    acts = 48 * 256 * (2 * 2048 + 768) * 2
    flops = 48 * 2.0 * 256 * 2048 * 768 * 3
    want = 100 * (bound_s(4800 * w + acts, flops) + bound_s(5000 * w + acts, flops)) / 0.030
    assert metric("k4_decode_roofline").read(run) == pytest.approx(want)
    assert 0 < want < 100


def test_clock_mapping_by_the_pair():
    """The profiler's base is the wall clock: the pair takes a record to
    monotonic seconds."""
    sl = SimpleNamespace(t0=10.0, t1=11.0, trace_start_ns=5_010 * 10**9 + 2 * MS,
                         raw_records=[("k", 500.0, 1500.0)])
    run = _run(slice_=sl, steps=[_entry(0, "idle", [("engine.step", 0, 1)])])
    ((name, a, b),) = program.mapped_records(run)
    assert name == "k" and a == pytest.approx(10.0025) and b == pytest.approx(10.0035)


def _split_run():
    """A 10 ms slice: the pod loop 0-1 ms; a step 1-9 ms with schedule
    1-2, a drain 2-4 holding a decode wait 2-3 and commit 3-4, a prefill
    launch 4-7, publish 8-9 (7-8 the step's own time); the loop again
    9-10. The card runs 2.5-3 and 5-6 ms."""
    t0 = 100 * MS
    at = lambda ms: t0 + int(ms * MS)  # noqa: E731
    host = [("engine.schedule", at(1), at(2)), ("engine.decode.wait", at(2), at(3)),
            ("engine.decode.commit", at(3), at(4)), ("engine.drain", at(2), at(4)),
            ("engine.prefill.launch", at(4), at(7)), ("engine.publish", at(8), at(9)),
            ("engine.step", at(1), at(9)), ("pod.resolve", at(9), at(9.5))]
    entry = _entry(0, "prefill", [("pod.admit", at(0), at(1))] + host, prefill_rows=2)
    base_wall = 7 * 10**9  # the pair: wall - mono = 7 s
    sl = SimpleNamespace(t0=0.1, t1=0.11, trace_start_ns=base_wall + t0,
                         raw_records=[("k", 2500.0, 3000.0), ("k", 5000.0, 6000.0)])
    steps = [Step(0.101, 0.109, True, 0, 1)]
    return _run([entry], slice_=sl, slice_steps=steps, clock_pair=(base_wall, 0))


def test_idle_split_by_innermost_span():
    run = _split_run()
    idle, working = program.idle_by_span(run)
    assert working == pytest.approx(0.010)
    want = {"pod.admit": 1.0, "engine.schedule": 1.0, "engine.decode.wait": 0.5,
            "engine.decode.commit": 1.0, "engine.prefill.launch": 2.0, "engine.step": 1.0,
            "engine.publish": 1.0, "pod.resolve": 0.5, "outside": 0.5}
    assert {k: round(v * 1e3, 9) for k, v in idle.items()} == pytest.approx(want)
    shares = {g: metric(f"idle_share.{g}").read(run)
              for g in ("loop", "prefill_host", "decode_host", "step_host")}
    assert shares == pytest.approx({"loop": 20.0, "prefill_host": 20.0, "decode_host": 15.0,
                                    "step_host": 30.0})
    # The four sum to the idle share on the same placement: 1.5 ms busy.
    assert sum(shares.values()) == pytest.approx(100 * (1 - 0.0015 / 0.010))


def test_idle_split_leaves_out_waits_for_arrivals():
    """A step that ends with nothing ready: the wait after it, where no
    record runs, is not time with work."""
    run = _split_run()
    run.slice_steps = [Step(0.101, 0.102, False, 0, 1, idle_after=True),
                       Step(0.106, 0.109, True, 0, 1)]
    idle, working = program.idle_by_span(run)
    # The wait 2-6 ms holds the record 5-6 and 2.5-3: 2.5 ms of it idle.
    assert working == pytest.approx(0.010 - 0.0025)
    assert sum(idle.values()) == pytest.approx(working - 0.0015)


def test_decode_device_ms_over_the_windows_decode_steps():
    s = 10**9
    steps = [
        _entry(0, "decode", [("engine.step", 1 * s, 1 * s + 20 * MS)],
               [("device.decode", 1 * s + 2 * MS, 1 * s + 18 * MS)], decode_steps=4),
        _entry(1, "decode", [("engine.step", 2 * s, 2 * s + 20 * MS)],
               [("device.decode", 2 * s + 1 * MS, 2 * s + 25 * MS)], decode_steps=4),
        _entry(2, "mixed", [("engine.step", 3 * s, 3 * s + 30 * MS)],
               [("device.decode", 3 * s, 3 * s + 30 * MS)], decode_steps=4, prefill_rows=2),
        # In the profiled slice: left out.
        _entry(3, "decode", [("engine.step", 8 * s, 8 * s + 20 * MS)],
               [("device.decode", 8 * s, 8 * s + 90 * MS)], decode_steps=4),
    ]
    run = _run(steps, slice_=SimpleNamespace(t0=7.5, t1=9.0), w=(0.5, 10.0))
    assert metric("decode_device_ms").read(run) == pytest.approx((16 + 24) / 8)


def test_prefill_pad_share_by_hand():
    s = 10**9
    steps = [
        _entry(0, "prefill", [("engine.step", 1 * s, 2 * s)], prefill_rows=8, prefill_chunk=384,
               prefill_valid_tokens=350),
        _entry(1, "prefill", [("engine.step", 3 * s, 4 * s)], prefill_rows=8, prefill_chunk=64,
               prefill_valid_tokens=100),
        _entry(2, "prefill", [("engine.step", 20 * s, 21 * s)], prefill_rows=8,
               prefill_chunk=64, prefill_valid_tokens=64),  # after the window
    ]
    run = _run(steps, w=(0.5, 10.0))
    computed = 8 * 384 + 8 * 64
    assert metric("prefill_pad_share").read(run) == pytest.approx(100 * (computed - 450) / computed)


def test_commit_gaps():
    seq = SimpleNamespace(commit_times=[(0, 1), (30 * MS, 4), (70 * MS, 4), (75 * MS, 2)])
    assert program.commit_gaps_s(seq) == pytest.approx([0.03, 0, 0, 0, 0.04, 0, 0, 0, 0.005, 0])
    reqs = [SimpleNamespace(seq=seq)] * 3
    run = _run(sample=reqs)
    assert metric("commit_gap_ms_p95").read(run) == pytest.approx(40.0)


def test_preempted_share():
    seqs = [SimpleNamespace(num_preemptions=n) for n in (0, 0, 1, 2)]
    run = _run(sample=[SimpleNamespace(seq=s) for s in seqs])
    assert metric("preempted_share").read(run) == 50.0
    none = _run(sample=[SimpleNamespace(seq=SimpleNamespace(num_preemptions=0))])
    assert metric("preempted_share").read(none) == 0.0
    assert math.isfinite(metric("preempted_share").read(run))
