"""The port's step record (``server/step_record.py``): what it holds with
the switch on, that nothing of it runs with the switch off, its counters
against hand and numpy counts, and what ``step_stats``, the flight ring and
the pod read from it. CPU tests on the tiny presets; one test needs the
card (the graph-captured expert-group count against the eager one)."""

import json
import time

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig,
    Engine,
    EngineConfig,
    SamplingParams,
    SchedulerConfig,
)
from llm_d_kv_cache_manager_tpu_torch.server.decode_graphs import DecodeGraphs
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServer, PodServerConfig
from llm_d_kv_cache_manager_tpu_torch.server.step_record import (
    HOST_SPANS,
    PHASE_KEYS,
    StepEntry,
    StepRecord,
    phase_seconds,
)


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(1, 250, n).tolist()


def _config(model=llama.TINY_LLAMA, total_pages=64, k=1, pipeline=False, batch=2,
            chunked=None, **kw) -> EngineConfig:
    return EngineConfig(
        model=model,
        block_manager=BlockManagerConfig(total_pages=total_pages, page_size=4),
        scheduler=SchedulerConfig(max_prefill_batch=batch, chunked_prefill_tokens=chunked),
        max_model_len=128, decode_batch_size=4, decode_steps_per_iter=k,
        decode_pipeline=pipeline, **kw,
    )


def _engine(on=True, **kw) -> Engine:
    eng = Engine(_config(**kw), device="cpu")
    eng.obs_step_timing = on
    return eng


def _serve(eng, lengths, new=6):
    seqs = [eng.add_request(_prompt(i, n), SamplingParams(max_new_tokens=new))
            for i, n in enumerate(lengths)]
    eng.run_until_complete()
    return seqs


def _names(entry) -> list[str]:
    return [name for name, _, _ in entry.host]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


# -- the switch --------------------------------------------------------------
def test_off_by_default_keeps_nothing():
    eng = _engine(on=False)
    seqs = _serve(eng, [9, 13])
    assert eng.step_record is None and not eng.obs_step_timing
    assert all(v == 0 for v in eng.step_stats.values())
    assert all(s.commit_times is None for s in seqs)
    assert eng.decode_graphs.clock is None


def test_off_reads_no_clock(monkeypatch):
    """With the switch off a decode step reads neither clock, and a prefill
    step only the prefill-rate span's two ``perf_counter`` reads it always
    took."""
    eng = _engine(on=False)
    seqs = [eng.add_request(_prompt(3, 10), SamplingParams(max_new_tokens=8))]
    calls = {"monotonic_ns": 0, "perf_counter": 0}
    real = {name: getattr(time, name) for name in calls}

    def counting(name):
        def clock():
            calls[name] += 1
            return real[name]()
        return clock

    for name in calls:
        monkeypatch.setattr(time, name, counting(name))
    eng.step()  # prefill
    assert calls == {"monotonic_ns": 0, "perf_counter": 2}
    calls.update(monotonic_ns=0, perf_counter=0)
    eng.step()  # decode
    assert calls == {"monotonic_ns": 0, "perf_counter": 0}
    monkeypatch.undo()
    eng.run_until_complete()
    assert seqs[0].num_generated == 8


def test_off_records_no_device_mark(monkeypatch):
    """No timing mark and no counter on a burst with the switch off."""
    def refuse(self):
        raise AssertionError("a device mark was taken with the record off")

    monkeypatch.setattr(DecodeGraphs, "_mark", refuse)
    eng = _engine(on=False, model=llama.TINY_QWEN3_MOE, k=4, pipeline=True)
    _serve(eng, [9, 13], new=9)
    assert all(b.groups is None for b in eng.decode_graphs._graphs.values())


def test_switch_off_again_drops_the_record():
    eng = _engine()
    _serve(eng, [8])
    assert eng.step_record.entries
    eng.obs_step_timing = False
    assert eng.step_record is None and eng.decode_graphs.clock is None
    steps = eng.step_stats["steps"]
    _serve(eng, [8])
    assert eng.step_stats["steps"] == steps


# -- spans -------------------------------------------------------------------
def test_prefill_step_spans():
    eng = _engine()
    eng.add_request(_prompt(1, 10), SamplingParams(max_new_tokens=4))
    eng.step()
    (entry,) = eng.step_record.entries
    assert entry.kind == "prefill" and entry.index == 0
    assert _names(entry) == ["engine.schedule", "engine.prefill.prepare", "engine.prefill.launch",
                             "engine.prefill.sample", "engine.prefill.commit", "engine.publish",
                             "engine.step"]
    step = entry.host[-1]
    assert all(_inside(s, step) for s in entry.host)
    # The phases follow each other: each starts where the previous ended.
    chain = entry.host[1:5]
    assert all(a[2] == b[1] for a, b in zip(chain, chain[1:]))
    assert entry.device == []  # a prefill dispatch has no device span


def test_decode_step_spans():
    eng = _engine()
    eng.add_request(_prompt(1, 10), SamplingParams(max_new_tokens=4))
    eng.step()
    eng.step()
    entry = eng.step_record.entries[-1]
    assert entry.kind == "decode"
    assert _names(entry) == ["engine.schedule", "engine.decode.launch", "engine.decode.wait",
                             "engine.decode.commit", "engine.publish", "engine.step"]
    ((name, a, b),) = entry.device
    assert name == "device.decode" and a < b
    assert entry.counters == {"decode_steps": 1}


def test_prefill_drains_the_inflight_burst():
    """A prefill while a pipelined burst is in flight: the drain is its own
    span, holding that burst's wait and commit."""
    eng = _engine(k=2, pipeline=True)
    eng.add_request(_prompt(1, 10), SamplingParams(max_new_tokens=12))
    eng.step()
    eng.step()  # a burst left in flight
    eng.add_request(_prompt(2, 7), SamplingParams(max_new_tokens=4))
    eng.step()
    entry = eng.step_record.entries[-1]
    assert entry.kind == "prefill"
    (drain,) = [s for s in entry.host if s[0] == "engine.drain"]
    inner = [s for s in entry.host if s[0] in ("engine.decode.wait", "engine.decode.commit")]
    assert len(inner) == 2 and all(_inside(s, drain) for s in inner)
    assert entry.phases["prefill"] >= (drain[2] - drain[1]) / 1e9


def test_pipelined_burst_device_span_in_its_launching_step():
    eng = _engine(k=2, pipeline=True)
    eng.add_request(_prompt(1, 10), SamplingParams(max_new_tokens=9))
    eng.run_until_complete()
    decodes = [e for e in eng.step_record.entries if e.kind == "decode"]
    assert decodes and all(len(e.device) == 1 for e in decodes)
    for e in decodes:
        (_, a, b), step = e.device[0], e.host[-1]
        assert step[1] <= a  # launched in this step
    assert len({e.device[0][1] for e in decodes}) == len(decodes)


def test_mixed_step_kind():
    eng = _engine(chunked=8)
    eng.add_request(_prompt(1, 6), SamplingParams(max_new_tokens=8))
    eng.step()
    eng.add_request(_prompt(2, 20), SamplingParams(max_new_tokens=2))
    eng.step()
    kinds = [e.kind for e in eng.step_record.entries]
    assert kinds[0] == "prefill" and "mixed" in kinds
    mixed = next(e for e in eng.step_record.entries if e.kind == "mixed")
    assert [d[0] for d in mixed.device] == ["device.decode"]
    assert {"prefill_rows", "decode_steps"} <= set(mixed.counters)


def test_every_span_name_is_listed():
    eng = _engine(k=2, pipeline=True)
    _serve(eng, [9, 13, 5], new=7)
    seen = {name for e in eng.step_record.entries for name, _, _ in e.host}
    assert seen <= set(HOST_SPANS) | {"engine.step"}
    assert {e.kind for e in eng.step_record.entries} <= {"prefill", "decode", "mixed", "idle"}


# -- counters ----------------------------------------------------------------
def test_prefill_padding_counters_by_hand():
    """Two prompts of 19 and 5 tokens into a batch of 4 rows: one chunk of
    64 (the bucket), 24 valid tokens of 256 computed."""
    eng = _engine(batch=4)
    eng.add_request(_prompt(1, 19), SamplingParams(max_new_tokens=2))
    eng.add_request(_prompt(2, 5), SamplingParams(max_new_tokens=2))
    eng.step()
    c = eng.step_record.entries[0].counters
    assert (c["prefill_rows"], c["prefill_chunk"], c["prefill_valid_tokens"]) == (4, 64, 24)


def _routing_counts(monkeypatch):
    """Hook the router: the distinct experts each call's rows choose."""
    seen = []
    real = llama._moe_gates

    def gates(layer, cfg, x):
        topv, topi = real(layer, cfg, x)
        seen.append(len(np.unique(topi.numpy())))
        return topv, topi

    monkeypatch.setattr(llama, "_moe_gates", gates)
    return seen


@pytest.mark.parametrize("preset", ["TINY_MOE", "TINY_QWEN3_MOE"])
@pytest.mark.parametrize("gmm", ["auto", "xla"])
def test_k4_touched_against_numpy_routing(monkeypatch, preset, gmm):
    """``decode_steps``' expert-group count equals the distinct experts the
    router picked, summed over layers, at each model step (padded lanes
    route too)."""
    import dataclasses

    cfg = dataclasses.replace(getattr(llama, preset), moe_gmm=gmm)
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, gen, torch.device("cpu"))
    k_pages, v_pages = llama.init_kv_pages(cfg, 16, 4, torch.device("cpu"))
    b, steps = 3, 3
    seen = _routing_counts(monkeypatch)
    groups = torch.zeros(steps, dtype=torch.int32)
    llama.decode_steps(
        params, cfg, torch.tensor([5, 9, 0], dtype=torch.int32),
        torch.tensor([2, 4, 0], dtype=torch.int32), k_pages, v_pages,
        torch.tensor([[1, 2], [3, 4], [0, 0]], dtype=torch.int32),
        torch.tensor([3, 5, 0], dtype=torch.int32), torch.zeros(b), torch.zeros(b, dtype=torch.int32),
        torch.ones(b), torch.Generator().manual_seed(1), page_size=4, num_steps=steps,
        expert_groups=groups,
    )
    per_step = np.asarray(seen).reshape(steps, cfg.n_layers).sum(axis=1)
    assert groups.tolist() == per_step.tolist()
    assert all(cfg.n_layers <= g <= cfg.n_layers * cfg.n_experts for g in groups.tolist())


def test_k4_touched_per_model_step_in_the_engine(monkeypatch):
    seen = _routing_counts(monkeypatch)
    eng = _engine(model=llama.TINY_QWEN3_MOE, k=4, pipeline=True)
    _serve(eng, [9, 13], new=9)
    decode_calls = []
    n_layers = llama.TINY_QWEN3_MOE.n_layers
    for e in eng.step_record.entries:
        if "decode_steps" in e.counters:
            assert len(e.counters["k4_touched"]) == e.counters["decode_steps"]
            decode_calls += e.counters["k4_touched"]
    # Prefill calls route too: the decode calls are the last ones of each
    # burst's model steps, in order.
    sums = [sum(seen[i:i + n_layers]) for i in range(0, len(seen), n_layers)]
    assert decode_calls and all(c in sums for c in decode_calls)


def test_graphs_captured_before_the_switch_count_nothing():
    eng = _engine(on=False, model=llama.TINY_QWEN3_MOE, k=2)
    _serve(eng, [9])
    eng.obs_step_timing = True
    _serve(eng, [10])
    decodes = [e for e in eng.step_record.entries if "decode_steps" in e.counters]
    assert decodes and all("k4_touched" not in e.counters for e in decodes)


def test_dense_model_counts_no_expert_groups():
    eng = _engine(k=2)
    _serve(eng, [9])
    assert not any("k4_touched" in e.counters for e in eng.step_record.entries)


def test_preemption_counters(monkeypatch):
    """A pool too small for two sequences: one is preempted, and each
    sequence's ``num_preemptions`` counts its own folds."""
    from llm_d_kv_cache_manager_tpu_torch.server.step_record import EngineSequence

    folds: dict[str, int] = {}
    fold = EngineSequence.fold_for_preemption

    def counting(self):
        folds[self.request_id] = folds.get(self.request_id, 0) + 1
        return fold(self)

    monkeypatch.setattr(EngineSequence, "fold_for_preemption", counting)
    eng = _engine(total_pages=9, batch=2)
    seqs = _serve(eng, [10, 10], new=14)
    assert sum(folds.values()) >= 1
    assert {s.request_id: s.num_preemptions for s in seqs if s.num_preemptions} == folds
    assert all(s.num_generated == 14 for s in seqs)


def test_preemption_counted_with_the_record_off():
    eng = _engine(on=False, total_pages=9, batch=2)
    seqs = _serve(eng, [10, 10], new=14)
    assert sum(s.num_preemptions for s in seqs) >= 1


@pytest.mark.parametrize("k, pipeline", [(1, False), (4, True)])
def test_commit_times_sum_to_num_generated(k, pipeline):
    eng = _engine(k=k, pipeline=pipeline)
    seqs = _serve(eng, [9, 13, 6], new=11)
    for s in seqs:
        assert sum(n for _, n in s.commit_times) == s.num_generated == 11
        stamps = [t for t, _ in s.commit_times]
        assert stamps == sorted(stamps)
        assert s.commit_times[0][1] == 1  # the first token commits alone
    if k > 1:
        assert any(n > 1 for s in seqs for _, n in s.commit_times)


def test_ring_is_bounded():
    eng = _engine()
    eng.step_record = StepRecord(None, eng.device, eng.step_stats, capacity=5)
    _serve(eng, [9, 13], new=12)
    entries = list(eng.step_record.entries)
    assert len(entries) == 5 and eng.step_stats["steps"] > 5
    assert [e.index for e in entries] == list(range(entries[0].index, entries[0].index + 5))


# -- what reads the record -----------------------------------------------------
def test_step_stats_are_the_record_folded():
    eng = _engine(k=2, pipeline=True)
    _serve(eng, [9, 13, 5], new=7)
    entries = list(eng.step_record.entries)
    assert list(eng.step_stats) == ["steps"] + list(PHASE_KEYS)
    assert eng.step_stats["steps"] == len(entries)
    for key in PHASE_KEYS:
        assert eng.step_stats[key] == pytest.approx(sum(e.phases[key[:-2]] for e in entries))
    # sample_s holds every blocking fetch of sampled ids, as before.
    waits = sum(b - a for e in entries for name, a, b in e.host
                if name in ("engine.prefill.sample", "engine.decode.wait"))
    assert eng.step_stats["sample_s"] == pytest.approx(waits / 1e9)
    assert eng.step_stats["prefill_s"] > 0 and eng.step_stats["decode_s"] > 0


def test_phase_seconds_by_hand():
    ms = 1_000_000
    entry = StepEntry(0, kind="mixed", counters={"gather_s": 0.25})
    entry.host = [("engine.schedule", 0, 1 * ms), ("engine.decode.wait", 1 * ms, 3 * ms),
                  ("engine.decode.commit", 3 * ms, 4 * ms), ("engine.drain", 1 * ms, 4 * ms),
                  ("engine.prefill.launch", 4 * ms, 9 * ms), ("engine.decode.launch", 9 * ms, 11 * ms),
                  ("engine.publish", 11 * ms, 12 * ms), ("engine.step", 0, 12 * ms)]
    p = phase_seconds(entry)
    assert p["schedule"] == pytest.approx(0.001)
    assert p["prefill"] == pytest.approx(0.008)  # the drain and the prefill
    assert p["decode"] == pytest.approx(0.002)
    assert p["sample"] == pytest.approx(0.002)
    assert (p["publish"], p["gather"], p["demote"]) == (pytest.approx(0.001), 0.25, 0.0)


def test_cpu_anchor_places_host_marks_on_monotonic():
    eng = _engine()
    rec = eng.step_record
    p, ns = time.perf_counter(), time.monotonic_ns()
    assert abs(rec.to_ns(p) - ns) < 1_000_000
    assert rec.to_ns(12345) == 12345  # a mark already placed
    wall, mono = rec.clock_pair
    assert abs((time.time_ns() - wall) - (time.monotonic_ns() - mono)) < 50_000_000


@pytest.mark.parametrize("age_s, taken", [(5, False), (15, True)])
def test_anchor_taken_again_when_old(age_s, taken):
    """A drain takes the anchor again once it is ``ANCHOR_AGE_NS`` old."""
    from llm_d_kv_cache_manager_tpu_torch.server.step_record import ANCHOR_AGE_NS

    eng = _engine(k=2, pipeline=True)
    rec = eng.step_record
    old = (rec._anchor[0] - age_s, rec._anchor[1] - age_s * 1_000_000_000)
    rec._anchor = old
    assert (age_s * 1_000_000_000 > ANCHOR_AGE_NS) == taken
    eng.add_request(_prompt(1, 10), SamplingParams(max_new_tokens=12))
    eng.step()
    eng.step()  # a burst left in flight
    assert rec._anchor == old
    eng.add_request(_prompt(2, 7), SamplingParams(max_new_tokens=4))
    eng.step()  # drains it
    assert (rec._anchor != old) == taken
    p, ns = time.perf_counter(), time.monotonic_ns()
    assert abs(rec.to_ns(p) - ns) < 1_000_000  # either anchor places marks alike


def test_any_step_takes_a_very_old_anchor_again():
    from llm_d_kv_cache_manager_tpu_torch.server.step_record import ANCHOR_MAX_AGE_NS

    eng = _engine()
    rec = eng.step_record
    rec._anchor = (rec._anchor[0], rec._anchor[1] - ANCHOR_MAX_AGE_NS - 1)
    old = rec._anchor
    eng.add_request(_prompt(1, 10), SamplingParams(max_new_tokens=2))
    eng.step()
    assert rec._anchor != old


def test_export_is_plain_json():
    eng = _engine(model=llama.TINY_QWEN3_MOE, k=2)
    _serve(eng, [9])
    out = json.loads(json.dumps(eng.step_record.export()))
    assert len(out["steps"]) == len(eng.step_record.entries)
    assert {"clock_pair", "anchor_monotonic_ns"} <= set(out)
    assert out["steps"][0]["host"][-1][0] == "engine.step"


def _pod(**cfg) -> PodServer:
    econf = _config(**cfg.pop("engine_kw", {}))
    server = PodServer(
        PodServerConfig(model_name="tiny", pod_identifier="trace-pod", publish_events=False,
                        engine=econf, **cfg),
        engine=Engine(econf, device="cpu"),
    )
    server.start()
    return server


def test_pod_spans_around_each_step():
    server = _pod(obs_metrics=True)
    try:
        server.generate(_prompt(4, 10), SamplingParams(max_new_tokens=5), timeout=60)
    finally:
        server.shutdown()
    entries = list(server.engine.step_record.entries)
    assert entries
    for e in entries:
        names = _names(e)
        step = next(s for s in e.host if s[0] == "engine.step")
        admits = [s for s in e.host if s[0] == "pod.admit"]
        resolves = [s for s in e.host if s[0] == "pod.resolve"]
        assert len(admits) == 1 and admits[0][2] <= step[1]
        assert len(resolves) == 1 and resolves[0][1] >= step[2]
        assert names.count("engine.step") == 1


def test_flight_ring_reads_the_record():
    server = _pod(obs_flight=True)
    try:
        for i in range(2):
            server.generate(_prompt(5 + i, 9), SamplingParams(max_new_tokens=4), timeout=60)
        server.flight.trigger("test")
    finally:
        server.shutdown()
    ring = [e for e in server.flight.timeline()["entries"] if e["kind"] == "step"]
    entries = list(server.engine.step_record.entries)
    assert len(ring) == len(entries) and all(r["steps"] == 1 for r in ring)
    for r, e in zip(ring, entries):
        want = {k: v for k, v in e.phases.items() if v > 0}
        assert set(r["phases"]) == {k for k, v in want.items() if round(v, 6) > 0}
        for k, v in r["phases"].items():
            assert v == pytest.approx(want[k], abs=2e-6)


@pytest.mark.parametrize("metrics", [False, True])
def test_host_prefetch_span_and_bringback(metrics):
    """``OBS_TRACING`` alone leaves the record off and still traces each
    prefetch round; with the record on, each round is also its
    ``engine.host_prefetch`` span, over the same interval."""
    econf = EngineConfig(
        model=llama.TINY_LLAMA,
        block_manager=BlockManagerConfig(total_pages=12, page_size=4, host_pages=32),
        scheduler=SchedulerConfig(max_prefill_batch=2), max_model_len=128,
        decode_batch_size=4, host_prefetch=True, host_tier_policy="always",
    )
    server = PodServer(
        PodServerConfig(model_name="tiny", pod_identifier="pf-pod", publish_events=False,
                        obs_tracing=True, obs_metrics=metrics, engine=econf),
        engine=Engine(econf, device="cpu"),
    )
    server.start()
    try:
        assert server.engine.obs_step_timing == metrics
        prompts = [_prompt(120 + i, 16) for i in range(3)]
        for p in prompts + [prompts[0]]:
            server.generate(p, SamplingParams(max_new_tokens=3), timeout=120)
        spans = [s for trace in server.tracer.traces(limit=1000) for s in trace["spans"]
                 if s["name"] == "pod.host_bringback"]
    finally:
        server.shutdown()
    assert spans
    assert sum(s["attrs"]["pages"] for s in spans) == server.engine.host_prefetch_stats["pages"]
    if metrics:
        rounds = [(a, b) for e in server.engine.step_record.entries
                  for name, a, b in e.host if name == "engine.host_prefetch"]
        assert len(rounds) == len(spans)
        durations = sorted((b - a) / 1e9 for a, b in rounds)
        assert sorted(s["duration_s"] for s in spans) == pytest.approx(durations, abs=2e-6)


@pytest.mark.cuda
def test_graph_captured_k4_touched_equals_eager():
    """On the card: a burst replayed from a graph captured with the record
    on counts the expert groups the eager burst over the same inputs
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: decode bursts are graph replays only there")
    import dataclasses

    # The kernels' widths: K1 is built for heads of 128, K4 for bf16.
    cfg = dataclasses.replace(llama.TINY_QWEN3_MOE, head_dim=128, n_experts=16,
                              dtype=torch.bfloat16)
    dev = torch.device("cuda")
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    k_pages, v_pages = llama.init_kv_pages(cfg, 16, 4, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    graphs = DecodeGraphs(params, cfg, k_pages, v_pages, None, None, lanes=4, max_pages=4,
                          page_size=4, generator=gen, device=dev, chain=False)
    rec = StepRecord(torch.cuda.current_stream(dev), dev,
                     {"steps": 0, **dict.fromkeys(PHASE_KEYS, 0.0)})
    graphs.clock = rec.to_ns
    lanes = np.array([3, 5, 0, 0], np.int32)
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0] * 4, [0] * 4], np.int32)
    # Inactive lanes (length 0) sit at position 0, as the engine leaves them.
    args = (np.array([5, 9, 0, 0], np.int32), np.maximum(lanes - 1, 0), lanes, tables,
            np.zeros(4, np.float32), np.zeros(4, np.int32), np.ones(4, np.float32))
    burst = graphs.dispatch(2, *args)
    burst.tokens()
    replayed = burst.expert_groups()
    eager = torch.zeros(2, dtype=torch.int32, device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    llama.decode_steps(params, cfg, t(args[0]), t(args[1]), k_pages.clone(), v_pages.clone(),
                       t(tables), t(lanes), t(args[4]), t(args[5]), t(args[6]),
                       torch.Generator(device=dev).manual_seed(1), page_size=4, num_steps=2,
                       expert_groups=eager)
    assert replayed == eager.tolist()
    # The graph records its own start event: a second replay places the
    # first burst's start before recording it again.
    again = graphs.dispatch(2, *args)
    again.tokens()
    assert isinstance(burst.start, int)
    first = (burst.start, rec.to_ns(burst.stop))
    second = (rec.to_ns(again.start), rec.to_ns(again.stop))
    assert first[0] < first[1] <= second[0] < second[1]
