"""The port's ``Engine(device="cpu")`` against the JAX package's ``Engine``
on the same parameters, driven through the scenarios of
``tests/test_engine.py`` (basics, prefix caching, event emission,
preemption), on TINY_LLAMA and, as further cases of the same
parametrisation, on TINY_MOE, TINY_QWEN3_MOE, a TINY_QWEN3_MOE engine
with int8 weights and int8 experts (``quantize="int8",
quantize_experts=True``, applied by each engine to the same full-precision
parameters) and a TINY_LLAMA engine on int8 KV pages
(``kv_quant_hbm="int8"``). In every scenario three things must be equal:
greedy outputs (and what the engine reports about each request),
``prefill_stats["tokens_computed"]``, and the emitted event lists compared
as the msgpack bytes of ``EventBatch``. On int8 pages the final pools must
hold the same codes, and scales within rtol 1e-6 (the two frameworks'
float32 matmuls write K/V that differ in their last bits; see
``test_torch_kv_quant_hbm.py``).
"""

import functools
import time

import jax
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.kvcache.kvevents.events import EventBatch as JEventBatch
from llm_d_kv_cache_manager_tpu.models import TINY_LLAMA as J_TINY
from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu.server import (
    BlockManagerConfig as JBM,
    Engine as JEngine,
    EngineConfig as JEC,
    SamplingParams as JSP,
    SchedulerConfig as JSC,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents.events import EventBatch as TEventBatch
from llm_d_kv_cache_manager_tpu_torch.models import params_from_jax
from llm_d_kv_cache_manager_tpu_torch.models import quant as t_quant
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig as TBM,
    Engine as TEngine,
    EngineConfig as TEC,
    SamplingParams as TSP,
    SchedulerConfig as TSC,
)

PS = 4
MODEL = "tiny-llama"
#: engine model -> (preset name in both packages, quantize mode, KV pool mode)
MODELS = {
    "tiny-llama": ("TINY_LLAMA", None, None),
    "tiny-moe": ("TINY_MOE", None, None),
    "tiny-qwen3-moe": ("TINY_QWEN3_MOE", None, None),
    "tiny-qwen3-moe-int8": ("TINY_QWEN3_MOE", "int8", None),
    "tiny-llama-kvq": ("TINY_LLAMA", None, "int8"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _params(preset):
    """Full-precision parameters of ``preset``, JAX's and their port."""
    jp = jl.init_params(jax.random.PRNGKey(0), getattr(jl, preset))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), getattr(tl, preset), "cpu")


@pytest.fixture(scope="module")
def params():
    return _params("TINY_LLAMA")


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, J_TINY.vocab_size, n)]


class _Side:
    """One framework's engine plus the events it emitted."""

    def __init__(self, torch_side, params, total_pages, decode_batch, max_model_len, prefill_batch,
                 model="tiny-llama", **engine_knobs):
        """``engine_knobs``: further ``EngineConfig`` fields, the same for
        both frameworks (the decode fast path's, in its tests)."""
        self.events = []
        sink = lambda evs: self.events.append(list(evs))  # noqa: E731
        preset, quantize, kv_quant_hbm = MODELS[model]
        knobs = dict(quantize=quantize, quantize_experts=quantize is not None,
                     kv_quant_hbm=kv_quant_hbm, **engine_knobs)
        if torch_side:
            self.SP = TSP
            self.batch_cls = TEventBatch
            cfg = TEC(model=getattr(tl, preset),
                      block_manager=TBM(total_pages=total_pages, page_size=PS),
                      scheduler=TSC(max_prefill_batch=prefill_batch),
                      max_model_len=max_model_len, decode_batch_size=decode_batch, prefill_bucket=8,
                      **knobs)
            self.eng = TEngine(cfg, params=params[1], on_events=sink, device="cpu")
        else:
            self.SP = JSP
            self.batch_cls = JEventBatch
            cfg = JEC(model=getattr(jl, preset),
                      block_manager=JBM(total_pages=total_pages, page_size=PS),
                      scheduler=JSC(max_prefill_batch=prefill_batch),
                      max_model_len=max_model_len, decode_batch_size=decode_batch,
                      prefill_bucket=8, interpret=True, **knobs)
            self.eng = JEngine(cfg, params=params[0], on_events=sink)

    def event_bytes(self):
        return [self.batch_cls(ts=0.0, events=evs).to_payload() for evs in self.events]

    def pools(self):
        """(k_pages, v_pages, k_scales, v_scales) as numpy; no scales when
        the pool is not int8."""
        eng = self.eng
        arrays = [eng.k_pages, eng.v_pages, eng.k_scales, eng.v_scales]
        return [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                for a in arrays if a is not None]


def assert_pools_match(tside, jside):
    """Equal codes (or pages) and, for int8 pools, scales within rtol 1e-6."""
    tp, jp = tside.pools(), jside.pools()
    assert len(tp) == len(jp)
    if len(tp) == 4:
        for t, j in zip(tp[:2], jp[:2]):
            np.testing.assert_array_equal(t, j)
        for t, j in zip(tp[2:], jp[2:]):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


def _observe(seq):
    return {
        "generated": [int(t) for t in seq.generated_tokens],
        "output": [int(t) for t in seq.output_tokens],
        "all": [int(t) for t in seq.all_tokens],
        "cached": seq.num_cached_prompt,
        "error": seq.error,
        "finish_reason": seq.finish_reason,
    }


# Each scenario drives one engine through `side` and returns what it saw;
# the same code runs against both frameworks.
def basics_single(s):
    seq = s.eng.add_request(_prompt(0, 10), s.SP(max_new_tokens=5))
    done = s.eng.run_until_complete()
    assert [d.seq_id for d in done] == [seq.seq_id] and seq.ttft is not None
    return [seq]


def basics_batch(s):
    seqs = [s.eng.add_request(_prompt(i, 6 + i), s.SP(max_new_tokens=4)) for i in range(4)]
    assert len(s.eng.run_until_complete()) == 4
    return seqs


def basics_mixed_batching(s):
    seqs = [
        s.eng.add_request(_prompt(7, 9), s.SP(max_new_tokens=6)),
        s.eng.add_request(_prompt(8, 5), s.SP(max_new_tokens=3)),
        s.eng.add_request(_prompt(9, 13), s.SP(max_new_tokens=4)),
    ]
    s.eng.run_until_complete()
    return seqs


def basics_stop_token(s):
    probe = s.eng.add_request(_prompt(1, 8), s.SP(max_new_tokens=1))
    s.eng.run_until_complete()
    seq = s.eng.add_request(
        _prompt(1, 8), s.SP(max_new_tokens=32, stop_token_ids=(probe.output_tokens[0],))
    )
    s.eng.run_until_complete()
    assert len(seq.output_tokens) == 1
    return [probe, seq]


def basics_rejects(s):
    for bad in ([], _prompt(0, 64)):
        with pytest.raises(ValueError):
            s.eng.add_request(bad, s.SP())
    return []


def prefix_shared(s):
    shared = _prompt(42, 16)
    a = s.eng.add_request(shared + _prompt(1, 4), s.SP(max_new_tokens=4))
    s.eng.run_until_complete()
    b = s.eng.add_request(shared + _prompt(2, 4), s.SP(max_new_tokens=4))
    s.eng.run_until_complete()
    assert b.num_cached_prompt == 16
    return [a, b]


def prefix_identical(s):
    p = _prompt(5, 8)
    first = s.eng.add_request(p, s.SP(max_new_tokens=2))
    s.eng.run_until_complete()
    again = s.eng.add_request(p, s.SP(max_new_tokens=2))
    s.eng.run_until_complete()
    assert again.num_cached_prompt < len(p)
    return [first, again]


def prefix_pages_shared(s):
    shared = _prompt(11, 16)
    a = s.eng.add_request(shared + [1], s.SP(max_new_tokens=1))
    s.eng.run_until_complete()
    before = s.eng.block_manager.num_free
    b = s.eng.add_request(shared + [2], s.SP(max_new_tokens=1))
    s.eng.run_until_complete()
    assert s.eng.block_manager.num_free >= before - 2
    return [a, b]


def events_eviction(s):
    seqs = []
    for i in range(6):
        seqs.append(s.eng.add_request(_prompt(100 + i, 12), s.SP(max_new_tokens=2)))
        s.eng.run_until_complete()
    assert any(type(e).__name__ == "BlockRemoved" for evs in s.events for e in evs)
    return seqs


def events_partial_page(s):
    seq = s.eng.add_request(_prompt(33, 13), s.SP(max_new_tokens=7))
    s.eng.run_until_complete()
    return [seq]


def preempt_decode_oom(s):
    a = s.eng.add_request(_prompt(50, 10), s.SP(max_new_tokens=12))
    b = s.eng.add_request(_prompt(51, 10), s.SP(max_new_tokens=12))
    assert len(s.eng.run_until_complete()) == 2
    assert len(a.generated_tokens) == 12 and len(b.generated_tokens) == 12
    return [a, b]


def preempt_reporting_stable(s):
    orig = _prompt(52, 10)
    a = s.eng.add_request(list(orig), s.SP(max_new_tokens=10))
    b = s.eng.add_request(_prompt(53, 10), s.SP(max_new_tokens=10))
    s.eng.run_until_complete()
    assert a.all_tokens[: a.user_prompt_len] == orig
    return [a, b]


def preempt_oversized(s):
    with pytest.raises(ValueError, match="pages"):
        s.eng.add_request(_prompt(60, 16), s.SP(max_new_tokens=1))
    return []


def preempt_pool_too_small(s):
    seq = s.eng.add_request(_prompt(61, 9), s.SP(max_new_tokens=30))
    assert len(s.eng.run_until_complete(max_steps=500)) == 1
    assert seq.error is not None and not s.eng.has_work
    return [seq]


def abort_mid_decode(s):
    a = s.eng.add_request(_prompt(70, 9), s.SP(max_new_tokens=20), request_id="a")
    b = s.eng.add_request(_prompt(71, 6), s.SP(max_new_tokens=5), request_id="b")
    for _ in range(3):
        s.eng.step()
    assert s.eng.abort("a") is a and s.eng.abort("missing") is None
    s.eng.run_until_complete()
    c = s.eng.add_request(_prompt(72, 7), s.SP(max_new_tokens=9))
    s.eng.step()
    assert s.eng.abort_all() == [c]
    return [a, b, c]


# (scenario, total_pages, decode_batch, max_model_len, max_prefill_batch)
SCENARIOS = {
    "basics_single": (basics_single, 64, 4, 64, 4),
    "basics_batch": (basics_batch, 64, 4, 64, 4),
    "basics_mixed_batching": (basics_mixed_batching, 64, 4, 64, 4),
    "basics_stop_token": (basics_stop_token, 64, 4, 64, 4),
    "basics_rejects": (basics_rejects, 64, 4, 64, 4),
    "prefix_shared": (prefix_shared, 64, 4, 64, 4),
    "prefix_identical": (prefix_identical, 64, 4, 64, 4),
    "prefix_pages_shared": (prefix_pages_shared, 16, 4, 64, 4),
    "events_partial_page": (events_partial_page, 64, 2, 64, 8),
    "events_eviction": (events_eviction, 10, 2, 32, 8),
    "preempt_decode_oom": (preempt_decode_oom, 9, 2, 64, 4),
    "preempt_reporting_stable": (preempt_reporting_stable, 9, 2, 64, 4),
    "preempt_oversized": (preempt_oversized, 4, 4, 64, 4),
    "preempt_pool_too_small": (preempt_pool_too_small, 4, 1, 64, 4),
    "abort_mid_decode": (abort_mid_decode, 64, 4, 64, 4),
}


# TINY_LLAMA cases keep the bare scenario name as their id.
CASES = [
    pytest.param(model, name, id=name if model == "tiny-llama" else f"{model}-{name}")
    for model in MODELS
    for name in SCENARIOS
]


@pytest.mark.parametrize("model,name", CASES)
def test_engine_parity(model, name):
    fn, *shape = SCENARIOS[name]
    params = _params(MODELS[model][0])
    jside = _Side(False, params, *shape, model=model)
    tside = _Side(True, params, *shape, model=model)
    jobs = [_observe(s) for s in fn(jside)]
    tobs = [_observe(s) for s in fn(tside)]
    assert tobs == jobs
    assert tside.eng.prefill_stats["tokens_computed"] == jside.eng.prefill_stats["tokens_computed"]
    assert tside.eng.block_manager.num_free == jside.eng.block_manager.num_free
    assert tside.event_bytes() == jside.event_bytes()
    if MODELS[model][2] is not None:
        assert_pools_match(tside, jside)


def test_events_drive_jax_indexer_to_score_torch_pod(params):
    """The port's events, through the JAX package's ingestion pool and
    indexer, score the pod with every KV-complete page of the request
    (hash parity end to end)."""
    from llm_d_kv_cache_manager_tpu.kvcache import KVCacheIndexer, KVCacheIndexerConfig
    from llm_d_kv_cache_manager_tpu.kvcache.kvblock import TokenProcessorConfig
    from llm_d_kv_cache_manager_tpu.kvcache.kvevents import KVEventsPool, Message

    ix = KVCacheIndexer(KVCacheIndexerConfig(token_processor=TokenProcessorConfig(block_size=PS)))
    pool = KVEventsPool(ix.kv_block_index)
    pool.start()
    side = _Side(True, params, 64, 2, 64, 8)
    seq = side.eng.add_request(_prompt(33, 13), TSP(max_new_tokens=7))
    side.eng.run_until_complete()
    for payload in side.event_bytes():
        pool.add_task(Message(topic=f"kv@gpu-pod-0@{MODEL}", pod_identifier="gpu-pod-0",
                              model_name=MODEL, payload=payload))
    assert pool.drain()
    pool.shutdown()
    scores = ix.score_tokens(seq.all_tokens, MODEL)
    assert scores.get("gpu-pod-0", 0) == (len(seq.all_tokens) - 1) // PS


def test_deadline_expiry_matches(params):
    """A request past its deadline finishes early with the same reason in
    both engines (a deadline already in the past sheds before prefill)."""
    for s in (_Side(False, params, 64, 4, 64, 4), _Side(True, params, 64, 4, 64, 4)):
        seq = s.eng.add_request(_prompt(3, 9), s.SP(max_new_tokens=4), deadline=time.monotonic() - 1)
        done = s.eng.run_until_complete()
        assert done == [seq] and seq.finish_reason == "deadline" and seq.num_generated == 0
        assert s.eng.lifecycle_stats["deadline_shed"] == 1


@pytest.mark.parametrize("quantize_experts", [False, True])
def test_engine_holds_quantized_params_to_the_mode(quantize_experts):
    """A tree that is already quantized is served only in the form the
    config asks for: dense weights int8, expert stacks int8 exactly when
    ``quantize_experts`` is set. A full-precision tree is quantized."""
    full = _params("TINY_MOE")[1]
    given = t_quant.quantize_params(full, quantize_experts=quantize_experts)
    cfg = lambda qe: TEC(model=tl.TINY_MOE, quantize="int8", quantize_experts=qe)  # noqa: E731
    eng = TEngine(cfg(quantize_experts), params=given, device="cpu")
    assert eng.params is given
    with pytest.raises(ValueError, match="'w_(gate|up|down)' is not in the form"):
        TEngine(cfg(not quantize_experts), params=given, device="cpu")
    eng = TEngine(cfg(quantize_experts), params=full, device="cpu")
    assert t_quant.quantize_mismatch(eng.params, quantize_experts=quantize_experts) is None
    assert t_quant.quantize_mismatch(full, quantize_experts=quantize_experts) == "lm_head"
