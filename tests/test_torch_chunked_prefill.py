"""Chunked prefill and the mixed prefill/decode step of the port's ``Engine``
(``SchedulerConfig.chunked_prefill_tokens``) against the JAX package's, on
the CPU, through the scenarios of ``tests/test_chunked_prefill.py::
TestChunkedPrefillParity``: one long prompt, mixed arrivals (decode lanes
stream while a long prompt is ingested), a prefix-cache hit, and preemption
in the middle of a prefill. Each runs with bf16-style full-width pages and
with int8 pages (``kv_quant_hbm="int8"``), whose later chunks read the
quantized context earlier chunks wrote.

In every case the port and JAX must agree on greedy outputs, cached
prompt tokens, ``prefill_stats["tokens_computed"]``, the events (as
msgpack bytes) and, on int8 pages, the final codes (equal) and scales
(rtol 1e-6; see ``test_torch_kv_quant_hbm.py``). Within the port, chunked
output must equal unchunked output, as the JAX suite requires of JAX.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.kvcache.kvevents.events import EventBatch as JEventBatch
from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.server import (
    BlockManagerConfig as JBM,
    Engine as JEngine,
    EngineConfig as JEC,
    SamplingParams as JSP,
    SchedulerConfig as JSC,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents.events import EventBatch as TEventBatch
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import params_from_jax
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig as TBM,
    Engine as TEngine,
    EngineConfig as TEC,
    SamplingParams as TSP,
    SchedulerConfig as TSC,
)

PS = 4
CHUNK = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _params():
    jp = jl.init_params(jax.random.PRNGKey(0), jl.TINY_LLAMA)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tl.TINY_LLAMA, "cpu")


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, jl.TINY_LLAMA.vocab_size, n)]


class _Side:
    """One framework's engine plus the events it emitted."""

    def __init__(self, torch_side, chunked, kv_quant_hbm, total_pages=64, decode_batch=4):
        self.events = []
        sink = lambda evs: self.events.append(list(evs))  # noqa: E731
        jp, tp = _params()
        common = dict(max_model_len=64, decode_batch_size=decode_batch, prefill_bucket=8,
                      kv_quant_hbm=kv_quant_hbm)
        if torch_side:
            self.SP, self.batch_cls = TSP, TEventBatch
            cfg = TEC(model=tl.TINY_LLAMA, block_manager=TBM(total_pages=total_pages, page_size=PS),
                      scheduler=TSC(max_prefill_batch=4, chunked_prefill_tokens=chunked), **common)
            self.eng = TEngine(cfg, params=tp, on_events=sink, device="cpu")
        else:
            self.SP, self.batch_cls = JSP, JEventBatch
            cfg = JEC(model=jl.TINY_LLAMA, block_manager=JBM(total_pages=total_pages, page_size=PS),
                      scheduler=JSC(max_prefill_batch=4, chunked_prefill_tokens=chunked),
                      interpret=True, **common)
            self.eng = JEngine(cfg, params=jp, on_events=sink)

    def event_bytes(self):
        return [self.batch_cls(ts=0.0, events=evs).to_payload() for evs in self.events]

    def pools(self):
        arrays = [self.eng.k_pages, self.eng.v_pages, self.eng.k_scales, self.eng.v_scales]
        return [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                for a in arrays if a is not None]


def _observe(seq):
    return {
        "generated": [int(t) for t in seq.generated_tokens],
        "cached": seq.num_cached_prompt,
        "error": seq.error,
        "finish_reason": seq.finish_reason,
    }


# Each scenario drives one engine and returns (sequences, extra facts).
def single_long_prompt(s):
    seq = s.eng.add_request(_prompt(10, 40), s.SP(max_new_tokens=6))
    s.eng.run_until_complete()
    assert seq.error is None and len(seq.generated_tokens) == 6
    return [seq], {}


def mixed_arrivals(s):
    a = s.eng.add_request(_prompt(11, 6), s.SP(max_new_tokens=14))
    b = s.eng.add_request(_prompt(12, 9), s.SP(max_new_tokens=14))
    for _ in range(3):
        s.eng.step()
    c = s.eng.add_request(_prompt(13, 41), s.SP(max_new_tokens=5))
    during_ingest = 0
    while c.num_generated == 0 and s.eng.has_work:
        g0 = a.num_generated + b.num_generated
        s.eng.step()
        if c.num_generated == 0:
            during_ingest += a.num_generated + b.num_generated - g0
    s.eng.run_until_complete()
    return [a, b, c], {"during_ingest": during_ingest}


def prefix_cache_hit(s):
    shared = _prompt(42, 16)  # 4 full pages
    a = s.eng.add_request(shared + _prompt(14, 20), s.SP(max_new_tokens=4))
    s.eng.run_until_complete()
    b = s.eng.add_request(shared + _prompt(15, 24), s.SP(max_new_tokens=4))
    s.eng.run_until_complete()
    assert b.num_cached_prompt == 16
    return [a, b], {}


def preemption_mid_prefill(s):
    a = s.eng.add_request(_prompt(17, 8), s.SP(max_new_tokens=20))
    s.eng.step()  # a prefills and starts decoding
    b = s.eng.add_request(_prompt(18, 33), s.SP(max_new_tokens=4))
    s.eng.run_until_complete()
    assert a.error is None and b.error is None
    assert len(a.generated_tokens) == 20 and len(b.generated_tokens) == 4
    return [a, b], {}


#: scenario -> (function, total_pages, decode lanes)
SCENARIOS = {
    "single_long_prompt": (single_long_prompt, 64, 4),
    "mixed_arrivals": (mixed_arrivals, 64, 4),
    "prefix_cache_hit": (prefix_cache_hit, 64, 4),
    "preemption_mid_prefill": (preemption_mid_prefill, 16, 2),
}


def _run(torch_side, name, chunked, kv_quant_hbm):
    fn, pages, lanes = SCENARIOS[name]
    side = _Side(torch_side, chunked, kv_quant_hbm, pages, lanes)
    seqs, facts = fn(side)
    return side, [_observe(q) for q in seqs], facts


@pytest.mark.parametrize("kv_quant_hbm", [None, "int8"], ids=["full_width", "int8"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_chunked_prefill_parity(name, kv_quant_hbm):
    jside, jobs, jfacts = _run(False, name, CHUNK, kv_quant_hbm)
    tside, tobs, tfacts = _run(True, name, CHUNK, kv_quant_hbm)
    assert tobs == jobs and tfacts == jfacts
    assert tside.eng.prefill_stats == jside.eng.prefill_stats
    assert tside.eng.block_manager.num_free == jside.eng.block_manager.num_free
    assert tside.event_bytes() == jside.event_bytes()
    tp, jp = tside.pools(), jside.pools()
    if kv_quant_hbm:
        for t, j in zip(tp[:2], jp[:2]):
            np.testing.assert_array_equal(t, j)
        for t, j in zip(tp[2:], jp[2:]):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    # Within the port: chunked greedy output equals unchunked.
    _, base, base_facts = _run(True, name, None, kv_quant_hbm)
    assert [o["generated"] for o in tobs] == [o["generated"] for o in base]
    if name == "mixed_arrivals":
        # The mechanism: unchunked, the lanes commit nothing while the
        # 41-token prompt prefills; chunked, they stream through its chunks.
        assert base_facts["during_ingest"] == 0 and tfacts["during_ingest"] >= 4


def test_mixed_step_counts_one_prefill_and_one_decode_dispatch():
    """A mixed step dispatches a prefill chunk and the running lanes'
    decode; the engine counts each, so steps no longer count decodes."""
    side = _Side(True, CHUNK, None)
    a = side.eng.add_request(_prompt(20, 6), TSP(max_new_tokens=8))
    side.eng.step()  # a's only chunk
    assert side.eng.prefill_stats["dispatches"] == 1 and side.eng.decode_stats["dispatches"] == 0
    b = side.eng.add_request(_prompt(21, 30), TSP(max_new_tokens=2))
    side.eng.step()  # b's first chunk + a's decode
    assert side.eng.prefill_stats["dispatches"] == 2 and side.eng.decode_stats["dispatches"] == 1
    assert b.num_prefilled == CHUNK and b.num_generated == 0 and a.num_generated == 2
    side.eng.run_until_complete()
    steps = side.eng._step_count
    assert side.eng.decode_stats["dispatches"] > steps - side.eng.prefill_stats["dispatches"]


def test_rejects_bad_budget():
    with pytest.raises(ValueError, match="chunked_prefill_tokens"):
        _Side(True, 0, None)
