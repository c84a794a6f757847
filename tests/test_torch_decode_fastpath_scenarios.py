"""The JAX package's own decode fast-path scenarios, run on both engines:
``tests/test_engine.py::TestFusedDecode`` and ``TestDecodePipeline`` and
``tests/test_decode_fastpath.py::TestFusedSampling`` (its
``test_sample_phase_recorded`` reads ``step_stats``, which belong to the
observability the port has not ported). Each scenario asserts the JAX
contract (greedy output at every knob setting equals the knobs-off engine's,
across every drain edge) on the JAX engine (interpret mode) and on the
port's CPU engine, both on one set of TINY_LLAMA parameters, and the two
engines' outputs must also be equal.
"""

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import TINY_LLAMA as J_TINY
from llm_d_kv_cache_manager_tpu.server import BlockManagerConfig as JBM
from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu.server import EngineConfig as JEC
from llm_d_kv_cache_manager_tpu.server import SamplingParams as JSP
from llm_d_kv_cache_manager_tpu.server import SchedulerConfig as JSC
from llm_d_kv_cache_manager_tpu.server.block_manager import AllocationError as JAllocationError
from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA as T_TINY
from llm_d_kv_cache_manager_tpu_torch.server import BlockManagerConfig as TBM
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server import EngineConfig as TEC
from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams as TSP
from llm_d_kv_cache_manager_tpu_torch.server import SchedulerConfig as TSC
from llm_d_kv_cache_manager_tpu_torch.server.block_manager import AllocationError as TAllocationError
from test_torch_engine import _params, _prompt

PS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Fw:
    """One framework's engine factory, sampling params and pool error."""

    def __init__(self, name):
        self.name = name
        self.SP = JSP if name == "jax" else TSP
        self.AllocationError = JAllocationError if name == "jax" else TAllocationError

    def engine(self, total_pages=64, decode_batch=4, **kw):
        jp, tp = _params("TINY_LLAMA")
        common = dict(max_model_len=64, decode_batch_size=decode_batch, prefill_bucket=8, **kw)
        if self.name == "jax":
            return JEngine(JEC(model=J_TINY, block_manager=JBM(total_pages=total_pages, page_size=PS),
                               scheduler=JSC(max_prefill_batch=4), interpret=True, **common),
                           params=jp)
        return TEngine(TEC(model=T_TINY, block_manager=TBM(total_pages=total_pages, page_size=PS),
                           scheduler=TSC(max_prefill_batch=4), **common),
                       params=tp, device="cpu")


def on_both(scenario):
    """Run ``scenario(fw)`` on each engine; their results must be equal."""
    results = [scenario(Fw(name)) for name in ("jax", "torch")]
    assert results[1] == results[0]
    return results[0]


def _tokens(seqs):
    return [[int(t) for t in s.generated_tokens] for s in seqs]


# -- tests/test_engine.py::TestFusedDecode -----------------------------------


def test_fused_greedy_matches_per_step():
    def scenario(fw):
        prompts = [_prompt(i, 9 + i) for i in range(3)]
        outs = []
        for k in (1, 4):
            eng = fw.engine(decode_steps_per_iter=k)
            seqs = [eng.add_request(p, fw.SP(max_new_tokens=7)) for p in prompts]
            eng.run_until_complete()
            outs.append(_tokens(seqs))
        assert outs[0] == outs[1]
        return outs[0]

    on_both(scenario)


def test_fused_respects_max_new_tokens():
    def scenario(fw):
        eng = fw.engine(decode_steps_per_iter=4)
        seq = eng.add_request(_prompt(1, 10), fw.SP(max_new_tokens=6))
        eng.run_until_complete()
        assert len(seq.output_tokens) == 6
        return _tokens([seq])

    on_both(scenario)


def test_fused_stop_token_truncates():
    def scenario(fw):
        eng = fw.engine(decode_steps_per_iter=4)
        probe = eng.add_request(_prompt(2, 8), fw.SP(max_new_tokens=3))
        eng.run_until_complete()
        stop = probe.output_tokens[1]
        eng2 = fw.engine(decode_steps_per_iter=4)
        seq = eng2.add_request(_prompt(2, 8), fw.SP(max_new_tokens=8, stop_token_ids=(stop,)))
        eng2.run_until_complete()
        assert seq.output_tokens[-1] == stop
        assert len(seq.output_tokens) == 2
        return _tokens([probe, seq])

    on_both(scenario)


def test_fused_prefix_cache_still_consistent():
    def scenario(fw):
        p = _prompt(3, 16)
        eng = fw.engine(decode_steps_per_iter=4)
        a = eng.add_request(p, fw.SP(max_new_tokens=6))
        eng.run_until_complete()
        b = eng.add_request(p, fw.SP(max_new_tokens=6))
        eng.run_until_complete()
        assert b.num_cached_prompt > 0
        assert a.output_tokens == b.output_tokens
        return _tokens([a, b])

    on_both(scenario)


def test_fused_preemption_under_tiny_pool():
    def scenario(fw):
        eng = fw.engine(total_pages=14, decode_batch=3, decode_steps_per_iter=4)
        seqs = [eng.add_request(_prompt(10 + i, 8), fw.SP(max_new_tokens=8)) for i in range(3)]
        eng.run_until_complete()
        for s in seqs:
            assert s.error is None
            assert len(s.output_tokens) == 8
        return _tokens(seqs)

    on_both(scenario)


# -- tests/test_engine.py::TestDecodePipeline ---------------------------------


def _pipelined_vs_not(fw, drive, **kw):
    outs = [drive(fw, fw.engine(decode_steps_per_iter=4, decode_pipeline=p, **kw))
            for p in (False, True)]
    assert outs[0] == outs[1]
    return outs[0]


def test_pipelined_greedy_matches_unpipelined():
    def drive(fw, eng):
        seqs = [eng.add_request(_prompt(20 + i, 9 + i), fw.SP(max_new_tokens=13)) for i in range(3)]
        eng.run_until_complete()
        return _tokens(seqs)

    base = on_both(lambda fw: _pipelined_vs_not(fw, drive))
    assert all(len(toks) == 13 for toks in base)


def test_staggered_arrival_lane_change_drains():
    def drive(fw, eng):
        a = eng.add_request(_prompt(30, 8), fw.SP(max_new_tokens=12))
        for _ in range(3):
            eng.step()
        b = eng.add_request(_prompt(31, 10), fw.SP(max_new_tokens=12))
        eng.run_until_complete()
        return _tokens([a, b])

    base = on_both(lambda fw: _pipelined_vs_not(fw, drive))
    assert all(len(toks) == 12 for toks in base)


def test_pipelined_preemption_tiny_pool():
    def drive(fw, eng):
        bm = eng.block_manager
        orig = bm.reserve_slots
        pressure = [0]

        def spy(seq, n):
            try:
                return orig(seq, n)
            except fw.AllocationError:
                pressure[0] += 1
                raise

        bm.reserve_slots = spy
        seqs = [eng.add_request(_prompt(10 + i, 8), fw.SP(max_new_tokens=8)) for i in range(3)]
        eng.run_until_complete()
        assert pressure[0] > 0, "pool never under pressure; test too big"
        assert all(s.error is None for s in seqs)
        return _tokens(seqs)

    base = on_both(lambda fw: _pipelined_vs_not(fw, drive, total_pages=12, decode_batch=3))
    assert all(len(toks) == 8 for toks in base)


def test_pipelined_stop_token_truncates():
    def scenario(fw):
        probe_eng = fw.engine(decode_steps_per_iter=4)
        probe = probe_eng.add_request(_prompt(2, 8), fw.SP(max_new_tokens=3))
        probe_eng.run_until_complete()
        stop = probe.output_tokens[1]

        def drive(fw, eng):
            seq = eng.add_request(_prompt(2, 8), fw.SP(max_new_tokens=8, stop_token_ids=(stop,)))
            eng.run_until_complete()
            return _tokens([seq])[0]

        piped = _pipelined_vs_not(fw, drive)
        assert piped[-1] == stop and len(piped) == 2
        return piped

    on_both(scenario)


def test_pipelined_prefix_cache_still_consistent():
    def drive(fw, eng):
        p = _prompt(3, 16)
        a = eng.add_request(p, fw.SP(max_new_tokens=6))
        eng.run_until_complete()
        b = eng.add_request(p, fw.SP(max_new_tokens=6))
        eng.run_until_complete()
        assert b.num_cached_prompt > 0
        return _tokens([a, b])

    on_both(lambda fw: _pipelined_vs_not(fw, drive))


def test_inactive_lane_sentinel_preserved_when_chaining():
    """White-box: when burst N+1 chains on the device from burst N, only
    previously active lanes advance; padded lanes keep the 0 = inactive
    sentinel (no garbage attention, no KV writes into reserved page 0)."""

    def scenario(fw):
        eng = fw.engine(decode_batch=4, decode_steps_per_iter=2, decode_pipeline=True)
        seqs = [eng.add_request(_prompt(40 + i, 8), fw.SP(max_new_tokens=20)) for i in range(2)]
        eng.step()  # prefills both (max_prefill_batch=4)
        eng._run_decode_fused(seqs)  # burst 1 in flight
        assert eng._inflight is not None
        eng._run_decode_fused(seqs)  # burst 2 chained from burst 1
        burst = eng._inflight
        np.testing.assert_array_equal(burst["seq_lens"][2:], 0)
        np.testing.assert_array_equal(burst["positions"][2:], 0)
        assert (burst["seq_lens"][:2] > 0).all()
        seen = [burst["positions"].tolist(), burst["seq_lens"].tolist()]
        eng._drain_inflight()
        return seen + _tokens(seqs)

    on_both(scenario)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_env_knob_wires_decode_pipeline(monkeypatch, pkg):
    if pkg == "jax":
        from llm_d_kv_cache_manager_tpu.server.serve import PodServerConfig
    else:
        from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServerConfig

    monkeypatch.setenv("DECODE_PIPELINE", "1")
    monkeypatch.setenv("DECODE_STEPS_PER_ITER", "4")
    cfg = PodServerConfig.from_env()
    assert cfg.engine.decode_pipeline is True
    assert cfg.engine.decode_steps_per_iter == 4
    monkeypatch.setenv("DECODE_PIPELINE", "0")
    assert PodServerConfig.from_env().engine.decode_pipeline is False


# -- tests/test_decode_fastpath.py::TestFusedSampling -------------------------

PROMPTS = [(0, 10), (1, 17), (2, 5)]


def _run(fw, **kw):
    eng = fw.engine(**kw)
    seqs = [eng.add_request(_prompt(s, n), fw.SP(max_new_tokens=8)) for s, n in PROMPTS]
    eng.run_until_complete()
    assert all(s.error is None for s in seqs)
    return _tokens(seqs)


def test_greedy_parity_all_modes():
    def scenario(fw):
        base = _run(fw)
        for kw in (
            dict(decode_fused_sampling=True),
            dict(decode_fused_sampling=True, decode_steps_per_iter=2),
            dict(decode_fused_sampling=True, decode_steps_per_iter=4, decode_pipeline=True),
        ):
            assert _run(fw, **kw) == base, kw
        return base

    on_both(scenario)


def test_fused_k1_enables_pipeline():
    def scenario(fw):
        assert fw.engine(decode_fused_sampling=True)._pipeline  # device-resident loop at k=1
        assert not fw.engine()._pipeline
        return True

    on_both(scenario)


def test_parity_under_pool_pressure_with_preemption():
    def scenario(fw):
        outs = []
        for fused in (False, True):
            eng = fw.engine(total_pages=14, decode_fused_sampling=fused)
            seqs = [eng.add_request(_prompt(s, 9), fw.SP(max_new_tokens=10)) for s in (3, 4)]
            eng.run_until_complete()
            assert all(s.error is None for s in seqs)
            outs.append(_tokens(seqs))
        assert outs[0] == outs[1]
        return outs[0]

    on_both(scenario)


def test_warm_cache_hit_parity():
    def scenario(fw):
        prefix = _prompt(5, 12)
        outs = []
        for fused in (False, True):
            eng = fw.engine(decode_fused_sampling=fused)
            a = eng.add_request(prefix + _prompt(6, 4), fw.SP(max_new_tokens=6))
            eng.run_until_complete()
            b = eng.add_request(prefix + _prompt(7, 4), fw.SP(max_new_tokens=6))
            eng.run_until_complete()
            assert b.num_cached_prompt >= PS
            outs.append(_tokens([a, b]))
        assert outs[0] == outs[1]
        return outs[0]

    on_both(scenario)
