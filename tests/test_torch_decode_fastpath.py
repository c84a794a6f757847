"""The port's decode fast path (``decode_steps_per_iter``,
``decode_pipeline``, ``decode_fused_sampling``) against the JAX engine at
the same knobs, on the CPU.

- The parity harness of ``test_torch_engine.py`` (its 15 scenarios on
  TINY_LLAMA, JAX in interpret mode) at four knob sets: fused k=1, fused
  k=2, fused and pipelined k=4, pipelined k=4 without fused sampling.
  Generated tokens, finish reasons, ``tokens_computed``, free pages and the
  KV-event msgpack bytes must be equal. The int8-expert and int8-page
  models run in ``test_torch_decode_fastpath_models.py``, JAX's own
  fast-path scenarios in ``test_torch_decode_fastpath_scenarios.py``.
- Engine details: ``max_pages_per_seq`` and ``_pipeline`` equal JAX's at
  each knob set; ``decode_steps_per_iter`` below 1 is refused; model steps
  are counted beside dispatches.
- ``DecodeGraphs`` (everything but the capture itself, which needs the
  card): one key per (k, block-table width) used, a replay on the CPU equal
  to ``llama.decode_steps`` on twin pools, the chained token input, and the
  launch-count accounting of a capture and its replays on a stub graph.
"""

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu_torch import ops
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams as TSP
from llm_d_kv_cache_manager_tpu_torch.server import decode_graphs as dg
from test_torch_engine import (
    MODELS,
    SCENARIOS,
    _params,
    _prompt,
    _Side,
    _observe,
    assert_pools_match,
)

#: the knob sets the parity harness runs (knobs off is test_torch_engine's)
KNOB_SETS = {
    "fused_k1": dict(decode_fused_sampling=True),
    "fused_k2": dict(decode_fused_sampling=True, decode_steps_per_iter=2),
    "fused_pipelined_k4": dict(decode_fused_sampling=True, decode_pipeline=True,
                               decode_steps_per_iter=4),
    "pipelined_k4": dict(decode_pipeline=True, decode_steps_per_iter=4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_fast_path_parity(model: str, knobs: dict, name: str) -> None:
    """One scenario on both engines at ``knobs``: what the requests saw,
    tokens computed, free pages, KV-event bytes (and int8 pools) equal, and
    no burst left in flight."""
    fn, *shape = SCENARIOS[name]
    params = _params(MODELS[model][0])
    jside = _Side(False, params, *shape, model=model, **knobs)
    tside = _Side(True, params, *shape, model=model, **knobs)
    jobs = [_observe(s) for s in fn(jside)]
    tobs = [_observe(s) for s in fn(tside)]
    assert tobs == jobs
    assert tside.eng.prefill_stats["tokens_computed"] == jside.eng.prefill_stats["tokens_computed"]
    assert tside.eng.block_manager.num_free == jside.eng.block_manager.num_free
    assert tside.event_bytes() == jside.event_bytes()
    assert tside.eng._inflight is None and jside.eng._inflight is None
    if MODELS[model][2] is not None:
        assert_pools_match(tside, jside)


@pytest.mark.parametrize(
    "knobs,name", [pytest.param(k, n, id=f"{k}-{n}") for k in KNOB_SETS for n in SCENARIOS]
)
def test_fast_path_parity(knobs, name):
    assert_fast_path_parity("tiny-llama", KNOB_SETS[knobs], name)


def _configs(**knobs):
    """(JAX, port) engine configs of TINY_LLAMA at ``knobs``."""
    from llm_d_kv_cache_manager_tpu.models import TINY_LLAMA as J_TINY
    from llm_d_kv_cache_manager_tpu.server import BlockManagerConfig as JBM
    from llm_d_kv_cache_manager_tpu.server import EngineConfig as JEC
    from llm_d_kv_cache_manager_tpu_torch.server import BlockManagerConfig as TBM
    from llm_d_kv_cache_manager_tpu_torch.server import EngineConfig as TEC

    common = dict(max_model_len=61, decode_batch_size=4, prefill_bucket=8, **knobs)
    return (JEC(model=J_TINY, block_manager=JBM(total_pages=64, page_size=4), interpret=True,
                **common),
            TEC(model=tl.TINY_LLAMA, block_manager=TBM(total_pages=64, page_size=4), **common))


@pytest.mark.parametrize("knobs", [{}] + list(KNOB_SETS.values()) + [
    dict(decode_pipeline=True), dict(decode_steps_per_iter=3)],
    ids=["off"] + list(KNOB_SETS) + ["pipeline_k1", "k3"])
def test_pages_per_seq_and_pipeline_match_jax(knobs):
    """Burst headroom (``k * bursts_in_flight - 1`` tokens) and whether the
    pipeline is live, as JAX computes them; pipelining alone at k=1 stays
    off, fused sampling turns it on at any k."""
    jcfg, tcfg = _configs(**knobs)
    jeng = JEngine(jcfg, params=_params("TINY_LLAMA")[0])
    teng = TEngine(tcfg, params=_params("TINY_LLAMA")[1], device="cpu")
    assert teng.max_pages_per_seq == jeng.max_pages_per_seq
    assert teng._pipeline == jeng._pipeline
    assert teng._inflight is None


def test_steps_per_iter_below_one_is_refused():
    _, tcfg = _configs(decode_steps_per_iter=0)
    with pytest.raises(ValueError, match="decode_steps_per_iter"):
        TEngine(tcfg, params=_params("TINY_LLAMA")[1], device="cpu")


def test_steps_counted_beside_dispatches_and_keys_by_width():
    """``decode_stats["steps"]`` counts model steps (k a dispatch), and the
    graphs hold exactly one key per (k, table width) the bursts used."""
    _, tcfg = _configs(decode_pages_bucket=4, **KNOB_SETS["fused_pipelined_k4"])
    eng = TEngine(tcfg, params=_params("TINY_LLAMA")[1], device="cpu")
    used = []
    dispatch = eng.decode_graphs.dispatch

    def spy(k, tokens, positions, seq_lens, block_tables, *rest):
        used.append((k, block_tables.shape[1]))
        return dispatch(k, tokens, positions, seq_lens, block_tables, *rest)

    eng.decode_graphs.dispatch = spy
    seqs = [eng.add_request(_prompt(90 + i, 5 + 3 * i), TSP(max_new_tokens=30)) for i in range(3)]
    eng.run_until_complete()
    assert all(len(s.generated_tokens) == 30 for s in seqs)
    stats = eng.decode_stats
    assert stats["dispatches"] == len(used) > 0 and stats["steps"] == 4 * stats["dispatches"]
    assert eng.decode_graphs.keys == sorted(set(used))
    assert len(set(w for _, w in used)) >= 2  # the table crossed a bucket
    assert eng.decode_graphs.warmup_steps == 0  # no warm-up without capture


def _twin_inputs(lanes=4, n=9, ps=4, seed=3):
    """A TINY_LLAMA pool with ``lanes`` prefilled lanes (lane 3 inactive),
    its twin, and the next decode inputs as numpy arrays."""
    cfg = tl.TINY_LLAMA
    params = _params("TINY_LLAMA")[1]
    width = 6
    pages = lanes * width + 1
    k_pages, v_pages = tl.init_kv_pages(cfg, pages, ps, "cpu")
    table = np.arange(1, pages, dtype=np.int32).reshape(lanes, width)
    table[3] = 0
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (lanes, n)).astype(np.int32)
    pos = np.broadcast_to(np.arange(n - 1, dtype=np.int32), (lanes, n - 1))
    t = torch.from_numpy
    tl.prefill(params, cfg, t(tokens[:, :-1].copy()), t(pos.copy()), torch.ones(lanes, n - 1, dtype=torch.bool),
               k_pages, v_pages, t(np.take_along_axis(table, pos // ps, 1)), t(pos % ps),
               torch.zeros((lanes, 0), dtype=torch.int32), torch.zeros(lanes, dtype=torch.int32))
    seq_lens = np.full(lanes, n, np.int32)
    seq_lens[3] = 0
    inputs = dict(tokens=tokens[:, -1].copy(), positions=np.where(seq_lens > 0, n - 1, 0).astype(np.int32),
                  seq_lens=seq_lens, block_tables=table, temperature=np.array([0, 0, 0.8, 0], np.float32),
                  top_k=np.array([0, 0, 5, 0], np.int32), top_p=np.array([1, 1, 0.9, 1], np.float32))
    return params, (k_pages, v_pages), (k_pages.clone(), v_pages.clone()), inputs


@pytest.mark.parametrize("k", [1, 3])
def test_cpu_replay_equals_decode_steps_and_chains(k):
    """A ``DecodeGraphs`` dispatch on the CPU runs ``llama.decode_steps`` on
    its static inputs: the same tokens (greedy and sampled lanes, one seed)
    and the same pools as a direct call on twin pools. With ``chain`` the
    token input then holds the last sampled column, and a chained dispatch
    (``tokens=None``) equals a direct call from those tokens."""
    params, pools, twin, inp = _twin_inputs()
    t = {name: torch.from_numpy(a.copy()) for name, a in inp.items()}

    def direct(tokens, positions, seq_lens, gen):
        return tl.decode_steps(params, tl.TINY_LLAMA, tokens, positions, *pools, t["block_tables"],
                               seq_lens, t["temperature"], t["top_k"], t["top_p"], gen,
                               page_size=4, num_steps=k)[0]

    graphs = dg.DecodeGraphs(params, tl.TINY_LLAMA, *twin, None, None, lanes=4, max_pages=8,
                             page_size=4, generator=torch.Generator().manual_seed(7),
                             device=torch.device("cpu"), chain=True)
    gen = torch.Generator().manual_seed(7)
    first = graphs.dispatch(k, inp["tokens"], inp["positions"], inp["seq_lens"],
                            inp["block_tables"], inp["temperature"], inp["top_k"], inp["top_p"])
    ref = direct(t["tokens"], t["positions"], t["seq_lens"], gen)
    np.testing.assert_array_equal(first.tokens(), ref.numpy())
    assert first.key == (k, 6)
    assert torch.equal(graphs._inputs["tokens"], ref[:, -1])
    active = inp["seq_lens"] > 0
    positions = np.where(active, inp["positions"] + k, 0).astype(np.int32)
    seq_lens = np.where(active, inp["seq_lens"] + k, 0).astype(np.int32)
    second = graphs.dispatch(k, None, positions, seq_lens, inp["block_tables"],
                             inp["temperature"], inp["top_k"], inp["top_p"])
    ref2 = direct(ref[:, -1].contiguous(), torch.from_numpy(positions), torch.from_numpy(seq_lens), gen)
    np.testing.assert_array_equal(second.tokens(), ref2.numpy())
    for a, b in zip(pools, twin):
        assert torch.equal(a, b)
    assert graphs.keys == [(k, 6)] and graphs.pool_bytes() == 0


def test_dispatch_refuses_another_lane_count():
    params, _, twin, inp = _twin_inputs()
    graphs = dg.DecodeGraphs(params, tl.TINY_LLAMA, *twin, None, None, lanes=8, max_pages=8,
                             page_size=4, generator=torch.Generator(), device=torch.device("cpu"),
                             chain=False)
    with pytest.raises(ValueError, match="4 lanes"):
        graphs.dispatch(1, *(inp[n] for n in ("tokens", "positions", "seq_lens", "block_tables",
                                              "temperature", "top_k", "top_p")))


def test_launch_accounting_of_capture_and_replay_on_a_stub():
    """A capture's wrapper counts are taken back (it launches nothing) and
    kept on the graph; each replay, which runs no Python wrapper, adds them
    again."""
    saved = dg.launch_counts()
    try:
        def fake_capture():
            ops.paged_attention.launches += 3
            ops.grouped_matmul_int8.launches += 9
            return torch.zeros((2, 1), dtype=torch.int32)

        out, delta = dg.count_launches(fake_capture)
        assert delta == {"paged_decode": 3, "grouped_matmul_int8": 9}
        assert dg.launch_counts() == saved

        class StubGraph:
            replays = 0

            def replay(self):
                self.replays += 1

        def eager():
            raise AssertionError("a replay must not run the eager burst")

        graph = StubGraph()
        burst = dg.CapturedBurst(graph, eager, out, delta)
        for _ in range(4):
            assert burst.replay() is out
        assert graph.replays == 4
        after = dg.launch_counts()
        assert after["paged_decode"] == saved["paged_decode"] + 12
        assert after["grouped_matmul_int8"] == saved["grouped_matmul_int8"] + 36
        assert all(after[n] == saved[n] for n in saved if n not in delta)
        # Without a graph (the CPU), a replay is the eager burst itself.
        assert dg.CapturedBurst(None, lambda: out).replay() is out
    finally:
        for name, n in saved.items():
            ops.COUNTED[name].launches = n


def test_int8_head_applied_a_slice_of_vocab_at_a_time(monkeypatch):
    """An int8 head is dequantized and applied a slice of the vocabulary at
    a time (a decode graph keeps its largest temporary in its pool): the
    logits equal those of the whole head dequantized at once."""
    from llm_d_kv_cache_manager_tpu_torch.models import quant

    cfg = tl.TINY_LLAMA
    params = quant.quantize_params(_params("TINY_LLAMA")[1])
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((3, 1, cfg.hidden_size), generator=gen).to(cfg.dtype)
    normed = tl.rms_norm(h, params["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    whole = (normed @ quant.materialize(params["lm_head"], h.dtype)).float()
    # 128 columns a slice: the 256-token vocabulary in two.
    monkeypatch.setattr(tl, "_HEAD_CHUNK_BYTES", 2 * cfg.hidden_size * 128)
    torch.testing.assert_close(tl._logits(params, cfg, h), whole, rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(tl, "_HEAD_CHUNK_BYTES", 1)  # at least 128 columns a slice
    torch.testing.assert_close(tl._logits(params, cfg, h), whole, rtol=1e-6, atol=1e-6)
