"""Speculative decoding in the port against the JAX package's, on the CPU:
``ops.spec_sample``, ``prefill(return_all_logits=True)``,
``spec_decode_steps``, the engine scenarios of ``tests/test_engine.py``'s
``TestSpeculativeDecode`` and the spec configurations of its
``TestDecodePathParityFuzz`` (those without ``sp``) on both engines, and a
torch pod with ``SPEC_DECODE=prompt_lookup`` beside a JAX pod.

TINY_LLAMA in float32, the JAX parameters carried over with
``params_from_jax``. Held exactly: greedy tokens (against JAX's and the
port's own spec-off run), ``spec_stats``, the KV events as msgpack bytes,
and ``spec_decode_steps``' packed outputs; logits at atol = rtol = 1e-4 and
pools at 1e-5, as in ``test_torch_llama.py``. Sampled draws are the JAX
function's in distribution only: a chi-square test over 20,000 draws holds
the emitted and free tokens to the filtered distribution at p > 1e-3.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from aiohttp.test_utils import TestClient, TestServer

from llm_d_kv_cache_manager_tpu.ops import sampling as j_sampling
from llm_d_kv_cache_manager_tpu.server.serve import PodServer as JPod
from llm_d_kv_cache_manager_tpu.server.serve import PodServerConfig as JPodConfig
from llm_d_kv_cache_manager_tpu_torch.ops import sampling as t_sampling
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServer as TPod
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServerConfig as TPodConfig
from test_torch_engine import (
    JBM,
    JEC,
    JSC,
    JSP,
    TBM,
    TEC,
    TSC,
    TSP,
    JEngine,
    JEventBatch,
    TEngine,
    TEventBatch,
    _params,
    jl,
    tl,
)

LOGITS = dict(atol=1e-4, rtol=1e-4)
POOL = dict(atol=1e-5, rtol=1e-5)
PS = 4
SPEC = dict(spec_decode="prompt_lookup", spec_k=4, spec_ngram=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, jl.TINY_LLAMA.vocab_size, n)]


# -- spec_sample -----------------------------------------------------------------
def _sample_inputs(seed, b=4, s=5, vocab=64):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, s, vocab)).astype(np.float32) * 3
    drafts = rng.integers(0, vocab, (b, s)).astype(np.int32)
    # Half the drafts are the argmax, so both verdicts occur.
    hit = rng.random((b, s)) < 0.5
    drafts = np.where(hit, logits.argmax(-1), drafts).astype(np.int32)
    temperature = np.array([0.0, 0.8, 0.0, 1.3], np.float32)[:b]
    top_k = np.array([0, 8, 5, 0], np.int32)[:b]
    top_p = np.array([1.0, 0.9, 1.0, 0.7], np.float32)[:b]
    return logits, drafts, temperature, top_k, top_p


def _spec_sample_both(inputs, seed=0):
    j = j_sampling.spec_sample(*map(jnp.asarray, inputs), jax.random.PRNGKey(seed))
    gen = torch.Generator().manual_seed(seed)
    t = t_sampling.spec_sample(*map(torch.from_numpy, inputs), gen)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_sample_greedy_lanes_equal_jax(seed):
    inputs = _sample_inputs(seed)
    (ja, jr, jf), (ta, tr, tf) = _spec_sample_both(inputs, seed)
    greedy = inputs[2] == 0
    for j, t in ((ja, ta), (jr, tr), (jf, tf)):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t[greedy], j[greedy])
    np.testing.assert_array_equal(ta[greedy], inputs[1][greedy] == inputs[0][greedy].argmax(-1))
    vocab = inputs[0].shape[-1]
    assert ta.dtype == bool and tr.dtype == tf.dtype == np.int32
    assert ((tr >= 0) & (tr < vocab)).all() and ((tf >= 0) & (tf < vocab)).all()
    # A sampled lane's replacement never equals its draft.
    sampled = ~greedy
    assert (tr[sampled] != inputs[1][sampled]).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_spec_sample_top_k1_lane_equals_greedy(seed):
    """top_k=1 collapses the filtered distribution to its argmax: a sampled
    lane accepts exactly the argmax draft, and its replacement and free
    tokens are the argmax."""
    logits, drafts, _, _, _ = _sample_inputs(seed)
    b = logits.shape[0]
    inputs = (logits, drafts, np.full(b, 0.9, np.float32), np.ones(b, np.int32),
              np.full(b, 0.95, np.float32))
    _, (ta, tr, tf) = _spec_sample_both(inputs, seed)
    greedy = logits.argmax(-1)
    np.testing.assert_array_equal(ta, drafts == greedy)
    np.testing.assert_array_equal(tr[~ta], greedy[~ta])
    np.testing.assert_array_equal(tf, greedy)


def test_spec_sample_emits_the_filtered_distribution():
    """20,000 draws at one position of a 16-token vocabulary with a fixed
    draft: the emitted token (the draft where accepted, else the
    replacement) and the free token each follow the filtered distribution
    (temperature 0.8, top_k 12, top_p 0.95), by chi-square at p > 1e-3."""
    n, vocab = 20_000, 16
    rng = np.random.default_rng(11)
    row = (rng.normal(size=vocab) * 1.5).astype(np.float32)
    temperature, top_k, top_p = 0.8, 12, 0.95
    draft = int(np.argsort(row)[-3])  # a likely but not the likeliest token
    masked = t_sampling._filtered_logits(
        torch.from_numpy(row)[None], torch.tensor([temperature]), torch.tensor([top_k]),
        torch.tensor([top_p]),
    )
    expect = torch.softmax(masked, -1)[0].double().numpy()
    assert expect[draft] > 0 and (expect == 0).sum() > 0
    logits = torch.from_numpy(np.broadcast_to(row, (n, 1, vocab)).copy())
    drafts = torch.full((n, 1), draft, dtype=torch.int32)
    gen = torch.Generator().manual_seed(2024)
    accept, replacement, free = t_sampling.spec_sample(
        logits, drafts, torch.full((n,), temperature), torch.full((n,), top_k, dtype=torch.int32),
        torch.full((n,), top_p), gen,
    )
    emitted = torch.where(accept[:, 0], drafts[:, 0], replacement[:, 0]).numpy()
    support = expect > 0
    for tokens in (emitted, free[:, 0].numpy()):
        counts = np.bincount(tokens, minlength=vocab)
        assert counts[~support].sum() == 0
        p = scipy.stats.chisquare(counts[support], n * expect[support] / expect[support].sum()).pvalue
        assert p > 1e-3, (counts, expect)


# -- prefill(return_all_logits=True) and spec_decode_steps ------------------------
@functools.lru_cache(maxsize=1)
def _tiny():
    return _params("TINY_LLAMA")


class _Pools:
    """One pool per framework, kept in step."""

    def __init__(self, pages):
        self.jk, self.jv = jl.init_kv_pages(jl.TINY_LLAMA, pages, PS)
        self.tk, self.tv = tl.init_kv_pages(tl.TINY_LLAMA, pages, PS, "cpu")

    def assert_equal(self):
        np.testing.assert_allclose(self.tk.numpy(), np.asarray(self.jk), **POOL)
        np.testing.assert_allclose(self.tv.numpy(), np.asarray(self.jv), **POOL)


def _prefill_both(pools, rows, starts, lens, tables, s, all_logits=False):
    """One prefill chunk through both models: row i holds ``rows[i]``'s
    tokens at positions starts[i] .. starts[i] + lens[i] - 1 (right-padded
    to ``s``), over the context its first starts[i] tokens left in the
    pool."""
    jp, tp = _tiny()
    b = len(lens)
    tok = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    valid = np.zeros((b, s), bool)
    for i, (st, n) in enumerate(zip(starts, lens)):
        tok[i, :n] = rows[i][st : st + n]
        pos[i, :n] = np.arange(st, st + n)
        valid[i, :n] = True
    tables = np.asarray(tables, np.int32)
    page_ids = np.take_along_axis(tables, pos // PS, axis=1)
    slot_ids = pos % PS
    ctx_pages = -(-max(starts) // PS)
    ctx_bt = np.ascontiguousarray(tables[:, :ctx_pages])
    ctx_lens = np.asarray(starts, np.int32)
    jlog, pools.jk, pools.jv = jl.prefill(
        jp, jl.TINY_LLAMA, *map(jnp.asarray, (tok, pos, valid)), pools.jk, pools.jv,
        *map(jnp.asarray, (page_ids, slot_ids, ctx_bt, ctx_lens)), attn_impl="xla",
        return_all_logits=all_logits,
    )
    t = torch.from_numpy
    tlog, pools.tk, pools.tv = tl.prefill(
        tp, tl.TINY_LLAMA, t(tok), t(pos), t(valid), pools.tk, pools.tv,
        t(page_ids), t(slot_ids), t(ctx_bt), t(ctx_lens), return_all_logits=all_logits,
    )
    return np.asarray(jlog), tlog.numpy(), valid


#: three lanes' histories: an echoing pattern, random tokens, another echo
_ROWS = [([5, 9, 2, 7, 11] * 8)[:23], _prompt(71, 30), ([3, 4] * 12)[:17]]
_TABLES = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
           [13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24],
           [25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36]]


def test_prefill_all_logits_equal_jax_at_unaligned_context():
    """Every position's logits of a chunk over contexts of 17, 9 and 13
    tokens (none page-aligned), and the pools it writes."""
    pools = _Pools(40)
    _prefill_both(pools, _ROWS, [0, 0, 0], [17, 9, 13], _TABLES, 24)
    jlog, tlog, valid = _prefill_both(pools, _ROWS, [17, 9, 13], [5, 8, 1], _TABLES, 8,
                                      all_logits=True)
    assert tlog.shape == jlog.shape == (3, 8, jl.TINY_LLAMA.vocab_size)
    np.testing.assert_allclose(tlog[valid], jlog[valid], **LOGITS)
    pools.assert_equal()
    # The last-position head is the all-logits head at each row's last
    # valid position.
    again = _Pools(40)
    _prefill_both(again, _ROWS, [0, 0, 0], [17, 9, 13], _TABLES, 24)
    _, tlast, _ = _prefill_both(again, _ROWS, [17, 9, 13], [5, 8, 1], _TABLES, 8)
    np.testing.assert_array_equal(tlast, tlog[np.arange(3), valid.sum(1) - 1])


def _packed_input(rounds, k, n, max_scan, table_w):
    """The engine's packed burst input for lanes 0-2 of _ROWS (each with
    its whole history prefilled but the last token committed, the decode
    state) and an inactive fourth lane."""
    b = 4
    scan_need = max_scan + n + 1
    W = scan_need + rounds * (k + 1)
    packed = np.zeros((b, W + table_w + 5), np.int32)
    for i, row in enumerate(_ROWS):
        n_win = min(len(row), scan_need)
        packed[i, :n_win] = row[-n_win:]
        packed[i, W : W + table_w] = _TABLES[i][:table_w]
        packed[i, W + table_w] = n_win
        packed[i, W + table_w + 1] = len(row)
        packed[i, W + table_w + 2] = [9, 2, 12][i]  # budgets (lane 1 clamps)
        packed[i, W + table_w + 3] = 1
    fparams = np.zeros((b, 2), np.float32)
    fparams[:, 1] = 1.0
    return packed, fparams


@pytest.mark.parametrize("rounds", [1, 3])
def test_spec_decode_steps_equal_jax(rounds):
    """Greedy lanes through one packed burst: emitted tokens, emit_len,
    prop_len and accepted counts equal, pools within 1e-5."""
    k, n, max_scan, table_w = 4, 2, 16, 12
    jp, tp = _tiny()
    pools = _Pools(40)
    # Decode state: every history token but the last is in the pool.
    _prefill_both(pools, _ROWS, [0, 0, 0], [len(r) - 1 for r in _ROWS], _TABLES, 32)
    packed, fparams = _packed_input(rounds, k, n, max_scan, table_w)
    kw = dict(page_size=PS, num_rounds=rounds, s_chunk=8, ngram=n, spec_k=k, max_scan=max_scan,
              table_w=table_w)
    jout, pools.jk, pools.jv = jl.spec_decode_steps(
        jp, jl.TINY_LLAMA, jnp.asarray(packed), jnp.asarray(fparams), pools.jk, pools.jv,
        jax.random.PRNGKey(0), attn_impl="xla", **kw,
    )
    tout, pools.tk, pools.tv = tl.spec_decode_steps(
        tp, tl.TINY_LLAMA, torch.from_numpy(packed), torch.from_numpy(fparams), pools.tk, pools.tv,
        torch.Generator().manual_seed(0), sampled=False, **kw,
    )
    jout = np.asarray(jout)
    assert tout.shape == jout.shape == (rounds, 4, k + 4) and tout.dtype == torch.int32
    np.testing.assert_array_equal(tout.numpy(), jout)
    prop_len = jout[..., k + 2]
    assert prop_len[0, 0] > 0 and prop_len[0, 2] > 0  # the echoing lanes propose
    assert (jout[:, 3, k + 1 : k + 3] == 0).all()  # the inactive lane emits and proposes nothing
    pools.assert_equal()


# -- the engine scenarios ------------------------------------------------------------
def _engine(torch_side, total_pages=64, decode_batch=4, host_pages=0, **kw):
    """tests/test_engine.py's ``_engine`` on the shared parameters, with an
    event sink (``eng.events``)."""
    jp, tp = _tiny()
    events = []
    sink = lambda evs: events.append(list(evs))  # noqa: E731
    if torch_side:
        cfg = TEC(model=tl.TINY_LLAMA,
                  block_manager=TBM(total_pages=total_pages, page_size=PS, host_pages=host_pages),
                  scheduler=TSC(max_prefill_batch=4), max_model_len=64,
                  decode_batch_size=decode_batch, prefill_bucket=8, **kw)
        eng = TEngine(cfg, params=tp, on_events=sink, device="cpu")
        eng.event_bytes = lambda: [TEventBatch(ts=0.0, events=e).to_payload() for e in events]
        eng.SP = TSP
    else:
        cfg = JEC(model=jl.TINY_LLAMA,
                  block_manager=JBM(total_pages=total_pages, page_size=PS, host_pages=host_pages),
                  scheduler=JSC(max_prefill_batch=4), max_model_len=64,
                  decode_batch_size=decode_batch, prefill_bucket=8, interpret=True, **kw)
        eng = JEngine(cfg, params=jp, on_events=sink)
        eng.event_bytes = lambda: [JEventBatch(ts=0.0, events=e).to_payload() for e in events]
        eng.SP = JSP
    return eng


def _tokens(seqs):
    return [[int(t) for t in s.generated_tokens] for s in seqs]


# Each scenario drives one engine and returns its sequences; the same code
# runs on both frameworks and, with the knobs off, on the port again.
def sc_matches_plain(eng):
    prompts = [_prompt(50, 6) * 3, _prompt(51, 13), ([7, 3, 9, 5, 2] * 6)[:21]]
    seqs = [eng.add_request(p, eng.SP(max_new_tokens=11)) for p in prompts]
    eng.run_until_complete()
    assert all(s.error is None and len(s.generated_tokens) == 11 for s in seqs)
    return seqs


def sc_stop_token(eng):
    probe = eng.add_request(([4, 8, 1] * 8)[:14], eng.SP(max_new_tokens=4))
    eng.run_until_complete()
    stop = int(probe.output_tokens[2])
    seq = eng.add_request(([4, 8, 1] * 8)[:14], eng.SP(max_new_tokens=16, stop_token_ids=(stop,)))
    eng.run_until_complete()
    assert seq.generated_tokens[-1] == stop and len(seq.generated_tokens) <= 3
    return [probe, seq]


def sc_prefix_cache(eng):
    p = ([2, 6, 10, 14] * 5)[:16]
    a = eng.add_request(p, eng.SP(max_new_tokens=8))
    eng.run_until_complete()
    b = eng.add_request(p, eng.SP(max_new_tokens=8))
    eng.run_until_complete()
    assert b.num_cached_prompt > 0 and a.generated_tokens == b.generated_tokens
    return [a, b]


def sc_repetitive(eng):
    seq = eng.add_request(_prompt(54, 2) * 8, eng.SP(max_new_tokens=12))
    eng.run_until_complete()
    return [seq]


def sc_budget_clamp(eng):
    seq = eng.add_request(([4, 8, 1] * 8)[:20], eng.SP(max_new_tokens=6))
    eng.run_until_complete()
    assert len(seq.generated_tokens) == 6 and seq.num_tokens <= 64
    return [seq]


def sc_pool_pressure(eng):
    seqs = [eng.add_request(([3 + i, 9, 1 + i] * 4)[:8] if i != 1 else _prompt(57, 8),
                            eng.SP(max_new_tokens=8)) for i in range(3)]
    eng.run_until_complete()
    assert all(s.error is None for s in seqs)
    return seqs


def sc_gate(eng):
    seq = eng.add_request(_prompt(60, 10), eng.SP(max_new_tokens=40))
    eng.run_until_complete()
    assert len(seq.generated_tokens) == 40
    return [seq]


#: scenario -> (the function that drives it, spec knobs, engine knobs)
SCENARIOS = {
    "matches_plain": (sc_matches_plain, SPEC, {}),
    "matches_plain_rounds3": (sc_matches_plain, dict(SPEC, spec_rounds=3), {}),
    "stop_token": (sc_stop_token, SPEC, {}),
    "prefix_cache": (sc_prefix_cache, SPEC, {}),
    "repetitive": (sc_repetitive, SPEC, {}),
    "budget_clamp": (sc_budget_clamp, dict(SPEC, spec_rounds=4), {}),
    "pool_pressure": (sc_pool_pressure, SPEC, dict(total_pages=14, decode_batch=3)),
    "pool_pressure_rounds3": (sc_pool_pressure, dict(SPEC, spec_rounds=3),
                              dict(total_pages=14, decode_batch=3)),
    "adaptive_gate": (sc_gate, dict(SPEC, spec_ngram=1, spec_min_accept=1.1, spec_min_sample=4),
                      {}),
}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    drive, spec, knobs = SCENARIOS[name]
    eng = _engine(False, **knobs, **spec)
    seqs = drive(eng)
    return _tokens(seqs), dict(eng.spec_stats), eng.event_bytes()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenario_equals_jax_and_spec_off(name):
    drive, spec, knobs = SCENARIOS[name]
    j_tokens, j_stats, j_events = _jax_run(name)
    eng = _engine(True, **knobs, **spec)
    t_tokens = _tokens(drive(eng))
    assert t_tokens == j_tokens
    assert eng.spec_stats == j_stats
    assert eng.event_bytes() == j_events
    if name != "stop_token":  # its stop token comes from its own probe
        assert eng.spec_stats["verify_steps"] == spec.get("spec_rounds", 1) * eng.spec_stats["bursts"]
    off = _engine(True, **knobs)
    assert _tokens(drive(off)) == t_tokens
    if name == "adaptive_gate":
        # The gate engaged: proposals stopped shortly after the sample filled.
        assert 4 <= eng.spec_stats["proposed"] <= 4 + 4
    if name in ("matches_plain", "repetitive", "budget_clamp"):
        assert eng.spec_stats["proposed"] > 0


def test_fused_rounds_same_tokens_fewer_bursts():
    prompt = ([7, 3, 9, 5, 2] * 6)[:28]
    streams, bursts = [], []
    for rounds in (1, 4):
        eng = _engine(True, **SPEC, spec_rounds=rounds)
        seq = eng.add_request(prompt, TSP(max_new_tokens=20))
        eng.run_until_complete()
        streams.append(_tokens([seq]))
        bursts.append(eng.spec_stats["bursts"])
        assert len(seq.generated_tokens) == 20
        assert eng.spec_stats["verify_steps"] == rounds * eng.spec_stats["bursts"]
    jeng = _engine(False, **SPEC, spec_rounds=4)
    jseq = jeng.add_request(prompt, JSP(max_new_tokens=20))
    jeng.run_until_complete()
    assert streams[0] == streams[1] == _tokens([jseq])
    assert bursts[1] < bursts[0]
    assert jeng.spec_stats["bursts"] == bursts[1]


@pytest.mark.parametrize("rounds", [1, 3])
def test_top_k1_sampled_lane_equals_greedy(rounds):
    cyc = ([8, 1, 6] * 6)
    outs = []
    for sampling in (TSP(max_new_tokens=10), TSP(max_new_tokens=10, temperature=0.9, top_k=1)):
        eng = _engine(True, **SPEC, spec_rounds=rounds)
        seq = eng.add_request(list(cyc), sampling)
        eng.run_until_complete()
        outs.append(_tokens([seq]))
    jeng = _engine(False, **SPEC, spec_rounds=rounds)
    jseq = jeng.add_request(list(cyc), JSP(max_new_tokens=10))
    jeng.run_until_complete()
    assert outs[0] == outs[1] == _tokens([jseq])


@pytest.mark.parametrize("rounds", [1, 3])
def test_sampled_lane_generates_in_vocab(rounds):
    eng = _engine(True, **SPEC, spec_rounds=rounds)
    seq = eng.add_request(_prompt(55, 2) * 8, TSP(max_new_tokens=9, temperature=0.8, top_k=8))
    eng.run_until_complete()
    assert len(seq.generated_tokens) == 9
    assert all(0 <= t < tl.TINY_LLAMA.vocab_size for t in seq.generated_tokens)


def test_mixed_greedy_and_sampled_batch_keeps_greedy_lane_independent():
    knobs = dict(SPEC, spec_k=3)
    g_prompt = _prompt(58, 2) * 6
    eng = _engine(True, **knobs)
    g = eng.add_request(g_prompt, TSP(max_new_tokens=7))
    s = eng.add_request(_prompt(59, 9), TSP(max_new_tokens=7, temperature=0.7, top_p=0.9))
    eng.run_until_complete()
    assert len(g.generated_tokens) == 7 and len(s.generated_tokens) == 7
    alone = _engine(True, **knobs)
    g2 = alone.add_request(g_prompt, TSP(max_new_tokens=7))
    alone.run_until_complete()
    jeng = _engine(False, **knobs)
    jg = jeng.add_request(g_prompt, JSP(max_new_tokens=7))
    jeng.run_until_complete()
    assert _tokens([g]) == _tokens([g2]) == _tokens([jg])


@pytest.mark.parametrize("torch_side", [True, False], ids=["torch", "jax"])
def test_rejects_bad_config_as_jax(torch_side):
    with pytest.raises(ValueError, match="spec_decode"):
        _engine(torch_side, spec_decode="medusa")
    with pytest.raises(ValueError, match="spec_k"):
        _engine(torch_side, spec_decode="prompt_lookup", spec_k=0)
    with pytest.raises(ValueError, match="spec_rounds"):
        _engine(torch_side, spec_decode="prompt_lookup", spec_rounds=0)
    with pytest.raises(ValueError, match="kv_quant_hbm is incompatible with spec_decode"):
        _engine(torch_side, spec_decode="prompt_lookup", kv_quant_hbm="int8")


# -- TestDecodePathParityFuzz's spec configurations, without sp -------------------
FUZZ_CONFIGS = [
    dict(spec_decode="prompt_lookup", spec_k=3, spec_ngram=2),
    dict(decode_steps_per_iter=3, decode_pipeline=True, spec_decode="prompt_lookup", spec_k=3,
         spec_ngram=2),
    dict(spec_decode="prompt_lookup", spec_k=3, spec_ngram=2, spec_rounds=3),
    dict(host_pages=16, spec_decode="prompt_lookup", spec_k=3, spec_ngram=2, spec_rounds=3),
    dict(decode_steps_per_iter=3, decode_pipeline=True, spec_decode="prompt_lookup", spec_k=3,
         spec_ngram=2, spec_rounds=3),
]


def _fuzz_case(seed):
    rng = np.random.default_rng(seed)
    n_req = int(rng.integers(2, 5))
    prompts = []
    for _ in range(n_req):
        if rng.random() < 0.5:  # repetition-heavy (exercises spec)
            pat = _prompt(int(rng.integers(0, 1000)), int(rng.integers(2, 5)))
            prompts.append((pat * 6)[: int(rng.integers(8, 20))])
        else:
            prompts.append(_prompt(int(rng.integers(0, 1000)), int(rng.integers(5, 20))))
    max_new = [int(rng.integers(3, 12)) for _ in range(n_req)]
    return prompts, max_new, int(rng.integers(24, 64)), int(rng.integers(0, 3))


def _fuzz_streams(torch_side, seed, knobs):
    prompts, max_new, pages, stagger = _fuzz_case(seed)
    eng = _engine(torch_side, total_pages=pages, decode_batch=3, **knobs)
    seqs = []
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        seqs.append(eng.add_request(p, eng.SP(max_new_tokens=m)))
        if stagger and i < len(prompts) - 1:
            for _ in range(stagger):
                eng.step()
    eng.run_until_complete()
    assert all(s.error is None for s in seqs), knobs
    out = _tokens(seqs)
    assert [len(t) for t in out] == max_new
    return out


@pytest.mark.parametrize("seed", [101, 202, 303, 404, 505])
def test_fuzz_spec_paths_equal_jax(seed):
    """The JAX engine's plain greedy streams (which its own fuzz holds equal
    to every JAX decode path) against the port's under each spec
    configuration, and JAX's first spec configuration against both."""
    reference = _fuzz_streams(False, seed, {})
    assert _fuzz_streams(False, seed, FUZZ_CONFIGS[0]) == reference
    for knobs in FUZZ_CONFIGS:
        assert _fuzz_streams(True, seed, knobs) == reference, f"{knobs} diverged (seed {seed})"


# -- the pod --------------------------------------------------------------------------
SPEC_ENV = {"SPEC_DECODE": "prompt_lookup", "SPEC_K": "3", "SPEC_NGRAM": "2", "SPEC_ROUNDS": "2",
            "SPEC_MIN_ACCEPT": "0.25", "SPEC_MIN_SAMPLE": "6", "SPEC_MAX_SCAN": "512"}
SPEC_FIELDS = ("spec_decode", "spec_k", "spec_ngram", "spec_rounds", "spec_min_accept",
               "spec_min_sample", "spec_max_scan")


def _env_fields(cls):
    e = cls.from_env().engine
    return tuple(getattr(e, f) for f in SPEC_FIELDS)


def test_pod_reads_spec_env_as_jax(monkeypatch):
    for name in SPEC_ENV:
        monkeypatch.delenv(name, raising=False)
    assert _env_fields(TPodConfig) == _env_fields(JPodConfig) == ("off", 4, 3, 1, 0.4, 8, 4096)
    for name, value in SPEC_ENV.items():
        monkeypatch.setenv(name, value)
    assert _env_fields(TPodConfig) == _env_fields(JPodConfig) == (
        "prompt_lookup", 3, 2, 2, 0.25, 6, 512)


def _pod_answers(torch_side, prompts):
    """A pod of either framework from ``SPEC_ENV``'s engine fields on the
    shared parameters: completions over HTTP, then ``/metrics`` and the
    engine's ``spec_stats``."""
    jp, tp = _tiny()
    spec = dict(spec_decode="prompt_lookup", spec_k=3, spec_ngram=2, spec_rounds=2,
                spec_min_accept=0.25, spec_min_sample=6, spec_max_scan=512)
    eng = _engine(torch_side, **spec)
    cls, cfg_cls = (TPod, TPodConfig) if torch_side else (JPod, JPodConfig)
    server = cls(cfg_cls(model_name="tiny-llama", pod_identifier="spec-pod", publish_events=False,
                         engine=eng.config), engine=eng)
    server.start()

    async def scenario():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            out = []
            for p in prompts:
                resp = await client.post("/v1/completions",
                                         json={"prompt_token_ids": p, "max_tokens": 12})
                assert resp.status == 200
                out.append((await resp.json())["choices"][0]["token_ids"])
            metrics = await (await client.get("/metrics")).text()
            return out, metrics
        finally:
            await client.close()

    try:
        out, metrics = asyncio.run(scenario())
        return out, metrics, dict(server.engine.spec_stats)
    finally:
        server.shutdown()


def _metric(text, name):
    lines = [ln for ln in text.splitlines() if ln.startswith(name + " ")]
    assert len(lines) == 1, name
    return float(lines[0].split()[1])


def test_spec_pod_serves_jax_pods_completions_and_counts():
    prompts = [([7, 3, 9, 5, 2] * 6)[:21], _prompt(81, 11), ([6, 2] * 9)]
    t_out, t_metrics, t_stats = _pod_answers(True, prompts)
    j_out, j_metrics, j_stats = _pod_answers(False, prompts)
    assert t_out == j_out and t_stats == j_stats
    assert t_stats["bursts"] > 0 and t_stats["proposed"] > 0
    for key, family in (("proposed", "tpu_pod_spec_proposed_tokens_total"),
                        ("accepted", "tpu_pod_spec_accepted_tokens_total"),
                        ("verify_steps", "tpu_pod_spec_verify_steps_total"),
                        ("bursts", "tpu_pod_spec_bursts_total")):
        assert _metric(t_metrics, family) == t_stats[key] == _metric(j_metrics, family)
