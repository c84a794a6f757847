"""The rows of the port's prefill dispatch: ``Engine._run_prefill`` builds
one row a scheduled sequence, not ``max_prefill_batch`` rows as the JAX
engine pads to. On the CPU: the engine's dispatch width against the
sequences it was handed; ``llama.prefill`` over the trimmed rows against
the same rows padded as before (equal logits, bit-equal pools, page 0
included), dense, routed MoE and int8 pools; and the engine's greedy
tokens and KV events at ``max_prefill_batch`` 1 against 8, chunked
prefill off and on."""

import dataclasses

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents.events import EventBatch
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig,
    Engine,
    EngineConfig,
    SamplingParams,
    SchedulerConfig,
)

PS = 4


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(1, 250, n).tolist()


def _engine(batch: int, chunked=None, on_events=None, params=None) -> Engine:
    cfg = EngineConfig(
        model=llama.TINY_LLAMA,
        block_manager=BlockManagerConfig(total_pages=96, page_size=PS),
        scheduler=SchedulerConfig(max_prefill_batch=batch, chunked_prefill_tokens=chunked),
        max_model_len=96, decode_batch_size=4, prefill_bucket=8,
    )
    return Engine(cfg, params=params, on_events=on_events, device="cpu")


def _dispatch_rows(monkeypatch) -> list[int]:
    """Wrap ``llama.prefill``: the row count of each dispatch."""
    rows = []
    real = llama.prefill

    def prefill(params, cfg, tokens, *args, **kw):
        rows.append(tokens.shape[0])
        return real(params, cfg, tokens, *args, **kw)

    monkeypatch.setattr(llama, "prefill", prefill)
    return rows


@pytest.mark.parametrize("waiting", [1, 3])
def test_dispatch_has_one_row_a_sequence(monkeypatch, waiting):
    eng = _engine(batch=8)
    rows = _dispatch_rows(monkeypatch)
    for i in range(waiting):
        eng.add_request(_prompt(i, 5 + 3 * i), SamplingParams(max_new_tokens=3))
    eng.step()
    assert rows == [waiting]
    eng.run_until_complete()
    assert rows == [waiting]  # decode dispatches no prefill


# -- llama.prefill: trimmed rows against the padded dispatch ---------------
CASES = {
    "dense": (llama.TINY_LLAMA, None),
    "dense_bf16": (dataclasses.replace(llama.TINY_LLAMA, dtype=torch.bfloat16), None),
    "routed_moe": (llama.TINY_QWEN3_MOE, None),
    "int8_pools": (llama.TINY_LLAMA, "int8"),
}
TOTAL_PAGES = 24
#: (prompt tokens, pages held as context, pages the chunk writes): one
#: warm row over two cached pages, one cold row; page 0 belongs to no row.
ROWS = [
    (list(range(7, 14)), [3, 5], [6, 9]),
    (list(range(30, 35)), [], [11, 12]),
]


def _pools(cfg, kv_quant_hbm, gen):
    """Pools holding random bytes everywhere, reserved page 0 included."""
    k, v = llama.init_kv_pages(cfg, TOTAL_PAGES, PS, "cpu", kv_quant_hbm)
    if kv_quant_hbm:
        for p in (k, v):
            p.copy_(torch.randint(-127, 128, p.shape, generator=gen, dtype=torch.int8))
        ks, vs = llama.init_kv_scales(cfg, TOTAL_PAGES, "cpu")
        for s in (ks, vs):
            s.copy_(torch.rand(s.shape, generator=gen) * 0.05 + 0.01)
        return [k, v, ks, vs]
    for p in (k, v):
        p.copy_(torch.randn(p.shape, generator=gen).to(p.dtype))
    return [k, v]


def _prefill(params, cfg, pools, b):
    """The engine's host arrays for ``ROWS`` at ``b`` rows (rows past
    ``len(ROWS)`` zero, as the padded dispatch built them), one call."""
    chunk, ctx_pages = 8, 4
    arrays = {n: np.zeros((b, chunk), t) for n, t in
              (("tokens", np.int32), ("positions", np.int32), ("valid", bool),
               ("page_ids", np.int32), ("slot_ids", np.int32))}
    ctx_bt = np.zeros((b, ctx_pages), np.int32)
    ctx_lens = np.zeros((b,), np.int32)
    for i, (toks, ctx, fresh) in enumerate(ROWS):
        start, n = len(ctx) * PS, len(toks)
        pos = np.arange(start, start + n)
        table = np.asarray(ctx + fresh, np.int32)
        arrays["tokens"][i, :n] = toks
        arrays["positions"][i, :n] = pos
        arrays["valid"][i, :n] = True
        arrays["page_ids"][i, :n] = table[pos // PS]
        arrays["slot_ids"][i, :n] = pos % PS
        ctx_bt[i, : len(ctx)] = ctx
        ctx_lens[i] = start
    t = {n: torch.from_numpy(a) for n, a in arrays.items()}
    scales = dict(k_scales=pools[2], v_scales=pools[3]) if len(pools) == 4 else {}
    return llama.prefill(
        params, cfg, t["tokens"], t["positions"], t["valid"], pools[0], pools[1],
        t["page_ids"], t["slot_ids"], torch.from_numpy(ctx_bt), torch.from_numpy(ctx_lens),
        attn_impl="pallas", **scales,
    )[0]


@pytest.mark.parametrize("case", list(CASES))
def test_trimmed_dispatch_equals_padded(case):
    cfg, kv_quant_hbm = CASES[case]
    gen = torch.Generator().manual_seed(7)
    params = llama.init_params(cfg, gen, "cpu")
    padded = _pools(cfg, kv_quant_hbm, gen)
    trimmed = [p.clone() for p in padded]
    before = [p.clone() for p in padded]
    want = _prefill(params, cfg, padded, b=8)
    got = _prefill(params, cfg, trimmed, b=len(ROWS))
    assert got.shape[0] == len(ROWS)
    assert torch.equal(got, want[: len(ROWS)])
    for p, t, old in zip(padded, trimmed, before):
        assert torch.equal(p, t)
        assert torch.equal(p[:, 0], old[:, 0])  # padded rows left page 0 as it was
        assert not torch.equal(p, old)  # the chunk was written


# -- the engine at one row a step against eight ----------------------------
def _serve(batch: int, chunked, params):
    events = []
    eng = _engine(batch, chunked, on_events=lambda evs: events.extend(evs), params=params)
    lengths = [5, 19, 11, 27]
    seqs = [eng.add_request(_prompt(40 + i, n), SamplingParams(max_new_tokens=6))
            for i, n in enumerate(lengths)]
    eng.run_until_complete()
    # A request sharing the first one's prompt: a warm prefill over its pages.
    seqs.append(eng.add_request(_prompt(40, 5) + _prompt(50, 9), SamplingParams(max_new_tokens=4)))
    eng.run_until_complete()
    payloads = sorted(EventBatch(ts=0.0, events=[e]).to_payload() for e in events)
    return [s.generated_tokens for s in seqs], payloads, eng.prefill_stats["dispatches"]


@pytest.mark.parametrize("chunked", [None, 24], ids=["whole", "chunked"])
def test_engine_tokens_and_events_match_one_row_batches(chunked):
    params = llama.init_params(llama.TINY_LLAMA, torch.Generator().manual_seed(3), "cpu")
    one_tokens, one_events, one_dispatches = _serve(1, chunked, params)
    wide_tokens, wide_events, wide_dispatches = _serve(8, chunked, params)
    assert wide_tokens == one_tokens
    assert wide_events == one_events and one_events
    assert wide_dispatches < one_dispatches  # the wide engine batched rows
