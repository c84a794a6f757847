"""The port's fleet router (``kvcache/router.py``, a copy of the JAX
package's): ``tests/test_router.py``'s cases on the port's classes, then a
seeded stream of 200 routing inputs (tokens, pods, index scores, loads,
time) through both packages' ``BlendedRouter`` — plain, with a
``TransferCostModel`` (and its remote-holder arm) and with the
``TTFTPredictor`` — and of 200 fleet views through both ``TwoHopPlanner``s.
Every ``RoutingDecision`` and every plan (or ``PlanError``) must be equal
field for field: the comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from llm_d_kv_cache_manager_tpu import kvcache as jk
from llm_d_kv_cache_manager_tpu.kvcache.transfer import cost_model as jcm
from llm_d_kv_cache_manager_tpu_torch import kvcache as tk
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.keys import PodEntry
from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer import cost_model as tcm

BS = 4
MODEL = "m"
N_INPUTS = 200
POD_NAMES = ["a", "b", "c", "d", "e"]


def _tracker(n_pods=3, capacity=64, ttl=None, pkg=tk):
    kvblock = pkg.kvblock
    return pkg.PrefixAffinityTracker(
        n_pods, capacity, ttl_s=ttl,
        token_processor=kvblock.ChunkedTokenDatabase(kvblock.TokenProcessorConfig(block_size=BS)),
    )


# -- tests/test_router.py on the port ------------------------------------------
class TestPrefixAffinityTracker:
    def test_sticky_after_record(self):
        t = _tracker()
        keys = t.keys(list(range(16)))
        assert all(t.score(keys, p) == 0 for p in range(3))
        t.record(keys, 1)
        assert t.score(keys, 1) == len(keys) == 4
        assert t.score(keys, 0) == 0

    def test_consecutive_prefix_semantics(self):
        t = _tracker()
        keys = t.keys(list(range(16)))
        t.record(keys[1:2], 2)
        assert t.score(keys, 2) == 0

    def test_capacity_lru_evicts_oldest(self):
        t = _tracker(capacity=4)
        a = t.keys(list(range(16)))
        b = t.keys(list(range(100, 116)))
        t.record(a, 0)
        t.record(b, 0)
        assert t.score(b, 0) == 4
        assert t.score(a, 0) == 0

    def test_ttl_expires_affinity(self):
        t = _tracker(ttl=5.0)
        keys = t.keys(list(range(16)))
        t.record(keys, 0, now=10.0)
        assert t.score(keys, 0, now=12.0) == 4
        assert t.score(keys, 0, now=16.1) == 0


class TestBlendedRouter:
    def _setup(self, loads):
        ix = tk.KVCacheIndexer(
            tk.KVCacheIndexerConfig(token_processor=TokenProcessorConfig(block_size=BS)))
        router = tk.BlendedRouter(
            score_fn=lambda toks, p: ix.score_tokens(toks, MODEL, p),
            affinity=_tracker(),
            loads_fn=lambda p: [loads[x] for x in p],
        )
        return ix, ["a", "b", "c"], router

    def test_index_score_dominates(self):
        loads = {"a": 0, "b": 9, "c": 0}
        ix, pods, router = self._setup(loads)
        toks = list(range(16))
        keys = ix.token_processor.tokens_to_kv_block_keys(toks, MODEL)
        ix.kv_block_index.add(keys, [PodEntry("b", "tpu_hbm")])
        assert router.route(toks, pods).pod == "b"
        ix.shutdown()

    def test_cold_index_uses_load_then_sticks(self):
        loads = {"a": 3, "b": 1, "c": 2}
        ix, pods, router = self._setup(loads)
        toks = list(range(16))
        assert router.route(toks, pods).pod == "b"
        loads["b"] = 99
        again = router.route(toks, pods)
        assert again.pod == "b" and again.affinity_score > 0
        assert router.route(list(range(200, 216)), pods).pod == "c"
        ix.shutdown()

    def test_decision_reports_decision_time_scores(self):
        loads = {"a": 0, "b": 0, "c": 0}
        ix, pods, router = self._setup(loads)
        toks = list(range(16))
        first = router.route(toks, pods)
        assert first.index_score == 0 and first.affinity_score == 0
        again = router.route(toks, pods)
        assert again.pod == first.pod and again.affinity_score == 4
        ix.shutdown()


def test_exports_match_the_jax_package():
    assert tk.__all__ == jk.__all__
    assert ChunkedTokenDatabase is tk.kvblock.ChunkedTokenDatabase


# -- a seeded stream through both routers --------------------------------------
def _stream(seed: int) -> list[dict]:
    """``N_INPUTS`` routing inputs: tokens drawn from a few shared prefixes
    (so affinity and index scores recur), a shuffled subset of the pods,
    index scores for some of them, loads, a rising clock, the cost model's
    rates, a remote holder's blocks and per-pod predictor signals."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 500, 32).tolist() for _ in range(6)]
    out, now = [], 0.0
    for _ in range(N_INPUTS):
        n_pods = int(rng.integers(1, len(POD_NAMES) + 1))
        pods = [POD_NAMES[i] for i in rng.permutation(len(POD_NAMES))[:n_pods]]
        prefix = prefixes[int(rng.integers(len(prefixes)))]
        tokens = prefix[: int(rng.integers(0, 33))] + rng.integers(0, 500, int(rng.integers(0, 9))).tolist()
        scored = [p for p in pods if rng.random() < 0.5]
        now += float(rng.exponential(1.0))
        out.append({
            "tokens": tokens,
            "pods": pods,
            "scores": {p: int(rng.integers(0, 10)) for p in scored},
            "loads": [int(rng.integers(0, 6)) for _ in pods],
            "now": now,
            "transfer_bytes_s": float(rng.choice([1e3, 1e5, 1e7, 1e9])),
            "prefill_tokens_s": float(rng.choice([10.0, 1e3, 1e5])),
            "remote": ({f"holder-{int(rng.integers(2))}": int(rng.integers(0, 12))}
                       if rng.random() < 0.4 else {}),
            "signals": [
                {"name": p, "queue_depth": None if rng.random() < 0.2 else float(rng.integers(0, 6)),
                 "prefill_rate": None if rng.random() < 0.3 else float(rng.choice([50.0, 500.0, 5e3])),
                 "draining": bool(rng.random() < 0.1), "dead": bool(rng.random() < 0.05),
                 "admitting": bool(rng.random() < 0.9)}
                for p in pods
            ],
        })
    return out


def _router(pkg, cm_mod, variant: str, feed: dict):
    """One package's router over the current input in ``feed``."""
    cost_model = None
    if variant != "plain":
        cost_model = cm_mod.TransferCostModel(
            cm_mod.TransferCostModelConfig(block_bytes=2048, block_size=BS, max_pull_blocks=6))
    predictor = signals_fn = None
    if variant == "predictor":
        predictor = pkg.TTFTPredictor(pkg.TTFTPredictorConfig(block_size=BS))

        def signals_fn(pods):
            return [pkg.PodSignals(**s) for s in feed["input"]["signals"]]

    router = pkg.BlendedRouter(
        score_fn=lambda toks, pods: dict(feed["input"]["scores"]),
        affinity=_tracker(n_pods=len(POD_NAMES), capacity=16, ttl=5.0, pkg=pkg),
        loads_fn=lambda pods: list(feed["input"]["loads"]),
        cost_model=cost_model,
        remote_score_fn=(lambda toks: dict(feed["input"]["remote"]))
        if variant in ("cost_model_remote", "predictor") else None,
        predictor=predictor,
        signals_fn=signals_fn,
    )
    return router, cost_model


@pytest.mark.parametrize("variant", ["plain", "cost_model", "cost_model_remote", "predictor"])
def test_router_decisions_identical(variant):
    stream = _stream(seed=7)
    feed = {}
    sides = [_router(tk, tcm, variant, feed), _router(jk, jcm, variant, feed)]
    actions = set()
    for item in stream:
        feed["input"] = item
        decisions = []
        for router, cost_model in sides:
            if cost_model is not None:
                cost_model.seed_rates(transfer_bytes_s=item["transfer_bytes_s"],
                                      prefill_tokens_s=item["prefill_tokens_s"])
            decisions.append(dataclasses.asdict(router.route(item["tokens"], item["pods"],
                                                             now=item["now"])))
        assert decisions[0] == decisions[1], item
        actions.add(decisions[0]["action"])
    # The stream reaches the arms the variant adds.
    if variant != "plain":
        assert {"route_warm", "pull"} <= actions, actions
    else:
        assert actions == {"route_warm"}


def _views(rng, pkg) -> list:
    n = int(rng.integers(1, 6))
    return [
        pkg.PodView(
            name=f"pod-{i}",
            role=str(rng.choice(["prefill", "decode", "mixed"])),
            transfer_endpoint=None if rng.random() < 0.25 else f"tcp://pod-{i}:5558",
            draining=bool(rng.random() < 0.15),
            dead=bool(rng.random() < 0.1),
            breaker_open=bool(rng.random() < 0.15),
            queue_depth=float(rng.integers(0, 5)),
            prefill_rate=None if rng.random() < 0.3 else float(rng.choice([100.0, 1000.0])),
        )
        for i in range(n)
    ]


def test_two_hop_plans_identical():
    plans = {}
    for pkg in (tk, jk):
        rng = np.random.default_rng(11)
        scores = {}
        planner = pkg.TwoHopPlanner(score_fn=lambda toks, names: dict(scores))
        out = []
        for _ in range(N_INPUTS):
            views = _views(rng, pkg)
            scores = {v.name: int(rng.integers(0, 8)) for v in views if rng.random() < 0.6}
            exclude = {v.name for v in views if rng.random() < 0.1}
            tokens = rng.integers(0, 500, 12).tolist()
            try:
                out.append(dataclasses.asdict(planner.plan(tokens, views, exclude=exclude)))
            except pkg.PlanError as e:
                out.append(("PlanError", str(e)))
        plans[pkg.__name__] = out
    t, j = plans.values()
    assert t == j
    modes = {p["mode"] if isinstance(p, dict) else p[0] for p in t}
    assert modes == {"disagg", "single", "PlanError"}
