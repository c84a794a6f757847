"""The port's index backends against the JAX package's, on the CPU.

The scenarios of ``test_index_backends.py`` (``TestIndexConformance`` and
``TestNativeSpecifics``) run as sequences of operations on one backend of
each package, built the same way: in-memory, cost-aware, Redis (over
``fake_redis.FakeRedis``), the instrumented wrapper, native, and the
chain-hash-sharded facade over three in-memory shards and over a native
shard group. Every operation's result (lookups, pod evictions, fused
scores, sizes) is recorded, with keys as ``(model, hash)`` pairs, and the
two records must be equal. The concurrency hammer is nondeterministic, so
there both packages must come through without an error.
"""

from __future__ import annotations

import random
import threading
from types import SimpleNamespace

import pytest

from fake_redis import FakeRedis
from llm_d_kv_cache_manager_tpu.kvcache import kvblock as jax_kvblock
from llm_d_kv_cache_manager_tpu.kvcache import scorer as jax_scorer
from llm_d_kv_cache_manager_tpu.kvcache import sharding as jax_sharding
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import redis_index as jax_redis
from llm_d_kv_cache_manager_tpu_torch.kvcache import kvblock as port_kvblock
from llm_d_kv_cache_manager_tpu_torch.kvcache import scorer as port_scorer
from llm_d_kv_cache_manager_tpu_torch.kvcache import sharding as port_sharding
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import redis_index as port_redis

import torch_scoring  # noqa: F401  (the port's collector off the default registry)

SIDES = {
    "jax": SimpleNamespace(kb=jax_kvblock, scorer=jax_scorer, sharding=jax_sharding,
                           redis=jax_redis),
    "port": SimpleNamespace(kb=port_kvblock, scorer=port_scorer, sharding=port_sharding,
                            redis=port_redis),
}


def _in_memory(s, size=1000, pods=10):
    return s.kb.InMemoryIndex(s.kb.InMemoryIndexConfig(size=size, pod_cache_size=pods))


def _native(s, size=1000, pods=10):
    return s.kb.NativeMemoryIndex(s.kb.NativeMemoryIndexConfig(size=size, pod_cache_size=pods))


BACKENDS = {
    "in_memory": _in_memory,
    "cost_aware": lambda s: s.kb.CostAwareMemoryIndex(
        s.kb.CostAwareMemoryIndexConfig(max_cost_bytes=10**6)
    ),
    "redis": lambda s: s.redis.RedisIndex(s.kb.RedisIndexConfig(client=FakeRedis())),
    "instrumented": lambda s: s.kb.InstrumentedIndex(_in_memory(s)),
    "native": _native,
    "sharded": lambda s: s.sharding.ShardedIndex([_in_memory(s) for _ in range(3)], vnodes=16),
    "sharded_native": lambda s: s.sharding.ShardedIndex(
        s.kb.NativeMemoryIndex.shard_group(
            3, s.kb.NativeMemoryIndexConfig(size=1000, pod_cache_size=10)
        ),
        vnodes=16,
    ),
}


class Recorder:
    """One package's side of a scenario: builds keys and entries with that
    package's classes and records every result in package-free form."""

    def __init__(self, side):
        self.kb = side.kb
        self.side = side
        self.log = []

    def k(self, i, model="m"):
        return self.kb.Key(model, i)

    def e(self, pod, tier="tpu_hbm"):
        return self.kb.PodEntry(pod, self.kb.DeviceTier(tier))

    def lookup(self, index, keys, pods=()):
        got = index.lookup(keys, set(pods))
        self.log.append(
            ("lookup", sorted(((k.model_name, k.chunk_hash), list(v)) for k, v in got.items()))
        )

    def record(self, what, value):
        self.log.append((what, value))


# -- TestIndexConformance --------------------------------------------------------


def basic_add_and_lookup(r, index):
    keys = [r.k(1), r.k(2), r.k(3)]
    index.add(keys, [r.e("podA")])
    r.lookup(index, keys)


def duplicate_pod_handling(r, index):
    index.add([r.k(1)], [r.e("podA")])
    index.add([r.k(1)], [r.e("podA")])
    r.lookup(index, [r.k(1)])


def filtered_lookup(r, index):
    index.add([r.k(1)], [r.e("podA"), r.e("podB"), r.e("podC")])
    r.lookup(index, [r.k(1)], {"podB"})


def filter_no_match(r, index):
    index.add([r.k(1)], [r.e("podA")])
    r.lookup(index, [r.k(1)], {"podZ"})


def evict_basic(r, index):
    index.add([r.k(1)], [r.e("podA"), r.e("podB")])
    index.evict(r.k(1), [r.e("podA")])
    r.lookup(index, [r.k(1)])
    index.evict(r.k(1), [r.e("podB")])
    r.lookup(index, [r.k(1)])


def evict_missing_key_is_noop(r, index):
    index.evict(r.k(99), [r.e("podA")])
    r.lookup(index, [r.k(99)])


def multiple_tiers_same_pod(r, index):
    index.add([r.k(1)], [r.e("podA"), r.e("podA", "host_dram")])
    r.lookup(index, [r.k(1)])
    index.evict(r.k(1), [r.e("podA")])
    r.lookup(index, [r.k(1)])


def evict_pod_removes_every_entry(r, index):
    index.add([r.k(1), r.k(2)], [r.e("podA"), r.e("podB")])
    index.add([r.k(3)], [r.e("podA", "host_dram")])
    index.add([r.k(4, "other-model")], [r.e("podA")])
    r.record("evict_pod", index.evict_pod("podA"))
    r.lookup(index, [r.k(1), r.k(2)])
    r.lookup(index, [r.k(3)])
    r.lookup(index, [r.k(4, "other-model")])


def evict_pod_multi_tier_same_key(r, index):
    index.add([r.k(1)], [r.e("podA"), r.e("podA", "host_dram")])
    r.record("evict_pod", index.evict_pod("podA"))
    r.lookup(index, [r.k(1)])


def evict_pod_remote_tier_keyed_to_holder(r, index):
    index.add([r.k(1)], [r.e("demoter")])
    index.add([r.k(1), r.k(2)], [r.e("kv-holder", "remote")])
    r.record("evict_pod", index.evict_pod("demoter"))
    r.lookup(index, [r.k(1), r.k(2)])
    r.record("evict_pod", index.evict_pod("kv-holder"))
    r.lookup(index, [r.k(1), r.k(2)])


def evict_remote_tier_entry_by_medium(r, index):
    index.add([r.k(1)], [r.e("pod"), r.e("pod", "remote")])
    index.evict(r.k(1), [r.e("pod", "remote")])
    r.lookup(index, [r.k(1)])
    index.evict(r.k(1), [r.e("pod")])
    r.lookup(index, [r.k(1)])


def evict_pod_unknown_is_noop(r, index):
    index.add([r.k(1)], [r.e("podA")])
    r.record("evict_pod", index.evict_pod("never-seen"))
    r.lookup(index, [r.k(1)])


def evict_pod_then_readd_revives(r, index):
    index.add([r.k(1)], [r.e("podA")])
    index.evict_pod("podA")
    index.add([r.k(1)], [r.e("podA")])
    r.lookup(index, [r.k(1)])


CONFORMANCE = [
    basic_add_and_lookup,
    duplicate_pod_handling,
    filtered_lookup,
    filter_no_match,
    evict_basic,
    evict_missing_key_is_noop,
    multiple_tiers_same_pod,
    evict_pod_removes_every_entry,
    evict_pod_multi_tier_same_key,
    evict_pod_remote_tier_keyed_to_holder,
    evict_remote_tier_entry_by_medium,
    evict_pod_unknown_is_noop,
    evict_pod_then_readd_revives,
]


NATIVE_BACKENDS = {"native", "sharded_native"}


def _need_jax_native():
    if not jax_kvblock.native_available():
        pytest.skip("the JAX package's liblruindex.so is not built")


def _run(scenario, make):
    logs = {}
    for name, side in SIDES.items():
        r = Recorder(side)
        scenario(r, make(side))
        logs[name] = r.log
    return logs


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("scenario", CONFORMANCE, ids=lambda f: f.__name__)
def test_conformance_matches_jax(scenario, backend):
    if backend in NATIVE_BACKENDS:
        _need_jax_native()
    logs = _run(scenario, BACKENDS[backend])
    assert logs["port"] == logs["jax"]
    assert logs["port"]


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_concurrent_operations(backend):
    """The hammer of the JAX suite on both packages' backends: 20 threads of
    adds, lookups, evictions and pod sweeps raise nothing."""
    if backend in NATIVE_BACKENDS:
        _need_jax_native()
    for side in SIDES.values():
        r = Recorder(side)
        index = BACKENDS[backend](side)
        errors = []

        def worker(tid):
            try:
                for i in range(25):
                    key, entry = r.k(i % 7), r.e(f"pod{tid % 3}")
                    op = (tid + i) % 4
                    if op == 0:
                        index.add([key], [entry])
                    elif op == 1:
                        index.lookup([key], set())
                    elif op == 2:
                        index.evict(key, [entry])
                    else:
                        index.evict_pod(entry.pod_identifier)
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors


# -- TestNativeSpecifics ---------------------------------------------------------


def lru_key_eviction_bound(r, s):
    idx = _native(s, size=2)
    idx.add([r.k(1), r.k(2), r.k(3)], [r.e("podA")])
    r.lookup(idx, [r.k(1), r.k(2), r.k(3)])
    r.record("len", len(idx))


def pod_lru_bound(r, s):
    idx = _native(s, size=10, pods=2)
    for pod in ("podA", "podB", "podC"):
        idx.add([r.k(1)], [r.e(pod)])
    r.lookup(idx, [r.k(1)])


def lookup_promotes_key_recency(r, s):
    idx = _native(s, size=2, pods=4)
    idx.add([r.k(1), r.k(2)], [r.e("podA")])
    r.lookup(idx, [r.k(1)])
    idx.add([r.k(3)], [r.e("podA")])
    r.lookup(idx, [r.k(1), r.k(2), r.k(3)])


def early_stop_on_emptied_key(r, s):
    idx = _native(s, size=10, pods=4)
    idx.add([r.k(1), r.k(2), r.k(3)], [r.e("podA")])
    idx.add([r.k(2)], [r.e("podB")])
    idx.evict(r.k(2), [r.e("podA")])
    idx.evict(r.k(2), [r.e("podB")])
    r.lookup(idx, [r.k(1), r.k(2), r.k(3)])


def mixed_model_batches(r, s):
    idx = _native(s, size=10, pods=4)
    idx.add([r.k(1, "m1")], [r.e("podA")])
    idx.add([r.k(1, "m2")], [r.e("podB")])
    r.lookup(idx, [r.k(1, "m1"), r.k(1, "m2")])


def unknown_model_lookup_empty(r, s):
    r.lookup(_native(s, size=10, pods=4), [r.k(1, "never-seen")])


def fused_score_matches_python_pipeline(r, s):
    rng = random.Random(0)
    scorer = s.scorer.LongestPrefixScorer()
    for _ in range(50):
        native, mirror = _native(s, 100, 8), _in_memory(s, 100, 8)
        keys = [r.k(i) for i in range(rng.randint(1, 12))]
        for pod in ("podA", "podB", "podC"):
            depth = rng.randint(0, len(keys))
            chain = [k for k in keys[:depth] if rng.random() > 0.15]
            if chain:
                for idx in (native, mirror):
                    idx.add(chain, [r.e(pod)])
        pods = rng.choice([set(), {"podA"}, {"podA", "podB"}, {"podZ"}])
        r.record("fused", native.score_longest_prefix(keys, pods))
        r.record("two_step", scorer.score(keys, mirror.lookup(keys, pods)))


def fused_score_multi_tier_dedup(r, s):
    idx = _native(s, size=10, pods=8)
    idx.add([r.k(1), r.k(2)], [r.e("podA")])
    idx.add([r.k(1)], [r.e("podA", "host_dram")])
    r.record("fused", idx.score_longest_prefix([r.k(1), r.k(2)], set()))


def fused_score_promotes_past_holes(r, s):
    idx = _native(s, size=2, pods=4)
    idx.add([r.k(1), r.k(2)], [r.e("podA")])
    r.record("fused", idx.score_longest_prefix([r.k(99), r.k(1)], set()))
    idx.add([r.k(3)], [r.e("podA")])
    r.lookup(idx, [r.k(1), r.k(2), r.k(3)])


def fused_score_hits_match_two_step_semantics(r, s):
    idx = _native(s, size=16, pods=4)
    keys = [r.k(i) for i in range(10)]
    idx.add(keys[:2] + keys[3:], [r.e("podA")])
    r.record("with_hits", idx.score_hashes_with_hits("m", [k.chunk_hash for k in keys], set()))


def unknown_filter_pod_still_promotes(r, s):
    idx = _native(s, size=2, pods=4)
    idx.add([r.k(1), r.k(2)], [r.e("podA")])
    r.lookup(idx, [r.k(1)], {"podZ"})
    idx.add([r.k(3)], [r.e("podA")])
    r.lookup(idx, [r.k(1), r.k(2), r.k(3)])


def fused_score_mixed_models_falls_back(r, s):
    idx = _native(s, size=10, pods=8)
    idx.add([r.k(1, "m1")], [r.e("podA")])
    r.record("fused", idx.score_longest_prefix([r.k(1, "m1"), r.k(1, "m2")], set()))


NATIVE = [
    lru_key_eviction_bound,
    pod_lru_bound,
    lookup_promotes_key_recency,
    early_stop_on_emptied_key,
    mixed_model_batches,
    unknown_model_lookup_empty,
    fused_score_matches_python_pipeline,
    fused_score_multi_tier_dedup,
    fused_score_promotes_past_holes,
    fused_score_hits_match_two_step_semantics,
    unknown_filter_pod_still_promotes,
    fused_score_mixed_models_falls_back,
]


@pytest.mark.parametrize("scenario", NATIVE, ids=lambda f: f.__name__)
def test_native_specifics_match_jax(scenario):
    _need_jax_native()
    logs = {}
    for name, side in SIDES.items():
        r = Recorder(side)
        scenario(r, side)
        logs[name] = r.log
    assert logs["port"] == logs["jax"]
    assert logs["port"]


def test_native_libraries_are_the_ports_own():
    """Both packages' native indexes live in one process, each on its own
    library: the port's is built from its own sources under ``build/``."""
    from llm_d_kv_cache_manager_tpu.native import lruindex as jax_lru
    from llm_d_kv_cache_manager_tpu_torch.native import build, hashcore, lruindex

    assert port_kvblock.native_available() and hashcore.available()
    ours = {lruindex._load()._name, hashcore._load()._name}
    assert ours == {str(build.library_path(n)) for n in build.LIBS}
    assert all("/build/native/" in path for path in ours)
    if jax_lru.available():
        assert jax_lru._load()._name not in ours
