"""Fleet self-healing with torch pods: ``tests/test_chaos.py``'s
``TestEngineFleetChaos`` pod-level scenarios, with the port's pods (CPU
engines) publishing through a fault-injecting link into the port's
indexer, events pool and ``FleetHealth``, and the port's router reading
them. A crashed pod is swept, a partition heals with one resync, periodic
resync converges after dropped batches, a drained pod is evicted at once
(the TTL is huge) and never routed to, a draining heartbeat unroutes a pod
before its goodbye, and a drained pod that restarts is routable again.
Greedy outputs on the survivor equal the crashed or drained pod's.
"""

import threading
import time

import pytest
import torch

from chaos import ChaosLink, engine_truth
from llm_d_kv_cache_manager_tpu_torch.kvcache import (
    BlendedRouter,
    KVCacheIndexer,
    KVCacheIndexerConfig,
    PrefixAffinityTracker,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import Key, TokenProcessorConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import (
    BlockStored,
    EventBatch,
    FleetHealth,
    FleetHealthConfig,
    Heartbeat,
    IndexSnapshot,
    KVEventsPool,
    KVEventsPoolConfig,
    Message,
)
from llm_d_kv_cache_manager_tpu_torch.server.serve import DrainingError
from torch_fleet import MODEL, PS, pod, prompt, sampling, wait_until


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class PortChaosLink(ChaosLink):
    """``tests/chaos.py``'s link with the port's wire: the port's
    ``EventBatch`` encodes each batch and the port's pool decodes it."""

    def publish(self, events, ts=None) -> int:
        batch = EventBatch(ts=ts if ts is not None else time.time(), events=list(events),
                           data_parallel_rank=self.config.data_parallel_rank)
        payload = batch.to_payload()
        for ev in batch.events:
            if isinstance(ev, BlockStored):
                self.seen_hashes.update(int(h) for h in ev.block_hashes)
            elif isinstance(ev, IndexSnapshot):
                for hashes in ev.blocks_by_medium.values():
                    self.seen_hashes.update(int(h) for h in hashes)
        with self._mu:
            seq = self._seq
            self._seq += 1  # consumed even when the batch is lost
            if self._partitioned or self._drop_next > 0:
                if self._drop_next > 0:
                    self._drop_next -= 1
                self.dropped_batches += 1
                return -1
        self.pool.add_task(Message(topic=self.topic, pod_identifier=self.pod_identifier,
                                   model_name=self.model_name, payload=payload, seq=seq))
        return seq


def index_view_of_pod(index, universe, pod_name) -> set[int]:
    """The subset of ``universe`` the port's index attributes to a pod."""
    view = set()
    for h in universe:
        key = Key(MODEL, int(h))
        if pod_name in index.lookup([key], set()).get(key, []):
            view.add(int(h))
    return view


class Fleet:
    """Torch pods publishing through ``PortChaosLink``s into one port
    indexer, events pool and ``FleetHealth``."""

    def __init__(self, n=2, ttl_s=5.0, **pod_kw):
        self.clock = FakeClock()
        self.health = FleetHealth(FleetHealthConfig(pod_ttl_s=ttl_s), clock=self.clock)
        self.indexer = KVCacheIndexer(
            KVCacheIndexerConfig(token_processor=TokenProcessorConfig(block_size=PS)),
            fleet_health=self.health,
        )
        self.pool = KVEventsPool(self.indexer.kv_block_index, KVEventsPoolConfig(concurrency=2),
                                 health=self.health)
        self.pool.start()
        self.pods = [f"chaos-pod-{i}" for i in range(n)]
        self.links = [PortChaosLink(self.pool, name, MODEL) for name in self.pods]
        self.servers = [pod(True, name, publisher=link, **pod_kw)
                        for name, link in zip(self.pods, self.links)]

    def scores(self, tokens, pods=None):
        return self.indexer.score_tokens(tokens, MODEL, pods or self.pods)

    def view(self, i):
        return index_view_of_pod(self.indexer.kv_block_index, self.links[i].seen_hashes,
                                 self.pods[i])

    def router(self):
        return BlendedRouter(
            score_fn=lambda toks, p: self.indexer.score_tokens(toks, MODEL, p),
            affinity=PrefixAffinityTracker(n_pods=len(self.pods), capacity_blocks=64),
            loads_fn=lambda p: [0.0] * len(p),
        )

    def close(self):
        for s in self.servers:
            s.shutdown()
        self.pool.shutdown()


@pytest.fixture
def fleet_factory():
    fleets = []

    def make(**kw):
        fleets.append(Fleet(**kw))
        return fleets[-1]

    yield make
    for f in fleets:
        f.close()


def test_pod_crash_swept_and_rerouted_cold(fleet_factory):
    f = fleet_factory(n=2)
    prefix = prompt(0, 16)
    baseline = f.servers[0].generate(prefix, sampling(True, max_new_tokens=3), timeout=120)
    assert f.pool.drain(timeout=10)
    assert f.scores(prefix)["chaos-pod-0"] > 0
    # Crash pod 0 (no evictions, no goodbye), then silence past the TTL
    # while pod 1 stays live.
    f.servers[0].shutdown()
    f.clock.advance(6.0)
    f.links[1].publish([Heartbeat()])
    assert f.pool.drain(timeout=10)
    assert f.scores(prefix) == {}
    assert f.health.sweep(f.indexer.kv_block_index) == ["chaos-pod-0"]
    assert f.view(0) == set()
    assert f.router().route(prefix, f.pods).index_score == 0
    seq = f.servers[1].generate(prefix, sampling(True, max_new_tokens=3), timeout=120)
    assert seq.output_tokens == baseline.output_tokens
    assert seq.num_cached_prompt == 0


def test_partition_heals_via_resync_to_ground_truth(fleet_factory):
    f = fleet_factory(n=1)
    server, link = f.servers[0], f.links[0]
    server.generate(prompt(1, 16), sampling(True, max_new_tokens=2), timeout=120)
    assert f.pool.drain(timeout=10)
    link.partition()
    for i in range(3):
        server.generate(prompt(10 + i, 24), sampling(True, max_new_tokens=2), timeout=120)
    link.heal()
    assert server.publish_index_snapshot(timeout_s=30)
    assert f.pool.drain(timeout=10)
    assert f.health.gaps_detected >= 1
    assert f.health.resyncs_applied == 1
    assert f.view(0) == engine_truth(server)


def test_periodic_resync_converges_after_drops(fleet_factory):
    f = fleet_factory(n=1, resync_interval_s=0.3, heartbeat_interval_s=0.2)
    server, link = f.servers[0], f.links[0]
    link.drop_next(2)  # lose the first prefill's event batches
    server.generate(prompt(2, 16), sampling(True, max_new_tokens=2), timeout=120)

    def converged():
        f.pool.drain(timeout=2)
        truth = engine_truth(server)
        return f.view(0) == truth and truth

    assert wait_until(converged, timeout=30)
    assert server.snapshots_published >= 1
    assert server.heartbeats_published >= 1
    assert f.health.heartbeats_seen >= 1


def test_drained_pod_evicted_immediately_and_never_routed(fleet_factory):
    f = fleet_factory(n=2, ttl_s=100_000.0)
    prefix = prompt(20, 16)
    baseline = f.servers[0].generate(prefix, sampling(True, max_new_tokens=3), timeout=120)
    assert f.pool.drain(timeout=10)
    assert f.scores(prefix)["chaos-pod-0"] > 0
    # No clock advance: eviction must come from the goodbye, not the TTL.
    assert f.servers[0].drain(timeout_s=30) is True
    assert f.pool.drain(timeout=10)
    assert f.health.snapshot()["pods_drained"] == 1
    assert f.view(0) == set()
    assert engine_truth(f.servers[0])  # the engine still holds its cache
    assert f.scores(prefix) == {}
    assert f.router().route(prefix, f.pods).index_score == 0
    with pytest.raises(DrainingError):
        f.servers[0].submit(prefix)
    seq = f.servers[1].generate(prefix, sampling(True, max_new_tokens=3), timeout=120)
    assert seq.output_tokens == baseline.output_tokens
    assert seq.num_cached_prompt == 0


def test_draining_heartbeat_unroutes_before_goodbye(fleet_factory):
    """A pod advertising ``draining`` stops being scored at once while its
    entries stay indexed, and a plain heartbeat restores it. Then the
    pod's own drain: it publishes the draining heartbeat before it waits
    for its in-flight request, so routing drops the pod before the
    goodbye, and only the goodbye evicts its entries."""
    f = fleet_factory(n=2, ttl_s=100_000.0, heartbeat_interval_s=30.0)
    prefix = prompt(21, 16)
    f.servers[0].generate(prefix, sampling(True, max_new_tokens=2), timeout=120)
    assert f.pool.drain(timeout=10)
    assert f.scores(prefix)["chaos-pod-0"] > 0
    f.links[0].publish([Heartbeat(draining=True)])
    assert f.pool.drain(timeout=10)
    assert f.scores(prefix) == {}
    assert f.view(0)
    f.links[0].publish([Heartbeat(draining=False)])
    assert f.pool.drain(timeout=10)
    assert f.scores(prefix)["chaos-pod-0"] > 0

    gate = threading.Event()
    orig = f.servers[0].engine.step

    def gated_step():
        gate.wait(30)
        return orig()

    f.servers[0].engine.step = gated_step
    inflight = f.servers[0].submit(prompt(23, 8), sampling(True, max_new_tokens=2))
    drain = threading.Thread(target=f.servers[0].drain, kwargs={"timeout_s": 60})
    drain.start()
    try:
        assert wait_until(lambda: f.health.snapshot()["pods"]["chaos-pod-0"]["draining"],
                          timeout=10)
        assert f.pool.drain(timeout=10)
        assert f.scores(prefix) == {}
        assert f.view(0)  # still indexed: the drain is not done
        assert f.health.snapshot()["pods_drained"] == 0
    finally:
        gate.set()
        drain.join(60)
    assert inflight.result(timeout=30).finish_reason is None
    assert f.pool.drain(timeout=10)
    assert f.health.snapshot()["pods_drained"] == 1 and f.view(0) == set()


def test_drained_pod_restart_revives_routing(fleet_factory):
    f = fleet_factory(n=1, ttl_s=100_000.0)
    prefix = prompt(22, 16)
    f.servers[0].generate(prefix, sampling(True, max_new_tokens=2), timeout=120)
    assert f.pool.drain(timeout=10)
    assert f.servers[0].drain(timeout_s=30) is True
    assert f.pool.drain(timeout=10)
    assert f.scores(prefix) == {}
    # "Restart": the same identity re-announces its warmth in a resync.
    digest = f.servers[0].engine.block_digest()
    assert digest == f.servers[0].engine.block_manager.block_digest()
    f.links[0].publish([IndexSnapshot(blocks_by_medium=digest)])
    assert f.pool.drain(timeout=10)
    assert f.scores(prefix)["chaos-pod-0"] > 0
