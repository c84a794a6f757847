"""Live migration, warm revival and the fleet controller on the port's
pods, on the cases of ``tests/test_fleet_controller.py``:
``TestLiveMigration``, ``TestWarmChains``, ``TestFleetEndToEnd`` and
``TestStatsGating``, plus its decision table run on both packages'
controllers (the controller modules are copies).

Pods run TINY_LLAMA on shared parameters (the port's engine on the CPU,
the JAX engine in interpret mode) over real ZMQ transfer sockets on
127.0.0.1. Held exactly: a migrated sequence's greedy tokens equal the
unmigrated run's, torch to torch and JAX to torch (the migration frame and
the page bytes are one wire); the dead-target and draining-target
fallbacks keep that parity; pages come back to baseline; and
``queue_depth`` counts a migrated-in continuation from its admission to
its resolution, once.
"""

import asyncio
import threading
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import chip_smoke
from conftest import free_tcp_port
from llm_d_kv_cache_manager_tpu.kvcache import controller as j_controller
from llm_d_kv_cache_manager_tpu_torch.kvcache import controller as t_controller
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import FleetHealth, FleetHealthConfig
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServerConfig as TPodConfig
from test_fleet_controller import BURNING, CALM, FLAT, STEEP, FakeClock
from torch_fleet import PS, SIDES, pod, prompt, sampling, wait_until


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _endpoint() -> str:
    return f"tcp://127.0.0.1:{free_tcp_port()}"


def _park(server, rid, min_generated=4) -> "chip_smoke.StepGate":
    """Stop the pod's engine steps from the first step at which request
    ``rid`` has decoded ``min_generated`` tokens (the loop still serves its
    queues, so a migration can freeze it) until ``release``. Set up before
    the request is submitted, it parks the request mid-decode however fast
    the engine runs; ``parked`` is set once it has."""
    gate = chip_smoke.StepGate(server.engine)
    sch = server.engine.scheduler
    gate.park_when = lambda: any(s.request_id == rid and s.num_generated >= min_generated
                                 for s in list(sch.running) + list(sch.prefilling))
    gate.running.set()
    return gate


def _reference(prompt_tokens, max_new_tokens):
    """The unmigrated run's tokens, from both packages' pods (equal)."""
    outs = []
    for side in SIDES:
        ref = pod(side, "mig-ref")
        try:
            outs.append(list(ref.generate(prompt_tokens, sampling(side, max_new_tokens=max_new_tokens),
                                          timeout=300).generated_tokens))
            if side:
                free = ref.engine.block_manager.num_free
        finally:
            ref.shutdown()
    assert outs[0] == outs[1]
    return outs[0], free


# ---------------------------------------------------------------------------
# Live migration over real ZMQ
# ---------------------------------------------------------------------------
class TestLiveMigration:
    @pytest.mark.parametrize("src_side", SIDES, ids=["torch_to_torch", "jax_to_torch"])
    def test_migrated_sequence_is_greedy_identical(self, src_side):
        """Migrate an in-flight decode mid-sequence: the continuation's
        tokens equal the unmigrated run's, token for token, and both pods'
        ``queue_depth`` account for the move exactly once."""
        ep = _endpoint()
        p = prompt(42, 16)
        base, ref_free = _reference(p, 12)
        src = pod(src_side, "mig-src", fleet_controller=True)
        tgt = pod(True, "mig-tgt", fleet_controller=True, transfer_endpoint=ep)
        try:
            park = _park(src, "mig-1")
            fut = src.submit(p, sampling(src_side, max_new_tokens=12), request_id="mig-1")
            assert park.parked.wait(120)
            t0 = time.monotonic()
            assert src.migrate_out("mig-1", ep)
            migrate_s = time.monotonic() - t0
            park.release()
            local = fut.result(timeout=60)
            assert local.finish_reason == "migrated"
            cont_fut = tgt.migrated_future("mig-1")
            cont = cont_fut.result(timeout=300)
            assert cont.generated_tokens == base
            assert cont.finish_reason is None or cont.finish_reason == "length"
            assert cont.num_cached_prompt > 0  # the shipped chain served it warm
            assert src.migrations_out == 1 and tgt.migrations_in == 1
            assert migrate_s < src.config.drain_timeout_s
            # Resolved once on each side: nothing left in either count.
            assert wait_until(lambda: tgt.queue_depth == 0)
            assert src.queue_depth == 0
            with tgt._mu:
                assert tgt._pending_tokens == 0
            assert src.engine.block_manager.num_free == ref_free
        finally:
            src.shutdown()
            tgt.shutdown()

    def test_queue_depth_counts_a_migrated_in_continuation_once(self):
        """The target's ``queue_depth`` (admitted, unresolved requests)
        takes the continuation in at its admission and lets it go at its
        resolution; the source lets the frozen request go at the settle."""
        ep = _endpoint()
        src = pod(True, "qd-src", fleet_controller=True)
        tgt = pod(True, "qd-tgt", fleet_controller=True, transfer_endpoint=ep)
        try:
            park = _park(src, "qd-1", min_generated=2)
            fut = src.submit(prompt(43, 16), sampling(True, max_new_tokens=40), request_id="qd-1")
            assert park.parked.wait(120)
            assert src.queue_depth == 1 and tgt.queue_depth == 0
            # Hold the target's engine so the continuation stays admitted.
            release = threading.Event()
            orig_step = tgt.engine.step

            def held_step():
                release.wait(30)
                return orig_step()

            tgt.engine.step = held_step
            assert src.migrate_out("qd-1", ep)
            park.release()
            assert fut.result(timeout=60).finish_reason == "migrated"
            assert src.queue_depth == 0
            assert tgt.queue_depth == 1
            with tgt._mu:
                assert tgt._pending_tokens == 16
            release.set()
            cont = tgt.migrated_future("qd-1").result(timeout=300)
            assert len(cont.generated_tokens) == 40
            assert wait_until(lambda: tgt.queue_depth == 0)
            with tgt._mu:
                assert tgt._pending_tokens == 0
        finally:
            src.shutdown()
            tgt.shutdown()

    def test_dead_target_falls_back_to_local_with_parity(self):
        """The target is dead: the frozen sequence resumes locally,
        finishes token-identical, and the pages come back to baseline."""
        p = prompt(7, 16)
        base, ref_free = _reference(p, 12)
        src = pod(True, "dead-src", fleet_controller=True)
        src.config.transfer_timeout_s = 0.4
        try:
            park = _park(src, "mig-x")
            fut = src.submit(p, sampling(True, max_new_tokens=12), request_id="mig-x")
            assert park.parked.wait(120)
            assert not src.migrate_out("mig-x", _endpoint())
            park.release()
            assert src.migration_fallbacks == 1
            out = fut.result(timeout=300)
            assert out.finish_reason != "migrated"
            assert out.generated_tokens == base
            assert src.engine.lifecycle_stats.get("migration_fallback") == 1
            assert src.engine.lifecycle_stats.get("migration_frozen") == 1
            assert src.engine.block_manager.num_free == ref_free
            assert src.queue_depth == 0
        finally:
            src.shutdown()

    def test_draining_target_refuses_and_source_falls_back(self):
        ep = _endpoint()
        p = prompt(8, 12)
        base, _ = _reference(p, 10)
        src = pod(True, "drn-src", fleet_controller=True)
        tgt = pod(True, "drn-tgt", fleet_controller=True, transfer_endpoint=ep)
        try:
            tgt.drain(timeout_s=5)
            park = _park(src, "r-d", min_generated=2)
            fut = src.submit(p, sampling(True, max_new_tokens=10), request_id="r-d")
            assert park.parked.wait(120)
            assert not src.migrate_out("r-d", ep)
            park.release()
            out = fut.result(timeout=300)
            assert out.generated_tokens == base
            assert tgt.migrations_in == 0 and tgt.queue_depth == 0
        finally:
            src.shutdown()
            tgt.shutdown()

    def test_knob_off_migrate_out_is_inert(self):
        server = pod(True, "legacy")
        try:
            assert server.config.fleet_controller is False
            assert TPodConfig.from_env().fleet_controller is False
            assert not server.migrate_out("anything", "tcp://nowhere")
            assert server.migrations_out == 0 and server.migration_fallbacks == 0
            assert server.warm_chains(4) == []
            assert server.revive_chain([1, 2], "tcp://nowhere") == 0
        finally:
            server.shutdown()

    def test_migrating_unknown_or_finished_request_is_false(self):
        ep = _endpoint()
        src = pod(True, "u-src", fleet_controller=True)
        try:
            assert not src.migrate_out("never-submitted", ep)
            seq = src.generate(prompt(3, 8), sampling(True, max_new_tokens=2), timeout=300)
            assert not src.migrate_out(seq.request_id, ep)
            assert "migration_frozen" not in src.engine.lifecycle_stats
        finally:
            src.shutdown()


# ---------------------------------------------------------------------------
# Warm chains (the scale-up revival donor side)
# ---------------------------------------------------------------------------
class TestWarmChains:
    def test_hot_chains_are_chain_ordered_longest_first(self):
        chains = []
        for side in SIDES:
            server = pod(side, "warm-donor", fleet_controller=True)
            try:
                long_prefix, short_prefix = prompt(20, 24), prompt(21, 8)
                server.generate(long_prefix, sampling(side, max_new_tokens=1), timeout=300)
                server.generate(short_prefix, sampling(side, max_new_tokens=1), timeout=300)
                got = server.warm_chains(8)
                assert len(got) >= 2 and len(got[0]) >= len(got[-1])
                db = server.engine.block_manager.token_db
                assert got[0] == db.prefix_hashes(long_prefix)[: len(got[0])]
                chains.append(got)
            finally:
                server.shutdown()
        assert chains[0] == chains[1]


# ---------------------------------------------------------------------------
# End to end: the in-process fleet under the real controller
# ---------------------------------------------------------------------------
class SteeredFleet(t_controller.InProcessFleet):
    """Real pods, scripted signals: burn and MRC are injected so the
    decision is deterministic while migration, revival, drain and
    retirement all run for real."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.steer_burn = None
        self.steer_mrc = None

    def observe(self):
        pods = super().observe()
        for p in pods:
            p.burn_rates = self.steer_burn
            p.mrc = self.steer_mrc
        return pods


class TestFleetEndToEnd:
    def test_scale_down_live_migrates_then_retires(self):
        ep_a, ep_b = _endpoint(), _endpoint()
        prompt_a, prompt_b = prompt(30, 12), prompt(31, 12)
        base_b, _ = _reference(prompt_b, 40)
        pod_a = pod(True, "pod-a", fleet_controller=True, transfer_endpoint=ep_a)
        pod_b = pod(True, "pod-b", total_pages=48, fleet_controller=True, transfer_endpoint=ep_b)
        health = FleetHealth(FleetHealthConfig())
        fleet = SteeredFleet(fleet_health=health)
        fleet.register("pod-a", pod_a, ep_a)
        fleet.register("pod-b", pod_b, ep_b)
        fleet.steer_burn, fleet.steer_mrc = CALM, FLAT
        ctl = t_controller.FleetController(
            t_controller.FleetControllerConfig(enabled=True, min_pods=1), fleet
        )
        try:
            park_b = _park(pod_b, "rb", min_generated=2)
            fut_b = pod_b.submit(prompt_b, sampling(True, max_new_tokens=40), request_id="rb")
            assert park_b.parked.wait(120)
            park_a = _park(pod_a, "ra", min_generated=1)
            fut_a = pod_a.submit(prompt_a, sampling(True, max_new_tokens=40), request_id="ra")
            fut_a2 = pod_a.submit(prompt(32, 12), sampling(True, max_new_tokens=40),
                                  request_id="ra2")
            assert park_a.parked.wait(120)
            d = ctl.reconcile()
            park_a.release()
            park_b.release()
            assert d.action == "scale_down" and d.pod_id == "pod-b"
            assert d.migrated == 1 and d.migration_fallbacks == 0
            assert fleet.pod_ids() == ["pod-a"]
            assert health.pods_removed == 1 and not health.is_routable("pod-b")
            cont = pod_a.migrated_future("rb").result(timeout=600)
            assert cont.generated_tokens == base_b
            assert fut_b.result(timeout=60).finish_reason == "migrated"
            assert len(fut_a.result(timeout=600).generated_tokens) == 40
            assert len(fut_a2.result(timeout=600).generated_tokens) == 40
            assert wait_until(lambda: pod_a.queue_depth == 0)
            assert pod_b.queue_depth == 0
        finally:
            pod_a.shutdown()
            for s in fleet.retired:
                s.shutdown()
            pod_b.shutdown()

    def test_scale_up_revives_warm_sets_on_the_new_pod(self):
        ep = _endpoint()
        donor = pod(True, "donor", fleet_controller=True, transfer_endpoint=ep)
        spawned = []

        def make_pod(pod_id):
            server = pod(True, pod_id, fleet_controller=True)
            spawned.append(server)
            return server, None

        health = FleetHealth(FleetHealthConfig())
        fleet = SteeredFleet(make_pod=make_pod, fleet_health=health)
        fleet.register("donor", donor, ep)
        fleet.steer_burn, fleet.steer_mrc = BURNING, STEEP
        ctl = t_controller.FleetController(
            t_controller.FleetControllerConfig(enabled=True, max_pods=4), fleet
        )
        try:
            prefix = prompt(50, 20)
            donor.generate(prefix, sampling(True, max_new_tokens=1), timeout=300)
            d = ctl.reconcile()
            assert d.action == "scale_up" and d.pod_id == "fleet-1"
            assert d.revived_blocks == len(prefix) // PS
            assert health.pods_added == 1
            out = fleet.server("fleet-1").generate(
                prefix + prompt(51, 4), sampling(True, max_new_tokens=2), timeout=300
            )
            assert out.num_cached_prompt == len(prefix)
        finally:
            donor.shutdown()
            for s in spawned:
                s.shutdown()


# ---------------------------------------------------------------------------
# /stats gating
# ---------------------------------------------------------------------------
class TestStatsGating:
    def _stats(self, side, **knobs):
        server = pod(side, "st-pod", **knobs)

        async def run():
            client = TestClient(TestServer(server.build_app()))
            await client.start_server()
            try:
                return await (await client.get("/stats")).json()
            finally:
                await client.close()

        try:
            return asyncio.run(run())
        finally:
            server.shutdown()

    @pytest.mark.parametrize("on", [False, True], ids=["knob_off", "knob_on"])
    def test_fleet_block_only_with_knob_on(self, on):
        knobs = {"fleet_controller": True} if on else {}
        t, j = (self._stats(side, **knobs) for side in SIDES)
        assert sorted(t) == sorted(j)
        assert ("fleet" in t) is on
        if on:
            assert t["fleet"] == j["fleet"] == {
                "migrations_out": 0, "migrations_in": 0, "migration_fallbacks": 0,
                "migrations_served": 0, "migration_blocks_accepted": 0,
            }


# ---------------------------------------------------------------------------
# The decision table on both packages' controllers
# ---------------------------------------------------------------------------
def _signals(ctl_mod, n, burn, mrc, live=0):
    return [
        ctl_mod.PodSignals(pod_id=f"pod-{i}", transfer_endpoint=f"tcp://pod-{i}",
                           capacity_blocks=63, burn_rates=burn, mrc=mrc,
                           live_requests=[f"req-{i}-{j}" for j in range(live)])
        for i in range(n)
    ]


class _ScriptedFleet:
    def __init__(self, ctl_mod, signals):
        self.mod, self.signals = ctl_mod, signals
        self.added, self.migrations, self.retired = [], [], []

    def observe(self):
        return self.signals

    def add_pod(self):
        p = self.mod.PodSignals(pod_id=f"new-{len(self.added)}", transfer_endpoint=None,
                                capacity_blocks=63)
        self.added.append(p.pod_id)
        self.signals = self.signals + [p]
        return p

    def migrate(self, pod_id, request_id, target_endpoint):
        self.migrations.append((pod_id, request_id, target_endpoint))
        return True

    def retire(self, pod_id):
        self.retired.append(pod_id)
        self.signals = [p for p in self.signals if p.pod_id != pod_id]

    def warm_sets(self, limit):
        return []

    def revive(self, pod_id, source_endpoint, chain_hashes):
        return 0


#: (pods, burn, mrc, live, config overrides) -> the reconcile to compare
DECISIONS = {
    "scale_up": (2, BURNING, STEEP, 0, {}),
    "burning_mrc_flat": (2, BURNING, FLAT, 0, {}),
    "burning_no_mrc": (2, BURNING, None, 0, {}),
    "burning_at_max_pods": (2, BURNING, STEEP, 0, {"max_pods": 2}),
    "scale_down": (3, CALM, FLAT, 1, {}),
    "min_pods": (1, CALM, FLAT, 0, {}),
    "steady": (3, CALM, STEEP, 0, {}),
}


@pytest.mark.parametrize("case", list(DECISIONS))
def test_decision_table_equal(case):
    n, burn, mrc, live, over = DECISIONS[case]
    outs = []
    for mod in (t_controller, j_controller):
        fleet = _ScriptedFleet(mod, _signals(mod, n, burn, mrc, live))
        kw = {**dict(enabled=True, hysteresis_s=60.0, min_pods=1, max_pods=4), **over}
        d = mod.FleetController(mod.FleetControllerConfig(**kw), fleet,
                                clock=FakeClock()).reconcile()
        outs.append((d.action, d.reason, d.pod_id, d.migrated, d.migration_fallbacks,
                     d.hit_now, d.hit_up, fleet.added, fleet.migrations, fleet.retired))
    assert outs[0] == outs[1]
