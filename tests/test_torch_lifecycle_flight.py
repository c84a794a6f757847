"""The port's block-lifecycle ledger, reuse-distance MRC, flight recorder
and SLO burn hooks beside the JAX package's, on the cases of
``tests/test_lifecycle_flight.py``: ``TestLedgerOnEngine``,
``TestFlightRecorder``, ``TestSLOBurnCallback``, ``TestKnobsOffParity``,
``TestPodSurfaces`` and ``TestFleetAcceptance``'s forced-burn case (its
other case drives the remote tier, which the port does not have).

Both engines run TINY_LLAMA on shared parameters (the port's on the CPU,
the JAX engine in interpret mode). Held equal, exactly: the ledger's
transition rows (all but their timestamps) and the MRC payloads after the
same requests, the kinds and order of the flight timelines, the ``/stats``
keys and ``/debug/*`` payloads, and with the knobs off the exposition
families and the KV-event and heartbeat bytes. The recorder modules are
copies, so their own cases run on both packages' modules.
"""

import asyncio
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from conftest import free_tcp_port
from llm_d_kv_cache_manager_tpu.obs import flight as j_flight
from llm_d_kv_cache_manager_tpu.obs import lifecycle as j_lifecycle
from llm_d_kv_cache_manager_tpu.obs import slo as j_slo
from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu.server.sequence import Sequence as JSequence
from llm_d_kv_cache_manager_tpu_torch.obs import flight as t_flight
from llm_d_kv_cache_manager_tpu_torch.obs import lifecycle as t_lifecycle
from llm_d_kv_cache_manager_tpu_torch.obs import slo as t_slo
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server.sequence import Sequence as TSequence
from test_observability import _exposition_types
from torch_fleet import SIDES, RecordingPublisher, engine_config, pod, prompt, sampling
from torch_fleet import shared_params, wait_until

#: (flight, lifecycle, slo) modules of each package: the port's, then JAX's
MODULES = {"torch": (t_flight, t_lifecycle, t_slo), "jax": (j_flight, j_lifecycle, j_slo)}
OBS_KNOBS = dict(obs_lifecycle=True, obs_flight=True, obs_slo="ttft:0.5:0.99")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engine(side, **kw):
    jp, tp = shared_params()
    econf = engine_config(side, **kw)
    return TEngine(econf, params=tp, device="cpu") if side else JEngine(econf, params=jp)


def _rows(ledger):
    """Ledger rows without their timestamps."""
    return [{k: v for k, v in r.items() if k != "t"} for r in ledger.recent(limit=1 << 20)]


def _serve(server, scenario):
    """Run ``scenario(client)`` against the pod's HTTP app; the pod is shut
    down afterwards."""

    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            return await scenario(client)
        finally:
            await client.close()

    try:
        return asyncio.run(run())
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# Ledger and MRC on the engine
# ---------------------------------------------------------------------------
class TestLedgerOnEngine:
    def _host_tier_run(self, side):
        mods = MODULES["torch" if side else "jax"]
        eng = _engine(side, total_pages=12, host_pages=8, host_tier_policy="always")
        led = mods[1].BlockLifecycleLedger(ring=1 << 14)
        mrc = mods[1].ReuseDistanceEstimator()
        eng.block_manager.attach_lifecycle(led, mrc)
        for i in range(6):
            eng.add_request(prompt(i, 16), sampling(side, max_new_tokens=4))
            eng.run_until_complete()
        # Prompt 0 again: its chain comes back from the host tier.
        eng.add_request(prompt(0, 16), sampling(side, max_new_tokens=4))
        eng.run_until_complete()
        return eng, led, mrc

    def test_host_tier_transitions_match_block_manager_counters(self):
        runs = [self._host_tier_run(side) for side in SIDES]
        for eng, led, mrc in runs:
            counts = {}
            for row in led.recent(limit=1 << 14):
                counts[row["reason"]] = counts.get(row["reason"], 0) + 1
            bm = eng.block_manager
            assert counts.get("spill", 0) == bm.host_stats["spilled"] > 0
            assert counts.get("restore", 0) + counts.get("prefetch", 0) == \
                bm.host_stats["restored"]
            assert counts.get("evict", 0) == bm.host_stats["host_evicted"]
            by_tier = led.resident_by_tier()
            assert by_tier.get("tpu_hbm", 0) == bm.num_cached_pages
            assert by_tier.get("host_dram", 0) == bm.num_host_cached_pages
            assert mrc.accesses >= 7 * 4
        (t_eng, t_led, t_mrc), (j_eng, j_led, j_mrc) = runs
        assert _rows(t_led) == _rows(j_led)
        assert t_led.transition_counts() == j_led.transition_counts()
        caps = {"tpu_hbm": 11, "tpu_hbm+host_dram": 19}
        assert t_lifecycle.debug_mrc_payload(t_mrc, tier_capacities=caps) == \
            j_lifecycle.debug_mrc_payload(j_mrc, tier_capacities=caps)

    def test_rollback_retry_observes_chain_once(self):
        """A scheduler rollback (free, reset, allocate again) walks the
        same chain again: the MRC observes a request's chain once."""
        accesses = []
        for side in SIDES:
            mods = MODULES["torch" if side else "jax"]
            eng = _engine(side, total_pages=32)
            mrc = mods[1].ReuseDistanceEstimator()
            eng.block_manager.attach_lifecycle(None, mrc)
            seq = (TSequence if side else JSequence)(prompt_tokens=prompt(0, 16))
            eng.block_manager.allocate(seq)
            first = mrc.accesses
            assert first > 0
            eng.block_manager.free_sequence(seq)
            seq.reset_allocation()
            eng.block_manager.allocate(seq)
            assert mrc.accesses == first
            accesses.append(first)
        assert accesses[0] == accesses[1]

    @pytest.mark.parametrize("pkg", list(MODULES))
    def test_raising_observer_never_fails_the_transition(self, pkg):
        def boom(*_a):
            raise RuntimeError("observer kaput")

        led = MODULES[pkg][1].BlockLifecycleLedger(on_transition=boom, on_residency=boom)
        led.record(1, "tpu_hbm", "allocate")
        led.record(1, "none", "evict")
        led.observe_stored("p", [2], "tpu_hbm")
        led.observe_pod_gone("p", "drained")
        assert led.transitions == 4

    def test_outputs_identical_with_and_without_ledger(self):
        outs = {}
        for side in SIDES:
            mods = MODULES["torch" if side else "jax"]
            for attached in (False, True):
                eng = _engine(side, total_pages=12, host_pages=8, host_tier_policy="always")
                if attached:
                    eng.block_manager.attach_lifecycle(
                        mods[1].BlockLifecycleLedger(), mods[1].ReuseDistanceEstimator()
                    )
                toks = []
                for i in range(6):
                    seq = eng.add_request(prompt(i, 16), sampling(side, max_new_tokens=4))
                    eng.run_until_complete()
                    toks.append(list(seq.generated_tokens))
                outs[side, attached] = toks
        assert outs[True, False] == outs[True, True] == outs[False, True] == outs[False, False]


# ---------------------------------------------------------------------------
# The flight recorder and the SLO burn callback (copied modules)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", list(MODULES))
class TestFlightRecorder:
    def test_step_deltas_and_ring_bound(self, pkg):
        clock = [100.0]
        fr = MODULES[pkg][0].FlightRecorder(ring=16, clock=lambda: clock[0])
        stats = {"steps": 0, "prefill_s": 0.0, "decode_s": 0.0}
        for i in range(1, 40):
            stats = {"steps": i, "prefill_s": 0.5 * i, "decode_s": 0.25 * i}
            clock[0] += 1.0
            fr.record_step(stats, occupancy=0.5, free_pages=7)
        snap = fr.snapshot()
        assert snap["steps_recorded"] == 39 and snap["steps_buffered"] == 16
        fr.record_step(stats)  # no new engine step: nothing recorded
        assert fr.snapshot()["steps_recorded"] == 39

    def test_trigger_timeline_causally_ordered(self, pkg, tmp_path):
        import json

        mod = MODULES[pkg][0]
        clock = [10.0]
        fr = mod.FlightRecorder(ring=64, out_dir=str(tmp_path), pod="p0", clock=lambda: clock[0])
        fr.record_step({"steps": 1, "prefill_s": 0.1}, free_pages=3)
        clock[0] = 11.0
        fr.record_event("breaker", endpoint="tcp://x", state="open")
        clock[0] = 12.0
        fr.record_step({"steps": 2, "prefill_s": 0.2})
        clock[0] = 13.0
        path = fr.trigger("slo_burn", objective="ttft", rate=9.0)
        assert path is not None
        timeline = fr.timeline()
        kinds = [e["kind"] for e in timeline["entries"]]
        assert kinds == ["step", "breaker", "step", "trigger:slo_burn"]
        with open(path) as f:
            on_disk = json.load(f)
        assert on_disk["reason"] == "slo_burn"
        assert [e["kind"] for e in on_disk["entries"]] == kinds
        payload = mod.debug_flight_payload(fr)[1]
        assert payload["enabled"] and payload["timeline"]["reason"] == "slo_burn"

    def test_dump_rate_limited_per_reason(self, pkg, tmp_path):
        clock = [0.0]
        fr = MODULES[pkg][0].FlightRecorder(out_dir=str(tmp_path), min_dump_interval_s=5.0,
                                            clock=lambda: clock[0])
        assert fr.trigger("resync") is not None
        clock[0] = 1.0
        assert fr.trigger("resync") is None
        assert fr.trigger("breaker_open") is not None
        clock[0] = 6.0
        assert fr.trigger("resync") is not None
        assert fr.snapshot()["triggers"] == 4

    def test_no_dir_keeps_timeline_in_memory(self, pkg):
        fr = MODULES[pkg][0].FlightRecorder()
        assert fr.trigger("resync") is None
        assert fr.timeline()["reason"] == "resync"


@pytest.mark.parametrize("pkg", list(MODULES))
class TestSLOBurnCallback:
    def test_edge_triggered_and_rearms(self, pkg):
        slo = MODULES[pkg][2]
        clock = [0.0]
        fired = []
        rec = slo.SLORecorder(
            [slo.SLObjective(metric="ttft", threshold_s=0.1, target=0.9)],
            windows_s=(60.0,), clock=lambda: clock[0],
            on_burn=lambda o, w, r: fired.append((o, w, r)), burn_threshold=1.0,
        )
        rec.observe(1.0, None)
        assert len(fired) == 1 and fired[0][2] >= 1.0
        clock[0] = 2.0
        rec.observe(1.0, None)
        assert len(fired) == 1
        clock[0] = 70.0
        rec.observe(0.01, None)
        assert len(fired) == 1
        clock[0] = 72.0
        rec.observe(1.0, None)
        assert len(fired) == 2 and rec.burn_crossings == 2

    def test_throttled_between_checks(self, pkg):
        slo = MODULES[pkg][2]
        clock = [0.0]
        fired = []
        rec = slo.SLORecorder(
            [slo.SLObjective(metric="ttft", threshold_s=0.1, target=0.5)],
            windows_s=(60.0,), clock=lambda: clock[0], on_burn=lambda *a: fired.append(a),
            burn_threshold=1.0, burn_check_interval_s=10.0,
        )
        rec.observe(0.01, None)
        rec.observe(1.0, None)
        assert fired == []
        clock[0] = 11.0
        rec.observe(1.0, None)
        assert len(fired) == 1

    def test_no_callback_is_legacy(self, pkg):
        slo = MODULES[pkg][2]
        rec = slo.SLORecorder([slo.SLObjective(metric="ttft", threshold_s=0.1, target=0.9)])
        rec.observe(1.0, None)
        assert rec.burn_crossings == 0


# ---------------------------------------------------------------------------
# Knobs-off parity
# ---------------------------------------------------------------------------
class TestKnobsOffParity:
    def _answers(self, side, **knobs):
        server = pod(side, "parity-pod", **knobs)

        async def scenario(c):
            resp = await c.post("/v1/completions",
                                json={"prompt_token_ids": prompt(0, 10), "max_tokens": 3})
            assert resp.status == 200
            body = await resp.json()
            stats = await (await c.get("/stats")).json()
            debug = []
            for path in ("/debug/lifecycle", "/debug/mrc", "/debug/flight"):
                resp = await c.get(path)
                debug.append((path, resp.status, await resp.json()))
            return sorted(body), sorted(stats), debug

        return _serve(server, scenario)

    def test_stats_response_keys_and_debug_endpoints_equal(self):
        t, j = (self._answers(side) for side in SIDES)
        assert t == j
        assert t[0] == sorted({"id", "object", "model", "choices", "usage", "ttft_s"})
        assert t[1] == sorted({"pod", "model", "data_parallel_rank", "staged", "waiting",
                               "running", "free_pages", "total_pages", "prefill", "transfer",
                               "self_heal", "admission", "drain"})
        assert [d[1:] for d in t[2]] == [(200, {"enabled": False, "recent": []}),
                                         (200, {"enabled": False}), (200, {"enabled": False})]

    def test_no_new_exposition_series_knobs_off(self):
        fams = []
        for side in SIDES:
            server = pod(side, "parity-pod-m", start=False, obs_metrics=True)
            try:
                fams.append(_exposition_types(server.metrics.exposition().decode()))
            finally:
                server.shutdown()
        assert fams[0] == fams[1]
        for name in ("kvcache_block_tier_transitions_total",
                     "kvcache_block_tier_residency_seconds", "kvcache_reuse_distance_blocks"):
            assert name not in fams[0]

    def test_knobs_off_no_hooks_attached(self):
        server = pod(True, "parity-pod-h", start=False)
        try:
            bm = server.engine.block_manager
            assert bm._lifecycle is None and bm._mrc is None
            assert server.lifecycle is None and server.mrc is None
            assert server.flight is None and server.slo is None
            assert not server.engine.obs_step_timing
        finally:
            server.shutdown()

    def test_wire_bytes_identical_knobs_on(self):
        """The events and the heartbeat a knobs-on pod publishes are the
        knobs-off pod's bytes, on both packages, and the two packages'
        bytes are equal."""
        emitted, heartbeats = {}, {}
        for side in SIDES:
            for on in (False, True):
                rec = RecordingPublisher(side)
                server = pod(side, "wire-pod", publisher=rec, **(OBS_KNOBS if on else {}))
                try:
                    server.generate(prompt(3, 12), sampling(side, max_new_tokens=3), timeout=120)
                    server._publish_heartbeat()
                finally:
                    server.shutdown()
                batch = rec._batch
                evs = [e for b in rec.batches for e in b.events]
                emitted[side, on] = batch(ts=0.0, events=[
                    e for e in evs if type(e).__name__ != "Heartbeat"]).to_payload()
                heartbeats[side, on] = batch(ts=0.0, events=[
                    e for e in evs if type(e).__name__ == "Heartbeat"]).to_payload()
        assert len(set(emitted.values())) == 1
        assert len(set(heartbeats.values())) == 1

    def test_outputs_identical_knobs_on_vs_off(self):
        outs = {}
        for side in SIDES:
            for on in (False, True):
                kw = dict(obs_lifecycle=True, obs_flight=True) if on else {}
                server = pod(side, "out-pod", total_pages=16, **kw)
                try:
                    outs[side, on] = [
                        list(server.generate(prompt(i, 12), sampling(side, max_new_tokens=3),
                                             timeout=120).generated_tokens)
                        for i in range(4)
                    ]
                finally:
                    server.shutdown()
        assert len({str(v) for v in outs.values()}) == 1


# ---------------------------------------------------------------------------
# Pod surfaces with the knobs on
# ---------------------------------------------------------------------------
class TestPodSurfaces:
    def _lifecycle_answers(self, side):
        server = pod(side, "obs-pod", total_pages=16, obs_lifecycle=True)

        async def scenario(c):
            for _ in range(3):
                await c.post("/v1/completions",
                             json={"prompt_token_ids": prompt(0, 12), "max_tokens": 2})
            stats = await (await c.get("/stats")).json()
            lifecycle = await (await c.get("/debug/lifecycle")).json()
            mrc = await (await c.get("/debug/mrc")).json()
            return stats, lifecycle, mrc

        return _serve(server, scenario)

    def test_lifecycle_mrc_stats_and_endpoints(self):
        (t_stats, t_led, t_mrc), (j_stats, j_led, j_mrc) = (
            self._lifecycle_answers(side) for side in SIDES
        )
        assert t_stats["lifecycle"] == j_stats["lifecycle"]
        assert t_stats["lifecycle"]["transitions"] > 0
        assert t_stats["lifecycle"]["mrc"]["accesses"] > 0
        assert sorted(t_stats) == sorted(j_stats)
        strip = lambda d: {**d, "recent": [{k: v for k, v in r.items() if k != "t"}  # noqa: E731
                                           for r in d["recent"]]}
        assert strip(t_led) == strip(j_led)
        assert t_led["enabled"] and t_led["recent"] and t_led["transitions"] > 0
        assert t_mrc == j_mrc
        assert t_mrc["tiers"]["tpu_hbm"]["capacity_blocks"] == 15
        assert t_mrc["tiers"]["tpu_hbm"]["predicted_hit_rate"] > 0

    def test_lifecycle_exposition_series(self):
        series = []
        for side in SIDES:
            server = pod(side, "obs-pod-m", total_pages=16, obs_lifecycle=True)
            try:
                for _ in range(2):
                    server.generate(prompt(0, 12), sampling(side, max_new_tokens=2), timeout=120)
                text = server.metrics.exposition().decode()
            finally:
                server.shutdown()
            assert ('kvcache_block_tier_transitions_total{from="none",'
                    'reason="allocate",to="tpu_hbm"}') in text
            assert "kvcache_reuse_distance_blocks_bucket" in text
            series.append(sorted(
                ln for ln in text.splitlines()
                if ln.startswith(("kvcache_block_tier_transitions_total",
                                  "kvcache_reuse_distance_blocks")) and "_created" not in ln
            ))
        assert series[0] == series[1]

    def test_flight_records_steps(self):
        snaps = []
        for side in SIDES:
            server = pod(side, "flight-pod", total_pages=32, obs_flight=True)
            try:
                assert server.engine.obs_step_timing  # implied by the knob
                server.generate(prompt(1, 12), sampling(side, max_new_tokens=3), timeout=120)
                assert wait_until(lambda: server.flight.snapshot()["steps_recorded"] > 0)
                snaps.append(server.flight.snapshot())
            finally:
                server.shutdown()
        assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# Fleet acceptance
# ---------------------------------------------------------------------------
class TestFleetAcceptance:
    def _burn_timeline(self, side, tmp_path):
        dead = f"tcp://127.0.0.1:{free_tcp_port()}"  # nothing listens
        a = pod(side, "burn-a", obs_flight=True, obs_flight_dir=str(tmp_path),
                obs_slo="ttft:0.000001:0.99", transfer_breaker_failures=1,
                transfer_timeout_s=0.3)
        b = pod(side, "burn-b")
        try:
            b.generate(prompt(9, 12), sampling(side, max_new_tokens=2), timeout=120)
            a.generate(prompt(1, 12), sampling(side, max_new_tokens=2), timeout=120)
            assert a.pull_prefix(prompt(2, 12), dead) == 0
            assert wait_until(lambda: any(
                e["kind"] == "breaker" for e in (a.flight.timeline() or {}).get("entries", [])
            ))
            deadline = time.monotonic() + 10
            while a.slo.burn_crossings == 0 and time.monotonic() < deadline:
                a.generate(prompt(3, 12), sampling(side, max_new_tokens=2), timeout=120)
                time.sleep(0.3)
            assert a.slo.burn_crossings >= 1
            timeline = a.flight.timeline()
        finally:
            a.shutdown()
            b.shutdown()
        entries = timeline["entries"]
        ts = [e["t"] for e in entries]
        assert ts == sorted(ts), "timeline not causally ordered"
        kinds = [e["kind"] for e in entries]
        assert {"slo_burn", "step", "breaker"} <= set(kinds), kinds
        assert list(tmp_path.glob("flight-*.json")), "no flight dump written"
        return timeline["reason"], kinds

    def test_forced_burn_dumps_causal_timeline(self, tmp_path):
        t = self._burn_timeline(True, tmp_path / "torch")
        j = self._burn_timeline(False, tmp_path / "jax")
        assert t == j


#: this slice's knobs in the environment, and the config fields they set
ENV = {
    "OBS_SLO": "ttft:0.5:0.99", "OBS_SLO_WINDOWS": "30,120", "OBS_LIFECYCLE": "1",
    "OBS_LIFECYCLE_RING": "512", "OBS_MRC_SAMPLE": "0.5", "OBS_MRC_TRACKED": "1024",
    "OBS_FLIGHT": "yes", "OBS_FLIGHT_RING": "256", "OBS_FLIGHT_DIR": "/flight",
    "OBS_FLIGHT_BURN": "4.5", "OBS_AUDIT": "1", "OBS_EXEMPLARS": "true",
    "FLEET_CONTROLLER": "1",
}
KNOB_FIELDS = ["obs_slo", "obs_slo_windows", "obs_lifecycle", "obs_lifecycle_ring",
               "obs_mrc_sample", "obs_mrc_tracked", "obs_flight", "obs_flight_ring",
               "obs_flight_dir", "obs_flight_burn", "obs_audit", "obs_exemplars",
               "fleet_controller"]


def test_from_env_knobs_match_jax(monkeypatch):
    from llm_d_kv_cache_manager_tpu.server import serve as jserve
    from llm_d_kv_cache_manager_tpu_torch.server import serve as tserve

    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    defaults = [{f: getattr(mod.PodServerConfig.from_env(), f) for f in KNOB_FIELDS}
                for mod in (tserve, jserve)]
    assert defaults[0] == defaults[1] == {f: getattr(tserve.PodServerConfig(), f)
                                          for f in KNOB_FIELDS}
    assert not any(defaults[0][f] for f in ("obs_slo", "obs_lifecycle", "obs_flight",
                                           "obs_audit", "obs_exemplars", "fleet_controller"))
    for name, value in ENV.items():
        monkeypatch.setenv(name, value)
    set_ = [{f: getattr(mod.PodServerConfig.from_env(), f) for f in KNOB_FIELDS}
            for mod in (tserve, jserve)]
    assert set_[0] == set_[1]
    assert set_[0]["fleet_controller"] is True and set_[0]["obs_flight_burn"] == 4.5
