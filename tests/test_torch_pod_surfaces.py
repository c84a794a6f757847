"""The port pod's fleet surfaces beside the JAX pod: ``/stats``, the
completion response, ``/metrics``, request tracing, ``/debug/traces``,
``/debug/profile``, the engine's step telemetry, ``Engine.block_digest``
and the knobs' environment parsing.

Both pods run TINY_LLAMA on shared parameters (the port's engine on the
CPU, the JAX engine in interpret mode). Held equal, exactly: the key sets
of ``/stats`` and of the completion response (body and headers), knobs off
and with this slice's knobs on; the exposition's metric family names and
types under each flag set of ``_ServingMetrics``; the span names and parent
links of one request; the disabled answers of the debug endpoints; the
``step_stats`` keys; the resync digests after the same requests; and the
configs ``from_env`` builds.
"""

import asyncio
import glob
import json
import os

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import chip_smoke
from llm_d_kv_cache_manager_tpu.server import serve as jserve
from llm_d_kv_cache_manager_tpu_torch.server import serve as tserve
from test_observability import _POD_OBS_METRICS, _exposition_types
from torch_fleet import SIDES, RecordingPublisher, pod, prompt, sampling

TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"

#: the fleet-contract knobs, all on (admission caps far above the load)
SLICE_KNOBS = dict(
    heartbeat_interval_s=30.0, resync_interval_s=30.0, admission_max_waiting=100,
    admission_max_queued_tokens=100_000, drain_timeout_s=5.0, obs_tracing=True,
    obs_trace_buffer=64, obs_metrics=True,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _shape(obj):
    """The nested key structure of a JSON value (lists by their first
    element's shape)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return None


def _surfaces(side, knobs, engine_kw=None, headers=None):
    """Serve two requests over HTTP (the second a prefix hit) and read
    ``/stats``; returns (completion bodies, their headers' names,
    /stats)."""
    server = pod(side, "surf-pod", publisher=RecordingPublisher(side), engine_kw=engine_kw,
                 **knobs)

    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            bodies, names = [], []
            p = prompt(40, 12)
            for tokens in (p, p + prompt(41, 4)):
                resp = await client.post("/v1/completions", headers=headers,
                                         json={"prompt_token_ids": tokens, "max_tokens": 3})
                assert resp.status == 200
                bodies.append(await resp.json())
                names.append(sorted(h for h in resp.headers if h.lower() in
                                    ("traceparent", "retry-after")))
            stats = await (await client.get("/stats")).json()
            return bodies, names, stats
        finally:
            await client.close()

    try:
        return asyncio.run(run())
    finally:
        server.shutdown()


@pytest.mark.parametrize("knobs, engine_kw", [
    ({}, None),
    (SLICE_KNOBS, None),
    (dict(SLICE_KNOBS, async_pull=True, transfer_breaker_failures=2),
     {"host_pages": 32, "host_tier_policy": "always"}),
], ids=["knobs_off", "slice_knobs", "slice_knobs_async_pull_host_tier"])
def test_stats_and_completion_keys_equal(knobs, engine_kw):
    t, j = (_surfaces(side, knobs, engine_kw, headers={"traceparent": TRACEPARENT})
            for side in SIDES)
    assert [_shape(b) for b in t[0]] == [_shape(b) for b in j[0]]
    assert t[1] == j[1]
    assert _shape(t[2]) == _shape(j[2])
    # The values the two engines must agree on.
    for key in ("staged", "waiting", "running", "free_pages", "total_pages", "prefill",
                "admission", "drain"):
        assert t[2][key] == j[2][key], key
    assert [b["choices"][0]["token_ids"] for b in t[0]] == \
        [b["choices"][0]["token_ids"] for b in j[0]]
    assert [b["usage"] for b in t[0]] == [b["usage"] for b in j[0]]
    traced = knobs.get("obs_tracing", False)
    assert t[1] == [["traceparent"]] * 2 if traced else [[]] * 2
    assert ("obs" in t[2]) == traced


@pytest.mark.parametrize("flags", [
    {}, {"obs": True}, {"obs": True, "lifecycle": True},
    {"obs": True, "tenant_qos": True, "integrity": True},
], ids=["off", "obs", "obs_lifecycle", "obs_tenant_integrity"])
def test_exposition_families_equal(flags):
    t = tserve._ServingMetrics(**flags)
    j = jserve._ServingMetrics(**flags)
    t_types = _exposition_types(t.exposition().decode())
    assert t_types == _exposition_types(j.exposition().decode())
    if flags.get("obs"):
        assert {n: t_types.get(n) for n in _POD_OBS_METRICS} == _POD_OBS_METRICS
    else:
        assert not set(t_types) & set(_POD_OBS_METRICS)


@pytest.mark.parametrize("obs_metrics", [False, True], ids=["knobs_off", "obs_metrics"])
def test_metrics_endpoint_answers_equal(obs_metrics):
    """``GET /metrics``: the same status, Content-Type and family names
    from both pods."""
    answers = []
    for side in SIDES:
        server = pod(side, "metrics-pod", obs_metrics=obs_metrics)

        async def run():
            client = TestClient(TestServer(server.build_app()))
            await client.start_server()
            try:
                resp = await client.get("/metrics")
                return resp.status, resp.headers["Content-Type"], await resp.text()
            finally:
                await client.close()

        try:
            status, ctype, text = asyncio.run(run())
        finally:
            server.shutdown()
        answers.append((status, ctype, _exposition_types(text)))
    assert answers[0] == answers[1]
    assert answers[0][0] == 200 and answers[0][1].startswith("text/plain")


def test_chip_smoke_pins_the_jax_families():
    """The card run checks the families the JAX pod exposes with
    OBS_METRICS on; its list must be theirs."""
    types = _exposition_types(jserve._ServingMetrics(obs=True).exposition().decode())
    assert set(_POD_OBS_METRICS) <= set(chip_smoke.POD_METRIC_FAMILIES)
    assert set(chip_smoke.POD_METRIC_FAMILIES) <= set(types)


def test_metrics_observe_equal_series():
    """The same finished requests and step stats give the same series."""
    out = []
    for mod in (tserve, jserve):
        m = mod._ServingMetrics(obs=True)
        stats = {"steps": 3, "schedule_s": 0.5, "prefill_s": 1.0, "decode_s": 0.25,
                 "sample_s": 0.0625, "gather_s": 0.125, "demote_s": 0.0, "publish_s": 0.125}
        m.sync_step_stats(stats, lag_s=0.01)
        m.sync_step_stats(stats, lag_s=0.01)
        m.set_engine_gauges(0.5, 17)
        m.observe_rejected(draining=False)
        m.observe_rejected(draining=True)
        m.observe_drain("started")
        m.observe_drain("forced", 2)
        m.sync_lifecycle_stats({"deadline_shed": 1, "deadline_expired": 2, "aborted": 3})
        lines = [ln for ln in m.exposition().decode().splitlines()
                 if not ln.startswith("#") and "_created" not in ln]
        out.append(sorted(lines))
    assert out[0] == out[1]


def _trace_tree(side):
    server = pod(side, "trace-pod", obs_tracing=True)
    try:
        fut = server.submit(prompt(2, 12), sampling(side, max_new_tokens=4))
        fut.result(timeout=120)
        rid = fut.request_id
    finally:
        server.shutdown()
    (trace,) = server.tracer.traces(request_id=rid)
    by_id = {s["span_id"]: s["name"] for s in trace["spans"]}
    links = sorted((s["name"], by_id.get(s["parent_span_id"])) for s in trace["spans"])
    req = next(s for s in trace["spans"] if s["name"] == "pod.request")
    return links, sorted(req["attrs"]), req["attrs"]["outcome"]


def test_request_span_tree_equal():
    t, j = _trace_tree(True), _trace_tree(False)
    assert t == j
    assert t[0] == [("pod.decode", "pod.request"), ("pod.prefill", "pod.request"),
                    ("pod.queue", "pod.request"), ("pod.request", None)]
    assert t[2] == "cold"


def test_traceparent_adopted_and_served_by_debug_traces():
    server = pod(True, "trace-pod", obs_tracing=True)

    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            resp = await client.post(
                "/v1/completions", headers={"traceparent": TRACEPARENT, "X-Route-Action": "cold"},
                json={"prompt_token_ids": prompt(3, 10), "max_tokens": 3})
            assert resp.status == 200
            echoed = resp.headers["traceparent"]
            trace_id = TRACEPARENT.split("-")[1]
            assert echoed.split("-")[1] == trace_id
            data = await (await client.get(f"/debug/traces?trace_id={trace_id}")).json()
            return data
        finally:
            await client.close()

    try:
        data = asyncio.run(run())
    finally:
        server.shutdown()
    (trace,) = data["traces"]
    names = {s["name"] for s in trace["spans"]}
    assert {"pod.request", "pod.queue", "pod.prefill", "pod.decode"} <= names
    req = next(s for s in trace["spans"] if s["name"] == "pod.request")
    assert req["parent_span_id"] == TRACEPARENT.split("-")[2]
    assert req["attrs"]["outcome"] == "cold"


def test_route_action_labels_the_request():
    """``X-Route-Action`` rides the sequence into the histogram labels
    (only the three verdicts; anything else derives warm/cold)."""
    for header, want in (("pull", "pull"), ("bogus", "cold")):
        server = pod(True, "route-pod", obs_metrics=True)

        async def run():
            client = TestClient(TestServer(server.build_app()))
            await client.start_server()
            try:
                resp = await client.post(
                    "/v1/completions", headers={"X-Route-Action": header},
                    json={"prompt_token_ids": prompt(5, 10), "max_tokens": 2})
                assert resp.status == 200
                return await (await client.get("/metrics")).text()
            finally:
                await client.close()

        try:
            text = asyncio.run(run())
        finally:
            server.shutdown()
        assert f'kvcache_request_e2e_seconds_count{{finish="length",outcome="{want}"}} 1.0' in text


def _debug_answers(side, profile_dir=None):
    server = pod(side, "debug-pod", obs_profile_dir=profile_dir)

    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            out = []
            for method, path in (("get", "/debug/traces"), ("get", "/debug/traces?trace_id=x"),
                                 ("post", "/debug/profile?seconds=0"),
                                 ("post", "/debug/profile?seconds=bogus"),
                                 ("post", "/debug/profile?seconds=61")):
                resp = await getattr(client, method)(path)
                out.append((path, resp.status, await resp.json()))
            assert server._profile_mu.acquire(blocking=False)
            try:
                resp = await client.post("/debug/profile?seconds=0.01")
                out.append(("held", resp.status, await resp.json()))
            finally:
                server._profile_mu.release()
            return out
        finally:
            await client.close()

    try:
        return asyncio.run(run())
    finally:
        server.shutdown()


def test_debug_endpoints_disabled_answers_equal():
    t, j = _debug_answers(True), _debug_answers(False)
    assert t == j
    assert t[0][1:] == (200, {"enabled": False, "traces": []})
    assert t[2][1:] == (400, {"error": "profiling disabled; set OBS_PROFILE_DIR"})


def test_debug_profile_answers_with_knob_equal(tmp_path):
    t = _debug_answers(True, str(tmp_path / "t"))
    j = _debug_answers(False, str(tmp_path / "j"))
    assert t == j
    assert [a[1] for a in t[2:]] == [400, 400, 400, 409]


def test_debug_profile_writes_a_torch_trace(tmp_path):
    server = pod(True, "prof-pod", obs_profile_dir=str(tmp_path))

    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            done = asyncio.create_task(client.post("/debug/profile?seconds=0.5"))
            await asyncio.sleep(0.05)
            resp = await client.post("/v1/completions",
                                     json={"prompt_token_ids": prompt(6, 10), "max_tokens": 4})
            assert resp.status == 200
            resp = await done
            return resp.status, await resp.json()
        finally:
            await client.close()

    try:
        status, body = asyncio.run(run())
    finally:
        server.shutdown()
    assert status == 200 and body == {"profile_dir": str(tmp_path), "seconds": 0.5}
    (path,) = glob.glob(os.path.join(str(tmp_path), "prof-pod-*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert events


def test_step_stats_keys_and_timing():
    engines = []
    for side in SIDES:
        server = pod(side, "step-pod", obs_metrics=True)
        try:
            assert server.engine.obs_step_timing is True
            server.generate(prompt(7, 10), sampling(side, max_new_tokens=4), timeout=120)
        finally:
            server.shutdown()
        engines.append(server.engine)
    t, j = (e.step_stats for e in engines)
    assert list(t) == list(j)
    assert t["steps"] == j["steps"] > 0
    assert t["prefill_s"] > 0 and t["decode_s"] > 0 and t["sample_s"] > 0
    off = pod(True, "step-off")
    try:
        assert off.engine.obs_step_timing is False
        off.generate(prompt(7, 10), sampling(True, max_new_tokens=4), timeout=120)
        assert all(v == 0 for v in off.engine.step_stats.values())
    finally:
        off.shutdown()


def test_block_digest_equal_after_the_same_requests():
    digests = []
    for side in SIDES:
        server = pod(side, "digest-pod", total_pages=16)
        try:
            for i in range(5):  # 16 pages of 4: later prompts evict earlier ones
                server.generate(prompt(60 + i, 14), sampling(side, max_new_tokens=3), timeout=120)
            digests.append(server.engine.block_digest())
        finally:
            server.shutdown()
    assert digests[0] == digests[1]
    assert digests[0]["tpu_hbm"]


def test_load_signals():
    server = pod(True, "load-pod", start=False)
    assert server.is_alive is False and server.is_draining is False
    server.start()
    try:
        assert server.is_alive and server.queue_depth == 0 and server.prefill_rate is None
        futs = [server.submit(prompt(70 + i, 8), sampling(True, max_new_tokens=30))
                for i in range(6)]
        # Counted from the moment submit returns: staged, waiting or running.
        assert server.queue_depth == 6
        for f in futs:
            f.result(timeout=120)
        assert server.queue_depth == 0 and server.prefill_rate > 0
        assert server.open_breaker_endpoints == set()
    finally:
        server.shutdown()
    assert server.is_alive is False


ENV = {
    "HEARTBEAT_INTERVAL_S": "0.5", "RESYNC_INTERVAL_S": "7", "ADMISSION_MAX_WAITING": "3",
    "ADMISSION_MAX_QUEUED_TOKENS": "900", "DRAIN_TIMEOUT_S": "12.5", "OBS_TRACING": "1",
    "OBS_TRACE_BUFFER": "99", "OBS_METRICS": "yes", "OBS_PROFILE_DIR": "/profiles",
}
KNOB_FIELDS = ["heartbeat_interval_s", "resync_interval_s", "admission_max_waiting",
               "admission_max_queued_tokens", "drain_timeout_s", "obs_tracing",
               "obs_trace_buffer", "obs_metrics", "obs_profile_dir"]


def test_from_env_knobs_match_jax(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    defaults = [{f: getattr(mod.PodServerConfig.from_env(), f) for f in KNOB_FIELDS}
                for mod in (tserve, jserve)]
    assert defaults[0] == defaults[1] == {f: getattr(tserve.PodServerConfig(), f)
                                          for f in KNOB_FIELDS}
    assert defaults[0]["drain_timeout_s"] == 30.0 and defaults[0]["obs_trace_buffer"] == 2048
    for name, value in ENV.items():
        monkeypatch.setenv(name, value)
    set_ = [{f: getattr(mod.PodServerConfig.from_env(), f) for f in KNOB_FIELDS}
            for mod in (tserve, jserve)]
    assert set_[0] == set_[1]
    assert set_[0]["obs_metrics"] is True and set_[0]["admission_max_queued_tokens"] == 900


def test_capture_counts_only_its_own_launches_across_threads():
    """Pods in one process launch from threads of their own: a decode
    graph's capture counts only the launches its own thread records (the
    other thread's wait for it), and no concurrent count is lost."""
    import sys
    import threading
    import time

    from llm_d_kv_cache_manager_tpu_torch import ops
    from llm_d_kv_cache_manager_tpu_torch.ops._counting import count_launch
    from llm_d_kv_cache_manager_tpu_torch.server import decode_graphs as dg

    saved = dg.launch_counts()
    started = threading.Event()

    def other():
        started.wait(10)
        for _ in range(1000):
            count_launch(ops.paged_attention)

    def capture():
        started.set()
        time.sleep(0.05)  # the other thread tries to count meanwhile
        for _ in range(3):
            count_launch(ops.paged_attention)
        return "out"

    threads = [threading.Thread(target=other) for _ in range(16)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        out, delta = dg.count_launches(capture)
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert out == "out" and delta == {"paged_decode": 3}
        assert dg.launch_counts()["paged_decode"] == saved["paged_decode"] + 16_000
    finally:
        sys.setswitchinterval(switch)
        for name, n in saved.items():
            ops.COUNTED[name].launches = n
