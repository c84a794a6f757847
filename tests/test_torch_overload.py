"""Overload protection on the port's pod, beside the JAX pod.

``tests/test_overload.py``'s ``TestAdmissionControl``, ``TestDrain``,
``TestShutdownEdges`` and ``TestWireCompat`` run on a torch pod (CPU
engine) and on a JAX pod (interpret mode), both on TINY_LLAMA's shared
parameters. Held equal between them, exactly: status codes, error
messages and ``finish_reason``s; ``Retry-After`` hints with the measured
rates pinned; the msgpack bytes of the ``Heartbeat``, ``IndexSnapshot`` and
``PodDrained`` events the pods publish; and greedy tokens, which the
admitted requests of an overloaded pod also share with an unloaded one.
"""

import asyncio
import threading
import time

import msgpack
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from llm_d_kv_cache_manager_tpu.kvcache import kvevents as jev
from llm_d_kv_cache_manager_tpu.server import serve as jserve
from llm_d_kv_cache_manager_tpu_torch.kvcache import kvevents as tev
from llm_d_kv_cache_manager_tpu_torch.server import serve as tserve
from torch_fleet import SIDES, RecordingPublisher, gate_engine, pod, prompt, sampling, wait_until


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _serve(torch_side):
    return tserve if torch_side else jserve


def _both(scenario):
    """Run ``scenario(torch_side)`` on each package; returns (torch's, JAX's)."""
    return tuple(scenario(side) for side in SIDES)


# -- TestAdmissionControl ------------------------------------------------------
def test_caps_off_admits_unboundedly():
    def scenario(side):
        server = pod(side, "overload-pod")
        try:
            futs = [server.submit(prompt(i, 8), sampling(side, max_new_tokens=2))
                    for i in range(12)]
            seqs = [f.result(timeout=120) for f in futs]
            assert all(s.num_generated == 2 for s in seqs)
            return [s.output_tokens for s in seqs]
        finally:
            server.shutdown()

    t, j = _both(scenario)
    assert t == j


def test_max_waiting_sheds_and_admitted_match_unloaded_baseline():
    prompts = [prompt(100 + i, 8 + i) for i in range(6)]

    def scenario(side):
        baseline = pod(side, "overload-base")
        try:
            expect = [baseline.generate(p, sampling(side, max_new_tokens=4), timeout=120)
                      .output_tokens for p in prompts]
        finally:
            baseline.shutdown()
        server = pod(side, "overload-pod", admission_max_waiting=3, start=False)
        gate = threading.Event()  # cleared: engine steps blocked
        gate_engine(server, gate)
        server.start()
        try:
            results, rejected = {}, []
            for i, p in enumerate(prompts):
                try:
                    results[i] = server.submit(p, sampling(side, max_new_tokens=4))
                except _serve(side).AdmissionError as e:
                    rejected.append((i, str(e), e.retry_after_s))
            assert len(results) == 3 and len(rejected) == 3
            assert server.admission_rejected == 3
            gate.set()
            admitted = {i: fut.result(timeout=120).output_tokens for i, fut in results.items()}
            assert admitted == {i: expect[i] for i in results}
            return expect, admitted, rejected
        finally:
            gate.set()
            server.shutdown()

    t, j = _both(scenario)
    assert t == j
    assert t[2][0] == (3, "overloaded: 3 requests waiting >= ADMISSION_MAX_WAITING=3", 1.0)


def test_max_queued_tokens_cap():
    def scenario(side):
        server = pod(side, "overload-pod", admission_max_queued_tokens=20, start=False)
        gate = threading.Event()
        gate_engine(server, gate)
        server.start()
        try:
            ok = server.submit(prompt(0, 16), sampling(side, max_new_tokens=2))
            with pytest.raises(_serve(side).AdmissionError) as err:
                server.submit(prompt(1, 16), sampling(side, max_new_tokens=2))
            gate.set()
            first = ok.result(timeout=120)
            assert first.num_generated == 2
            # Accounting drains with the queue: the next request admits.
            fut = server.submit(prompt(2, 16), sampling(side, max_new_tokens=2))
            second = fut.result(timeout=120)
            assert second.num_generated == 2
            return str(err.value), first.output_tokens, second.output_tokens
        finally:
            gate.set()
            server.shutdown()

    t, j = _both(scenario)
    assert t == j
    assert t[0] == "overloaded: 16 + 16 queued prompt tokens > ADMISSION_MAX_QUEUED_TOKENS=20"


@pytest.mark.parametrize("pinned", ["request_rate", "prefill_rate"])
def test_retry_after_from_pinned_rates(pinned):
    """The hint is the queue over the measured completion rate, else the
    queued prompt tokens over the prefill rate, clamped to [1, 60] s: with
    the rates pinned to the same values both pods give the same hints."""

    def scenario(side):
        server = pod(side, "overload-pod", admission_max_waiting=2, start=False)
        gate = threading.Event()
        gate_engine(server, gate)
        server.start()
        try:
            if pinned == "request_rate":
                server.metrics.request_rate = 0.4
            else:
                server.engine._prefill_rate = 3.0
            hints = []
            for i in range(5):
                try:
                    server.submit(prompt(200 + i, 7), sampling(side, max_new_tokens=1))
                except _serve(side).AdmissionError as e:
                    hints.append((str(e), e.retry_after_s))
            hints.append(server._retry_after_s(100, 0))
            hints.append(server._retry_after_s(0, 10_000))
            return hints
        finally:
            gate.set()
            server.shutdown()

    t, j = _both(scenario)
    assert t == j
    assert len(t) == 5
    want = 5.0 if pinned == "request_rate" else 14 / 3.0
    assert t[0] == ("overloaded: 2 requests waiting >= ADMISSION_MAX_WAITING=2", want)


def test_http_429_with_retry_after():
    def scenario(side):
        server = pod(side, "overload-pod", admission_max_waiting=1, start=False)
        gate = threading.Event()
        gate_engine(server, gate)
        server.start()

        async def run():
            client = TestClient(TestServer(server.build_app()))
            await client.start_server()
            try:
                first = asyncio.create_task(client.post(
                    "/v1/completions", json={"prompt_token_ids": prompt(3, 8), "max_tokens": 2}))
                await asyncio.sleep(0.2)  # first request is staged by now
                resp = await client.post(
                    "/v1/completions", json={"prompt_token_ids": prompt(4, 8), "max_tokens": 2})
                assert resp.status == 429
                assert int(resp.headers["Retry-After"]) >= 1
                data = await resp.json()
                assert "overloaded" in data["error"]
                gate.set()
                resp1 = await first
                body1 = await resp1.json()
                return (resp.status, resp.headers["Retry-After"], data, resp1.status,
                        body1["choices"][0]["token_ids"], body1["choices"][0]["finish_reason"])
            finally:
                await client.close()

        try:
            return asyncio.run(run())
        finally:
            gate.set()
            server.shutdown()

    t, j = _both(scenario)
    assert t == j
    assert t[2] == {"error": "overloaded: 1 requests waiting >= ADMISSION_MAX_WAITING=1",
                    "retry_after_s": 1.0}


def test_reject_response_rounds_hint_up():
    class Web:
        @staticmethod
        def json_response(body, status, headers):
            return body, status, headers

    for hint in (0.2, 1.0, 1.2, 59.5):
        t = tserve.admission_reject_response(Web, tserve.AdmissionError("x", hint))
        j = jserve.admission_reject_response(Web, jserve.AdmissionError("x", hint))
        assert t == j
        assert int(t[2]["Retry-After"]) >= 1 and t[0]["retry_after_s"] == hint


# -- TestDrain -----------------------------------------------------------------
def test_drain_idle_pod_publishes_goodbye():
    def scenario(side):
        pub = RecordingPublisher(side)
        server = pod(side, "overload-pod", publisher=pub)
        try:
            assert server.drain() is True
            assert server.is_draining
            with pytest.raises(_serve(side).DrainingError) as err:
                server.submit(prompt(12, 8))
            assert server.admission_rejected_draining == 1
            snaps, drains = pub.events("IndexSnapshot"), pub.events("PodDrained")
            assert len(snaps) == 1 and len(drains) == 1
            flat = [e for b in pub.batches for e in b.events]
            assert flat.index(snaps[0]) < flat.index(drains[0])
            assert server.drain() is True  # idempotent
            return str(err.value), pub.payloads("IndexSnapshot"), pub.payloads("PodDrained")
        finally:
            server.shutdown()

    t, j = _both(scenario)
    assert t == j
    assert t[0] == "pod is draining; retry against another pod"


def test_drain_waits_for_inflight():
    def scenario(side):
        pub = RecordingPublisher(side)
        server = pod(side, "overload-pod", publisher=pub)
        try:
            fut = server.submit(prompt(13, 8), sampling(side, max_new_tokens=6))
            assert server.drain(timeout_s=60) is True
            seq = fut.result(timeout=5)  # finished, not aborted
            assert seq.num_generated == 6 and seq.finish_reason is None
            assert server.drain_forced_requests == 0
            return seq.output_tokens, pub.payloads("IndexSnapshot"), pub.payloads("PodDrained")
        finally:
            server.shutdown()

    t, j = _both(scenario)
    assert t == j


def test_drain_aborts_wedged_request_past_timeout():
    def scenario(side):
        pub = RecordingPublisher(side)
        server = pod(side, "overload-pod", publisher=pub, total_pages=512,
                     engine_kw={"max_model_len": 2048})
        free0 = server.engine.block_manager.num_free
        try:
            fut = server.submit(prompt(14, 8), sampling(side, max_new_tokens=100_000))
            assert server.drain(timeout_s=0.4) is False  # forced
            seq = fut.result(timeout=30)
            assert seq.finish_reason == "abort"
            assert 0 < seq.num_generated < 100_000
            assert server.drain_forced_requests == 1
            assert wait_until(lambda: not server.engine.has_work
                              and server.engine.block_manager.num_free == free0)
            assert len(pub.events("PodDrained")) == 1
            return seq.finish_reason, server.drain_forced_requests, pub.payloads("PodDrained")
        finally:
            server.shutdown()

    t, j = _both(scenario)
    assert t == j


def test_drain_commits_pipelined_burst_before_freeing():
    """A forced drain aborts lanes while a pipelined decode burst may be in
    flight: the abort commits it first, so every page comes back and the
    partial outputs are a prefix of the unloaded greedy run."""
    prompts = [prompt(300 + i, 8) for i in range(3)]
    knobs = dict(max_model_len=2048, decode_steps_per_iter=4, decode_pipeline=True)
    ref = pod(True, "ref", total_pages=512, engine_kw=knobs)
    try:
        expect = [ref.generate(p, sampling(True, max_new_tokens=40), timeout=120).output_tokens
                  for p in prompts]
    finally:
        ref.shutdown()
    server = pod(True, "pipelined", total_pages=512, engine_kw=knobs)
    free0 = server.engine.block_manager.num_free
    try:
        futs = [server.submit(p, sampling(True, max_new_tokens=100_000)) for p in prompts]
        assert wait_until(lambda: all(len(s.output_tokens) > 40 for s in
                                      server.engine.scheduler.running) and
                          len(server.engine.scheduler.running) == 3)
        assert server.drain(timeout_s=0.0) is False
        seqs = [f.result(timeout=30) for f in futs]
        assert all(s.finish_reason == "abort" for s in seqs)
        assert [s.output_tokens[:40] for s in seqs] == expect
        assert server.engine._inflight is None
        assert wait_until(lambda: server.engine.block_manager.num_free == free0)
    finally:
        server.shutdown()


def test_http_drain_endpoint_and_healthz():
    def scenario(side):
        server = pod(side, "overload-pod")

        async def run():
            client = TestClient(TestServer(server.build_app()))
            await client.start_server()
            try:
                seen = [(await client.get("/healthz")).status]
                resp = await client.post("/drain")
                seen += [resp.status, await resp.json()]

                async def drained():
                    r = await client.get("/healthz")
                    return r.status == 503 and (await r.json())["status"] == "draining"

                deadline = time.time() + 30
                while time.time() < deadline and not await drained():
                    await asyncio.sleep(0.02)
                assert await drained()
                resp = await client.post(
                    "/v1/completions", json={"prompt_token_ids": prompt(15, 8), "max_tokens": 2})
                seen += [resp.status, await resp.json()]
                data = await (await client.get("/stats")).json()
                assert data["drain"]["draining"] is True
                assert data["admission"]["rejected_draining"] == 1
                return seen + [data["drain"], data["admission"]]
            finally:
                await client.close()

        try:
            return asyncio.run(run())
        finally:
            server.shutdown()

    t, j = _both(scenario)
    assert t == j
    assert t[:3] == [200, 202, {"status": "draining", "drain_timeout_s": 30.0}]
    assert t[3:5] == [503, {"error": "pod is draining; retry against another pod"}]


# -- TestShutdownEdges ---------------------------------------------------------
def test_fail_outstanding_queued_midprefill_middecode():
    def scenario(side):
        server = pod(side, "overload-pod", start=False,
                     engine_kw={"scheduler_kw": {"chunked_prefill_tokens": 8}})
        gate = threading.Event()
        gate.set()
        gate_engine(server, gate)
        server.start()
        fut_decode = server.submit(prompt(16, 8), sampling(side, max_new_tokens=50))
        assert wait_until(lambda: len(server.engine.scheduler.running) == 1)
        fut_prefill = server.submit(prompt(17, 40), sampling(side, max_new_tokens=4))
        assert wait_until(lambda: len(server.engine.scheduler.prefilling) == 1)
        gate.clear()  # blocks the loop inside its next step (<= 10s)
        fut_queued = server.submit(prompt(18, 8), sampling(side, max_new_tokens=4))
        timer = threading.Timer(0.5, gate.set)  # unblock the step mid-shutdown
        timer.start()
        try:
            server.shutdown()
            errors = []
            for fut in (fut_decode, fut_prefill, fut_queued):
                with pytest.raises(RuntimeError) as err:
                    fut.result(timeout=10)
                errors.append(str(err.value))
            with server._mu:
                assert server._pending == 0 and server._pending_tokens == 0
            return errors
        finally:
            timer.cancel()
            gate.set()

    t, j = _both(scenario)
    assert t == j == ["pod server shut down"] * 3


# -- TestWireCompat ------------------------------------------------------------
def test_heartbeat_wire_bytes_unchanged_when_not_draining():
    for ev in (tev, jev):
        payload = ev.EventBatch(ts=1.0, events=[ev.Heartbeat(dropped_batches=3)]).to_payload()
        assert payload == msgpack.packb([1.0, [["Heartbeat", 3]]], use_bin_type=True)


def test_heartbeat_draining_roundtrip():
    for ev in (tev, jev):
        payload = ev.EventBatch(
            ts=1.0, events=[ev.Heartbeat(dropped_batches=2, draining=True)]).to_payload()
        (got,) = ev.decode_event_batch(payload).events
        assert got == ev.Heartbeat(dropped_batches=2, draining=True)
        (got,) = ev.decode_event_batch(msgpack.packb([1.0, [["Heartbeat", 2, "yes"]]])).events
        assert got == ev.Heartbeat(dropped_batches=2, draining=False)


def test_pod_drained_roundtrip():
    for ev in (tev, jev):
        payload = ev.EventBatch(ts=1.0, events=[ev.PodDrained()]).to_payload()
        (got,) = ev.decode_event_batch(payload).events
        assert got == ev.PodDrained()


def test_pods_publish_equal_heartbeat_bytes():
    """The heartbeats a live pod publishes, then the draining one a drain
    sends at once, then the goodbye: the same bytes from both pods, and
    the legacy bytes while not draining."""

    def scenario(side):
        pub = RecordingPublisher(side)
        server = pod(side, "hb-pod", publisher=pub, heartbeat_interval_s=0.05)
        try:
            assert wait_until(lambda: server.heartbeats_published >= 2)
            server.generate(prompt(19, 8), sampling(side, max_new_tokens=2), timeout=120)
            assert server.drain(timeout_s=30) is True
            beats = pub.payloads("Heartbeat")
            return beats[0], [b for b in beats if b != beats[0]][:1], pub.payloads("PodDrained")
        finally:
            server.shutdown()

    t, j = _both(scenario)
    assert t == j
    assert t[0] == msgpack.packb([1.0, [["Heartbeat", 0]]], use_bin_type=True)
    assert t[1] == [msgpack.packb([1.0, [["Heartbeat", 0, True]]], use_bin_type=True)]
    assert t[2] == [msgpack.packb([1.0, [["PodDrained"]]], use_bin_type=True)]
