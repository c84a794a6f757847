"""Disaggregated prefill/decode serving on the port's pods, beside the JAX
pods (``tests/test_disagg.py``'s ``TestRoleWireFormat``, ``TestRoleGating``,
``TestDisaggServing`` and ``TestDisaggChaos``).

Both packages' pods run on TINY_LLAMA's shared parameters (the port's on the
CPU, JAX's in interpret mode) with their transfer planes on 127.0.0.1. Held
exactly: the Heartbeat and ``PrefillComplete`` bytes a pod publishes, the
``/stats`` ``disagg`` block, and greedy tokens at float32, which a two-hop
request shares with a single pod's run whichever package serves each hop.
"""

import asyncio
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from conftest import free_tcp_port
from llm_d_kv_cache_manager_tpu.kvcache import kvevents as jev
from llm_d_kv_cache_manager_tpu_torch.kvcache import kvevents as tev
from llm_d_kv_cache_manager_tpu_torch.kvcache.disagg import DisaggConfig, DisaggCoordinator
from llm_d_kv_cache_manager_tpu_torch.server.serve import AdmissionError
from torch_fleet import PS, SIDES, RecordingPublisher, pod, prompt, sampling

T, J = SIDES


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _endpoint():
    return f"tcp://127.0.0.1:{free_tcp_port()}"


def _stats(server) -> dict:
    async def go():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            return await (await client.get("/stats")).json()
        finally:
            await client.close()

    return asyncio.run(go())


class _Fleet:
    """Shut every pod down on exit (pods start when built)."""

    def __init__(self, **pods):
        self.pods = pods

    def __enter__(self):
        return self.pods

    def __exit__(self, *exc):
        for p in self.pods.values():
            p.shutdown()


def _disagg_fleet(pre_side=T, dec_side=T, *, async_pull=True, decode_pods=1):
    """One prefill pod (its transfer endpoint bound) and ``decode_pods``
    decode pods, each of the package its side names."""
    pods = {"pre": pod(pre_side, "pre", pod_role="prefill", transfer_endpoint=_endpoint())}
    for i in range(decode_pods):
        pods[f"dec{i}"] = pod(dec_side, f"dec{i}", pod_role="decode", async_pull=async_pull)
    return pods


def _reference(prompts, max_new) -> list:
    ref = pod(T, "ref")
    try:
        return [ref.generate(p, sampling(T, max_new_tokens=max_new), timeout=120)
                .generated_tokens for p in prompts]
    finally:
        ref.shutdown()


# -- TestRoleWireFormat ----------------------------------------------------------
@pytest.mark.parametrize("role", ["mixed", "prefill", "decode", "kvstore"])
def test_heartbeat_bytes_equal_jax_pod(role):
    """A pod's Heartbeat: the roleless (mixed) bytes are the legacy bytes,
    and a role rides both packages' beats identically."""
    payloads = []
    for side in SIDES:
        pub = RecordingPublisher(side)
        server = pod(side, "hb-pod", publisher=pub, pod_role=role)
        try:
            server._publish_heartbeat()
        finally:
            server.shutdown()
        payloads.append(pub.payloads("Heartbeat"))
    assert payloads[0] == payloads[1] and len(payloads[0]) == 1
    decoded = tev.decode_event_batch(payloads[0][0]).events[0]
    assert decoded.role == (None if role == "mixed" else role)
    if role == "mixed":
        assert tev.Heartbeat(dropped_batches=0).to_tagged_union() == ["Heartbeat", 0]


def test_role_and_prefill_complete_round_trip_across_packages():
    for enc, dec in ((tev, jev), (jev, tev)):
        for event in (enc.Heartbeat(dropped_batches=2, role="prefill"),
                      enc.PrefillComplete(request_id="r-1", num_blocks=5)):
            payload = enc.EventBatch(ts=1.0, events=[event]).to_payload()
            got = dec.decode_event_batch(payload).events[0]
            assert type(got).__name__ == type(event).__name__
            assert got.to_tagged_union() == event.to_tagged_union()
            assert dec.EventBatch(ts=1.0, events=[got]).to_payload() == payload


# -- TestRoleGating ---------------------------------------------------------------
def test_prefill_role_clamps_to_first_token_as_jax_pod():
    got = []
    for side in SIDES:
        pub = RecordingPublisher(side)
        server = pod(side, "rg-pre", publisher=pub, pod_role="prefill")
        try:
            seq = server.submit(prompt(5, 10), sampling(side, max_new_tokens=16),
                                request_id="rg-1").result(timeout=120)
            assert len(seq.generated_tokens) == 1
            assert server.role_clamped_requests == 1
            assert seq.num_registered_pages == 10 // PS
            assert server.prefill_completes_published == 1
            got.append((seq.generated_tokens, pub.payloads("PrefillComplete"), _stats(server)))
        finally:
            server.shutdown()
    (t_tok, t_pc, t_stats), (j_tok, j_pc, j_stats) = got
    assert t_tok == j_tok
    assert t_pc == j_pc and len(t_pc) == 1
    assert t_stats["disagg"] == j_stats["disagg"] == {
        "role": "prefill", "role_clamped_requests": 1, "prefill_completes_published": 1,
    }


def test_mixed_role_unclamped_and_no_disagg_block():
    server = pod(T, "rg-mix")
    try:
        seq = server.generate(prompt(5, 10), sampling(T, max_new_tokens=5), timeout=120)
        assert len(seq.generated_tokens) == 5 and server.role_clamped_requests == 0
        assert "disagg" not in _stats(server)
    finally:
        server.shutdown()


def test_invalid_role_rejected_and_kvstore_refuses_requests():
    with pytest.raises(ValueError, match="POD_ROLE"):
        pod(T, "rg-bad", pod_role="gpu", start=False)
    store = pod(T, "rg-store", pod_role="kvstore")
    try:
        with pytest.raises(ValueError, match="kvstore"):
            store.submit(prompt(1, 8))
    finally:
        store.shutdown()


# -- TestDisaggServing -------------------------------------------------------------
@pytest.mark.parametrize("pre_side, dec_side", [(T, T), (T, J), (J, T)],
                         ids=["torch-torch", "torch-jax", "jax-torch"])
def test_greedy_parity_disagg_vs_single_pod(pre_side, dec_side):
    """Two hops, in either package or across them, give a single pod's
    greedy tokens; the decode hop cache-hits the handed-off chain."""
    cases = [(prompt(1, 19), 8), (prompt(3, 33), 6)]
    want = [_reference([p], n)[0] for p, n in cases]
    with _Fleet(**_disagg_fleet(pre_side, dec_side)) as pods:
        co = DisaggCoordinator(pods, DisaggConfig())
        for (p, n), w in zip(cases, want):
            r = co.generate(p, sampling(T, max_new_tokens=n))
            assert r.mode == "disagg", r
            assert r.tokens == w
        assert r.decode_cached_tokens >= (33 // PS) * PS
        assert co.stats()["handoffs"] == 2


def test_blocking_pull_decode_pod_parity():
    p = prompt(7, 21)
    want = _reference([p], 5)[0]
    with _Fleet(**_disagg_fleet(async_pull=False)) as pods:
        r = DisaggCoordinator(pods, DisaggConfig()).generate(p, sampling(T, max_new_tokens=5))
        assert r.tokens == want
        assert r.decode_cached_tokens >= (21 // PS) * PS


def test_single_token_request_never_touches_decode_tier():
    with _Fleet(**_disagg_fleet()) as pods:
        r = DisaggCoordinator(pods).generate(prompt(9, 10), sampling(T, max_new_tokens=1))
        assert r.mode == "disagg" and r.decode_pod is None and len(r.tokens) == 1
        assert pods["dec0"].queue_depth == 0


def test_admission_sheds_at_prefill_tier_with_retry_after():
    pods = {
        "pre": pod(T, "pre-shed", pod_role="prefill", transfer_endpoint=_endpoint(),
                   admission_max_queued_tokens=8),
        "dec0": pod(T, "dec-shed", pod_role="decode", async_pull=True),
    }
    with _Fleet(**pods):
        with pytest.raises(AdmissionError) as ei:
            DisaggCoordinator(pods).generate(prompt(11, 16), sampling(T, max_new_tokens=4))
        assert ei.value.retry_after_s >= 1.0
        assert pods["dec0"].queue_depth == 0
        assert pods["pre"].admission_rejected == 1


def test_deadline_spans_both_hops():
    with _Fleet(**_disagg_fleet()) as pods:
        t0 = time.monotonic()
        r = DisaggCoordinator(pods).generate(
            prompt(13, 16), sampling(T, max_new_tokens=32), deadline_s=0.02
        )
        assert r.finish_reason == "deadline"
        assert time.monotonic() - t0 < 30.0


# -- TestDisaggChaos ----------------------------------------------------------------
def test_decode_pod_death_mid_handoff_replans():
    p = prompt(17, 18)
    want = _reference([p], 6)[0]
    with _Fleet(**_disagg_fleet(decode_pods=2)) as pods:
        frozen = DisaggCoordinator(pods)._views_fn()
        pods["dec0"].shutdown()
        co = DisaggCoordinator(pods, DisaggConfig(), views_fn=lambda: frozen)
        r = co.generate(p, sampling(T, max_new_tokens=6))
        assert r.tokens == want
        assert r.decode_pod == "dec1" and r.replans == 1


def test_prefill_pod_drain_degrades_to_single_pod_and_pages_return():
    p1 = prompt(20, 10)
    want = _reference([p1], 3)[0]
    pods = _disagg_fleet()
    pods["mix"] = pod(T, "mix-c2")
    with _Fleet(**pods):
        co = DisaggCoordinator(pods, DisaggConfig())
        dec = pods["dec0"]
        free0 = dec.engine.block_manager.num_free
        assert co.generate(prompt(19, 10), sampling(T, max_new_tokens=3)).mode == "disagg"
        assert dec.engine.block_manager.num_free == free0
        assert not dec._pull_jobs
        assert pods["pre"].drain(timeout_s=5.0)
        r1 = co.generate(p1, sampling(T, max_new_tokens=3))
        assert r1.mode == "single" and r1.decode_pod in ("dec0", "mix")
        assert r1.tokens == want
