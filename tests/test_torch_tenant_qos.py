"""Tenant QoS on the port's pod, beside the JAX pod (``tests/test_tenant_qos.py``'s
``TestTenantAdmission``, ``TestPriorityScheduling``,
``TestPreemptShedInterplay``, ``TestCacheShare``, ``TestOverloadDrill``,
``TestTenantObservability`` and ``TestKnobsOffParity``), a priority
preemption taken while a pipelined burst of 4 is in flight, and the slice's
modules in a process where ``jax`` cannot be imported.

Both packages' pods run TINY_LLAMA on shared parameters. Held exactly:
admission verdicts, messages and the per-tenant counters; greedy tokens at
float32 (a preempted victim's equal an unpreempted run's); the
``/stats`` ``tenant_qos`` block's keys and counts.
"""

import asyncio
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server.qos import TenantQoS, parse_tenant_qos
from llm_d_kv_cache_manager_tpu_torch.server.serve import AdmissionError, DrainingError
from torch_fleet import (
    SIDES,
    engine_config,
    gate_engine,
    pod,
    prompt,
    sampling,
    shared_params,
    wait_until,
)

T, J = SIDES
ROOT = Path(__file__).resolve().parent.parent
TWO_CLASS = "premium:prio=0,weight=4;batch:prio=1"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _decoding(server) -> bool:
    return any(s.num_generated > 0 for s in server.engine.scheduler.running)


def _http(server, requests):
    """POST each (tenant, prompt, max_tokens); then GET /stats, /debug/mrc
    and /metrics. Returns (statuses, 429 bodies and headers, stats, mrc,
    metrics)."""

    async def go():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            statuses, rejects = [], []
            for tenant, p, n in requests:
                resp = await client.post(
                    "/v1/completions", json={"prompt_token_ids": p, "max_tokens": n},
                    headers={"X-Tenant": tenant} if tenant else {},
                )
                statuses.append(resp.status)
                if resp.status == 429:
                    rejects.append((await resp.json(), resp.headers["Retry-After"]))
            stats = await (await client.get("/stats")).json()
            mrc = await (await client.get("/debug/mrc")).json()
            metrics = await (await client.get("/metrics")).text()
            return statuses, rejects, stats, mrc, metrics
        finally:
            await client.close()

    return asyncio.run(go())


# -- TestTenantAdmission ---------------------------------------------------------
def test_per_tenant_max_waiting_isolates_as_jax_pod():
    def scenario(side):
        server = pod(side, "qos-pod", tenant_qos="premium:prio=0;batch:prio=1,max_waiting=2",
                     start=False)
        gate = threading.Event()
        gate_engine(server, gate)
        server.start()
        try:
            sp = sampling(side, max_new_tokens=2)
            ok = [server.submit(prompt(i, 8), sp, tenant="batch") for i in range(2)]
            with pytest.raises(RuntimeError, match="'batch' over max_waiting") as ei:
                server.submit(prompt(9, 8), sp, tenant="batch")
            assert type(ei.value).__name__ == "AdmissionError"
            prem = server.submit(prompt(10, 8), sp, tenant="premium")
            assert server.admission_rejected == 1
            assert server.qos.rejected["batch"]["waiting"] == 1
            gate.set()
            toks = [f.result(timeout=120).generated_tokens for f in ok + [prem]]
            again = server.submit(prompt(11, 8), sp, tenant="batch").result(timeout=120)
            return str(ei.value), toks + [again.generated_tokens], server.qos.snapshot()
        finally:
            gate.set()
            server.shutdown()

    assert scenario(T) == scenario(J)


def test_per_tenant_queued_tokens_cap():
    server = pod(T, "qos-pod", tenant_qos="batch:max_queued_tokens=20;*:prio=0", start=False)
    gate = threading.Event()
    gate_engine(server, gate)
    server.start()
    try:
        server.submit(prompt(0, 16), sampling(T, max_new_tokens=1), tenant="batch")
        with pytest.raises(AdmissionError, match="over max_queued_tokens"):
            server.submit(prompt(1, 16), sampling(T, max_new_tokens=1), tenant="batch")
        assert server.qos.rejected["batch"]["tokens"] == 1
    finally:
        gate.set()
        server.shutdown()


def test_rate_budget_rejects_over_http_with_tenant_shape():
    server = pod(T, "qos-pod", tenant_qos="batch:rps=0.1;*:prio=0")
    try:
        statuses, rejects, *_ = _http(server, [
            ("batch", prompt(0, 8), 1), ("batch", prompt(1, 8), 1), ("someone-else", prompt(2, 8), 1),
        ])
    finally:
        server.shutdown()
    assert statuses == [200, 429, 200]
    body, retry_after = rejects[0]
    assert int(retry_after) >= 1 and isinstance(body["retry_after_s"], float)
    assert "'batch'" in body["error"]


# -- TestPriorityScheduling -------------------------------------------------------
def _preemption_run(side, tenant_qos, prompts, params, *, deadline_s=None, expire=False):
    server = pod(side, "qos-pod", total_pages=10, tenant_qos=tenant_qos)
    try:
        free0 = server.engine.block_manager.num_free
        bg = server.submit(prompts[0], sampling(side, **params[0]), tenant="batch",
                           deadline_s=deadline_s)
        assert wait_until(lambda: _decoding(server))
        prem = server.submit(prompts[1], sampling(side, **params[1]), tenant="premium")
        if expire:
            assert wait_until(lambda: server.engine.lifecycle_stats.get("priority_preempted", 0))
            for s in list(server.engine.scheduler.waiting):
                s.deadline = time.monotonic() - 1.0
        out = (bg.result(timeout=120), prem.result(timeout=120))
        assert wait_until(lambda: server.engine.block_manager.num_free == free0)
        if expire:
            assert server.abort(bg.request_id).result(timeout=30) is False
        return out, dict(server.engine.lifecycle_stats)
    finally:
        server.shutdown()


def test_priority_preemption_end_to_end_as_jax_pod():
    prompts = [prompt(50, 8), prompt(51, 28)]
    params = [dict(max_new_tokens=12), dict(max_new_tokens=4)]
    base = pod(T, "qos-base", total_pages=10)
    try:
        expect = [base.generate(p, sampling(T, **kw), timeout=120).generated_tokens
                  for p, kw in zip(prompts, params)]
    finally:
        base.shutdown()
    for side in SIDES:
        (bg, prem), stats = _preemption_run(side, TWO_CLASS, prompts, params)
        assert stats.get("priority_preempted", 0) >= 1
        assert [bg.generated_tokens, prem.generated_tokens] == expect
        assert bg.finish_reason is None and prem.finish_reason is None


def test_same_class_never_preempted():
    (a, b), stats = _preemption_run(T, "batch:prio=1;premium:prio=1",
                                    [prompt(60, 8), prompt(61, 20)],
                                    [dict(max_new_tokens=12), dict(max_new_tokens=4)])
    assert a.generated_tokens and b.generated_tokens
    assert stats.get("priority_preempted", 0) == 0


def test_priority_preemption_with_a_pipelined_burst_in_flight():
    """The victim is decoding in a pipelined burst of 4 when premium
    arrives: the burst is committed before its pages are freed, and the
    victim's tokens equal an unpreempted run's."""
    jp, tp = shared_params()
    knobs = dict(total_pages=10, decode_steps_per_iter=4, decode_pipeline=True)
    bg_prompt, prem_prompt = prompt(50, 8), prompt(51, 28)

    def run(with_premium):
        eng = TEngine(engine_config(True, **knobs), params=tp, device="cpu")
        eng.scheduler.attach_qos()
        eng.block_manager.attach_qos(TenantQoS(parse_tenant_qos(TWO_CLASS)))
        bg = eng.add_request(bg_prompt, sampling(T, max_new_tokens=16), tenant="batch",
                             priority=1)
        while eng._inflight is None:
            eng.step()
        prem = None
        if with_premium:
            assert any(s is bg for s in eng._inflight["active"])
            prem = eng.add_request(prem_prompt, sampling(T, max_new_tokens=4), tenant="premium",
                                   priority=0)
        eng.run_until_complete()
        return bg, prem, eng

    alone, _, _ = run(False)
    bg, prem, eng = run(True)
    assert eng.lifecycle_stats["priority_preempted"] == 1
    assert bg.generated_tokens == alone.generated_tokens and len(bg.generated_tokens) == 16
    assert prem.num_generated == 4 and bg.error is None
    assert eng.block_manager.num_free == eng.config.block_manager.total_pages - 1


def test_burst_in_flight_finishing_the_victim_leaves_it_unfolded():
    """Premium arrives while a pipelined burst of 4 in flight holds the
    victim's last tokens: committing the burst finishes the victim, which
    then leaves with exactly ``max_new_tokens`` tokens (a fold would have
    re-prefilled it and sampled past its cap); the batchmate preempted
    instead keeps the greedy stream of a QoS-off run."""
    jp, tp = shared_params()
    knobs = dict(total_pages=10, decode_steps_per_iter=4, decode_pipeline=True)
    prompts = [prompt(52, 8), prompt(53, 8)]
    caps = [12, 5]  # the second batch request ends inside the first burst

    def run(with_premium):
        eng = TEngine(engine_config(True, **knobs), params=tp, device="cpu")
        if with_premium:
            eng.scheduler.attach_qos()
            eng.block_manager.attach_qos(TenantQoS(parse_tenant_qos(TWO_CLASS)))
        batch = [eng.add_request(p, sampling(T, max_new_tokens=m), tenant="batch", priority=1)
                 for p, m in zip(prompts, caps)]
        while eng._inflight is None:
            eng.step()
        prem, finished = None, []
        if with_premium:
            victim = batch[1]  # the most recently admitted of the lower class
            assert any(s is victim for s in eng._inflight["active"])
            assert victim.num_generated + 4 >= caps[1]
            prem = eng.add_request(prompt(54, 28), sampling(T, max_new_tokens=4),
                                   tenant="premium", priority=0)
            assert not eng.block_manager.can_allocate(prem)
            finished = eng.step()
            assert victim in finished
            assert eng.lifecycle_stats.get("priority_preempted", 0) == 0
        eng.run_until_complete()
        return batch, prem, eng

    alone, _, _ = run(False)
    batch, prem, eng = run(True)
    assert batch[1].num_generated == caps[1] and len(batch[1].generated_tokens) == caps[1]
    assert [s.generated_tokens for s in batch] == [s.generated_tokens for s in alone]
    assert all(s.error is None for s in batch) and prem.num_generated == 4
    assert eng.block_manager.num_free == eng.config.block_manager.total_pages - 1


# -- TestPreemptShedInterplay -------------------------------------------------------
def test_preempted_then_expired_sequence_shed_once():
    (bg, prem), stats = _preemption_run(
        T, TWO_CLASS, [prompt(70, 8), prompt(71, 28)],
        [dict(max_new_tokens=32), dict(max_new_tokens=4)], deadline_s=600, expire=True)
    assert bg.finish_reason == "deadline" and prem.finish_reason is None
    assert stats["deadline_shed"] == 1 and stats.get("priority_preempted", 0) == 1
    assert stats["aborted"] == 0


# -- TestCacheShare ------------------------------------------------------------------
def test_flooding_tenant_recycles_its_own_pages_as_jax_pod():
    def scenario(side):
        server = pod(side, "qos-pod", total_pages=16,
                     tenant_qos="premium:prio=0;batch:prio=1,cache_share=0.25")
        try:
            sp = sampling(side, max_new_tokens=2)
            server.submit(prompt(80, 12), sp, tenant="premium").result(120)
            for i in range(8):
                server.submit(prompt(81 + i, 12), sp, tenant="batch").result(120)
            seq = server.submit(prompt(80, 12), sp, tenant="premium").result(120)
            bm = server.engine.block_manager
            assert bm.tenant_stats["batch"]["capped_evictions"] > 0
            assert seq.num_cached_prompt > 0
            return {t: dict(s) for t, s in bm.tenant_stats.items()}, seq.num_cached_prompt
        finally:
            server.shutdown()

    assert scenario(T) == scenario(J)


# -- TestOverloadDrill ------------------------------------------------------------------
def test_premium_token_identical_while_background_degrades():
    prem_prompts = [prompt(200 + i, 10) for i in range(3)]
    base = pod(T, "qos-base")
    try:
        expect = [base.generate(p, sampling(T, max_new_tokens=4), timeout=120).generated_tokens
                  for p in prem_prompts]
    finally:
        base.shutdown()
    server = pod(T, "qos-pod", tenant_qos="premium:prio=0,weight=4;batch:prio=1,max_waiting=2",
                 start=False)
    gate = threading.Event()
    gate_engine(server, gate)
    server.start()
    try:
        sp = sampling(T, max_new_tokens=4)
        admitted, rejected = [], 0
        for i in range(6):
            try:
                admitted.append(server.submit(prompt(300 + i, 8), sp, tenant="batch"))
            except AdmissionError:
                rejected += 1
        assert len(admitted) == 2 and rejected == 4
        prem = [server.submit(p, sp, tenant="premium") for p in prem_prompts]
        gate.set()
        assert [f.result(timeout=120).generated_tokens for f in prem] == expect
        assert all(f.result(timeout=120).num_generated == 4 for f in admitted)
        snap = server.qos.snapshot()["tenants"]
        assert snap["batch"]["rejected"]["waiting"] == 4
        assert snap["premium"]["rejected"] == {"waiting": 0, "tokens": 0, "rate": 0}
    finally:
        gate.set()
        server.shutdown()


def test_drain_mid_burst_leaks_no_tenant_budget():
    server = pod(T, "qos-pod", tenant_qos=TWO_CLASS, drain_timeout_s=60.0, start=False)
    gate = threading.Event()
    gate_engine(server, gate)
    server.start()
    try:
        sp = sampling(T, max_new_tokens=2)
        futs = [server.submit(prompt(400 + i, 8), sp, tenant=t)
                for i, t in enumerate(["premium", "batch", "premium", "batch"])]
        with server._mu:
            assert (server.qos.pending["premium"], server.qos.pending["batch"]) == (2, 2)
        drainer = threading.Thread(target=server.drain, daemon=True)
        drainer.start()
        assert wait_until(lambda: server._draining)
        with pytest.raises(DrainingError):
            server.submit(prompt(499, 8), sp, tenant="premium")
        gate.set()
        drainer.join(timeout=120)
        assert all(f.result(timeout=120).num_generated == 2 for f in futs)
        with server._mu:
            assert all(v == 0 for v in server.qos.pending.values())
            assert all(v == 0 for v in server.qos.pending_tokens.values())
    finally:
        gate.set()
        server.shutdown()


# -- TestTenantObservability, TestKnobsOffParity -----------------------------------------
@pytest.mark.parametrize("knob", [True, False], ids=["on", "off"])
def test_tenant_surfaces_equal_jax_pod(knob):
    """``/stats``, ``/debug/mrc`` and ``/metrics`` with TENANT_QOS on carry
    the tenant slices, keyed and counted as the JAX pod's; off, none."""
    requests = [("premium", prompt(0, 8), 2), ("batch", prompt(1, 8), 2), (None, prompt(2, 8), 2)]
    got = []
    for side in SIDES:
        server = pod(side, "qos-pod", tenant_qos=TWO_CLASS if knob else "",
                     obs_slo="ttft:30:0.9", obs_lifecycle=True, obs_metrics=True)
        try:
            statuses, _, stats, mrc, metrics = _http(server, requests)
            assert statuses == [200, 200, 200]
            if not knob:
                assert server.qos is None and server.engine.scheduler.qos_enabled is False
                assert server.engine.block_manager._qos is None
                assert server.slo.track_tenants is False
        finally:
            server.shutdown()
        got.append((stats, mrc, metrics))
    (ts, tm, tx), (js, jm, jx) = got
    assert set(ts) == set(js) and set(ts["admission"]) == set(js["admission"])
    if not knob:
        assert "tenant_qos" not in ts and "tenants" not in ts["lifecycle"]
        assert "tenants" not in tm and "kvcache_tenant_slo_burn_rate" not in tx
        return
    tq, jq = ts["tenant_qos"], js["tenant_qos"]
    assert set(tq) == set(jq) and tq["tenants"] == jq["tenants"]
    assert set(tq["tenants"]) == {"*", "batch", "premium"}
    assert tq["tenants"]["premium"]["admitted"] == 1 and tq["tenants"]["*"]["admitted"] == 1
    assert tq["cache"] == jq["cache"] and tq["qos_served_tokens"] == jq["qos_served_tokens"]
    assert set(tq["slo_burn"]) == set(jq["slo_burn"])
    assert "ttft_le_30s_p0.9" in tq["slo_burn"]["premium"]
    assert ts["lifecycle"]["tenants"] == js["lifecycle"]["tenants"]
    assert set(tm["tenants"]) == set(jm["tenants"]) >= {"batch", "premium"}
    assert tm["tenants"]["premium"]["enabled"] is True
    assert 'kvcache_tenant_slo_burn_rate{' in tx and 'tenant="premium"' in tx


# -- the slice's modules without JAX ---------------------------------------------------
def test_slice_modules_need_no_jax():
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from llm_d_kv_cache_manager_tpu_torch.kvcache.disagg import DisaggCoordinator, PodView
        from llm_d_kv_cache_manager_tpu_torch.kvcache.integrity import BlockIntegrity, page_digest
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import hash_block
        from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer import (
            BlockPayload, RemoteBlockStore, RemoteStoreConfig)
        from llm_d_kv_cache_manager_tpu_torch.server.qos import TenantQoS, parse_tenant_qos

        qos = TenantQoS(parse_tenant_qos("premium:prio=0,weight=4;batch:prio=1,max_waiting=1"))
        assert qos.admit("batch", 4) is None
        qos.on_admitted("batch", 4)
        assert qos.admit("batch", 4)[0] == "waiting"
        table = BlockIntegrity(table_cap=8)
        table.record(7, page_digest(b"k", b"v"))
        assert table.check(7, page_digest(b"k", b"v")) == "ok"
        assert table.check(7, page_digest(b"k", b"w")) == "corrupt"
        shape = (2, 4, 2, 8)
        data = np.zeros(shape, np.float32).tobytes()
        h = hash_block(0, [1, 2, 3, 4])
        store = RemoteBlockStore(RemoteStoreConfig(
            capacity_pages=4, page_size=4, page_shape=shape, dtype="float32",
            scale_bytes=2 * 2 * 4, init_hash=0))
        blk = BlockPayload(block_hash=h, parent_block_hash=None, token_ids=[1, 2, 3, 4],
                           block_size=4, dtype="float32", shape=shape, k_data=data, v_data=data)
        assert store.accept([blk]) == 1 and store.headroom == 3
        assert [b.block_hash for b in store.serve([h])] == [h]
        co = DisaggCoordinator({}, views_fn=lambda: [])
        assert co.stats()["handoffs"] == 0
        leaked = [m for m in sys.modules
                  if m == "llm_d_kv_cache_manager_tpu" or m.startswith("llm_d_kv_cache_manager_tpu.")]
        assert not leaked, leaked
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
