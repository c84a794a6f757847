"""The port pod's audit, SLO, pull and exemplar observability beside the
JAX pod's, on the cases of ``tests/test_route_audit.py`` (``TestSLO``,
``TestPodAuditPublish``, ``TestFleetAuditAcceptance``), the pull-histogram
cases of ``tests/test_observability.py`` and the exemplar cases of
``tests/test_federation.py``, plus the ``pod.pull_prefix`` spans of a
blocking and an async (``X-Pull-Source``) pull.

Pods run TINY_LLAMA on shared parameters (the port's engine on the CPU,
the JAX engine in interpret mode). A torch pod publishes through the
port's wire into the port's events pool, route auditor and router; a JAX
pod into the JAX package's. Held exactly: the audit rows and counters, the
SLO burn rates (float32-free arithmetic, equal to 1e-12), the pull series,
and the span names and parent links.
"""

import asyncio
import re
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from chaos import ChaosLink
from conftest import free_tcp_port
from llm_d_kv_cache_manager_tpu.kvcache.kvevents import KVEventsPool as JPool
from llm_d_kv_cache_manager_tpu.kvcache.kvevents import KVEventsPoolConfig as JPoolConfig
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.in_memory import InMemoryIndex as JIndex
from llm_d_kv_cache_manager_tpu.obs import audit as j_audit
from llm_d_kv_cache_manager_tpu.obs import slo as j_slo
from llm_d_kv_cache_manager_tpu.obs import tracing as j_tracing
from llm_d_kv_cache_manager_tpu.server import serve as jserve
from llm_d_kv_cache_manager_tpu_torch.kvcache import (
    BlendedRouter,
    KVCacheIndexer,
    KVCacheIndexerConfig,
    PrefixAffinityTracker,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import InMemoryIndex as TIndex
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import (
    BlockRemoved,
    FleetHealth,
    FleetHealthConfig,
    RequestAudit,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import KVEventsPool as TPool
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import KVEventsPoolConfig as TPoolConfig
from llm_d_kv_cache_manager_tpu_torch.obs import audit as t_audit
from llm_d_kv_cache_manager_tpu_torch.obs import slo as t_slo
from llm_d_kv_cache_manager_tpu_torch.obs import tracing as t_tracing
from llm_d_kv_cache_manager_tpu_torch.server import serve as tserve
from test_torch_fleet_chaos import PortChaosLink
from torch_fleet import MODEL, PS, SIDES, pod, prompt, sampling, wait_until

SLO_MODULES = {"torch": t_slo, "jax": j_slo}
_EXEMPLAR_RE = re.compile(
    r'kvcache_request_ttft_seconds_bucket\{[^}]*\}\s+\S+\s+#\s+\{trace_id="([0-9a-f]{32})"\}'
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _serve(server, scenario):
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


def _series(text: str, prefix: str) -> list[str]:
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith(prefix) and "_created" not in ln)


# ---------------------------------------------------------------------------
# SLO recording
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", list(SLO_MODULES))
class TestSLO:
    def test_parse_spec(self, pkg):
        slo = SLO_MODULES[pkg]
        (a, b) = slo.parse_slo_spec("ttft:0.5:0.99;itl:0.05:0.95")
        assert a.metric == "ttft" and a.threshold_s == 0.5 and a.target == 0.99
        assert b.label == "itl_le_0.05s_p0.95"
        assert slo.parse_slo_spec("") == []

    @pytest.mark.parametrize("spec", ["ttft:0.5", "e2e:1:0.9", "ttft:0:0.9", "ttft:1:1.5",
                                      "ttft:1:0"])
    def test_parse_spec_rejects_malformed(self, pkg, spec):
        with pytest.raises(ValueError):
            SLO_MODULES[pkg].parse_slo_spec(spec)

    def test_parse_windows(self, pkg):
        slo = SLO_MODULES[pkg]
        assert slo.parse_windows("") == (60.0, 300.0)
        assert slo.parse_windows("10,20") == (10.0, 20.0)
        with pytest.raises(ValueError):
            slo.parse_windows("0,10")

    def test_burn_rate_is_violating_fraction_over_budget(self, pkg):
        slo = SLO_MODULES[pkg]
        now = [0.0]
        r = slo.SLORecorder(slo.parse_slo_spec("ttft:0.5:0.9"), windows_s=(10.0,),
                            clock=lambda: now[0])
        for ttft in (0.1, 0.1, 0.1, 1.0):  # 25% violating, budget 10%
            r.observe(ttft, None)
        assert r.burn_rates()["ttft_le_0.5s_p0.9"]["10s"] == 2.5

    def test_window_pruning(self, pkg):
        slo = SLO_MODULES[pkg]
        now = [0.0]
        r = slo.SLORecorder(slo.parse_slo_spec("ttft:0.5:0.9"), windows_s=(10.0,),
                            clock=lambda: now[0])
        r.observe(1.0, None)
        now[0] = 20.0
        r.observe(0.1, None)
        assert r.burn_rates()["ttft_le_0.5s_p0.9"]["10s"] == 0.0

    def test_empty_window_is_none_and_gauge_skipped(self, pkg):
        slo = SLO_MODULES[pkg]
        r = slo.SLORecorder(slo.parse_slo_spec("itl:0.05:0.99"), windows_s=(60.0,))
        assert r.burn_rates()["itl_le_0.05s_p0.99"]["60s"] is None
        calls = []
        r.sync_gauges(lambda o, w, v: calls.append((o, w, v)))
        assert calls == []

    def test_none_measurement_skipped(self, pkg):
        slo = SLO_MODULES[pkg]
        r = slo.SLORecorder(slo.parse_slo_spec("itl:0.05:0.9"), windows_s=(60.0,))
        r.observe(0.3, None)
        assert r.burn_rates()["itl_le_0.05s_p0.9"]["60s"] is None


def test_malformed_slo_spec_fails_pod_construction():
    for side in SIDES:
        with pytest.raises(ValueError):
            pod(side, "slo-bad", start=False, obs_slo="garbage")


def test_pod_slo_block_and_burn_gauge_equal():
    """The same requests against an impossible TTFT objective: equal
    ``/stats`` ``slo`` blocks (burn rates to 1e-12) and the same
    ``kvcache_slo_burn_rate`` series on ``/metrics``."""
    answers = []
    for side in SIDES:
        server = pod(side, "slo-pod", obs_metrics=True, obs_slo="ttft:0.000001:0.99;itl:60:0.5")

        async def scenario(c):
            for i in range(2):
                resp = await c.post("/v1/completions",
                                    json={"prompt_token_ids": prompt(i, 10), "max_tokens": 3})
                assert resp.status == 200
            stats = await (await c.get("/stats")).json()
            text = await (await c.get("/metrics")).text()
            return stats["slo"], _series(text, "kvcache_slo_burn_rate")

        answers.append(_serve(server, scenario))
    (t_slo_block, t_series), (j_slo_block, j_series) = answers
    assert t_series == j_series and t_series
    assert sorted(t_slo_block) == sorted(j_slo_block)
    t_burn, j_burn = t_slo_block["burn_rates"], j_slo_block["burn_rates"]
    assert t_burn.keys() == j_burn.keys()
    for obj in t_burn:
        for win in t_burn[obj]:
            if j_burn[obj][win] is None:
                assert t_burn[obj][win] is None
            else:
                assert t_burn[obj][win] == pytest.approx(j_burn[obj][win], abs=1e-12)
    assert t_burn["ttft_le_1e-06s_p0.99"]["60s"] == pytest.approx(100.0)


def test_pod_slo_and_audit_blocks_absent_with_knobs_off():
    for side in SIDES:
        server = pod(side, "parity-pod")

        async def scenario(c):
            return await (await c.get("/stats")).json()

        stats = _serve(server, scenario)
        assert "slo" not in stats and "audit" not in stats
        assert server.slo is None and server.audits_published == 0


# ---------------------------------------------------------------------------
# Pod RequestAudit publishing
# ---------------------------------------------------------------------------
def _audit_run(side):
    idx = TIndex() if side else JIndex()
    pool = (TPool if side else JPool)(
        TIndex() if side else JIndex(), (TPoolConfig if side else JPoolConfig)(concurrency=1)
    )
    auditor = (t_audit if side else j_audit).RouteAuditor(index=idx, model_name=MODEL)
    pool.audit = auditor
    pool.start()
    link = (PortChaosLink if side else ChaosLink)(pool, "audit-pod", MODEL)
    server = pod(side, "audit-pod", publisher=link, obs_audit=True)
    prefix = prompt(30, 16)
    try:
        server.generate(prefix + prompt(31, 4), sampling(side, max_new_tokens=2), timeout=120)
        warm_fut = server.submit(prefix + prompt(32, 4), sampling(side, max_new_tokens=2),
                                 request_id="warm-1")
        auditor.record_decision("warm-1", chosen_pod="audit-pod",
                                predicted_blocks=len(prefix) // PS,
                                scoreboard={"audit-pod": len(prefix) // PS})
        seq = warm_fut.result(timeout=120)
        assert pool.drain(timeout=10.0)
    finally:
        server.shutdown()
        pool.shutdown()
    return server, seq, auditor


class TestPodAuditPublish:
    def test_realized_blocks_published_per_finished_request(self):
        runs = [_audit_run(side) for side in SIDES]
        for server, seq, auditor in runs:
            assert server.audits_published == 2
            assert seq.num_cached_prompt == 16
            snap = auditor.snapshot()
            assert snap["unmatched_realized"] == 1 and snap["joined"] == 1
            (row,) = auditor.recent(request_id="warm-1")
            assert row["predicted_blocks"] == row["realized_blocks"] == 16 // PS
            assert row["cause"] is None and row["ratio"] == 1.0
        (_, _, t_aud), (_, _, j_aud) = runs
        strip = lambda rows: [{k: v for k, v in r.items()  # noqa: E731
                               if k not in ("decided_at", "joined_at")} for r in rows]
        assert strip(t_aud.recent()) == strip(j_aud.recent())
        assert t_aud.snapshot() == j_aud.snapshot()

    def test_pod_publishes_no_audit_events_with_knob_off(self):
        pool = TPool(TIndex(), TPoolConfig(concurrency=1))
        pool.start()
        link = PortChaosLink(pool, "parity-pod", MODEL)
        server = pod(True, "parity-pod", publisher=link)
        try:
            server.generate(prompt(1, 12), sampling(True, max_new_tokens=3), timeout=120)
            assert pool.drain(timeout=5.0)
        finally:
            server.shutdown()
            pool.shutdown()
        assert server.audits_published == 0 and server.slo is None


# ---------------------------------------------------------------------------
# Two-pod fleet acceptance (the port's scoring plane and router)
# ---------------------------------------------------------------------------
class TestFleetAuditAcceptance:
    def _fleet(self):
        indexer = KVCacheIndexer(
            KVCacheIndexerConfig(token_processor=TokenProcessorConfig(block_size=PS))
        )
        fh = FleetHealth(FleetHealthConfig())
        now = [time.time()]
        tracker = t_audit.StalenessTracker(clock=lambda: now[0])
        auditor = t_audit.RouteAuditor(index=indexer.kv_block_index, fleet_health=fh,
                                       model_name=MODEL)
        pool = TPool(indexer.kv_block_index, TPoolConfig(concurrency=2), health=fh,
                     staleness=tracker, audit=auditor)
        pool.start()
        pods, links = {}, {}
        for name in ("pod-a", "pod-b"):
            links[name] = PortChaosLink(pool, name, MODEL)
            pods[name] = pod(True, name, publisher=links[name], obs_audit=True)
        router = BlendedRouter(
            score_fn=lambda toks, names: indexer.score_tokens(toks, MODEL, names),
            affinity=PrefixAffinityTracker(
                2, 64, token_processor=ChunkedTokenDatabase(TokenProcessorConfig(block_size=PS))
            ),
            loads_fn=lambda names: [pods[n].queue_depth for n in names],
            auditor=auditor,
        )
        return indexer, pool, pods, links, router, auditor, tracker

    def _close(self, indexer, pool, pods):
        for p in pods.values():
            p.shutdown()
        pool.shutdown()
        indexer.shutdown()

    def test_warm_route_predicted_equals_realized(self):
        indexer, pool, pods, links, router, auditor, tracker = self._fleet()
        prefix = prompt(40, 16)
        try:
            pods["pod-a"].generate(prefix + prompt(41, 4), sampling(True, max_new_tokens=2),
                                   timeout=120)
            assert pool.drain(timeout=10.0)
            p = prefix + prompt(42, 4)
            decision = router.route(p, ["pod-a", "pod-b"], request_id="acc-1")
            assert decision.pod == "pod-a" and decision.index_score == len(prefix) // PS
            seq = pods["pod-a"].submit(p, sampling(True, max_new_tokens=2),
                                       request_id="acc-1").result(timeout=120)
            assert seq.num_cached_prompt == len(prefix)
            assert pool.drain(timeout=10.0)
        finally:
            self._close(indexer, pool, pods)
        (row,) = auditor.recent(request_id="acc-1")
        assert row["predicted_blocks"] == row["realized_blocks"] == len(prefix) // PS
        assert row["ratio"] == 1.0 and row["cause"] is None
        assert tracker.snapshot()["events_observed"] > 0

    def test_forced_eviction_after_scoring_attributes_stale_index(self):
        indexer, pool, pods, links, router, auditor, tracker = self._fleet()
        prefix = prompt(50, 16)
        p = prefix + prompt(51, 4)
        try:
            pods["pod-a"].generate(prefix + prompt(52, 4), sampling(True, max_new_tokens=2),
                                   timeout=120)
            assert pool.drain(timeout=10.0)
            decision = router.route(p, ["pod-a", "pod-b"], request_id="evict-1")
            assert decision.pod == "pod-a" and decision.index_score > 0
            hashes = indexer.token_processor.prefix_hashes(p)
            links["pod-a"].publish([BlockRemoved(block_hashes=list(hashes))])
            assert pool.drain(timeout=10.0)
            links["pod-a"].publish([RequestAudit(request_id="evict-1", realized_blocks=0)])
            assert pool.drain(timeout=10.0)
        finally:
            self._close(indexer, pool, pods)
        (row,) = auditor.recent(request_id="evict-1")
        assert row["cause"] == "stale_index"
        assert auditor.snapshot()["miss_causes"]["stale_index"] == 1


# ---------------------------------------------------------------------------
# Pull histograms and spans
# ---------------------------------------------------------------------------
MODS = {"torch": tserve, "jax": jserve}


def test_pull_histogram_outcomes_equal():
    out = []
    for mod in MODS.values():
        m = mod._ServingMetrics(obs=True)
        m.observe_pull(0.1, "ok")
        m.observe_pull(0.2, "failed")
        text = m.exposition().decode()
        assert 'kvcache_transfer_pull_seconds_count{outcome="ok"} 1.0' in text
        assert 'kvcache_transfer_pull_seconds_count{outcome="failed"} 1.0' in text
        out.append(_series(text, "kvcache_transfer_pull_seconds"))
    assert out[0] == out[1]


def test_pull_overlap_histogram_kinds_equal():
    out = []
    for mod in MODS.values():
        m = mod._ServingMetrics(obs=True)
        m.observe_pull_overlap(0.4, 0.1)
        text = m.exposition().decode()
        assert 'kvcache_transfer_pull_overlap_seconds_count{kind="hidden"} 1.0' in text
        assert 'kvcache_transfer_pull_overlap_seconds_sum{kind="hidden"} 0.4' in text
        out.append(_series(text, "kvcache_transfer_pull_overlap_seconds"))
    assert out[0] == out[1]


def test_deadline_exhausted_pull_is_skipped_not_empty():
    out = []
    for side in SIDES:
        server = pod(side, "pull-pod", obs_metrics=True)
        try:
            n = server.pull_prefix(prompt(9, 8), "tcp://127.0.0.1:1",
                                   deadline=time.monotonic() - 1.0)
            assert n == 0
            text = server.metrics.exposition().decode()
        finally:
            server.shutdown()
        assert 'kvcache_transfer_pull_seconds_count{outcome="skipped"} 1.0' in text
        assert 'outcome="empty"' not in text
        out.append([ln for ln in _series(text, "kvcache_transfer_pull_seconds")
                    if "_count" in ln or "_bucket" in ln and "+Inf" in ln])
    assert out[0] == out[1]


def _span_links(tracer, trace_id):
    (trace,) = tracer.traces(trace_id=trace_id)
    by_id = {s["span_id"]: s["name"] for s in trace["spans"]}
    return sorted((s["name"], by_id.get(s["parent_span_id"], s["parent_span_id"]))
                  for s in trace["spans"])


def test_blocking_pull_span_joins_the_callers_trace():
    """``pull_prefix(trace_ctx=...)``: the puller records a
    ``pod.pull_prefix`` child of the caller's span, and the exporting
    peer's ``transfer.export`` span joins the same trace."""
    trace_id, parent_id = "ab" * 16, "cd" * 8
    ep = f"tcp://127.0.0.1:{free_tcp_port()}"
    donor = pod(True, "pull-donor", transfer_endpoint=ep, obs_tracing=True)
    p = prompt(60, 16)
    try:
        donor.generate(p, sampling(True, max_new_tokens=1), timeout=120)
        links = []
        for side in SIDES:
            ctx = (t_tracing if side else j_tracing).SpanContext(trace_id, parent_id)
            puller = pod(side, "pull-pod", obs_tracing=True, obs_metrics=True)
            try:
                assert puller.pull_prefix(p, ep, trace_ctx=ctx) == 4
                links.append(_span_links(puller.tracer, trace_id))
                text = puller.metrics.exposition().decode()
                assert 'kvcache_transfer_pull_seconds_count{outcome="ok"} 1.0' in text
            finally:
                puller.shutdown()
        assert wait_until(lambda: donor.tracer.traces(trace_id=trace_id))
        donor_names = {s["name"] for t in donor.tracer.traces(trace_id=trace_id)
                       for s in t["spans"]}
    finally:
        donor.shutdown()
    assert links[0] == links[1] == [("pod.pull_prefix", parent_id)]
    assert "transfer.export" in donor_names


def test_async_pull_request_trace_holds_pull_span():
    """A request with ``X-Pull-Source`` under ``ASYNC_PULL``: its trace
    holds an async ``pod.pull_prefix`` child of ``pod.request``, on both
    pods pulling from one donor, and the overlap histogram saw it."""
    ep = f"tcp://127.0.0.1:{free_tcp_port()}"
    donor = pod(True, "apull-donor", transfer_endpoint=ep)
    prefix = prompt(61, 16)
    try:
        donor.generate(prefix + prompt(62, 4), sampling(True, max_new_tokens=1), timeout=120)
        trees = []
        for side in SIDES:
            puller = pod(side, "apull-pod", async_pull=True, obs_tracing=True, obs_metrics=True)

            async def scenario(c):
                resp = await c.post("/v1/completions", headers={"X-Pull-Source": ep},
                                    json={"prompt_token_ids": prefix + prompt(63, 4),
                                          "max_tokens": 2})
                assert resp.status == 200
                body = await resp.json()
                trace_id = resp.headers["traceparent"].split("-")[1]
                text = await (await c.get("/metrics")).text()
                return body, trace_id, text

            body, trace_id, text = _serve(puller, scenario)
            assert body["usage"]["cached_prompt_tokens"] == 16
            links = _span_links(puller.tracer, trace_id)
            (trace,) = puller.tracer.traces(trace_id=trace_id)
            span = next(s for s in trace["spans"] if s["name"] == "pod.pull_prefix")
            assert span["attrs"]["async"] is True and span["attrs"]["outcome"] == "ok"
            assert span["attrs"]["imported_blocks"] == 4
            assert 'kvcache_transfer_pull_overlap_seconds_count{kind="hidden"} 1.0' in text
            trees.append((links, sorted(span["attrs"])))
    finally:
        donor.shutdown()
    assert trees[0] == trees[1]
    assert ("pod.pull_prefix", "pod.request") in trees[0][0]


# ---------------------------------------------------------------------------
# Trace exemplars (OBS_EXEMPLARS)
# ---------------------------------------------------------------------------
class TestExemplars:
    def test_tail_ttft_bucket_exemplar_resolves_in_debug_traces(self):
        server = pod(True, "exm-pod", obs_tracing=True, obs_metrics=True, obs_exemplars=True)

        async def scenario(c):
            resp = await c.post("/v1/completions",
                                json={"prompt_token_ids": prompt(3, 12), "max_tokens": 3})
            assert resp.status == 200
            resp = await c.get("/metrics")
            assert resp.status == 200
            ctype = resp.headers["Content-Type"]
            text = (await resp.read()).decode()
            match = _EXEMPLAR_RE.search(text)
            assert match, "no exemplar on any ttft bucket"
            tid = match.group(1)
            data = await (await c.get(f"/debug/traces?trace_id={tid}")).json()
            return ctype, tid, data

        ctype, tid, data = _serve(server, scenario)
        assert ctype == jserve._ServingMetrics(exemplars=True).exposition_content_type()
        assert ctype.startswith("application/openmetrics-text")
        (trace,) = data["traces"]
        assert trace["trace_id"] == tid
        assert any(s["name"] == "pod.request" for s in trace["spans"])

    def test_knob_off_keeps_classic_exposition(self):
        server = pod(True, "exm-off", obs_metrics=True)

        async def scenario(c):
            resp = await c.post("/v1/completions",
                                json={"prompt_token_ids": prompt(4, 12), "max_tokens": 3})
            assert resp.status == 200
            resp = await c.get("/metrics")
            return resp.headers["Content-Type"], (await resp.read()).decode()

        ctype, body = _serve(server, scenario)
        assert ctype.startswith("text/plain")
        assert "kvcache_request_ttft_seconds_bucket" in body
        assert "trace_id=" not in body

    @pytest.mark.parametrize("pkg", list(MODS))
    def test_serving_metrics_pull_exemplar_unit(self, pkg):
        pytest.importorskip("prometheus_client")
        from prometheus_client.openmetrics import exposition as om

        m = MODS[pkg]._ServingMetrics(obs=True, exemplars=True)
        m.observe_pull(0.02, "ok", trace_id="ab" * 16)
        assert 'trace_id="' + "ab" * 16 + '"' in om.generate_latest(m.registry).decode()
        m2 = MODS[pkg]._ServingMetrics(obs=True, exemplars=True)
        m2.observe_pull(0.02, "ok")
        assert "trace_id=" not in om.generate_latest(m2.registry).decode()

    def test_exemplar_exposition_families_equal(self):
        t = tserve._ServingMetrics(obs=True, exemplars=True)
        j = jserve._ServingMetrics(obs=True, exemplars=True)
        assert t.exposition_content_type() == j.exposition_content_type()
        fams = [sorted(ln for ln in m.exposition().decode().splitlines()
                       if ln.startswith("# TYPE")) for m in (t, j)]
        assert fams[0] == fams[1]
