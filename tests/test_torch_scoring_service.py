"""The port's scoring service against the JAX package's, on the CPU.

A port pod (TINY_LLAMA on the CPU, a pool small enough to evict) serves a
few prompts; the event batches it publishes are recorded and replayed, with
their timestamps, through two of the port's ``ZMQPublisher``s over real ZMQ
into two scoring services, one of each package, built from the same
configuration and given the same char tokenizer. Both then answer the same
requests: ``/score_completions`` (warm, filtered, cold, a bad placement),
``/score_chat_completions``, ``/stats`` and every ``/debug/*`` surface.
The answers must be equal once the fields in ``VOLATILE`` are set aside:
times, ages and latencies (wall-clock readings of each run) and the random
ids of traces and spans. The process-wide counters of each package's
metrics collector (``/stats`` ``index``) are compared as increments over
the scenario.

Configurations: defaults; ``NATIVE_INDEX=0``; ``SCORER_SHARDS=4``;
``ROUTE_PREDICT`` with ``signals``; ``OBS_AUDIT`` with ``OBS_METRICS``;
``OBS_LIFECYCLE``; ``OBS_TRACING``; ``OBS_FED`` with in-process hooks;
``POD_TTL_S`` with a sweep.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import torch_scoring as ts
from llm_d_kv_cache_manager_tpu.kvcache.metrics import collector as jax_collector
from llm_d_kv_cache_manager_tpu.server import api as jax_api
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import (
    RequestAudit,
    ZMQPublisher,
    ZMQPublisherConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.metrics import collector as port_collector
from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig,
    Engine,
    EngineConfig,
    SamplingParams,
    SchedulerConfig,
)
from llm_d_kv_cache_manager_tpu_torch.server import api as port_api

PS = 4
MODEL = "tiny-llama"
POD = "gpu-pod"
TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|>{{ message['content'] }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>{% endif %}"
)
MESSAGES = [
    {"role": "system", "content": "be brief"},
    {"role": "user", "content": "route me to the warm pod"},
]
RENDERED = "<|system|>be brief<|user|>route me to the warm pod<|assistant|>"

#: Keys whose values are readings of each run's clock or random ids.
VOLATILE = frozenset(
    {
        # fleet health, lifecycle ledger, audit joins, federation history
        "age_s", "ts", "t", "mono", "decided_at", "joined_at",
        # staleness: publish-to-visibility lags
        "max_lag_s", "p50_lag_s", "p99_lag_s", "max_s", "sum_s",
        # federation scrape durations
        "scrape_s", "last_scrape_s",
        # trace spans
        "trace_id", "span_id", "parent_span_id", "start_unix_s", "duration_s",
    }
)

CONFIGS = {
    "defaults": {},
    "native_index_off": {"native_index": False},
    "scorer_shards_4": {"scorer_shards": 4},
    "route_predict": {"route_predict": True},
    "obs_audit_metrics": {"obs_audit": True, "obs_metrics": True},
    "obs_lifecycle": {"obs_lifecycle": True},
    "obs_tracing": {"obs_tracing": True},
    "obs_fed": {"obs_fed": True},
    "pod_ttl_sweep": {"pod_ttl_s": 2.0},
}


def serve_and_record():
    """Prompts a port pod served and the event batches it published:
    ``(prompts, [(events, ts), ...])``. 40 pages of 4 tokens hold about
    two thirds of what the prompts fill, so the later ones evict the
    earlier ones."""
    batches = []
    engine = Engine(
        EngineConfig(
            model=TINY_LLAMA,
            block_manager=BlockManagerConfig(total_pages=40, page_size=PS),
            scheduler=SchedulerConfig(max_prefill_batch=2),
            max_model_len=96,
            decode_batch_size=2,
            prefill_bucket=8,
        ),
        on_events=lambda events: batches.append((list(events), 1.7e9 + len(batches))),
        device="cpu",
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(33, 127, 24).tolist() for _ in range(5)]
    prompts.append([ord(c) for c in RENDERED])
    for prompt in prompts:
        engine.add_request(prompt, SamplingParams(max_new_tokens=2))
        engine.run_until_complete()
    return prompts, batches


@pytest.fixture(scope="module")
def pod_run():
    return serve_and_record()


def _config(api, port, **knobs):
    return api.ServiceConfig(
        block_size=PS, zmq_endpoint=f"tcp://127.0.0.1:{port}", **knobs
    )


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _fed_hook(prompts):
    stats = {
        "pod": POD,
        "model": MODEL,
        "staged": 0,
        "waiting": 0,
        "running": 0,
        "free_pages": 4,
        "total_pages": 40,
        "prefill": {"requests": len(prompts), "cached_prompt_tokens": 0},
        "transfer": {"breakers": {}},
        "drain": {"draining": False},
    }
    return lambda path: stats if path == "/stats" else None


def _requests(prompts, knobs):
    """The requests both services answer, in order: (method, path, body)."""
    suffix = [ord(c) for c in "!fresh suffix"]
    out = []
    for i, prompt in enumerate(prompts[:-1]):
        body = {"prompt": ts.text(prompt + suffix), "model": MODEL}
        if knobs.get("obs_audit"):
            body["request_id"] = f"req-{i}"
        if knobs.get("route_predict"):
            body["signals"] = [
                {"pod": POD, "queue_depth": 2, "prefill_rate": 4000.0},
                {"pod": "cold-pod", "queue_depth": 0, "prefill_rate": 8000.0},
            ]
        out.append(("POST", "/score_completions", body))
    out += [
        ("POST", "/score_completions",
         {"prompt": ts.text(prompts[0]), "model": MODEL, "pod_identifiers": ["other"]}),
        ("POST", "/score_completions",
         {"prompt": ts.text(prompts[-2]), "model": MODEL, "pod_identifiers": [POD]}),
        ("POST", "/score_completions", {"prompt": "never served here", "model": MODEL}),
        ("POST", "/score_completions",
         {"prompt": ts.text(prompts[0]), "model": MODEL, "placement": "sideways"}),
        ("POST", "/score_completions", {"model": MODEL}),
        ("POST", "/score_chat_completions",
         {"messages": MESSAGES, "model": MODEL, "chat_template": TEMPLATE}),
        ("POST", "/score_chat_completions",
         {"messages": MESSAGES, "model": MODEL, "chat_template": TEMPLATE,
          "placement": "decode"}),
        ("POST", "/debug/mrc", {"pod": POD, "mrc": {"enabled": False}}),
        ("GET", "/debug/mrc", None),
        ("GET", "/debug/traces", None),
        ("GET", "/debug/staleness", None),
        ("GET", "/debug/audit", None),
        ("GET", "/debug/lifecycle", None),
        ("GET", "/debug/fleet", None),
        ("GET", "/healthz", None),
        ("GET", "/stats", None),
    ]
    return out


async def _answers(client, requests):
    out = []
    for method, path, body in requests:
        resp = await (client.post(path, json=body) if method == "POST" else client.get(path))
        payload = await resp.json()
        if path == "/stats":
            payload.pop("index")  # compared as increments
        out.append((path, resp.status, _strip(payload), "traceparent" in resp.headers))
    return out


def _run_pair(knobs, prompts, batches):
    """Both services through the scenario; returns each one's answers and
    its collector's counter increments."""
    sides = {}
    for name, api, tok in (
        ("jax", jax_api, ts.JaxCharTokenizer()),
        ("port", port_api, ts.PortCharTokenizer()),
    ):
        port = ts.free_port()
        svc = api.ScoringService(_config(api, port, **knobs), tokenizer=tok)
        pub = ZMQPublisher(
            ZMQPublisherConfig(
                endpoint=f"tcp://127.0.0.1:{port}", pod_identifier=POD, model_name=MODEL
            )
        )
        sides[name] = (svc, pub)
    before = {"jax": jax_collector.snapshot(), "port": port_collector.snapshot()}
    for svc, _ in sides.values():
        svc.start()
    try:
        pairs = [(pub, svc) for svc, pub in sides.values()]
        ts.join(pairs, POD)
        for events, stamp in batches:
            for pub, _ in pairs:
                pub.publish(events, ts=stamp)
        if knobs.get("obs_fed"):
            for svc, _ in sides.values():
                svc.federator.register_pod(POD, fetch=_fed_hook(prompts))
        n_blocks = sum(len(e.block_hashes) for evs, _ in batches for e in evs
                       if type(e).__name__ == "BlockStored")
        n_removed = sum(len(e.block_hashes) for evs, _ in batches for e in evs
                        if type(e).__name__ == "BlockRemoved")
        for svc, _ in sides.values():
            ts.wait_for(
                lambda: svc.fleet_health.snapshot()["pods"][POD]
                and svc.events_pool.drain(5.0)
                and _index_blocks(svc) == n_blocks - n_removed,
                what="the replayed batches to land",
            )
        requests = _requests(prompts, knobs)
        answers = {name: [] for name in sides}

        async def drive():
            loop = asyncio.get_running_loop()
            clients = {name: TestClient(TestServer(svc.build_app())) for name, (svc, _) in sides.items()}
            for client in clients.values():
                await client.start_server()
            try:
                # Under POD_TTL_S the pod may be swept at any time from here,
                # so that case asks nothing before the sweep.
                first = [] if knobs.get("pod_ttl_s") else requests[:5]
                for name, client in clients.items():
                    answers[name] += await _answers(client, first)
                for svc, pub in sides.values():
                    if knobs.get("obs_audit"):
                        pub.publish([RequestAudit(request_id="req-0", realized_blocks=3)],
                                    ts=1.8e9)
                        await loop.run_in_executor(
                            None, ts.wait_for,
                            lambda: svc.route_auditor.snapshot()["joined"] == 1,
                        )
                    if knobs.get("pod_ttl_s"):
                        await loop.run_in_executor(
                            None, ts.wait_for,
                            lambda: svc.fleet_health.snapshot()["pods_swept"] == 1,
                        )
                for name, client in clients.items():
                    answers[name] += await _answers(client, requests)
            finally:
                for client in clients.values():
                    await client.close()

        asyncio.run(drive())
    finally:
        for svc, pub in sides.values():
            pub.close()
            svc.shutdown()
    after = {"jax": jax_collector.snapshot(), "port": port_collector.snapshot()}
    # Counters a package's collector gained in earlier tests of the same
    # process show as keys that did not move: only the moves are compared.
    counted = {
        name: {k: n - before[name].get(k, 0) for k, n in after[name].items()
               if n != before[name].get(k, 0)}
        for name in sides
    }
    return answers, counted


def _index_blocks(svc):
    info = svc._refresh_index_gauges()
    return None if info is None else info["blocks"]


@pytest.mark.parametrize("knobs", list(CONFIGS.values()), ids=list(CONFIGS))
def test_port_service_answers_as_jax_service(knobs, pod_run):
    prompts, batches = pod_run
    answers, counted = _run_pair(knobs, prompts, batches)
    assert answers["port"] == answers["jax"]
    assert counted["port"] == counted["jax"]
    scores = [a[2].get("scores") for a in answers["port"][:5]]
    if knobs.get("pod_ttl_s"):
        assert not any(scores)  # swept: nothing scores
    else:
        assert any(s for s in scores)  # the replay routed something
        assert any(not s for s in scores)  # and the pod evicted something


@pytest.mark.parametrize(
    "env",
    [
        {},
        {"NATIVE_INDEX": "0", "SCORER_SHARDS": "4", "SCORER_SHARD_VNODES": "8"},
        {"ROUTE_PREDICT": "1", "ROUTE_PREDICT_HEARTBEAT_S": "2.5", "POD_TTL_S": "3"},
        {"OBS_AUDIT": "on", "OBS_METRICS": "yes", "OBS_LIFECYCLE": "true",
         "OBS_TRACING": "1", "OBS_FED": "1", "OBS_EXEMPLARS": "1", "BLOCK_SIZE": "32"},
    ],
    ids=["unset", "index", "routing", "observability"],
)
def test_from_env_matches_jax(env, monkeypatch):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jax_cfg = jax_api.ServiceConfig.from_env()
    port_cfg = port_api.ServiceConfig.from_env()
    assert vars(port_cfg) == vars(jax_cfg)
