"""The port's ``PodServer`` (CPU engine): the HTTP completions surface, the
engine loop, and the KV-event stream feeding the JAX package's indexer —
which must route a repeated prompt to the torch pod as a prefix hit, in a
fleet that also holds a JAX pod.
"""

import asyncio
import threading
import time

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from llm_d_kv_cache_manager_tpu.models import TINY_LLAMA as J_TINY
from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import BlockStored, EventBatch
from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA, params_from_jax
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig,
    Engine,
    EngineConfig,
    SamplingParams,
    SchedulerConfig,
)
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServer, PodServerConfig, _resolve_model

PS = 4
MODEL = "tiny-llama"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FakePublisher:
    """Collects published batches; mimics ZMQPublisher's surface."""

    def __init__(self):
        self.batches: list[EventBatch] = []
        self._mu = threading.Lock()

    def publish(self, events, ts=None):
        with self._mu:
            self.batches.append(EventBatch(ts=ts or time.time(), events=list(events)))
            return len(self.batches) - 1

    def close(self):
        pass


def _engine_config():
    return EngineConfig(
        model=TINY_LLAMA,
        block_manager=BlockManagerConfig(total_pages=64, page_size=PS),
        scheduler=SchedulerConfig(max_prefill_batch=4),
        max_model_len=64,
        decode_batch_size=4,
        prefill_bucket=8,
    )


def _server(pod="gpu-pod-test"):
    cfg = PodServerConfig(model_name=MODEL, pod_identifier=pod, publish_events=False,
                          engine=_engine_config())
    pub = FakePublisher()
    return PodServer(cfg, publisher=pub, device="cpu"), pub


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, TINY_LLAMA.vocab_size, n)]


def test_generate_matches_direct_engine():
    prompt = _prompt(0, 10)
    direct = Engine(_engine_config(), device="cpu")
    ref = direct.add_request(prompt, SamplingParams(max_new_tokens=6))
    direct.run_until_complete()
    server, _ = _server()
    server.start()
    try:
        futs = [server.submit(_prompt(i, 8 + i), SamplingParams(max_new_tokens=3)) for i in range(1, 6)]
        seq = server.generate(prompt, SamplingParams(max_new_tokens=6), timeout=120)
        assert seq.output_tokens == ref.output_tokens
        assert all(len(f.result(timeout=120).output_tokens) == 3 for f in futs)
    finally:
        server.shutdown()


def test_completions_roundtrip_and_healthz():
    server, pub = _server()
    server.start()

    async def scenario():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            resp = await client.get("/healthz")
            assert resp.status == 200 and (await resp.json())["status"] == "ok"
            prompt = _prompt(3, 10)
            resp = await client.post(
                "/v1/completions", json={"prompt_token_ids": prompt, "max_tokens": 4}
            )
            assert resp.status == 200
            data = await resp.json()
            assert data["object"] == "text_completion" and data["model"] == MODEL
            choice = data["choices"][0]
            assert len(choice["token_ids"]) == 4 and choice["finish_reason"] == "length"
            assert data["usage"] == {"prompt_tokens": 10, "completion_tokens": 4,
                                     "cached_prompt_tokens": 0}
            assert data["ttft_s"] is not None
            # Stop on the greedy continuation's second token.
            resp = await client.post(
                "/v1/completions",
                json={"prompt_token_ids": prompt, "max_tokens": 8,
                      "stop_token_ids": [choice["token_ids"][1]]},
            )
            data = await resp.json()
            assert data["choices"][0]["token_ids"] == choice["token_ids"][:2]
            assert data["choices"][0]["finish_reason"] == "stop"
            assert data["usage"]["cached_prompt_tokens"] == 8
            for bad in ({"prompt_token_ids": []}, {"max_tokens": 3},
                        {"prompt_token_ids": [1, 2], "max_tokens": "x"}):
                assert (await client.post("/v1/completions", json=bad)).status == 400
        finally:
            await client.close()

    try:
        asyncio.run(scenario())
    finally:
        server.shutdown()
    assert any(isinstance(e, BlockStored) for b in pub.batches for e in b.events)


def test_shutdown_fails_outstanding_and_rejects_submits():
    server, _ = _server()
    server.start()
    fut = server.submit(_prompt(4, 9), SamplingParams(max_new_tokens=40))
    server.shutdown()
    # Resolved either way: finished before the shutdown, or failed by it.
    assert fut.done()
    assert fut.exception() is None or isinstance(fut.exception(), RuntimeError)
    with pytest.raises(RuntimeError, match="not running"):
        server.submit(_prompt(4, 9))


def test_resolve_model_presets():
    from llm_d_kv_cache_manager_tpu_torch import models

    assert _resolve_model("tiny-llama") is TINY_LLAMA
    assert _resolve_model("meta-llama/Llama-3.1-8B-Instruct").n_layers == 32
    assert _resolve_model("tiny-moe") is models.TINY_MOE
    assert _resolve_model("tiny-qwen3-moe") is models.TINY_QWEN3_MOE
    a3b = _resolve_model("Qwen/Qwen3-30B-A3B")
    assert a3b is models.QWEN3_30B_A3B
    assert (a3b.n_layers, a3b.hidden_size, a3b.n_heads, a3b.n_kv_heads, a3b.hd) == (48, 2048, 32, 4, 128)
    assert (a3b.n_experts, a3b.n_experts_per_tok, a3b.moe_inter, a3b.vocab_size) == (128, 8, 768, 151_936)
    assert a3b.qk_norm and a3b.norm_topk_prob and a3b.moe_gmm == "auto"
    with pytest.raises(SystemExit):
        _resolve_model("unknown/model")


def test_quantize_env_reaches_engine_of_moe_pod(monkeypatch):
    """``MODEL_NAME``/``QUANTIZE`` from the environment: the pod serves the
    tiny Qwen3-MoE preset with int8 weights (experts stay full precision —
    the JAX pod has no knob for them either), and its greedy tokens equal a
    directly built engine's."""
    from llm_d_kv_cache_manager_tpu_torch.models import QuantizedTensor

    monkeypatch.setenv("MODEL_NAME", "tiny-qwen3-moe")
    monkeypatch.setenv("QUANTIZE", "int8")
    monkeypatch.setenv("TOTAL_PAGES", "64")
    monkeypatch.setenv("BLOCK_SIZE", str(PS))
    monkeypatch.setenv("PUBLISH_EVENTS", "0")
    cfg = PodServerConfig.from_env()
    assert cfg.engine.quantize == "int8" and not cfg.engine.quantize_experts
    cfg.engine.model = _resolve_model(cfg.model_name)
    server = PodServer(cfg, device="cpu")
    layer = server.engine.params["layers"][0]
    assert isinstance(layer["wq"], QuantizedTensor) and not isinstance(layer["w_gate"], QuantizedTensor)
    direct = Engine(cfg.engine, device="cpu")
    prompt = _prompt(9, 11)
    ref = direct.add_request(prompt, SamplingParams(max_new_tokens=4))
    direct.run_until_complete()
    server.start()
    try:
        seq = server.generate(prompt, SamplingParams(max_new_tokens=4), timeout=120)
    finally:
        server.shutdown()
    assert seq.output_tokens == ref.output_tokens and len(seq.generated_tokens) == 4
    monkeypatch.setenv("QUANTIZE", "")
    assert PodServerConfig.from_env().engine.quantize is None


def test_jax_indexer_routes_repeat_to_torch_pod_in_mixed_fleet():
    """One torch pod and one JAX pod publish into the JAX package's
    ingestion pool and indexer. A prompt the torch pod served scores
    highest on the torch pod, and re-sending it there is a prefix hit."""
    from llm_d_kv_cache_manager_tpu.kvcache import KVCacheIndexer, KVCacheIndexerConfig
    from llm_d_kv_cache_manager_tpu.kvcache.kvblock import TokenProcessorConfig
    from llm_d_kv_cache_manager_tpu.kvcache.kvevents import KVEventsPool, Message
    from llm_d_kv_cache_manager_tpu.server import (
        BlockManagerConfig as JBM, EngineConfig as JEC, SamplingParams as JSP,
        SchedulerConfig as JSC,
    )
    from llm_d_kv_cache_manager_tpu.server.engine import Engine as JEngine
    from llm_d_kv_cache_manager_tpu.server.serve import PodServer as JPodServer
    from llm_d_kv_cache_manager_tpu.server.serve import PodServerConfig as JPodServerConfig

    jp = jl.init_params(jax.random.PRNGKey(0), J_TINY)
    tpod_engine = Engine(_engine_config(), params=params_from_jax(
        jax.tree.map(np.asarray, jp), TINY_LLAMA, "cpu"), device="cpu")
    tpod = PodServer(PodServerConfig(model_name=MODEL, pod_identifier="gpu-pod",
                                     publish_events=False),
                     engine=tpod_engine, publisher=FakePublisher())
    jpub = FakePublisher()
    jengine = JEngine(JEC(model=J_TINY, block_manager=JBM(total_pages=64, page_size=PS),
                          scheduler=JSC(max_prefill_batch=4), max_model_len=64,
                          decode_batch_size=4, prefill_bucket=8, interpret=True), params=jp)
    jpod = JPodServer(JPodServerConfig(model_name=MODEL, pod_identifier="tpu-pod",
                                       publish_events=False),
                      engine=jengine, publisher=jpub)
    ix = KVCacheIndexer(KVCacheIndexerConfig(token_processor=TokenProcessorConfig(block_size=PS)))
    pool = KVEventsPool(ix.kv_block_index)
    pool.start()
    a, b = _prompt(20, 20), _prompt(21, 20)
    tpod.start()
    jpod.start()
    try:
        first = tpod.generate(a, SamplingParams(max_new_tokens=3), timeout=120)
        jpod.generate(b, JSP(max_new_tokens=3), timeout=120)
        for pod, pub in (("gpu-pod", tpod._publisher), ("tpu-pod", jpub)):
            for batch in pub.batches:
                pool.add_task(Message(topic=f"kv@{pod}@{MODEL}", pod_identifier=pod,
                                      model_name=MODEL, payload=batch.to_payload()))
        assert pool.drain()
        assert ix.score_tokens(b, MODEL) == {"tpu-pod": len(b) // PS}
        repeat_prompt = a + [1, 2, 3]
        scores = ix.score_tokens(repeat_prompt, MODEL)
        assert scores == {"gpu-pod": len(a) // PS}
        target = {"gpu-pod": tpod}[max(scores, key=scores.get)]
        repeat = target.generate(repeat_prompt, SamplingParams(max_new_tokens=3), timeout=120)
        assert repeat.num_cached_prompt == len(a)
        assert first.num_cached_prompt == 0
    finally:
        pool.shutdown()
        tpod.shutdown()
        jpod.shutdown()


def _deadline_pod(framework):
    """A pod of either framework on TINY_LLAMA (JAX in interpret mode, the
    port on the CPU) with the JAX deadline test's shape: 256 pages of 4,
    max_model_len 512."""
    if framework == "jax":
        from llm_d_kv_cache_manager_tpu.server import (
            BlockManagerConfig as JBM,
            EngineConfig as JEC,
            SchedulerConfig as JSC,
        )
        from llm_d_kv_cache_manager_tpu.server.serve import (
            PodServer as JPodServer,
            PodServerConfig as JPodServerConfig,
        )

        eng = JEC(model=J_TINY, block_manager=JBM(total_pages=256, page_size=PS),
                  scheduler=JSC(max_prefill_batch=4), max_model_len=512, decode_batch_size=4,
                  prefill_bucket=8, interpret=True)
        return JPodServer(JPodServerConfig(model_name=MODEL, pod_identifier="jax-deadline",
                                           publish_events=False, engine=eng))
    eng = EngineConfig(model=TINY_LLAMA, block_manager=BlockManagerConfig(total_pages=256, page_size=PS),
                       scheduler=SchedulerConfig(max_prefill_batch=4), max_model_len=512,
                       decode_batch_size=4, prefill_bucket=8)
    return PodServer(PodServerConfig(model_name=MODEL, pod_identifier="torch-deadline",
                                     publish_events=False, engine=eng), device="cpu")


def _deadline_answers(server):
    """The scenario of ``tests/test_overload.py::TestDeadlines::
    test_http_deadline_header``: (status, finish_reason, tokens) for a
    10,000-token ask under ``X-Request-Deadline: 0.4``, then the status of a
    2-token ask under each invalid header value."""
    server.start()

    async def scenario():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            resp = await client.post(
                "/v1/completions",
                json={"prompt_token_ids": _prompt(8, 8), "max_tokens": 10_000},
                headers={"X-Request-Deadline": "0.4"},
            )
            data = await resp.json()
            answers = {"0.4": (resp.status, data["choices"][0]["finish_reason"],
                               len(data["choices"][0]["token_ids"]))}
            for bad in ("bogus", "nan", "inf", "-1", "0"):
                resp = await client.post(
                    "/v1/completions",
                    json={"prompt_token_ids": _prompt(8, 8), "max_tokens": 2},
                    headers={"X-Request-Deadline": bad},
                )
                answers[bad] = (resp.status, (await resp.json()).get("error"))
            return answers
        finally:
            await client.close()

    try:
        return asyncio.run(scenario())
    finally:
        server.shutdown()


def test_http_deadline_header_matches_jax_pod():
    """Both pods read ``X-Request-Deadline`` alike: a 200 that finishes with
    ``"deadline"`` and fewer tokens than asked, and a 400 (with the same
    message) for a value that is not finite or not above 0."""
    jax_answers = _deadline_answers(_deadline_pod("jax"))
    torch_answers = _deadline_answers(_deadline_pod("torch"))
    for answers in (jax_answers, torch_answers):
        status, reason, n = answers["0.4"]
        assert status == 200 and reason == "deadline" and 0 < n < 10_000
    assert {h: a[:2] for h, a in torch_answers.items()} == {h: a[:2] for h, a in jax_answers.items()}
    assert all(torch_answers[bad][0] == 400 for bad in ("bogus", "nan", "inf", "-1", "0"))


def test_default_deadline_applies_without_header():
    """``PodServerConfig.default_deadline_s`` bounds a request that sends no
    header, as in the JAX pod (``submit`` falls back to it)."""
    pod = _deadline_pod("torch")
    pod.config.default_deadline_s = 0.4
    pod.start()
    try:
        seq = pod.generate(_prompt(7, 8), SamplingParams(max_new_tokens=10_000), timeout=120)
    finally:
        pod.shutdown()
    assert seq.finish_reason == "deadline" and 0 < seq.num_generated < 10_000


def test_from_env_reads_deadline_and_decode_fast_path(monkeypatch):
    """``REQUEST_DEADLINE_S`` and the three ``DECODE_*`` variables, with the
    JAX pod's defaults and parsing, on both pods."""
    from llm_d_kv_cache_manager_tpu.server.serve import PodServerConfig as JPodServerConfig

    for name in ("REQUEST_DEADLINE_S", "DECODE_STEPS_PER_ITER", "DECODE_PIPELINE",
                 "DECODE_FUSED_SAMPLING"):
        monkeypatch.delenv(name, raising=False)

    def read(cls):
        c = cls.from_env()
        e = c.engine
        return (c.default_deadline_s, e.decode_steps_per_iter, e.decode_pipeline,
                e.decode_fused_sampling)

    assert read(PodServerConfig) == read(JPodServerConfig) == (0.0, 1, False, False)
    for fused in ("1", "yes", "anything", "off", "0", "False", ""):
        monkeypatch.setenv("REQUEST_DEADLINE_S", "2.5")
        monkeypatch.setenv("DECODE_STEPS_PER_ITER", "4")
        monkeypatch.setenv("DECODE_PIPELINE", "true")
        monkeypatch.setenv("DECODE_FUSED_SAMPLING", fused)
        assert read(PodServerConfig) == read(JPodServerConfig)
        assert read(PodServerConfig)[:3] == (2.5, 4, True)
    monkeypatch.setenv("DECODE_FUSED_SAMPLING", "on")
    assert read(PodServerConfig)[3] is True
