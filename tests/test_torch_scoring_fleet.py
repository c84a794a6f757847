"""The port's scoring service routing a fleet of pods, on the CPU.

- A torch pod and a JAX pod publish over real ZMQ into the port's scoring
  service (its indexer, events pool and HTTP handlers). A prompt the torch
  pod served scores highest on the torch pod, and re-sending it there is a
  prefix hit: the scenario of
  ``test_torch_serve.py::test_jax_indexer_routes_repeat_to_torch_pod_in_mixed_fleet``
  with the port's scorer in place of the JAX package's.
- Eviction: a torch pod whose pool holds two prompts serves four. The
  scores of the first two equal the blocks its block manager still holds,
  counted as consecutive blocks from the first (``BlockRemoved`` end to end).
- In a process where ``jax`` cannot be imported, the port's ``server.api``
  imports, scores over ZMQ and HTTP, and leaves CUDA uninitialised.
"""

from __future__ import annotations

import asyncio
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
from aiohttp.test_utils import TestClient, TestServer

import torch_scoring as ts
from llm_d_kv_cache_manager_tpu.models import TINY_LLAMA as J_TINY
from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA, params_from_jax
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig,
    Engine,
    EngineConfig,
    SamplingParams,
    SchedulerConfig,
)
from llm_d_kv_cache_manager_tpu_torch.server.api import ScoringService, ServiceConfig
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServer, PodServerConfig

ROOT = Path(__file__).resolve().parent.parent
PS = 4
MODEL = "tiny-llama"


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, TINY_LLAMA.vocab_size, n)]


def _engine_config(total_pages=64):
    return EngineConfig(
        model=TINY_LLAMA,
        block_manager=BlockManagerConfig(total_pages=total_pages, page_size=PS),
        scheduler=SchedulerConfig(max_prefill_batch=4),
        max_model_len=64,
        decode_batch_size=4,
        prefill_bucket=8,
    )


def _scorer():
    port = ts.free_port()
    svc = ScoringService(
        ServiceConfig(block_size=PS, zmq_endpoint=f"tcp://127.0.0.1:{port}"),
        tokenizer=ts.PortCharTokenizer(),
    )
    return svc, f"tcp://127.0.0.1:{port}"


def _score(svc, prompts):
    """``/score_completions`` of each token list, over HTTP."""

    async def run():
        client = TestClient(TestServer(svc.build_app()))
        await client.start_server()
        try:
            out = []
            for tokens in prompts:
                resp = await client.post(
                    "/score_completions", json={"prompt": ts.text(tokens), "model": MODEL}
                )
                assert resp.status == 200
                out.append((await resp.json())["scores"])
            return out
        finally:
            await client.close()

    return asyncio.run(run())


def _landed(svc, n_blocks):
    ts.wait_for(
        lambda: svc.events_pool.drain(5.0)
        and svc.indexer.kv_block_index.size_info()["blocks"] == n_blocks,
        what=f"{n_blocks} blocks in the index",
    )


def test_port_scorer_routes_repeat_to_torch_pod_in_mixed_fleet():
    from llm_d_kv_cache_manager_tpu.server import (
        BlockManagerConfig as JBM,
        EngineConfig as JEC,
        SamplingParams as JSP,
        SchedulerConfig as JSC,
    )
    from llm_d_kv_cache_manager_tpu.server.engine import Engine as JEngine
    from llm_d_kv_cache_manager_tpu.server.serve import PodServer as JPodServer
    from llm_d_kv_cache_manager_tpu.server.serve import PodServerConfig as JPodServerConfig

    svc, endpoint = _scorer()
    jp = jl.init_params(jax.random.PRNGKey(0), J_TINY)
    tpod = PodServer(
        PodServerConfig(model_name=MODEL, pod_identifier="gpu-pod", zmq_endpoint=endpoint),
        engine=Engine(
            _engine_config(),
            params=params_from_jax(jax.tree.map(np.asarray, jp), TINY_LLAMA, "cpu"),
            device="cpu",
        ),
    )
    jengine = JEngine(
        JEC(model=J_TINY, block_manager=JBM(total_pages=64, page_size=PS),
            scheduler=JSC(max_prefill_batch=4), max_model_len=64, decode_batch_size=4,
            prefill_bucket=8, interpret=True),
        params=jp,
    )
    jpod = JPodServer(
        JPodServerConfig(model_name=MODEL, pod_identifier="tpu-pod", zmq_endpoint=endpoint),
        engine=jengine,
    )
    a, b = _prompt(20, 20), _prompt(21, 20)
    svc.start()
    tpod.start()
    jpod.start()
    try:
        ts.join([(tpod._publisher, svc)], "gpu-pod")
        ts.join([(jpod._publisher, svc)], "tpu-pod")
        first = tpod.generate(a, SamplingParams(max_new_tokens=3), timeout=120)
        jpod.generate(b, JSP(max_new_tokens=3), timeout=120)
        _landed(svc, 2 * (len(a) // PS))
        repeat_prompt = a + [1, 2, 3]
        cold_b, scores = _score(svc, [b, repeat_prompt])
        assert cold_b == {"tpu-pod": len(b) // PS}
        assert scores == {"gpu-pod": len(a) // PS}
        target = {"gpu-pod": tpod, "tpu-pod": jpod}[max(scores, key=scores.get)]
        repeat = target.generate(repeat_prompt, SamplingParams(max_new_tokens=3), timeout=120)
        assert repeat.num_cached_prompt == len(a)
        assert first.num_cached_prompt == 0
    finally:
        jpod.shutdown()
        tpod.shutdown()
        svc.shutdown()


def test_scores_follow_evictions_on_the_pod():
    """12 pages of 4 tokens: two 20-token prompts (5 pages each, and one
    page for their decode) fit, four do not. After all four, the first
    two score exactly the consecutive blocks the pod still holds."""
    svc, endpoint = _scorer()
    pod = PodServer(
        PodServerConfig(model_name=MODEL, pod_identifier="gpu-pod", zmq_endpoint=endpoint),
        engine=Engine(_engine_config(total_pages=12), device="cpu"),
    )
    prompts = [_prompt(30 + i, 20) for i in range(4)]
    svc.start()
    pod.start()
    try:
        ts.join([(pod._publisher, svc)], "gpu-pod")
        for p in prompts:
            pod.generate(p, SamplingParams(max_new_tokens=2), timeout=120)
        bm = pod.engine.block_manager
        held = [len(bm.lookup_chain(bm.token_db.prefix_hashes(p))) for p in prompts]
        _landed(svc, bm.num_cached_pages)
        scores = _score(svc, prompts)
        assert [s.get("gpu-pod", 0) for s in scores] == held
        assert held[0] < len(prompts[0]) // PS  # something was evicted
        assert held[-1] == len(prompts[-1]) // PS
    finally:
        pod.shutdown()
        svc.shutdown()


def test_scoring_service_needs_no_jax_and_no_card():
    script = textwrap.dedent(
        """
        import asyncio, sys, time
        sys.modules["jax"] = None
        from aiohttp.test_utils import TestClient, TestServer
        import torch
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import (
            BlockStored, ZMQPublisher, ZMQPublisherConfig)
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import ChunkedTokenDatabase, TokenProcessorConfig
        from llm_d_kv_cache_manager_tpu_torch.server.api import ScoringService, ServiceConfig
        from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizer import Tokenizer

        class Chars(Tokenizer):
            def encode(self, prompt, model_name):
                return [ord(c) for c in prompt], [(i, i + 1) for i in range(len(prompt))]

        port = int(sys.argv[1])
        svc = ScoringService(ServiceConfig(block_size=4, zmq_endpoint=f"tcp://127.0.0.1:{port}"),
                             tokenizer=Chars())
        svc.start()
        pub = ZMQPublisher(ZMQPublisherConfig(endpoint=f"tcp://127.0.0.1:{port}",
                                              pod_identifier="pod-a", model_name="m"))
        try:
            prompt = "sixteen tokens!!"
            hashes = ChunkedTokenDatabase(TokenProcessorConfig(block_size=4)).prefix_hashes(
                [ord(c) for c in prompt])
            deadline = time.monotonic() + 10
            while svc.indexer.kv_block_index.size_info()["blocks"] < 4:
                assert time.monotonic() < deadline
                pub.publish([BlockStored(block_hashes=hashes, block_size=4)])
                time.sleep(0.05)

            async def score():
                client = TestClient(TestServer(svc.build_app()))
                await client.start_server()
                try:
                    resp = await client.post("/score_completions",
                                             json={"prompt": prompt + "tail", "model": "m"})
                    return (await resp.json())["scores"]
                finally:
                    await client.close()

            scores = asyncio.run(score())
        finally:
            pub.close()
            svc.shutdown()
        assert scores == {"pod-a": 4}, scores
        assert type(svc.indexer.kv_block_index.inner).__name__ == "NativeMemoryIndex"
        assert not torch.cuda.is_initialized()
        leaked = [m for m in sys.modules
                  if m == "llm_d_kv_cache_manager_tpu" or m.startswith("llm_d_kv_cache_manager_tpu.")]
        assert not leaked, leaked
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script, str(ts.free_port())],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
