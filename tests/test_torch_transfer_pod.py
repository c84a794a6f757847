"""The port's pod transfer plane on the CPU: the ``TRANSFER_ENDPOINT``
export service, the blocking ``pull_prefix`` and ``ASYNC_PULL``, over real
ZMQ ROUTER/DEALER sockets on 127.0.0.1 (ports from ``free_tcp_port()``).

- ``tests/test_kv_transfer.py::TestTransferOverZMQ`` and
  ``tests/test_decode_fastpath.py::TestAsyncPull`` on torch pods: a pulled
  prefix serves the tokens of a pod that computed it, and every failure
  (dead peer, stalled peer, abort mid-import, an expired deadline) falls
  back to cold prefill or a clean abort, counted as in the JAX pod.
- Mixed fleets: a torch pod pulls from a JAX pod and a JAX pod from a torch
  pod, both on the same parameters, with warm tokens equal to cold.
- ``from_env`` reads the eight transfer knobs with the JAX pod's defaults;
  with the knob off no service is built and nothing binds.
"""

import asyncio
import time

import pytest
import torch
from conftest import free_tcp_port

from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu.server import SamplingParams as JSP
from llm_d_kv_cache_manager_tpu.server.serve import PodServer as JPod
from llm_d_kv_cache_manager_tpu.server.serve import PodServerConfig as JPodConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer import (
    KVTransferClient,
    TransferClientConfig,
    TransferCostModel,
    TransferCostModelConfig,
    TransferError,
)
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams as TSP
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServer, PodServerConfig
from test_torch_engine import _params, _prompt
from test_torch_host_tier import engine_config

PS = 4
MODEL = "tiny-llama"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _endpoint() -> str:
    return f"tcp://127.0.0.1:{free_tcp_port()}"


def _pod(pod_id, torch_side=True, **cfg):
    """A pod on TINY_LLAMA's shared parameters (pages of 4, 64 pages),
    events unpublished; ``cfg``: further ``PodServerConfig`` fields."""
    params = _params("TINY_LLAMA")
    econf = engine_config(torch_side, host_tier_policy="auto")
    if torch_side:
        config = PodServerConfig(model_name=MODEL, pod_identifier=pod_id, publish_events=False,
                                 engine=econf, **cfg)
        server = PodServer(config, engine=TEngine(econf, params=params[1], device="cpu"))
    else:
        config = JPodConfig(model_name=MODEL, pod_identifier=pod_id, publish_events=False,
                            engine=econf, **cfg)
        server = JPod(config, engine=JEngine(econf, params=params[0]))
    server.start()
    return server


def _wait_until(pred, timeout):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- TestTransferOverZMQ --------------------------------------------------------
def test_pull_then_serve_warm_and_parity():
    endpoint = _endpoint()
    model = TransferCostModel(TransferCostModelConfig(block_bytes=1, block_size=PS))
    warm = _pod("warm", transfer_endpoint=endpoint)
    cold = _pod("cold")
    cold.transfer_cost_model = model
    ref = _pod("ref")
    try:
        prefix = _prompt(10, 16)
        prompt = prefix + _prompt(11, 4)
        warm.generate(prefix, TSP(max_new_tokens=2), timeout=120)
        assert cold.pull_prefix(prompt, endpoint) == len(prefix) // PS
        assert cold.transfer_pulls == 1 and cold.transfer_pull_failures == 0
        s = cold.generate(prompt, TSP(max_new_tokens=4), timeout=120)
        s_ref = ref.generate(prompt, TSP(max_new_tokens=4), timeout=120)
        assert s.output_tokens == s_ref.output_tokens
        assert s.num_cached_prompt == len(prefix)
        assert warm._transfer_service.blocks_served == len(prefix) // PS
        assert warm.engine.transfer_stats["exported_blocks"] == len(prefix) // PS
        # The pull fed the cost model its link rate, the step its prefill rate.
        assert model.transfer_rate is not None and model.prefill_rate is not None
    finally:
        warm.shutdown(), cold.shutdown(), ref.shutdown()


def test_dead_peer_falls_back_to_cold_prefill():
    cold = _pod("cold2", transfer_timeout_s=0.4)
    ref = _pod("ref2")
    try:
        prompt = _prompt(12, 12)
        assert cold.pull_prefix(prompt, _endpoint()) == 0
        assert cold.transfer_pull_failures == 1
        s = cold.generate(prompt, TSP(max_new_tokens=4), timeout=120)
        s_ref = ref.generate(prompt, TSP(max_new_tokens=4), timeout=120)
        assert s.output_tokens == s_ref.output_tokens and s.num_cached_prompt == 0
    finally:
        cold.shutdown(), ref.shutdown()


def test_open_breaker_skips_the_dead_peer():
    """With ``transfer_breaker_failures=1`` the first failed pull opens the
    peer's breaker; the next pull fails at once, without a timeout, and
    both fall back to cold prefill."""
    cold = _pod("cold4", transfer_timeout_s=0.3, transfer_breaker_failures=1,
                transfer_breaker_backoff_s=60.0)
    try:
        dead = _endpoint()
        assert cold.pull_prefix(_prompt(14, 12), dead) == 0
        t0 = time.monotonic()
        assert cold.pull_prefix(_prompt(15, 12), dead) == 0
        assert time.monotonic() - t0 < 0.25
        client = cold._transfer_pool.clients()[dead]
        assert client.breaker.state == "open" and client.breaker_skips == 1
        assert cold.transfer_pull_failures == 2
    finally:
        cold.shutdown()


def test_expired_deadline_skips_the_pull():
    cold = _pod("cold3")
    try:
        assert cold.pull_prefix(_prompt(13, 12), _endpoint(), deadline=time.monotonic() - 1) == 0
        assert cold.transfer_pulls == cold.transfer_pull_failures == 0
    finally:
        cold.shutdown()


def test_client_timeout_raises_transfer_error():
    client = KVTransferClient(TransferClientConfig(endpoint=_endpoint(), timeout_s=0.3))
    with pytest.raises(TransferError):
        client.fetch(MODEL, [1, 2, 3])
    client.close()


# -- TestAsyncPull ----------------------------------------------------------------
def test_async_pull_parity_and_warm_hit():
    endpoint = _endpoint()
    warm = _pod("ap-warm", transfer_endpoint=endpoint)
    cold = _pod("ap-cold", async_pull=True)
    ref = _pod("ap-ref")
    try:
        prefix = _prompt(20, 16)
        prompt = prefix + _prompt(21, 4)
        warm.generate(prefix, TSP(max_new_tokens=2), timeout=120)
        s = cold.submit(prompt, TSP(max_new_tokens=4), pull_source=endpoint).result(timeout=120)
        s_ref = ref.generate(prompt, TSP(max_new_tokens=4), timeout=120)
        assert s.generated_tokens == s_ref.generated_tokens
        # Admission waited for the import: the warm prefix must hit.
        assert s.num_cached_prompt == len(prefix)
        assert cold.async_pulls == 1 and cold.transfer_pulls == 1
        assert not cold._pull_jobs
    finally:
        warm.shutdown(), cold.shutdown(), ref.shutdown()


def test_async_dead_peer_falls_back_to_cold_with_parity():
    cold = _pod("ap-cold2", async_pull=True, transfer_timeout_s=0.5)
    ref = _pod("ap-ref2")
    try:
        prompt = _prompt(22, 12)
        s = cold.submit(prompt, TSP(max_new_tokens=3), pull_source=_endpoint()).result(timeout=120)
        s_ref = ref.generate(prompt, TSP(max_new_tokens=3), timeout=120)
        assert s.generated_tokens == s_ref.generated_tokens
        assert s.num_cached_prompt == 0  # cold prefill, not a failure
        assert cold.async_pull_fallbacks == 1 and cold.transfer_pull_failures == 1
    finally:
        cold.shutdown(), ref.shutdown()


def test_stalled_import_never_blocks_other_requests():
    cold = _pod("ap-cold3", async_pull=True, transfer_timeout_s=5.0)
    try:
        stalled = cold.submit(_prompt(23, 12), TSP(max_new_tokens=2), pull_source=_endpoint())
        assert _wait_until(lambda: bool(cold._pull_jobs), timeout=10)
        # A later arrival is admitted straight past the importing head.
        s = cold.submit(_prompt(24, 8), TSP(max_new_tokens=4)).result(timeout=60)
        assert len(s.generated_tokens) == 4
        assert not stalled.done()  # the import is still on the wire
        assert len(stalled.result(timeout=60).generated_tokens) == 2  # then cold
    finally:
        cold.shutdown()


def test_abort_mid_import_cancels_fetch_and_frees_pages():
    cold = _pod("ap-cold4", async_pull=True, transfer_timeout_s=2.0)
    try:
        free0 = cold.engine.block_manager.num_free
        fut = cold.submit(_prompt(25, 12), TSP(max_new_tokens=4), pull_source=_endpoint())
        assert _wait_until(lambda: bool(cold._pull_jobs), timeout=10)
        assert cold.abort(fut.request_id).result(timeout=30)
        assert fut.result(timeout=30).finish_reason == "abort"
        assert _wait_until(lambda: cold.async_pull_canceled == 1, timeout=30)
        assert cold.engine.block_manager.num_free == free0
        assert not cold._pull_jobs
    finally:
        cold.shutdown()


def test_deadline_clamps_import_and_sheds():
    cold = _pod("ap-cold5", async_pull=True, transfer_timeout_s=30.0)
    try:
        t0 = time.monotonic()
        fut = cold.submit(_prompt(26, 12), TSP(max_new_tokens=4), deadline_s=0.3,
                          pull_source=_endpoint())
        # Clamped to the request's budget, not the 30 s transfer timeout;
        # then the expired sequence is shed.
        assert fut.result(timeout=30).finish_reason == "deadline"
        assert time.monotonic() - t0 < 10.0
    finally:
        cold.shutdown()


def test_knob_off_ignores_pull_source():
    plain = _pod("ap-plain")
    try:
        fut = plain.submit(_prompt(27, 10), TSP(max_new_tokens=3), pull_source=_endpoint())
        assert len(fut.result(timeout=120).generated_tokens) == 3
        assert plain.async_pulls == 0 and plain.async_pull_fallbacks == 0
        assert plain._pull_pool is None  # nothing was ever spawned
    finally:
        plain.shutdown()


def test_http_pull_source_header_imports_the_prefix():
    """``X-Pull-Source`` on ``POST /v1/completions`` of an ASYNC_PULL pod
    imports the named peer's prefix; the response counts it cached."""
    from aiohttp.test_utils import TestClient, TestServer

    endpoint = _endpoint()
    warm = _pod("hp-warm", transfer_endpoint=endpoint)
    cold = _pod("hp-cold", async_pull=True)
    prefix = _prompt(28, 16)
    prompt = prefix + _prompt(29, 4)

    async def post():
        client = TestClient(TestServer(cold.build_app()))
        await client.start_server()
        try:
            resp = await client.post("/v1/completions", headers={"X-Pull-Source": endpoint},
                                     json={"prompt_token_ids": prompt, "max_tokens": 3})
            return resp.status, await resp.json()
        finally:
            await client.close()

    try:
        warm.generate(prefix, TSP(max_new_tokens=2), timeout=120)
        status, body = asyncio.run(post())
        assert status == 200 and body["usage"]["cached_prompt_tokens"] == len(prefix)
        assert cold.async_pulls == 1
    finally:
        warm.shutdown(), cold.shutdown()


# -- mixed fleets -----------------------------------------------------------------
@pytest.mark.parametrize("puller", ["torch", "jax"])
def test_pull_across_frameworks(puller):
    """A torch pod pulls from a JAX pod's export service, and a JAX pod from
    a torch pod's; warm tokens equal the puller's framework computing the
    prompt cold."""
    endpoint = _endpoint()
    torch_puller = puller == "torch"
    warm = _pod("x-warm", torch_side=not torch_puller, transfer_endpoint=endpoint)
    cold = _pod("x-cold", torch_side=torch_puller)
    ref = _pod("x-ref", torch_side=torch_puller)
    SP = TSP if torch_puller else JSP
    try:
        prefix = _prompt(30, 16)
        prompt = prefix + _prompt(31, 4)
        warm.generate(prefix, (JSP if torch_puller else TSP)(max_new_tokens=2), timeout=120)
        assert cold.pull_prefix(prompt, endpoint) == len(prefix) // PS
        s = cold.generate(prompt, SP(max_new_tokens=4), timeout=120)
        s_ref = ref.generate(prompt, SP(max_new_tokens=4), timeout=120)
        assert s.output_tokens == s_ref.output_tokens
        assert s.num_cached_prompt == len(prefix)
        assert cold.engine.prefill_stats["tokens_computed"] == len(prompt) - len(prefix)
    finally:
        warm.shutdown(), cold.shutdown(), ref.shutdown()


# -- configuration ----------------------------------------------------------------
TRANSFER_ENV = {
    "TRANSFER_ENDPOINT": ("tcp://*:5599", "transfer_endpoint", "tcp://*:5599"),
    "TRANSFER_MAX_BLOCKS": ("17", "transfer_max_blocks", 17),
    "TRANSFER_TIMEOUT_S": ("2.5", "transfer_timeout_s", 2.5),
    "ASYNC_PULL": ("1", "async_pull", True),
    "PULL_WORKERS": ("5", "pull_workers", 5),
    "TRANSFER_BREAKER_FAILURES": ("3", "transfer_breaker_failures", 3),
    "TRANSFER_BREAKER_BACKOFF_S": ("0.5", "transfer_breaker_backoff_s", 0.5),
    "TRANSFER_BREAKER_BACKOFF_MAX_S": ("8", "transfer_breaker_backoff_max_s", 8.0),
}


def test_from_env_reads_transfer_knobs_like_jax(monkeypatch):
    """Unset: the JAX pod's defaults; set: the same parsed values."""
    for name in TRANSFER_ENV:
        monkeypatch.delenv(name, raising=False)
    fields = [f for _, f, _ in TRANSFER_ENV.values()]
    off = [getattr(PodServerConfig.from_env(), f) for f in fields]
    assert off == [getattr(JPodConfig.from_env(), f) for f in fields]
    assert off == [getattr(JPodConfig(), f) for f in fields]
    assert off[0] is None and off[3] is False
    for name, (value, _, _) in TRANSFER_ENV.items():
        monkeypatch.setenv(name, value)
    on = PodServerConfig.from_env()
    assert [getattr(on, f) for f in fields] == [v for _, _, v in TRANSFER_ENV.values()]
    assert [getattr(JPodConfig.from_env(), f) for f in fields] == [getattr(on, f) for f in fields]


def test_transfer_disabled_by_default_builds_and_binds_nothing(monkeypatch):
    """TestTransferDisabledDefault on a torch pod: no endpoint means no
    service and no socket, and requests are served as before."""
    import zmq

    assert PodServerConfig().transfer_endpoint is None
    monkeypatch.delenv("TRANSFER_ENDPOINT", raising=False)
    assert PodServerConfig.from_env().transfer_endpoint is None
    bound = []
    real = zmq.Socket.bind
    monkeypatch.setattr(zmq.Socket, "bind", lambda self, addr: bound.append(addr) or real(self, addr))
    server = _pod("plain")
    try:
        assert server._transfer_service is None
        s = server.generate(_prompt(9, 10), TSP(max_new_tokens=3), timeout=120)
        assert len(s.output_tokens) == 3
        assert bound == [] and server._transfer_pool.clients() == {}
    finally:
        server.shutdown()
