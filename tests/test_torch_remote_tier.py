"""The remote KV tier on the port's engine and pods, beside the JAX package
(``tests/test_remote_tier.py``'s ``TestDemotionEngine``, ``TestPushOverZMQ``,
``TestDemotionTargets``, ``TestDemotionChaos``, ``TestHeartbeatHeadroom`` and
``TestKnobsOffParity``).

Both packages run TINY_LLAMA on shared parameters. Held exactly: the hashes,
parents and tokens of the blocks each engine demotes (its page bytes
within 1e-5, since the two frameworks' float32 K/V differ in their last
bits), and the demoted payload bytes themselves where the pages were made
equal (a chain both engines imported); the ``PushBlocks`` payload a holder
of either package stores equals the one the demoter pushed, and the pages
pulled back equal it; greedy tokens at float32; Heartbeat bytes with a
headroom; the ``/stats`` ``remote`` block's keys.
"""

import asyncio
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from conftest import free_tcp_port
from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import hash_block
from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer import (
    BlockPayload,
    KVTransferClient,
    RemoteBlockStore,
    RemoteStoreConfig,
    TransferClientConfig,
    TransferError,
)
from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA, quant
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server import EngineConfig
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServerConfig
from torch_fleet import (
    MODEL,
    PS,
    SIDES,
    RecordingPublisher,
    engine_config,
    pod,
    prompt,
    sampling,
    shared_params,
    wait_until,
)

T, J = SIDES
SHAPE = (TINY_LLAMA.n_layers, PS, TINY_LLAMA.n_kv_heads, TINY_LLAMA.hd)
SCALE_BYTES = int(np.prod(quant.kv_scale_shape(SHAPE))) * 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engine(side, total_pages=64, on_events=None, **kw):
    jp, tp = shared_params()
    cfg = engine_config(side, total_pages=total_pages, **kw)
    if side:
        return TEngine(cfg, params=tp, on_events=on_events, device="cpu")
    return JEngine(cfg, params=jp, on_events=on_events)


def _store(capacity=64, init_hash=0, on_events=None):
    return RemoteBlockStore(
        RemoteStoreConfig(capacity_pages=capacity, page_size=PS, page_shape=SHAPE,
                          dtype="float32", scale_bytes=SCALE_BYTES, init_hash=init_hash),
        on_events=on_events,
    )


def _chain_payloads(init_hash, n=3, seed=0):
    rng = np.random.default_rng(seed)
    parent, out = None, []
    data = np.zeros(SHAPE, np.float32).tobytes()
    for _ in range(n):
        toks = [int(t) for t in rng.integers(0, 1000, PS)]
        h = hash_block(parent if parent is not None else init_hash, toks)
        out.append(BlockPayload(block_hash=h, parent_block_hash=parent, token_ids=toks,
                                block_size=PS, dtype="float32", shape=SHAPE,
                                k_data=data, v_data=data))
        parent = h
    return out


def _serve_rounds(eng, n=4, new=4, first=0) -> list:
    out = []
    for i in range(first, first + n):
        seq = eng.add_request(prompt(i, 16), sampling(isinstance(eng, TEngine), max_new_tokens=new))
        eng.run_until_complete()
        out.append(list(seq.generated_tokens))
    return out


def _page_array(payload) -> np.ndarray:
    return np.frombuffer(payload.k_data + payload.v_data, np.float32)


def _stats(server) -> dict:
    async def go():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            return await (await client.get("/stats")).json()
        finally:
            await client.close()

    return asyncio.run(go())


# -- TestDemotionEngine --------------------------------------------------------
def test_knob_off_no_hook():
    eng = _engine(T, total_pages=12)
    assert eng.block_manager._demote is None
    assert eng.remote_store is None and eng.remote_headroom is None


@pytest.mark.parametrize("host_pages", [0, 2], ids=["hbm", "host_lru"])
def test_demotions_match_jax_engine(host_pages):
    """HBM evictions (and host-LRU drops) demote the same blocks, in the same
    order, on both engines; every payload is one a fresh store accepts."""
    kw = dict(host_pages=host_pages, host_tier_policy="always") if host_pages else {}
    got = {}
    for side in SIDES:
        eng = _engine(side, total_pages=12, remote_tier=True, **kw)
        payloads = []
        eng.on_demotion = payloads.extend
        _serve_rounds(eng, n=5 if host_pages else 4)
        assert payloads and eng.remote_stats["demoted_blocks"] == len(payloads)
        store = _store(capacity=256, init_hash=eng.block_manager.token_db.init_hash)
        store.accept(payloads)
        assert store.stats["rejected"] == 0
        if host_pages:
            assert eng.block_manager.host_stats["host_evicted"] > 0
        got[side] = payloads
    t, j = got[T], got[J]
    assert [(b.block_hash, b.parent_block_hash, b.token_ids, b.dtype, tuple(b.shape))
            for b in t] == [(b.block_hash, b.parent_block_hash, b.token_ids, b.dtype,
                             tuple(b.shape)) for b in j]
    for a, b in zip(t, j):
        np.testing.assert_allclose(_page_array(a), _page_array(b), rtol=1e-5, atol=1e-5)


def test_no_sink_means_plain_eviction_and_outputs_identical():
    outs = {}
    for remote in (False, True):
        eng = _engine(T, total_pages=12, remote_tier=remote)
        outs[remote] = _serve_rounds(eng)
        assert eng.remote_stats["demoted_blocks"] == 0
    assert outs[False] == outs[True]


def test_int8_demotion_ships_quant_triple():
    eng = _engine(T, total_pages=12, remote_tier=True, kv_quant="int8")
    payloads = []
    eng.on_demotion = payloads.extend
    _serve_rounds(eng)
    assert payloads and all(b.quant == "int8" for b in payloads)
    assert all(len(b.k_scale) == SCALE_BYTES for b in payloads)
    assert all(b.wire_bytes < 2 * int(np.prod(SHAPE)) * 4 * 0.6 for b in payloads)
    store = _store(capacity=256, init_hash=eng.block_manager.token_db.init_hash)
    store.accept(payloads)
    assert store.stats["rejected"] == 0


def test_demote_pull_back_greedy_parity():
    want = _serve_rounds(_engine(T, total_pages=64), n=5)
    eng = _engine(T, total_pages=12, remote_tier=True)
    store = _store(capacity=256, init_hash=eng.block_manager.token_db.init_hash)
    eng.on_demotion = store.accept
    assert _serve_rounds(eng, n=5) == want
    hashes = eng.block_manager.token_db.prefix_hashes(prompt(0, 16))
    assert not any(eng.block_manager.is_block_resident(h) for h in hashes)
    served = store.serve(hashes)
    assert served and eng.import_kv_blocks(served) == len(served)
    seq = eng.add_request(prompt(0, 16), sampling(T, max_new_tokens=4))
    eng.run_until_complete()
    assert seq.num_cached_prompt >= PS and list(seq.generated_tokens) == want[0]


def test_import_recycles_evictable_only_with_knob():
    donor = _engine(T, total_pages=64)
    donor.add_request(prompt(99, 16), sampling(T, max_new_tokens=1))
    donor.run_until_complete()
    chain = donor.export_kv_blocks(donor.block_manager.token_db.prefix_hashes(prompt(99, 16)))
    assert chain
    for remote in (True, False):
        eng = _engine(T, total_pages=12, remote_tier=remote)
        eng.on_demotion = lambda ps: None
        _serve_rounds(eng)
        free = len(eng.block_manager._free)
        assert free < len(chain)
        assert eng.import_kv_blocks(list(chain)) == (len(chain) if remote else free)


def test_demoted_payload_bytes_equal_jax_on_shared_pages():
    """A chain both engines imported (so its pages hold the same bytes)
    demotes as the same payload bytes on both, full-width and int8."""
    donor = _engine(J, total_pages=64)
    donor.add_request(prompt(42, 16), sampling(J, max_new_tokens=1))
    donor.run_until_complete()
    hashes = donor.block_manager.token_db.prefix_hashes(prompt(42, 16))
    chain = donor.export_kv_blocks(hashes)
    for kv_quant in (None, "int8"):
        got = {}
        for side in SIDES:
            eng = _engine(side, total_pages=12, remote_tier=True, kv_quant=kv_quant)
            payloads = []
            eng.on_demotion = payloads.extend
            assert eng.import_kv_blocks(list(chain)) == len(chain)
            _serve_rounds(eng, n=3, first=50)
            got[side] = {b.block_hash: b for b in payloads if b.block_hash in hashes}
        assert set(got[T]) == set(got[J]) == set(hashes)
        for h in hashes:
            a, b = got[T][h], got[J][h]
            assert (a.k_data, a.v_data, a.k_scale, a.v_scale, a.dtype, a.quant) == (
                b.k_data, b.v_data, b.k_scale, b.v_scale, b.dtype, b.quant)


def test_remote_store_serves_exports_and_digest():
    events = []
    eng = _engine(T, total_pages=32, remote_tier=True, remote_store_pages=16,
                  on_events=events.append)
    chain = _chain_payloads(eng.block_manager.token_db.init_hash, n=3, seed=3)
    assert eng.accept_remote_blocks("peer", chain) == (3, 13)
    assert eng.remote_headroom == 13
    stored = [e for batch in events for e in batch if type(e).__name__ == "BlockStored"]
    assert stored and all(e.medium == "remote" for e in stored)
    assert set(eng.block_digest()["remote"]) == {b.block_hash for b in chain}
    hashes = [b.block_hash for b in chain]
    assert [b.block_hash for b in eng.export_kv_blocks(hashes)] == hashes


# -- TestPushOverZMQ -----------------------------------------------------------
@pytest.mark.parametrize("demoter_side, holder_side", [(T, T), (J, T), (T, J)],
                         ids=["torch-torch", "jax-torch", "torch-jax"])
def test_demote_push_pull_back_over_fabric(demoter_side, holder_side):
    """A demoter of either package pushes into a kvstore holder of either:
    the holder stores the pushed payload bytes unchanged, the pulled-back
    pages equal them, and the warm request's tokens equal the first run's."""
    endpoint = f"tcp://127.0.0.1:{free_tcp_port()}"
    holder = pod(holder_side, "kv-holder", transfer_endpoint=endpoint, pod_role="kvstore",
                 remote_tier=True, remote_store_pages=128)
    demoter = pod(demoter_side, "demoter", total_pages=12, remote_tier=True,
                  remote_peers=endpoint)
    pushed = {}
    stage = demoter._stage_demotions

    def record(payloads):
        for b in payloads:
            pushed[b.block_hash] = (b.k_data, b.v_data)
        stage(payloads)

    demoter.engine.on_demotion = record
    try:
        outs = [demoter.generate(prompt(i, 16), sampling(demoter_side, max_new_tokens=4),
                                 timeout=120).generated_tokens for i in range(5)]
        hashes = demoter.engine.block_manager.token_db.prefix_hashes(prompt(0, 16))
        store = holder.engine.remote_store
        assert wait_until(lambda: hashes[0] in store, timeout=30)
        assert wait_until(lambda: demoter.demote_pushed_blocks == len(pushed), timeout=30)
        for h, (k, v) in pushed.items():
            if h in store:
                assert (store._blocks[h].k_data, store._blocks[h].v_data) == (k, v)
        with pytest.raises(ValueError):
            holder.submit(prompt(0, 16))
        n = demoter.pull_prefix(prompt(0, 16), endpoint)
        assert n >= 1
        # The pulled-back pages hold the pushed bytes.
        eng = demoter.engine

        def k_bytes():
            eng._flush_page_moves()
            pages = [eng.block_manager._cached[h] for h in hashes[:n]]
            return [np.asarray(eng.k_pages[:, page]).tobytes() for page in pages]

        assert demoter._controller_read(k_bytes) == [pushed[h][0] for h in hashes[:n]]
        seq = demoter.generate(prompt(0, 16), sampling(demoter_side, max_new_tokens=4),
                               timeout=120)
        assert seq.generated_tokens == outs[0] and seq.num_cached_prompt >= PS
    finally:
        demoter.shutdown()
        holder.shutdown()


def test_tampered_push_rejected_over_wire():
    endpoint = f"tcp://127.0.0.1:{free_tcp_port()}"
    holder = pod(T, "kv-holder2", transfer_endpoint=endpoint, remote_tier=True,
                 remote_store_pages=16)
    client = KVTransferClient(TransferClientConfig(endpoint=endpoint, timeout_s=5.0))
    try:
        init = holder.engine.block_manager.token_db.init_hash
        good = _chain_payloads(init, n=1, seed=1)[0]
        bad = _chain_payloads(init, n=1, seed=2)[0]
        bad.token_ids = list(bad.token_ids)
        bad.token_ids[0] ^= 1
        trunc = _chain_payloads(init, n=1, seed=3)[0]
        trunc.quant = "int8"
        trunc.k_data = trunc.v_data = b"\x01" * int(np.prod(SHAPE))
        trunc.k_scale = b"\x00" * (SCALE_BYTES - 4)
        trunc.v_scale = b"\x00" * SCALE_BYTES
        assert client.push_blocks(MODEL, "attacker", [good, bad, trunc]) == (1, 15)
        store = holder.engine.remote_store
        assert good.block_hash in store and bad.block_hash not in store
        assert trunc.block_hash not in store and store.stats["rejected"] == 2
    finally:
        client.close()
        holder.shutdown()


def test_push_to_service_without_the_tier_refused():
    endpoint = f"tcp://127.0.0.1:{free_tcp_port()}"
    server = pod(T, "plain", transfer_endpoint=endpoint)
    client = KVTransferClient(TransferClientConfig(endpoint=endpoint, timeout_s=5.0))
    try:
        init = server.engine.block_manager.token_db.init_hash
        with pytest.raises(TransferError, match="push unsupported"):
            client.push_blocks(MODEL, "src", _chain_payloads(init, n=1))
    finally:
        client.close()
        server.shutdown()


# -- TestDemotionTargets, TestDemotionChaos ----------------------------------------
def test_zero_headroom_peer_ranks_last_but_stays_a_target():
    server = pod(T, "ranker", remote_tier=True, remote_peers="tcp://a:1,tcp://b:2", start=False)
    with server._mu:
        server._peer_headroom.update({"tcp://a:1": 0, "tcp://b:2": 5})
    assert server._demotion_targets() == ["tcp://b:2", "tcp://a:1"]
    with server._mu:
        server._peer_headroom["tcp://b:2"] = 0
    assert server._demotion_targets() == ["tcp://a:1", "tcp://b:2"]


def test_partitioned_target_degrades_to_plain_eviction():
    dead = f"tcp://127.0.0.1:{free_tcp_port()}"
    server = pod(T, "lonely", total_pages=12, remote_tier=True, remote_peers=dead,
                 transfer_timeout_s=0.3, transfer_breaker_failures=1)
    baseline = server.engine.block_manager.num_free
    try:
        t0 = time.monotonic()
        for i in range(4):
            seq = server.generate(prompt(i, 16), sampling(T, max_new_tokens=4), timeout=60)
            assert seq.num_generated == 4
        assert time.monotonic() - t0 < 45
        assert wait_until(lambda: not server._demote_queue and server.demote_failed_blocks > 0,
                          timeout=15)
        assert server.demote_pushed_blocks == 0
        assert server.engine.block_manager.num_free == baseline
    finally:
        server.shutdown()


# -- TestHeartbeatHeadroom -------------------------------------------------------
@pytest.mark.parametrize("role, store_pages", [("mixed", 0), ("mixed", 8), ("kvstore", 32)])
def test_heartbeat_headroom_bytes_equal_jax_pod(role, store_pages):
    payloads = []
    for side in SIDES:
        pub = RecordingPublisher(side)
        server = pod(side, "hr-pod", publisher=pub, pod_role=role, remote_tier=True,
                     remote_store_pages=store_pages, start=False)
        server._publish_heartbeat()
        payloads.append(pub.payloads("Heartbeat"))
    assert payloads[0] == payloads[1] and len(payloads[0]) == 1


def test_headroom_falls_by_the_blocks_accepted():
    eng = _engine(T, total_pages=32, remote_tier=True, remote_store_pages=8)
    assert eng.remote_headroom == 8
    eng.accept_remote_blocks("peer", _chain_payloads(eng.block_manager.token_db.init_hash, n=3))
    assert eng.remote_headroom == 5


# -- TestKnobsOffParity ----------------------------------------------------------
def test_defaults_off(monkeypatch):
    for var in ("REMOTE_TIER", "REMOTE_STORE_PAGES", "REMOTE_PEERS", "REMOTE_DEMOTE_QUEUE"):
        monkeypatch.delenv(var, raising=False)
    cfg = PodServerConfig.from_env()
    assert (cfg.remote_tier, cfg.remote_store_pages, cfg.remote_peers) == (False, 0, "")
    assert cfg.engine.remote_tier is False
    assert EngineConfig.__dataclass_fields__["remote_tier"].default is False
    monkeypatch.setenv("REMOTE_TIER", "1")
    monkeypatch.setenv("REMOTE_STORE_PAGES", "64")
    monkeypatch.setenv("REMOTE_PEERS", "tcp://a:1")
    cfg = PodServerConfig.from_env()
    assert (cfg.remote_tier, cfg.engine.remote_tier, cfg.engine.remote_store_pages) == (
        True, True, 64)


@pytest.mark.parametrize("knob", [False, True], ids=["off", "on"])
def test_stats_remote_block_keys_equal_jax_pod(knob):
    kw = dict(remote_tier=True, remote_store_pages=8) if knob else {}
    got = []
    for side in SIDES:
        server = pod(side, "rt", **kw)
        try:
            got.append(_stats(server))
        finally:
            server.shutdown()
    t, j = got
    assert set(t) == set(j)
    assert set(t["transfer"]) == set(j["transfer"])
    if knob:
        assert set(t["remote"]) == set(j["remote"])
        assert t["remote"]["store_pages"] == t["remote"]["headroom"] == 8
    else:
        assert "remote" not in t
