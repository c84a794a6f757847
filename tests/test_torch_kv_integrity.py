"""KV-block integrity on the port's engine and pods, beside the JAX package
(``tests/test_kv_integrity.py``'s ``TestHostTierDrill``,
``TestRemoteTierDrill``, ``TestInFlightDrill``, ``TestExportTruncation``,
``TestRevocationConformance``, ``TestBadBlockWire`` and
``TestKnobsOffParity``).

Held exactly: the bytes a digest covers (bf16 through its ``int16`` view,
int8 codes and their scales) and so the digests, on pages made equal in
both engines; the integrity counters of the two engines over one drill;
``BadBlock`` bytes; greedy tokens at float32, which a request recomputing
from a quarantined block shares with the clean run.
"""

import asyncio

import ml_dtypes
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from llm_d_kv_cache_manager_tpu.kvcache import integrity as jintegrity
from llm_d_kv_cache_manager_tpu.kvcache.kvevents import events as jevents
from llm_d_kv_cache_manager_tpu.models import quant as jquant
from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu_torch.kvcache.integrity import page_digest
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import InMemoryIndex, InMemoryIndexConfig, Key
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cost_aware import (
    CostAwareMemoryIndex,
    CostAwareMemoryIndexConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import (
    EventBatch,
    KVEventsPool,
    KVEventsPoolConfig,
    Message,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents.events import (
    BadBlock,
    BlockStored,
    decode_event_batch,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer import (
    RemoteBlockStore,
    RemoteStoreConfig,
    protocol,
)
from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA, quant
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server.engine import _tensor_bytes
from torch_fleet import PS, SIDES, RecordingPublisher, engine_config, pod, prompt, sampling
from torch_fleet import shared_params

T, J = SIDES
SHAPE = (TINY_LLAMA.n_layers, PS, TINY_LLAMA.n_kv_heads, TINY_LLAMA.hd)
SCALE_BYTES = int(np.prod(quant.kv_scale_shape(SHAPE))) * 4
HOST = dict(host_pages=32, host_tier_policy="always")


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


def _serve(eng, seeds, new=4) -> list:
    out = []
    for i in seeds:
        seq = eng.add_request(prompt(i, 16), sampling(isinstance(eng, TEngine), max_new_tokens=new))
        eng.run_until_complete()
        out.append(list(seq.generated_tokens))
    return out


def _baseline(n=5) -> list:
    return _serve(_engine(T, total_pages=64), range(n))


def _flip_host_byte(eng, h, byte_index=0) -> bool:
    """Flip one byte of block ``h``'s host slot in place, after the queued
    moves (and their copies) have landed, as the JAX drill does."""
    eng._flush_page_moves()
    slot = eng.block_manager._host_cached.get(h)
    if slot is None:
        return False
    if isinstance(eng, TEngine):
        eng._wait_host_copies()
        flat = eng._host_k[slot].reshape(-1).view(torch.uint8)
        flat[byte_index % flat.numel()] ^= 0xFF
    else:
        flat = eng._host_k[slot].reshape(-1).view("uint8")
        flat[byte_index % flat.size] ^= 0xFF
    return True


def _corrupt_payload(blocks, which=0):
    data = bytearray(blocks[which].k_data)
    data[0] ^= 0xFF
    blocks[which].k_data = bytes(data)


def _store(eng, on_events=None):
    return RemoteBlockStore(
        RemoteStoreConfig(capacity_pages=256, page_size=PS, page_shape=SHAPE, dtype="float32",
                          scale_bytes=SCALE_BYTES, init_hash=eng.block_manager.token_db.init_hash),
        on_events=on_events,
        integrity=eng.integrity,
    )


# -- digest inputs across frameworks -------------------------------------------
def test_digest_bytes_equal_jax_bf16_page():
    rng = np.random.default_rng(0)
    page = rng.standard_normal(SHAPE).astype(np.float32)
    j = page.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(page).to(torch.bfloat16)
    assert _tensor_bytes(t) == j.tobytes()
    assert page_digest(_tensor_bytes(t), _tensor_bytes(t)) == jintegrity.page_digest(
        j.tobytes(), j.tobytes())


def test_digest_bytes_equal_jax_int8_page_with_scales():
    rng = np.random.default_rng(1)
    page = rng.standard_normal(SHAPE).astype(np.float32)
    jq, js = jquant.quantize_kv_page(page)
    tq, ts = quant.quantize_kv_page(torch.from_numpy(page))
    parts_t = [_tensor_bytes(tq), _tensor_bytes(tq), _tensor_bytes(ts), _tensor_bytes(ts)]
    parts_j = [jq.tobytes(), jq.tobytes(), js.tobytes(), js.tobytes()]
    assert parts_t == parts_j
    assert page_digest(*parts_t) == jintegrity.page_digest(*parts_j)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["full", "int8"])
def test_host_slot_digests_equal_jax_on_shared_pages(kv_quant):
    """A chain both engines imported spills to the host tier: each block's
    write-time record equals the JAX engine's."""
    donor = _engine(J, total_pages=64)
    donor.add_request(prompt(42, 16), sampling(J, max_new_tokens=1))
    donor.run_until_complete()
    hashes = donor.block_manager.token_db.prefix_hashes(prompt(42, 16))
    chain = donor.export_kv_blocks(hashes)
    records = {}
    for side in SIDES:
        eng = _engine(side, total_pages=12, kv_integrity=True, kv_quant=kv_quant, **HOST)
        assert eng.import_kv_blocks(list(chain)) == len(chain)
        _serve(eng, range(50, 53))
        eng._flush_page_moves()
        if side:
            eng._wait_host_copies()
        records[side] = {h: eng.integrity.expected(h) for h in hashes}
        assert all(h in eng.block_manager._host_cached for h in hashes)
    assert records[T] == records[J] and None not in records[T].values()


# -- TestHostTierDrill ----------------------------------------------------------
def test_restore_detects_quarantines_and_recomputes_as_jax_engine():
    want = _baseline(4)
    snaps, bad_bytes = {}, {}
    for side in SIDES:
        events = []
        eng = _engine(side, total_pages=12, kv_integrity=True, **HOST)
        eng.block_manager.on_events = events.extend
        assert _serve(eng, range(4)) == want
        free_before = eng.block_manager.num_free
        h0 = eng.block_manager.token_db.prefix_hashes(prompt(0, 16))[0]
        assert _flip_host_byte(eng, h0)
        assert _serve(eng, [0]) == [want[0]]
        bad = [e for e in events if type(e).__name__ == "BadBlock"]
        assert len(bad) == 1 and bad[0].medium == "host_dram" and h0 in bad[0].block_hashes
        eng._flush_page_moves()
        assert eng.block_manager.num_free == free_before
        snaps[side] = eng.integrity.snapshot()
        bad_bytes[side] = bad[0].to_tagged_union()
    assert snaps[T]["checks_corrupt"] == snaps[T]["quarantined"] == 1
    assert snaps[T] == snaps[J]
    assert bad_bytes[T] == bad_bytes[J]


def test_scrubber_catches_latent_rot_and_clean_tier_is_all_ok():
    eng = _engine(T, total_pages=12, kv_integrity=True, **HOST)
    _serve(eng, range(4))
    checked = eng.scrub_host_pages(64)
    assert checked > 0 and eng.integrity.stats["checks_ok"] == checked
    bm = eng.block_manager
    victim = next(iter(bm._host_cached))
    assert _flip_host_byte(eng, victim, byte_index=3)
    checked2 = eng.scrub_host_pages(64)
    assert eng.integrity.stats["checks_corrupt"] == 1
    assert eng.integrity.stats["scrub_pages"] == checked + checked2
    assert victim not in bm._host_cached and eng.integrity.is_quarantined(victim)


# -- TestRemoteTierDrill --------------------------------------------------------
def test_remote_serve_detects_rot_revokes_and_recomputes():
    want = _baseline(5)
    eng = _engine(T, total_pages=12, remote_tier=True, kv_integrity=True)
    events = []
    store = _store(eng, on_events=events.extend)
    eng.on_demotion = store.accept
    assert _serve(eng, range(5)) == want
    assert len(store) and all(b.digest is not None for b in store._blocks.values())
    hashes = eng.block_manager.token_db.prefix_hashes(prompt(0, 16))
    blk = store._blocks[hashes[0]]
    data = bytearray(blk.k_data)
    data[0] ^= 0xFF
    blk.k_data = bytes(data)
    assert store.serve(hashes) == []
    assert store.stats["quarantined"] == 1 and hashes[0] not in store
    bad = [e for e in events if type(e).__name__ == "BadBlock"]
    assert bad and bad[0].medium == "remote"
    assert _serve(eng, [0]) == [want[0]]


def test_remote_accept_rejects_corrupt_push_and_purges():
    eng = _engine(T, total_pages=12, remote_tier=True, kv_integrity=True)
    payloads = []
    eng.on_demotion = payloads.extend
    _serve(eng, range(5))
    store = _store(eng)
    _corrupt_payload(payloads, which=0)
    assert store.accept(payloads, source_pod="pusher-1") == len(payloads) - 1
    assert store.stats["digest_rejected"] == 1 and payloads[0].block_hash not in store
    victims = list(store._blocks)[:2]
    assert store.purge(victims + [999]) == 2 and store.stats["purged"] == 2


# -- TestInFlightDrill ----------------------------------------------------------
@pytest.mark.parametrize("donor_side, recv_side", [(J, T), (T, J), (T, T)],
                         ids=["jax-torch", "torch-jax", "torch-torch"])
def test_import_rejects_corrupt_frame_before_install(donor_side, recv_side):
    want = _baseline(2)
    donor = _engine(donor_side, total_pages=64, kv_integrity=True)
    donor.add_request(prompt(1, 16), sampling(donor_side, max_new_tokens=1))
    donor.run_until_complete()
    blocks = donor.export_kv_blocks(donor.block_manager.token_db.prefix_hashes(prompt(1, 16)))
    assert blocks and all(b.digest is not None for b in blocks)
    events = []
    recv = _engine(recv_side, total_pages=64, kv_integrity=True, on_events=events.extend)
    _corrupt_payload(blocks, which=1)
    assert recv.import_kv_blocks(blocks, source_pod="donor-pod") == 1
    assert recv.transfer_stats["import_rejected"] == 1
    assert recv.integrity.stats["checks_corrupt"] == 1
    bad = [e for e in events if type(e).__name__ == "BadBlock"]
    assert bad and bad[0].pod == "donor-pod" and blocks[1].block_hash in bad[0].block_hashes
    assert _serve(recv, [1]) == [want[1]]


def test_export_digests_equal_jax_and_survive_the_wire():
    digests = {}
    for side in SIDES:
        donor = _engine(side, total_pages=64, kv_integrity=True)
        donor.add_request(prompt(1, 16), sampling(side, max_new_tokens=1))
        donor.run_until_complete()
        blocks = donor.export_kv_blocks(donor.block_manager.token_db.prefix_hashes(prompt(1, 16)))
        decoded, _complete, err = protocol.decode_response(protocol.encode_response(blocks, True))
        assert err is None and [b.digest for b in decoded] == [b.digest for b in blocks]
        digests[side] = [page_digest(b.k_data, b.v_data) == b.digest for b in blocks]
    assert all(digests[T]) and all(digests[J])


# -- TestExportTruncation --------------------------------------------------------
def test_export_truncates_at_corrupt_host_block():
    eng = _engine(T, total_pages=12, kv_integrity=True, **HOST)
    _serve(eng, range(4))
    bm = eng.block_manager
    hashes = bm.token_db.prefix_hashes(prompt(0, 16))
    eng._flush_page_moves()
    host_run = [h for h in hashes if h in bm._host_cached]
    assert len(host_run) >= 2
    bad = host_run[1]
    assert _flip_host_byte(eng, bad)
    blocks = eng.export_kv_blocks(hashes)
    assert [b.block_hash for b in blocks] == hashes[: hashes.index(bad)]
    assert eng.integrity.stats["checks_corrupt"] == 1 and bad not in bm._host_cached


# -- TestRevocationConformance, TestBadBlockWire -----------------------------------
BACKENDS = {
    "in_memory": lambda: InMemoryIndex(InMemoryIndexConfig(size=1000, pod_cache_size=10)),
    "cost_aware": lambda: CostAwareMemoryIndex(CostAwareMemoryIndexConfig(max_cost_bytes=10**6)),
}


def _feed(pool, pod_id, events, seq):
    pool.add_task(Message(topic=f"kv@{pod_id}@m", pod_identifier=pod_id, model_name="m",
                          payload=EventBatch(ts=0.0, events=events).to_payload(), seq=seq))
    assert pool.drain(5)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_bad_block_revokes_the_holders_entry(backend):
    index = BACKENDS[backend]()
    pool = KVEventsPool(index, KVEventsPoolConfig(concurrency=1))
    pool.start()
    try:
        stored = BlockStored(block_hashes=[11, 12], token_ids=list(range(2 * PS)), block_size=PS)
        _feed(pool, "pod-a", [stored], 0)
        _feed(pool, "pod-b", [stored], 0)
        keys = [Key("m", 11), Key("m", 12)]
        _feed(pool, "pod-a", [BadBlock(block_hashes=[11])], 1)
        got = index.lookup(keys, set())
        assert got[keys[0]] == ["pod-b"] and sorted(got[keys[1]]) == ["pod-a", "pod-b"]
    finally:
        pool.shutdown()


def test_bad_block_wire_bytes_equal_jax():
    for kw in ({"block_hashes": [1, 2]}, {"block_hashes": [3], "medium": "host_dram"},
               {"block_hashes": [4], "pod": "holder-1"}):
        t = EventBatch(ts=1.0, events=[BadBlock(**kw)]).to_payload()
        j = jevents.EventBatch(ts=1.0, events=[jevents.BadBlock(**kw)]).to_payload()
        assert t == j
        assert decode_event_batch(t).events[0].to_tagged_union() == BadBlock(**kw).to_tagged_union()


# -- the pod: one flipped host byte --------------------------------------------------
def _http(server, calls):
    async def go():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            out = []
            for path in calls:
                resp = await client.get(path)
                out.append(await (resp.json() if path == "/stats" else resp.text()))
            return out
        finally:
            await client.close()

    return asyncio.run(go())


def test_pod_flip_gives_one_quarantine_one_bad_block_as_jax_pod():
    """On a pod of each package: one corrupted host byte is one quarantine
    and one ``BadBlock``; the repeat recomputes to the clean tokens; the
    ``/stats`` integrity blocks and the BadBlock bytes are equal."""
    prompts = [prompt(100 + i, 16) for i in range(4)]
    got = {}
    for side in SIDES:
        pub = RecordingPublisher(side)
        server = pod(side, "ki-pod", publisher=pub, total_pages=12, kv_integrity=True,
                     obs_metrics=True, engine_kw=HOST)
        try:
            outs = [server.generate(p, sampling(side, max_new_tokens=4), timeout=120)
                    .generated_tokens for p in prompts]
            eng = server.engine
            h0 = eng.block_manager.token_db.prefix_hashes(prompts[0])[0]
            assert server._controller_read(lambda: _flip_host_byte(eng, h0))
            again = server.generate(prompts[0], sampling(side, max_new_tokens=4), timeout=120)
            assert again.generated_tokens == outs[0]
            stats, metrics = _http(server, ["/stats", "/metrics"])
            assert 'kvcache_integrity_checks_total{outcome="corrupt"} 1.0' in metrics
            got[side] = (outs, stats["integrity"],
                         [e.to_tagged_union() for e in pub.events("BadBlock")])
        finally:
            server.shutdown()
    t, j = got[T], got[J]
    assert t[1]["quarantined"] == t[1]["checks_corrupt"] == 1
    assert t == j and len(t[2]) == 1


# -- TestKnobsOffParity -----------------------------------------------------------
def test_knobs_off_no_table_no_wire_digest_same_outputs():
    eng = _engine(T, total_pages=64)
    assert eng.integrity is None and eng.block_manager._integrity is None
    eng.add_request(prompt(1, 16), sampling(T, max_new_tokens=1))
    eng.run_until_complete()
    blocks = eng.export_kv_blocks(eng.block_manager.token_db.prefix_hashes(prompt(1, 16)))
    assert blocks and all(b.digest is None for b in blocks)
    outs = {knob: _serve(_engine(T, total_pages=12, kv_integrity=knob, **HOST), range(4))
            for knob in (False, True)}
    assert outs[False] == outs[True]


def test_knobs_off_stats_and_exposition_equal_jax_pod():
    got = []
    for side in SIDES:
        server = pod(side, "ki-off", obs_metrics=True)
        try:
            stats, metrics = _http(server, ["/stats", "/metrics"])
        finally:
            server.shutdown()
        assert "integrity" not in stats and "kvcache_integrity" not in metrics
        got.append(set(stats))
    assert got[0] == got[1]
