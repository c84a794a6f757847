"""Page moves over sharded pools: the port's host-DRAM tier, remote tier and
KV export/import on a tp=2 engine (``server/engine.py``'s ``_gather_pages``
and ``_scatter_rows``), against the JAX engine at tp=2 with the same knobs
and against the port at tp=1, on the CPU.

The port's shards run on the CPU device (``"same_device"``); JAX's tp=2
engine builds its mesh over conftest's host devices. Held, as in
``test_torch_host_tier.py`` and ``test_torch_remote_tier.py``: what every
request saw (greedy tokens, cached prompt tokens), the tiers' counters, the
KV events as msgpack bytes, exactly; host slots and the gathered pools
within rtol/atol 1e-5 (the frameworks' float32 K/V differ in last bits),
int8 codes within 1. The movers themselves are held bit for bit: a page
offloaded from the shards and restored comes back equal on every shard,
and a wire payload of a tp=2 pod is byte for byte a tp=1 pod's (the same
whole-head layout, size and digest).
"""

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu_torch.kvcache.integrity import page_digest
from llm_d_kv_cache_manager_tpu_torch.parallel import MeshConfig, make_mesh
from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import gather_kv_pools
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from test_torch_engine import _observe, _params, _prompt
from test_torch_host_tier import SCENARIOS, TIERS, assert_slots_match, engine_config, pin_rates
from test_torch_host_tier import _Side as _HostSide

PS = 4
POOL = dict(rtol=1e-5, atol=1e-5)
TP = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(tp=TP):
    return make_mesh(MeshConfig(tp=tp), devices=["cpu"] * tp)


def _engine(torch_side, tp=TP, on_events=None, **cfg):
    """TINY_LLAMA at ``tp`` (the host-tier tests' engine config)."""
    jp, tparams = _params("TINY_LLAMA")
    config = engine_config(torch_side, tp=tp, **cfg)
    if torch_side:
        return TEngine(config, params=tparams, on_events=on_events, device="cpu",
                       mesh=cpu_mesh(tp) if tp > 1 else None)
    return JEngine(config, params=jp, on_events=on_events)


class _TpSide(_HostSide):
    """``test_torch_host_tier``'s side at tp=2: the JAX engine over its
    tp=2 mesh, the port's over two CPU shards."""

    def __init__(self, torch_side, rates=None, **cfg):
        self.torch_side = torch_side
        self.events = []
        sink = lambda evs: self.events.append(list(evs))  # noqa: E731
        from llm_d_kv_cache_manager_tpu.kvcache.kvevents.events import EventBatch as JB
        from llm_d_kv_cache_manager_tpu.server import SamplingParams as JSP
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents.events import EventBatch as TB
        from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams as TSP

        self.SP, self.batch_cls = (TSP, TB) if torch_side else (JSP, JB)
        self.eng = _engine(torch_side, on_events=sink, **cfg)
        pin_rates(self.eng, **(rates or {}))

    def pools(self) -> list[np.ndarray]:
        eng = self.eng
        pools = [p for p in (eng.k_pages, eng.v_pages, eng.k_scales, eng.v_scales) if p is not None]
        if self.torch_side:
            return [gather_kv_pools(p).numpy() for p in pools]
        return [np.asarray(p) for p in pools]


HOST_CASES = [("spill_restore", "fp"), ("spill_restore", "int8"), ("spill_restore", "hbm_int8"),
              ("fused_decode_spill", "fp"), ("medium_events", "fp"), ("host_lru", "fp"),
              ("prefetch", "fp")]


@pytest.mark.parametrize("name,tier", [pytest.param(n, t, id=f"{n}-{t}") for n, t in HOST_CASES])
def test_tp2_host_tier_matches_jax_tp2(name, tier):
    fn, cfg, rates = SCENARIOS[name]
    jside = _TpSide(False, rates, **cfg, **TIERS[tier])
    tside = _TpSide(True, rates, **cfg, **TIERS[tier])
    assert tside.eng.mesh.shape["tp"] == TP
    jobs = [_observe(s) for s in fn(jside)]
    tobs = [_observe(s) for s in fn(tside)]
    assert tobs == jobs
    assert tside.state() == jside.state()
    assert tside.event_bytes() == jside.event_bytes()
    assert_slots_match(tside, jside)
    for t, j in zip(tside.pools(), jside.pools(), strict=True):
        if t.dtype == np.int8:
            assert np.abs(t.astype(np.int16) - j).max() <= 1
        else:
            np.testing.assert_allclose(t, j, **POOL)


@pytest.mark.parametrize("tier", list(TIERS))
def test_tp2_tiered_engine_matches_tp1_and_untiered(tier):
    """Within the port: the spill-and-restore workload through the host tier
    at tp=2 gives the tokens of tp=1 with the tier and of tp=2 without it,
    and the pools stay the ones the decode graphs hold."""
    fn, cfg, _ = SCENARIOS["spill_restore"]
    outs = {}
    for key, tp, knobs in (("tp2", TP, cfg), ("tp1", 1, cfg), ("untiered", TP, dict(total_pages=64))):
        side = _TpSide(True, None, **knobs, **TIERS[tier]) if tp > 1 else _HostSide(
            True, None, **knobs, **TIERS[tier])
        ptrs = [t.data_ptr() for shards in side.eng._pool_shards() for t in shards]
        if key == "untiered":  # no tier: the repeat hits the pool
            seqs = [side.eng.add_request(p, side.SP(max_new_tokens=5))
                    for p in [_prompt(40 + i, 16) for i in range(3)] + [_prompt(40, 16)]]
            side.eng.run_until_complete()
        else:
            seqs = fn(side)
        outs[key] = [s.output_tokens for s in seqs]
        assert [t.data_ptr() for shards in side.eng._pool_shards() for t in shards] == ptrs
    assert outs["tp2"] == outs["tp1"] == outs["untiered"]


def _fill_random(eng, seed):
    """Random contents in every shard's pools (codes and scales on int8
    pages)."""
    g = torch.Generator().manual_seed(seed)
    for shards in eng._pool_shards():
        for pool in shards:
            if pool.dtype == torch.int8:
                pool.copy_(torch.randint(-127, 128, pool.shape, generator=g, dtype=torch.int8))
            else:
                pool.copy_(torch.rand(pool.shape, generator=g, dtype=pool.dtype) + 0.5)


@pytest.mark.parametrize("tier", list(TIERS))
def test_offload_and_restore_are_bit_equal_per_shard(tier):
    """A page offloaded from the tp=2 pools is the whole-head page in its
    slot (the shards concatenated along the KV heads), and restored into
    another page it comes back equal on every shard."""
    eng = _engine(True, total_pages=12, host_pages=8, **TIERS[tier])
    _fill_random(eng, 7)
    before = [[pool[:, 3].clone() for pool in shards] for shards in eng._pool_shards()]
    eng._offload_page(3, 1)
    eng._flush_page_moves()
    eng._wait_host_copies()
    whole = [torch.cat(parts, dim=2 if parts[0].dim() == 4 else 1) for parts in before]
    assert torch.equal(eng._gather_pages([3])[0][0], whole[0])
    if tier == "fp":
        assert torch.equal(eng._host_k[1], whole[0]) and torch.equal(eng._host_v[1], whole[1])
    eng._restore_page(1, 6)
    eng._flush_page_moves()
    for shards, parts in zip(eng._pool_shards(), before):
        for pool, page in zip(shards, parts):
            if tier == "int8":  # a full-width pool through an int8 tier: quantized once
                torch.testing.assert_close(pool[:, 6], page, rtol=0, atol=float(page.abs().max()) / 100)
            else:
                assert torch.equal(pool[:, 6], page)


def _serve(eng, prompt, new_tokens=4):
    from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams as TSP

    seq = eng.add_request(prompt, TSP(max_new_tokens=new_tokens))
    eng.run_until_complete()
    return seq


@pytest.mark.parametrize("src_tp,dst_tp", [(TP, 1), (1, TP), (TP, TP)])
@pytest.mark.parametrize("knobs", [{}, {"kv_quant": "int8"}, {"kv_quant_hbm": "int8"}],
                         ids=["fp", "int8_wire", "int8_pages"])
def test_export_import_round_trip_across_tp(src_tp, dst_tp, knobs):
    """A prefix exported by one pod and imported by another, tp=2 on either
    side: the payloads equal the exporter's gathered pages byte for byte,
    carry digests that verify, land bit-equal in the importer's pages (per
    shard; through an int8 wire into full-width pools, the codes the pages
    quantize back to), and the importer's warm continuation equals its
    cold one."""
    prompt = _prompt(31, 17)
    src = _engine(True, tp=src_tp, kv_integrity=True, **knobs)
    dst = _engine(True, tp=dst_tp, kv_integrity=True, **knobs)
    cold = _engine(True, tp=dst_tp, **knobs)
    _serve(src, prompt, 1)
    hashes = src.block_manager.token_db.prefix_hashes(prompt)
    blocks = src.export_kv_blocks(hashes)
    assert len(blocks) == len(hashes) == 4
    gathered = src._to_host_form(src._gather_pages(_resident_pages(src, hashes)))
    shape = (src.model_cfg.n_layers, PS, src.model_cfg.n_kv_heads, src.model_cfg.hd)
    for i, b in enumerate(blocks):
        assert tuple(b.shape) == shape and b.block_size == PS
        assert b.k_data == gathered[0][i].numpy().tobytes()
        assert b.v_data == gathered[1][i].numpy().tobytes()
        assert b.digest == page_digest(b.k_data, b.v_data, b.k_scale, b.v_scale)
        assert len(b.k_data) + len(b.v_data) + len(b.k_scale or b"") + len(b.v_scale or b"") \
            == src.kv_block_bytes
    assert dst.import_kv_blocks(blocks, source_pod="src") == len(blocks)
    assert dst.transfer_stats["import_rejected"] == 0
    dst._flush_page_moves()
    landed = dst._to_host_form(dst._gather_pages(_resident_pages(dst, hashes)))
    for got, want in zip(landed, gathered, strict=True):
        assert torch.equal(got, want)
    warm = _serve(dst, prompt)
    assert warm.num_cached_prompt == 16
    assert warm.output_tokens == _serve(cold, prompt).output_tokens


def _resident_pages(eng, hashes) -> list[int]:
    chain = eng.block_manager.lookup_chain(hashes, None)
    assert [tier for _, _, tier, _ in chain] == ["tpu_hbm"] * len(hashes)
    return [idx for _, _, _, idx in chain]


@pytest.mark.parametrize("knobs", [{}, {"kv_quant_hbm": "int8"}], ids=["fp", "int8_pages"])
def test_tp2_wire_bytes_equal_tp1_and_jax_tp2_on_shared_pages(knobs):
    """A chain imported by a tp=1 and a tp=2 port pod and by JAX's tp=2 pod
    (so every pool holds the same bytes) exports as the same payload bytes
    from all three: one wire format, whatever the sharding."""
    donor = _engine(False, tp=1, **knobs)
    jseq_prompt = _prompt(33, 16)
    from llm_d_kv_cache_manager_tpu.server import SamplingParams as JSP

    donor.add_request(jseq_prompt, JSP(max_new_tokens=1))
    donor.run_until_complete()
    hashes = donor.block_manager.token_db.prefix_hashes(jseq_prompt)
    chain = donor.export_kv_blocks(hashes)
    from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer.protocol import BlockPayload as TPayload

    tchain = [TPayload(**{f: getattr(b, f) for f in TPayload.__dataclass_fields__}) for b in chain]
    wires = []
    for torch_side, tp in ((True, 1), (True, TP), (False, TP)):
        eng = _engine(torch_side, tp=tp, **knobs)
        assert eng.import_kv_blocks(list(tchain if torch_side else chain)) == len(chain)
        out = eng.export_kv_blocks(hashes)
        wires.append([(b.k_data, b.v_data, b.k_scale, b.v_scale, b.dtype, tuple(b.shape), b.quant)
                      for b in out])
    assert wires[0] == wires[1] == wires[2]


def _demote_rounds(eng, torch_side, n=4):
    from llm_d_kv_cache_manager_tpu.server import SamplingParams as JSP
    from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams as TSP

    out = []
    for i in range(n):
        seq = eng.add_request(_prompt(60 + i, 16), (TSP if torch_side else JSP)(max_new_tokens=4))
        eng.run_until_complete()
        out.append([int(t) for t in seq.generated_tokens])
    return out


@pytest.mark.parametrize("host_pages", [0, 2], ids=["hbm", "host_lru"])
def test_tp2_remote_tier_demotes_like_jax_tp2(host_pages):
    """The remote tier at tp=2: the same blocks demoted in the same order as
    JAX's tp=2 engine, whole-head payloads within 1e-5 of JAX's, the same
    greedy tokens and event bytes."""
    from llm_d_kv_cache_manager_tpu.kvcache.kvevents.events import EventBatch as JB
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents.events import EventBatch as TB

    kw = dict(host_pages=host_pages, host_tier_policy="always") if host_pages else {}
    got = {}
    for torch_side in (True, False):
        events = []
        eng = _engine(torch_side, total_pages=12, remote_tier=True,
                      on_events=lambda evs, e=events: e.append(list(evs)), **kw)
        payloads = []
        eng.on_demotion = payloads.extend
        tokens = _demote_rounds(eng, torch_side, n=5 if host_pages else 4)
        assert payloads and eng.remote_stats["demoted_blocks"] == len(payloads)
        batch = TB if torch_side else JB
        got[torch_side] = (payloads, tokens, [batch(ts=0.0, events=e).to_payload() for e in events])
    (t, t_tok, t_ev), (j, j_tok, j_ev) = got[True], got[False]
    assert t_tok == j_tok and t_ev == j_ev
    assert [(b.block_hash, b.parent_block_hash, b.token_ids, tuple(b.shape)) for b in t] == [
        (b.block_hash, b.parent_block_hash, b.token_ids, tuple(b.shape)) for b in j]
    for a, b in zip(t, j):
        np.testing.assert_allclose(np.frombuffer(a.k_data + a.v_data, np.float32),
                                   np.frombuffer(b.k_data + b.v_data, np.float32), **POOL)


def test_tp2_demote_and_pull_back_serves_the_same_tokens():
    """Blocks a tp=2 engine demoted into a remote store come back through
    ``import_kv_blocks`` and serve the tokens the never-evicting engine
    served."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer import RemoteBlockStore, RemoteStoreConfig
    from llm_d_kv_cache_manager_tpu_torch.models import quant

    want = _demote_rounds(_engine(True, total_pages=64), True, n=5)
    eng = _engine(True, total_pages=12, remote_tier=True)
    cfg = eng.model_cfg
    shape = (cfg.n_layers, PS, cfg.n_kv_heads, cfg.hd)
    store = RemoteBlockStore(RemoteStoreConfig(
        capacity_pages=256, page_size=PS, page_shape=shape, dtype="float32",
        scale_bytes=int(np.prod(quant.kv_scale_shape(shape))) * 4,
        init_hash=eng.block_manager.token_db.init_hash))
    eng.on_demotion = store.accept
    assert _demote_rounds(eng, True, n=5) == want
    hashes = eng.block_manager.token_db.prefix_hashes(_prompt(60, 16))
    served = store.serve(hashes)
    assert served and eng.import_kv_blocks(served) == len(served)
    seq = _serve(eng, _prompt(60, 16))
    assert seq.num_cached_prompt >= PS and list(seq.generated_tokens) == want[0]
