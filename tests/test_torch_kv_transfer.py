"""The port's cross-pod KV transfer (``Engine.kv_block_bytes``,
``export_kv_blocks``, ``import_kv_blocks`` and the flush's in-memory
restore sources) against the JAX engine's, on the CPU.

- ``tests/test_kv_transfer.py::TestExportImport``'s scenarios run on both
  engines (same parameters, same numpy-seeded prompts): what each import
  returned, ``transfer_stats``, the requests' tokens, cached prompt tokens
  and ``tokens_computed``, and every engine's events as msgpack bytes must
  be equal.
- Transfers across frameworks, both directions, through the wire
  (``encode_response`` of the exporter's package, ``decode_response`` of
  the importer's): warm tokens equal the importer's cold tokens, on
  float32 and bfloat16 pages, full-width and int8 wires. Where both
  engines hold the same numpy pages (written into both pools, or host
  slots), the two packages' wire bytes are equal.
- ``tests/test_kv_quant_hbm.py::TestMixedFleetTransfer``'s directions, on
  int8 pages, with exporter and importer in different frameworks.
- Flush windows that tangle imports with offloads and restores, and with
  each other into one page, leave pools and slots bit-equal to the JAX
  engine's movers on shared pages.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.kvcache.kvblock.token_processor import hash_block
from llm_d_kv_cache_manager_tpu.kvcache.kvevents.events import EventBatch as JEventBatch
from llm_d_kv_cache_manager_tpu.kvcache.transfer import protocol as j_proto
from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.models import quant as j_quant
from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu.server import SamplingParams as JSP
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents.events import EventBatch as TEventBatch
from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer import protocol as t_proto
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import params_from_jax
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams as TSP
from test_torch_engine import _params, _prompt
from test_torch_host_tier import TIERS, _fill, _Side, engine_config

PS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _bf16_params():
    """TINY_LLAMA in bfloat16: JAX's parameters and their port."""
    jcfg = dataclasses.replace(jl.TINY_LLAMA, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tl.TINY_LLAMA, dtype=torch.bfloat16)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


class _Eng:
    """One framework's TINY_LLAMA engine (pages of 4, prefill batch 4, 4
    lanes) with its events, ``dtype`` "float32" or "bfloat16"."""

    def __init__(self, torch_side, dtype="float32", total_pages=64, hash_seed="", **knobs):
        self.torch_side = torch_side
        self.events = []
        sink = lambda evs: self.events.append(list(evs))  # noqa: E731
        knobs.setdefault("host_tier_policy", "auto")
        config = engine_config(torch_side, total_pages=total_pages, **knobs)
        config.block_manager = dataclasses.replace(config.block_manager, hash_seed=hash_seed)
        if dtype == "bfloat16":
            config.model = dataclasses.replace(
                config.model, dtype=torch.bfloat16 if torch_side else jnp.bfloat16)
            params = _bf16_params()
        else:
            params = _params("TINY_LLAMA")
        if torch_side:
            self.SP, self.proto, self.batch_cls = TSP, t_proto, TEventBatch
            self.eng = TEngine(config, params=params[1], on_events=sink, device="cpu")
        else:
            self.SP, self.proto, self.batch_cls = JSP, j_proto, JEventBatch
            self.eng = JEngine(config, params=params[0], on_events=sink)

    def serve(self, prompt, new_tokens):
        seq = self.eng.add_request(prompt, self.SP(max_new_tokens=new_tokens))
        self.eng.run_until_complete()
        return seq

    def export(self, prompt, max_blocks=None):
        return self.eng.export_kv_blocks(self.eng.block_manager.token_db.prefix_hashes(prompt),
                                         max_blocks)

    def event_bytes(self):
        return [self.batch_cls(ts=0.0, events=evs).to_payload() for evs in self.events]


def _fake_block(proto, h, parent, token_ids, shape=(2, PS, 2, 8), dtype="float32"):
    data = np.zeros(int(np.prod(shape)), np.dtype(dtype)).tobytes()
    return proto.BlockPayload(block_hash=h, parent_block_hash=parent, token_ids=list(token_ids),
                              block_size=len(token_ids), dtype=dtype, shape=shape,
                              k_data=data, v_data=data)


def _seq_obs(seq):
    return (list(seq.output_tokens), seq.num_cached_prompt)


# -- TestExportImport's scenarios: each returns what it observed -------------
def import_parity(mk):
    prefix, suffix = _prompt(0, 16), _prompt(1, 5)
    prompt = prefix + suffix
    warm = mk()
    warm.serve(prefix, 2)
    blocks = warm.export(prompt)
    assert blocks[0].parent_block_hash is None
    assert all(b.parent_block_hash == a.block_hash for a, b in zip(blocks, blocks[1:]))
    ref, cold = mk(), mk()
    s_ref = ref.serve(prompt, 6)
    n = cold.eng.import_kv_blocks(blocks)
    s = cold.serve(prompt, 6)
    assert s.output_tokens == s_ref.output_tokens and s.num_cached_prompt == len(prefix)
    assert cold.eng.prefill_stats["tokens_computed"] == len(suffix)
    return [n, len(blocks), _seq_obs(s), cold.eng.prefill_stats["tokens_computed"]], [warm, cold]


def partial_chain(mk):
    prefix = _prompt(2, 8)
    prompt = prefix + _prompt(3, 12)
    warm = mk()
    warm.serve(prefix, 2)
    blocks = warm.export(prompt)
    assert len(blocks) == len(prefix) // PS
    ref, cold = mk(), mk()
    s_ref = ref.serve(prompt, 5)
    n = cold.eng.import_kv_blocks(blocks)
    s = cold.serve(prompt, 5)
    assert s.output_tokens == s_ref.output_tokens and s.num_cached_prompt == len(prefix)
    return [n, _seq_obs(s)], [warm, cold]


def max_blocks_cap(mk):
    prefix = _prompt(4, 16)
    warm = mk()
    warm.serve(prefix, 2)
    blocks = warm.export(prefix, max_blocks=2)
    assert len(blocks) == 2
    return [len(blocks), dict(warm.eng.transfer_stats)], [warm]


def chain_gap(mk):
    prefix = _prompt(5, 16)
    warm = mk()
    warm.serve(prefix, 2)
    blocks = warm.export(prefix)
    cold = mk()
    n = cold.eng.import_kv_blocks(blocks[1:])
    assert n == 0 and cold.eng.transfer_stats["import_rejected"] == 1
    s = cold.serve(prefix, 3)
    return [n, dict(cold.eng.transfer_stats), _seq_obs(s)], [warm, cold]


def tampered_hash(mk):
    prefix = _prompt(30, 8)
    warm = mk()
    warm.serve(prefix, 2)
    blocks = warm.export(prefix)
    blocks[0].token_ids = list(blocks[0].token_ids)
    blocks[0].token_ids[0] ^= 1
    cold = mk()
    n = cold.eng.import_kv_blocks(blocks)
    misaligned = mk(hash_seed="other-seed")
    m = misaligned.eng.import_kv_blocks(warm.export(prefix))
    assert n == 0 and m == 0 and misaligned.eng.block_manager.num_cached_pages == 0
    return [n, m, dict(cold.eng.transfer_stats), dict(misaligned.eng.transfer_stats)], [warm]


def wrong_geometry(mk):
    cold = mk()
    cfg = cold.eng.model_cfg
    good = (cfg.n_layers, PS, cfg.n_kv_heads, cfg.hd)
    proto = cold.proto
    bad = [
        _fake_block(proto, 1, None, range(PS), shape=(1, PS, 1, 4)),
        _fake_block(proto, 2, None, range(PS), shape=good, dtype="float64"),
        _fake_block(proto, 3, None, range(PS + 1), shape=good),
    ]
    ns = [cold.eng.import_kv_blocks([blk]) for blk in bad]
    assert ns == [0, 0, 0] and cold.eng.transfer_stats["imported_blocks"] == 0
    return [ns, dict(cold.eng.transfer_stats)], [cold]


def pool_exhaustion(mk):
    prefix = _prompt(6, 32)
    warm = mk()
    warm.serve(prefix, 2)
    blocks = warm.export(prefix)
    cold = mk(total_pages=6)
    n = cold.eng.import_kv_blocks(blocks)
    assert (len(blocks), n, cold.eng.block_manager.num_cached_pages) == (8, 5, 5)
    return [n, cold.eng.block_manager.num_free], [warm, cold]


def reimport(mk):
    prefix = _prompt(7, 12)
    warm = mk()
    warm.serve(prefix, 2)
    blocks = warm.export(prefix)
    cold = mk()
    ns = [cold.eng.import_kv_blocks(blocks), cold.eng.import_kv_blocks(blocks)]
    assert ns == [len(blocks), 0] and cold.eng.block_manager.num_cached_pages == len(blocks)
    return [ns], [warm, cold]


def block_stored_events(mk):
    prefix = _prompt(8, 12)
    warm = mk()
    warm.serve(prefix, 2)
    blocks = warm.export(prefix)
    cold = mk()
    cold.eng.import_kv_blocks(blocks)
    stored = [h for evs in cold.events for ev in evs for h in ev.block_hashes]
    assert stored == [b.block_hash for b in blocks]
    return [stored], [warm, cold]


SCENARIOS = {fn.__name__: fn for fn in (
    import_parity, partial_chain, max_blocks_cap, chain_gap, tampered_hash, wrong_geometry,
    pool_exhaustion, reimport, block_stored_events)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_export_import_parity(name):
    """Each scenario on JAX engines and on torch engines: equal
    observations, and each engine's events equal as msgpack bytes."""
    runs = [SCENARIOS[name](functools.partial(_Eng, torch_side)) for torch_side in (False, True)]
    (jobs, jengs), (tobs, tengs) = runs
    assert tobs == jobs
    assert [e.event_bytes() for e in tengs] == [e.event_bytes() for e in jengs]


# -- across frameworks, through the wire --------------------------------------
KNOBS = {"fp": {}, "int8_wire": {"kv_quant": "int8"}, "int8_pages": {"kv_quant_hbm": "int8"}}
#: (page dtype, exporter's knobs, importer's knobs): full-width and int8
#: wires into full-width pools, and TestMixedFleetTransfer's directions
#: (int8 pages to a full-width pool, full-width and int8 wires to int8
#: pages), plus int8 pages to int8 pages
PULLS = [
    ("float32", "fp", "fp"), ("float32", "int8_wire", "fp"), ("float32", "int8_pages", "fp"),
    ("float32", "fp", "int8_pages"), ("float32", "int8_wire", "int8_pages"),
    ("float32", "int8_pages", "int8_pages"),
    ("bfloat16", "fp", "fp"), ("bfloat16", "int8_wire", "fp"),
    ("bfloat16", "int8_pages", "int8_pages"),
]
MIXED_PROMPT = _prompt(200, 24)


@functools.lru_cache(maxsize=None)
def _wire(torch_side, dtype, knobs):
    """The exporter's wire bytes of MIXED_PROMPT's chain after serving it."""
    e = _Eng(torch_side, dtype, **KNOBS[knobs])
    e.serve(MIXED_PROMPT, 4)
    blocks = e.export(MIXED_PROMPT)
    assert blocks and all((b.quant == "int8") == (knobs != "fp") for b in blocks)
    assert all(b.dtype == dtype for b in blocks)
    if knobs == "int8_pages":
        # The stored codes: a byte an element, scales in the slots' layout.
        assert len(blocks[0].k_data) == int(np.prod(blocks[0].shape))
        assert len(blocks[0].k_scale) == 4 * int(np.prod(j_quant.kv_scale_shape(tuple(blocks[0].shape))))
    assert e.eng.kv_block_bytes == len(blocks[0].k_data + blocks[0].v_data
                                       + blocks[0].k_scale + blocks[0].v_scale)
    return e.proto.encode_response(blocks, True), len(blocks)


@functools.lru_cache(maxsize=None)
def _cold(torch_side, dtype, knobs):
    return list(_Eng(torch_side, dtype, **KNOBS[knobs]).serve(MIXED_PROMPT, 4).output_tokens)


@pytest.mark.parametrize("importer", ["torch", "jax"])
@pytest.mark.parametrize("dtype,src,dst", PULLS, ids=[f"{d}-{s}-to-{t}" for d, s, t in PULLS])
def test_pull_across_frameworks(importer, dtype, src, dst):
    """The other framework exports, the wire carries it, the importer
    installs it: warm greedy tokens equal the importer's own cold ones, and
    the warm request prefilled only the pages it lacked."""
    torch_importer = importer == "torch"
    wire, n = _wire(not torch_importer, dtype, src)
    dst_eng = _Eng(torch_importer, dtype, **KNOBS[dst])
    blocks, complete, err = dst_eng.proto.decode_response(wire)
    assert err is None and complete and len(blocks) == n
    assert dst_eng.eng.import_kv_blocks(blocks) == n
    s = dst_eng.serve(MIXED_PROMPT, 4)
    # Every imported page hits but the one holding the last prompt token,
    # which is recomputed.
    cached = min(n, (len(MIXED_PROMPT) - 1) // PS) * PS
    assert s.num_cached_prompt == cached
    assert dst_eng.eng.prefill_stats["tokens_computed"] == len(MIXED_PROMPT) - cached
    assert s.output_tokens == _cold(torch_importer, dtype, dst)


def _random_like(shape, dtype, rng, scale_pool=False):
    if "int8" in str(dtype):
        return rng.integers(-127, 128, shape).astype(np.int8)
    return (np.abs(rng.standard_normal(shape)) * (0.05 if scale_pool else 1.0)).astype(np.float32)


def _chain(seed, n, parent=None, init=None):
    """``n`` payload-less chain links ``(hash, parent, tokens)`` from a
    seed; ``init`` is the root hash (the engines' ``token_db.init_hash``)."""
    rng = np.random.default_rng(seed)
    out, prev = [], parent
    for _ in range(n):
        tokens = [int(t) for t in rng.integers(0, 1000, PS)]
        h = hash_block(prev if prev is not None else init, tokens)
        out.append((h, prev, tokens))
        prev = h
    return out


def _blocks(proto, links, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    out = []
    for h, parent, tokens in links:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        if dtype == "bfloat16":
            k, v = (torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy() for a in (k, v))
        out.append(proto.BlockPayload(block_hash=h, parent_block_hash=parent, token_ids=tokens,
                                      block_size=PS, dtype=dtype, shape=shape,
                                      k_data=k.tobytes(), v_data=v.tobytes()))
    return out


def _write_same_pages(jeng, teng, rng):
    """The same random contents in both engines' page pools and host slots
    (the port's written in place), bf16 rounded once, the same way."""
    pools = [t for t in (teng.k_pages, teng.v_pages, teng.k_scales, teng.v_scales) if t is not None]
    arrays = [_random_like(t.shape, t.dtype, rng, scale_pool=t.dim() == 3) for t in pools]
    for t, a in zip(pools, arrays):
        t.copy_(torch.from_numpy(a).to(t.dtype))
    jdt = jeng.k_pages.dtype
    jeng.k_pages, jeng.v_pages = (jnp.asarray(a, dtype=jdt) for a in arrays[:2])
    if len(arrays) == 4:
        jeng.k_scales, jeng.v_scales = jnp.asarray(arrays[2]), jnp.asarray(arrays[3])
    if teng.config.block_manager.host_pages:
        jslots = [jeng._host_k, jeng._host_v] + (
            [jeng._host_k_scale, jeng._host_v_scale] if jeng._host_int8 else [])
        for j, t in zip(jslots, teng._host_pools(), strict=True):
            a = _random_like(t.shape, t.dtype, rng, scale_pool=t.dtype == torch.float32 and teng._host_int8)
            j[...] = a
            t.copy_(torch.from_numpy(a).to(t.dtype))


@pytest.mark.parametrize("tier", ["hbm", "host"])
@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_bytes_equal_on_shared_pages(dtype, knobs, tier):
    """Two chains imported into both engines, the first spilled to the host
    tier by the second (``allow_evict``, the remote tier's import rule);
    then the same random pages in both engines' pools and slots. Each
    chain's export is the same wire bytes from either package: HBM pages
    gathered (and quantized, for an int8 wire) and host slots as stored."""
    host = dict(total_pages=5, host_pages=16, host_tier_policy="always") if tier == "host" else {}
    sides = [_Eng(torch_side, dtype, **host, **KNOBS[knobs]) for torch_side in (False, True)]
    cfg = sides[1].eng.model_cfg
    shape = (cfg.n_layers, PS, cfg.n_kv_heads, cfg.hd)
    init = sides[1].eng.block_manager.token_db.init_hash
    first, second = _chain(1, 4, init=init), _chain(2, 4, init=init)
    for s in sides:
        assert s.eng.import_kv_blocks(_blocks(s.proto, first, shape, dtype, 3)) == 4
        s.eng._flush_page_moves()
        assert s.eng.import_kv_blocks(_blocks(s.proto, second, shape, dtype, 4),
                                      allow_evict=tier == "host") == 4
        s.eng._flush_page_moves()
    j, t = sides
    if tier == "host":
        assert j.eng.block_manager.num_host_cached_pages == 4
        assert t.eng.block_manager.num_host_cached_pages == 4
    _write_same_pages(j.eng, t.eng, np.random.default_rng(5))
    for links in (first, second):
        hashes = [h for h, _, _ in links]
        wires = [s.proto.encode_response(s.eng.export_kv_blocks(hashes), True) for s in sides]
        assert wires[1] == wires[0]
        assert len(t.proto.decode_response(wires[1])[0]) == 4


# -- the movers on shared pages: imports tangled with offloads and restores ----
def _queue_import(side, links, blocks):
    """Import ``blocks`` and return the pages they got."""
    bm = side.eng.block_manager
    assert side.eng.import_kv_blocks(blocks) == len(blocks)
    return [bm._cached[h] for h, _, _ in links]


@pytest.mark.parametrize("wire", ["fp", "int8"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_movers_with_imports_match_jax_on_shared_pages(tier, wire):
    """Two flush windows on shared pages and slots, each queued the same
    way on both engines, then the pools and slots held bit-equal:

    1. a restore into the page the next import takes (the import, queued
       last, wins); a second import whose page is then offloaded (the
       offload reads the imported bytes, quantized for an int8 tier); a
       plain offload, and a restore of its slot (read from the device page);
    2. an import into a page a restore then targets (the slot, queued last,
       wins), offloaded in the same window (it reads that slot).

    An ``int8`` wire carries codes and scales: full-width pools dequantize
    them (on the device here, on the host in the JAX engine), int8 pools
    take them as they are."""
    jside = _Side(False, total_pages=8, host_pages=4, **TIERS[tier])
    tside = _Side(True, total_pages=8, host_pages=4, **TIERS[tier])
    _fill(jside, tside, np.random.default_rng(11))
    cfg = tside.eng.model_cfg
    shape = (cfg.n_layers, PS, cfg.n_kv_heads, cfg.hd)
    init = tside.eng.block_manager.token_db.init_hash
    links = _chain(21, 3, init=init)
    rng = np.random.default_rng(12)
    payloads = []
    for h, parent, tokens in links:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        extra = {}
        if wire == "int8":
            (k, ks), (v, vs) = j_quant.quantize_kv_page(k), j_quant.quantize_kv_page(v)
            extra = {"quant": "int8", "k_scale": ks.tobytes(), "v_scale": vs.tobytes()}
        payloads.append(dict(block_hash=h, parent_block_hash=parent, token_ids=tokens,
                             block_size=PS, dtype="float32", shape=shape,
                             k_data=k.tobytes(), v_data=v.tobytes(), **extra))
    for side in (jside, tside):
        proto = t_proto if side.torch_side else j_proto
        blocks = [proto.BlockPayload(**p) for p in payloads]
        eng = side.eng
        # Window 1.
        eng._restore_page(2, eng.block_manager._free[-1])
        a, b = _queue_import(side, links[:2], blocks[:2])
        eng._offload_page(b, 0)
        eng._offload_page(5, 1)
        eng._restore_page(1, 6)
        eng._flush_page_moves()
        # Window 2.
        (c,) = _queue_import(side, links[2:], blocks[2:])
        eng._restore_page(3, c)
        eng._offload_page(c, 2)
        eng._flush_page_moves()
        side.pages = (a, b, c)
    assert tside.pages == jside.pages
    for t, j in zip(tside.slots(), jside.slots(), strict=True):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tside.pools(), jside.pools(), strict=True):
        np.testing.assert_array_equal(t, j)
