"""The port's int8 KV pages in device memory (``KV_QUANT_HBM=int8``) against
the JAX package's, on the CPU, from numpy seeds:

- (a) ``paged_attention`` with scales against the JAX ``paged_attention``
  (its Pallas kernel in interpret mode) on the shapes of
  ``test_kv_quant_hbm.py::TestQuantizedDecodeKernel``, at its 2e-5;
- (b) ``_quantized_scatter_kv_all_layers`` against JAX's, codes and scales
  bit-equal: fresh pages over a previous tenant's scales, a carry page
  whose scale grows, one whose scale stays (its codes unchanged), and
  right-padded invalid rows dropped;
- (c) ``prefill_with_paged_context`` with scales against JAX's;
- (d) ``prefill`` and ``decode_step`` of TINY_LLAMA and TINY_QWEN3_MOE
  (float32) on int8 pools against JAX ``prefill(attn_impl="xla")`` and
  ``decode_step(interpret=True)``: logits within 1e-4, int8 codes
  bit-equal, scales within rtol 1e-6. The two frameworks' float32 matmuls
  sum in different orders, so the K/V a layer writes differ in their last
  bits (the reason ``test_torch_llama.py`` holds bf16 pools at 1e-5); a
  scale is one such value's magnitude over 127 and differs by a few ulps
  (up to 5e-7 relative here), while the codes come out the same. (b)
  holds the arithmetic itself bit for bit on shared inputs;
- (e) the engine's scope checks, (f) the pod's env knobs, (g)
  ``kv_pools_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.models import quant as jq
from llm_d_kv_cache_manager_tpu.ops import attention as j_attention
from llm_d_kv_cache_manager_tpu.ops.paged_attention import paged_attention as j_paged_attention
from llm_d_kv_cache_manager_tpu_torch import ops as t_ops
from llm_d_kv_cache_manager_tpu_torch.models import convert as t_convert
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import quant as t_quant
from llm_d_kv_cache_manager_tpu_torch.server import Engine, EngineConfig

PS = 4
ATTN = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(atol=1e-4, rtol=1e-4)
SCALES = dict(atol=0, rtol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quantized_pool(rng, n_layers, total_pages, n_kv, hd):
    """Random int8 codes and scales, as the JAX suite makes them."""
    codes = rng.integers(-127, 128, (n_layers, total_pages, PS, n_kv, hd)).astype(np.int8)
    scales = rng.uniform(0.01, 0.2, (n_layers, total_pages, n_kv)).astype(np.float32)
    return codes, scales


# -- (a) decode attention over int8 pages --------------------------------------
def _decode_case(name):
    """(codes, scales, q, block tables, seq lens, fresh K/V or None, layers)
    of one ``TestQuantizedDecodeKernel`` shape."""
    if name == "gqa_single_layer":
        rng = np.random.default_rng(0)
        codes, scales = _quantized_pool(rng, 1, 16, 2, 8)
        q = rng.standard_normal((3, 8, 8)).astype(np.float32)
        bt = rng.integers(1, 16, (3, 4)).astype(np.int32)
        return codes[0], scales[0], q, bt, np.asarray([5, 16, 9], np.int32), None, [0]
    if name == "multi_layer_operand":
        rng = np.random.default_rng(1)
        codes, scales = _quantized_pool(rng, 3, 12, 2, 8)
        q = rng.standard_normal((2, 4, 8)).astype(np.float32)
        bt = rng.integers(1, 12, (2, 3)).astype(np.int32)
        return codes, scales, q, bt, np.asarray([7, 12], np.int32), None, [0, 2]
    rng = np.random.default_rng(2)
    codes, scales = _quantized_pool(rng, 1, 16, 2, 8)
    q = rng.standard_normal((3, 4, 8)).astype(np.float32)
    fresh = (rng.standard_normal((3, 2, 8)).astype(np.float32),
             rng.standard_normal((3, 2, 8)).astype(np.float32))
    bt = rng.permutation(np.arange(1, 16))[:12].reshape(3, 4).astype(np.int32)
    return codes[0], scales[0], q, bt, np.asarray([6, 11, 16], np.int32), fresh, [0]


@pytest.mark.parametrize("name", ["gqa_single_layer", "multi_layer_operand", "has_fresh"])
def test_paged_attention_with_scales_matches_jax(name):
    codes, scales, q, bt, sl, fresh, layers = _decode_case(name)
    fresh = fresh or (None, None)
    for layer in layers:
        jout = j_paged_attention(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(codes), jnp.asarray(bt), jnp.asarray(sl),
            *(None if f is None else jnp.asarray(f) for f in fresh),
            k_scale=jnp.asarray(scales), v_scale=jnp.asarray(scales), interpret=True, layer=layer,
        )
        tout = t_ops.paged_attention(
            _t(q), _t(codes), _t(codes), _t(bt), _t(sl),
            *(None if f is None else _t(f) for f in fresh),
            k_scale=_t(scales), v_scale=_t(scales), layer=layer,
        )
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN)


def test_paged_attention_scales_must_come_together():
    codes, scales, q, bt, sl, _, _ = _decode_case("gqa_single_layer")
    with pytest.raises(ValueError, match="together"):
        t_ops.paged_attention(_t(q), _t(codes), _t(codes), _t(bt), _t(sl), k_scale=_t(scales))


def test_plain_version_reads_the_dequantized_pool():
    """The plain version over int8 codes equals itself over the pool
    ``dequantize_kv_pool`` widens to float32 (the card check's oracle)."""
    codes, scales, q, bt, sl, (fk, fv), _ = _decode_case("has_fresh")
    wide = t_quant.dequantize_kv_pool(_t(codes), _t(scales), torch.float32)
    np.testing.assert_array_equal(wide.numpy(), jq.dequantize_kv_pool(codes, scales, np.float32))
    args = (_t(bt), _t(sl), _t(fk), _t(fv))
    out = t_ops.paged_attention_reference(_t(q), _t(codes), _t(codes), *args,
                                          k_scale=_t(scales), v_scale=_t(scales))
    ref = t_ops.paged_attention_reference(_t(q), wide, wide, *args)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


# -- (b) the write-time quantizing scatter --------------------------------------
def _scatter_both(pages, scales, fresh, page_ids, slot_ids, valid, positions, torch_valid="same"):
    jq_pages, j_scales = jl._quantized_scatter_kv_all_layers(
        *map(jnp.asarray, (pages, scales, fresh, page_ids, slot_ids, valid, positions))
    )
    tp, ts = _t(pages.copy()), _t(scales.copy())
    tv = _t(valid) if torch_valid == "same" else None
    out = tl._quantized_scatter_kv_all_layers(tp, ts, _t(fresh), _t(page_ids), _t(slot_ids), tv, _t(positions))
    assert out[0] is tp and out[1] is ts  # written in place
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jq_pages))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(j_scales))
    return tp.numpy(), ts.numpy()


def test_scatter_fresh_pages_reset_a_previous_tenants_scale_and_drop_invalid_rows():
    rng = np.random.default_rng(10)
    L, P, n_kv, hd = 2, 12, 2, 8
    pages, scales = _quantized_pool(rng, L, P, n_kv, hd)
    scales *= 50  # a previous tenant's large scales
    b, s = 3, 8
    fresh = rng.standard_normal((L, b, s, n_kv, hd)).astype(np.float32)
    page_ids = np.asarray([[1] * 4 + [2] * 4, [5] * 4 + [6] * 4, [0] * 8], np.int32)
    slot_ids = np.tile(np.arange(s) % PS, (b, 1)).astype(np.int32)
    valid = np.zeros((b, s), bool)
    valid[0, :8], valid[1, :5] = True, True  # row 1 right-padded, row 2 empty
    positions = np.tile(np.arange(s), (b, 1)).astype(np.int32)
    tp, ts = _scatter_both(pages, scales, fresh, page_ids, slot_ids, valid, positions)
    assert (ts[:, [1, 2, 5, 6]] < scales[:, [1, 2, 5, 6]]).all()  # reset, not kept
    np.testing.assert_array_equal(tp[:, 6, 1:], pages[:, 6, 1:])  # padded tokens dropped
    np.testing.assert_array_equal(tp[:, 0], pages[:, 0])
    np.testing.assert_array_equal(ts[:, 0], scales[:, 0])


@pytest.mark.parametrize("grows", [True, False], ids=["scale_grows", "scale_stays"])
def test_scatter_decode_write_into_a_carry_page(grows):
    """A decode write at slot 2 of a live page (the carry page) beside one
    into a fresh page and a padded lane (page 0, position 0). When the
    token's magnitude raises the page's scale, the resident codes are
    requantized with ``s_old / s_new``; when it does not, they stay bit
    for bit. The port's decode call passes no mask (every row valid)."""
    rng = np.random.default_rng(11 if grows else 12)
    L, P, n_kv, hd = 2, 10, 2, 8
    pages, scales = _quantized_pool(rng, L, P, n_kv, hd)
    amp = 100.0 if grows else 1e-3
    fresh = (rng.standard_normal((L, 3, 1, n_kv, hd)) * amp).astype(np.float32)
    page_ids = np.asarray([[3], [7], [0]], np.int32)
    positions = np.asarray([[6], [8], [0]], np.int32)  # slot 2 carry, slot 0 fresh
    slot_ids = positions % PS
    valid = np.ones((3, 1), bool)
    for torch_valid in ("same", None):
        tp, ts = _scatter_both(pages, scales, fresh, page_ids, slot_ids, valid, positions, torch_valid)
    if grows:
        assert (ts[:, 3] > scales[:, 3]).all()
        assert (tp[:, 3, :2] != pages[:, 3, :2]).any()
    else:
        np.testing.assert_array_equal(ts[:, 3], scales[:, 3])
        np.testing.assert_array_equal(tp[:, 3, :2], pages[:, 3, :2])
        np.testing.assert_array_equal(tp[:, 3, 3:], pages[:, 3, 3:])


def test_scatter_in_layer_chunks_matches_one_pass(monkeypatch):
    """Long writes quantize a few layers at a time; the result is the same
    bit for bit."""
    rng = np.random.default_rng(13)
    L, P, n_kv, hd = 3, 8, 2, 8
    pages, scales = _quantized_pool(rng, L, P, n_kv, hd)
    fresh = rng.standard_normal((L, 2, 6, n_kv, hd)).astype(np.float32)
    page_ids = np.asarray([[1, 1, 2, 2, 2, 2], [4, 4, 5, 5, 5, 5]], np.int32)
    positions = np.tile(np.arange(2, 8), (2, 1)).astype(np.int32)
    valid = np.ones((2, 6), bool)
    monkeypatch.setattr(tl, "_QUANT_CHUNK_BYTES", 1)
    _scatter_both(pages, scales, fresh, page_ids, positions % PS, valid, positions)


# -- (c) prefill attention over widened int8 context ----------------------------
def test_prefill_with_paged_context_widens_like_jax():
    rng = np.random.default_rng(20)
    b, s, n_q, n_kv, hd, P = 2, 6, 4, 2, 8, 10
    pages, scales = _quantized_pool(rng, 1, P, n_kv, hd)
    q = rng.standard_normal((b, s, n_q, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    bt = np.asarray([[3, 7, 2], [5, 0, 0]], np.int32)
    ctx = np.asarray([12, 4], np.int32)
    positions = ctx[:, None] + np.arange(s)[None]
    valid = np.arange(s)[None] < np.asarray([6, 3])[:, None]
    jout = j_attention.prefill_with_paged_context(
        *map(jnp.asarray, (q, k, v, pages[0], pages[0], bt, ctx)),
        positions=jnp.asarray(positions), valid=jnp.asarray(valid),
        k_scales=jnp.asarray(scales[0]), v_scales=jnp.asarray(scales[0]),
    )
    tout = t_ops.prefill_with_paged_context(
        *map(_t, (q, k, v, pages[0], pages[0], bt, ctx)),
        positions=_t(positions), valid=_t(valid), k_scales=_t(scales[0]), v_scales=_t(scales[0]),
    )
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN)
    wide = t_ops.widen_paged_context(_t(pages[0]), _t(scales[0]), _t(bt), torch.float32)
    np.testing.assert_array_equal(
        wide.numpy(), jq.dequantize_kv_pool(pages[0], scales[0], np.float32)[bt]
    )


# -- (d) the model on int8 pools --------------------------------------------------
@pytest.fixture(params=["TINY_LLAMA", "TINY_QWEN3_MOE"], scope="module")
def model(request):
    jcfg, tcfg = getattr(jl, request.param), getattr(tl, request.param)
    jp = jl.init_params(jax.random.PRNGKey(7), jcfg)
    return jcfg, tcfg, jp, t_convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


class _QuantPools:
    """int8 pools and scales of both frameworks, kept in step."""

    def __init__(self, jcfg, tcfg, pages):
        self.j = list(jl.init_kv_pages(jcfg, pages, PS, kv_quant_hbm="int8")) + list(
            jl.init_kv_scales(jcfg, pages))
        self.t = list(tl.init_kv_pages(tcfg, pages, PS, "cpu", kv_quant_hbm="int8")) + list(
            tl.init_kv_scales(tcfg, pages, "cpu"))
        assert self.t[0].dtype == torch.int8 and self.t[2].shape == (tcfg.n_layers, pages, tcfg.n_kv_heads)

    def assert_equal(self):
        for t, j in zip(self.t[:2], self.j[:2]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        for t, j in zip(self.t[2:], self.j[2:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **SCALES)


def _quant_prefill(m, pools, tokens, starts, lens, tables, s):
    jcfg, tcfg, jp, tp = m
    b = len(lens)
    tok = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    valid = np.zeros((b, s), bool)
    for i, (st, n) in enumerate(zip(starts, lens)):
        tok[i, :n] = tokens[i][st : st + n]
        pos[i, :n] = np.arange(st, st + n)
        valid[i, :n] = True
    tables = np.asarray(tables, np.int32)
    page_ids = np.where(valid, np.take_along_axis(tables, pos // PS, axis=1), 0).astype(np.int32)
    slot_ids = pos % PS
    n_ctx = max(st // PS for st in starts)
    ctx_bt = np.zeros((b, n_ctx), np.int32)
    for i, st in enumerate(starts):
        ctx_bt[i, : st // PS] = tables[i, : st // PS]
    ctx_lens = np.asarray(starts, np.int32)
    jk, jv, jks, jvs = pools.j
    jlog, *pools.j = jl.prefill(
        jp, jcfg, *map(jnp.asarray, (tok, pos, valid)), jk, jv,
        *map(jnp.asarray, (page_ids, slot_ids, ctx_bt, ctx_lens)), attn_impl="xla",
        k_scales=jks, v_scales=jvs,
    )
    tk, tv, tks, tvs = pools.t
    tlog, *out = tl.prefill(
        tp, tcfg, *map(_t, (tok, pos, valid)), tk, tv, *map(_t, (page_ids, slot_ids, ctx_bt, ctx_lens)),
        k_scales=tks, v_scales=tvs,
    )
    assert all(a is b for a, b in zip(out, pools.t))
    return jlog, tlog


def test_model_prefill_chunks_then_decode_on_int8_pools(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(21)
    tokens = [rng.integers(0, jcfg.vocab_size, 24).astype(np.int32) for _ in range(2)]
    tables = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    pools = _QuantPools(jcfg, tcfg, 16)
    # Cold chunk, then a page-aligned second chunk that reads the first
    # chunk's int8 pages as context (one row cold, one padded row).
    for starts, lens in (([0, 0, 0], [8, 5, 0]), ([8, 0, 0], [7, 0, 0])):
        jlog, tlog = _quant_prefill(model, pools, tokens + [tokens[0]], starts, lens, tables + [[0] * 6], 8)
        np.testing.assert_allclose(tlog[: len(tokens)].numpy(), np.asarray(jlog)[: len(tokens)], **LOGITS)
        pools.assert_equal()
    # Decode: row 0 writes slot 3 of a live page (carry), row 1 slot 1, a
    # padded lane writes page 0.
    bt = np.asarray([tables[0][:5], tables[1][:5], [0] * 5], np.int32)
    pos = np.asarray([15, 5, 0], np.int32)
    tok = np.asarray([tokens[0][15], tokens[1][5], 0], np.int32)
    for step in range(3):
        sl = np.where(np.arange(3) < 2, pos + 1, 0).astype(np.int32)
        jk, jv, jks, jvs = pools.j
        jlog, *pools.j = jl.decode_step(
            jp, jcfg, *map(jnp.asarray, (tok, pos)), jk, jv, *map(jnp.asarray, (bt, sl)),
            page_size=PS, interpret=True, k_scales=jks, v_scales=jvs,
        )
        tk, tv, tks, tvs = pools.t
        tlog, *out = tl.decode_step(
            tp, tcfg, _t(tok), _t(pos), tk, tv, _t(bt), _t(sl), page_size=PS,
            k_scales=tks, v_scales=tvs,
        )
        assert len(out) == 4
        np.testing.assert_allclose(tlog[:2].numpy(), np.asarray(jlog)[:2], **LOGITS)
        pools.assert_equal()
        tok = np.asarray(np.argmax(np.asarray(jlog), -1), np.int32)
        tok[2] = 0
        pos = np.where(np.arange(3) < 2, pos + 1, 0).astype(np.int32)


def test_model_scales_must_come_together(model):
    _, tcfg, _, tp = model
    k, v = tl.init_kv_pages(tcfg, 4, PS, "cpu", kv_quant_hbm="int8")
    ks, _ = tl.init_kv_scales(tcfg, 4, "cpu")
    z = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        tl.decode_step(tp, tcfg, z, z, k, v, torch.zeros((1, 1), dtype=torch.int32), z + 1,
                       page_size=PS, k_scales=ks)


# -- (e) scope, (f) env knobs, (g) pool carry-over --------------------------------
def test_engine_scope_checks():
    assert t_quant.KV_QUANT_HBM_MODES == jq.KV_QUANT_HBM_MODES
    with pytest.raises(ValueError, match="unknown kv_quant_hbm"):
        Engine(EngineConfig(kv_quant_hbm="int4"), device="cpu")
    with pytest.raises(NotImplementedError, match="float8_e4m3"):
        Engine(EngineConfig(kv_quant_hbm="float8_e4m3"), device="cpu")
    off = Engine(EngineConfig(), device="cpu")
    assert off.k_pages.dtype == torch.float32 and off.k_scales is None and off.v_scales is None
    on = Engine(EngineConfig(kv_quant_hbm="int8"), device="cpu")
    assert on.k_pages.dtype == torch.int8
    assert on.k_scales.shape == t_quant.kv_hbm_scale_shape(tuple(on.k_pages.shape))
    assert tuple(on.k_scales.shape) == jq.kv_hbm_scale_shape(tuple(on.k_pages.shape))


def test_env_knobs_reach_the_engine_config(monkeypatch):
    from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServerConfig

    cfg = PodServerConfig.from_env()
    assert cfg.engine.kv_quant_hbm is None and cfg.engine.scheduler.chunked_prefill_tokens is None
    monkeypatch.setenv("KV_QUANT_HBM", "int8")
    monkeypatch.setenv("CHUNKED_PREFILL_TOKENS", "512")
    cfg = PodServerConfig.from_env()
    assert cfg.engine.kv_quant_hbm == "int8" and cfg.engine.scheduler.chunked_prefill_tokens == 512
    monkeypatch.setenv("CHUNKED_PREFILL_TOKENS", "0")
    assert PodServerConfig.from_env().engine.scheduler.chunked_prefill_tokens is None


def test_kv_pools_from_jax_round_trip():
    rng = np.random.default_rng(30)
    codes, scales = _quantized_pool(rng, 2, 6, 2, 8)
    out = t_convert.kv_pools_from_jax(codes, codes + 1, scales, scales * 2, device="cpu")
    for t, a in zip(out, (codes, codes + 1, scales, scales * 2)):
        assert t.dtype == {np.int8: torch.int8, np.float32: torch.float32}[a.dtype.type]
        np.testing.assert_array_equal(t.numpy(), a)
    jk, jv = jl.init_kv_pages(jl.TINY_LLAMA, 4, PS)
    k, v = t_convert.kv_pools_from_jax(np.asarray(jk), np.asarray(jv), device="cpu")
    assert k.dtype == torch.float32 and k.shape == tuple(jk.shape)
    with pytest.raises(ValueError, match="together"):
        t_convert.kv_pools_from_jax(codes, codes, scales, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        t_convert.kv_pools_from_jax(codes.astype(np.float32), codes.astype(np.float32), scales, scales, device="cpu")
