"""The port's Llama forward (``models/llama.py``) against the JAX
package's, on the CPU, in float32: dense (TINY_LLAMA, TINY_GEMMA) and MoE
(TINY_MOE, TINY_QWEN3_MOE, each also with int8 weights and int8 expert
stacks, ``quantize="int8", quantize_experts=True``), and TINY_GEMMA with
int8 weights and an int8 embedding (the JAX ``quantize_params(...,
quantize_embed=True)``), which runs the port's quantized ``_embed`` and the
tied head through ``materialize``.

The JAX parameters are carried over with ``params_from_jax``; the same
token/page inputs go through both. Tolerances: logits atol = rtol = 1e-4
(two layers of float32 matmuls summed in different orders); K/V pools
1e-5; greedy tokens exact. The JAX decode runs its Pallas kernel in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.models import quant as jq
from llm_d_kv_cache_manager_tpu_torch.models import convert as t_convert
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import quant as t_quant

LOGITS = dict(atol=1e-4, rtol=1e-4)
POOL = dict(atol=1e-5, rtol=1e-5)
PS = 4
PAGES = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


MODELS = {
    "tiny-llama": ("TINY_LLAMA", None),
    "tiny-gemma": ("TINY_GEMMA", None),
    "tiny-moe": ("TINY_MOE", None),
    "tiny-qwen3-moe": ("TINY_QWEN3_MOE", None),
    "tiny-moe-int8": ("TINY_MOE", "int8"),
    "tiny-qwen3-moe-int8": ("TINY_QWEN3_MOE", "int8"),
    "tiny-gemma-int8-embed": ("TINY_GEMMA", "int8-embed"),
}


@pytest.fixture(params=list(MODELS), scope="module")
def models(request):
    preset, quantize = MODELS[request.param]
    jcfg, tcfg = getattr(jl, preset), getattr(tl, preset)
    if quantize == "int8-embed":
        jp = jq.quantize_params(jl.init_params(jax.random.PRNGKey(3), jcfg), quantize_embed=True)
        assert isinstance(jp["embed"], jq.QuantizedTensor)
    else:
        jp = jl.init_params(jax.random.PRNGKey(3), jcfg, quantize=quantize,
                            quantize_experts=quantize is not None)
    tp = t_convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Pools:
    """One pool per framework, kept in step."""

    def __init__(self, jcfg, tcfg):
        self.jk, self.jv = jl.init_kv_pages(jcfg, PAGES, PS)
        self.tk, self.tv = tl.init_kv_pages(tcfg, PAGES, PS, "cpu")

    def assert_equal(self):
        np.testing.assert_allclose(_np(self.tk), np.asarray(self.jk), **POOL)
        np.testing.assert_allclose(_np(self.tv), np.asarray(self.jv), **POOL)


def _prefill(m, pools, tokens, starts, lens, tables, s):
    """Run one prefill chunk through both models: row i holds tokens at
    positions starts[i] .. starts[i] + lens[i] - 1 (right-padded to s)."""
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
    page_ids = np.take_along_axis(tables, pos // PS, axis=1)
    slot_ids = pos % PS
    n_ctx = max(st // PS for st in starts)
    ctx_bt = np.zeros((b, n_ctx), np.int32)
    for i, st in enumerate(starts):
        ctx_bt[i, : st // PS] = tables[i, : st // PS]
    ctx_lens = np.asarray(starts, np.int32)
    jlog, pools.jk, pools.jv = jl.prefill(
        jp, jcfg, *map(jnp.asarray, (tok, pos, valid)), pools.jk, pools.jv,
        *map(jnp.asarray, (page_ids, slot_ids, ctx_bt, ctx_lens)), attn_impl="xla",
    )
    t = torch.from_numpy
    tlog, pools.tk, pools.tv = tl.prefill(
        tp, tcfg, t(tok), t(pos), t(valid), pools.tk, pools.tv,
        t(page_ids), t(slot_ids), t(ctx_bt), t(ctx_lens),
    )
    return jlog, tlog


def _scenario(m):
    rng = np.random.default_rng(5)
    jcfg = m[0]
    tokens = [rng.integers(0, jcfg.vocab_size, 24).astype(np.int32) for _ in range(2)]
    tables = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    return tokens, tables


def test_params_from_jax_round_trip(models):
    jcfg, tcfg, jp, tp = models
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == sum(1 for _ in _leaves(tp))
    for name in ("embed", "w_down"):
        t_leaf = tp[name] if name == "embed" else tp["layers"][1][name]
        j_leaf = jp[name] if name == "embed" else jp["layers"][1][name]
        for t, j in zip(_leaves(t_leaf), jax.tree.leaves(j_leaf), strict=True):
            np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_params_from_jax_bfloat16_through_uint16_view():
    cfg_j = jl.LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32,
                           n_layers=1, n_heads=2, n_kv_heads=1)
    cfg_t = tl.LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32,
                           n_layers=1, n_heads=2, n_kv_heads=1)
    jp = jl.init_params(jax.random.PRNGKey(0), cfg_j)  # bfloat16 leaves
    tp = t_convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg_t, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"][0]["wq"].float().numpy(),
        np.asarray(jp["layers"][0]["wq"], np.float32),
    )


def _leaves(tree):
    if isinstance(tree, t_quant.QuantizedTensor):
        yield from (tree.q, tree.scale)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_prefill_cold_then_warm_context(models):
    tokens, tables = _scenario(models)
    pools = _Pools(models[0], models[1])
    # Cold: ragged rows, right padding, no context table.
    jlog, tlog = _prefill(models, pools, tokens, [0, 0], [10, 7], tables, 16)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **LOGITS)
    pools.assert_equal()
    # Warm: row 0 attends 8 context tokens (2 pages), row 1 cold.
    jlog, tlog = _prefill(models, pools, tokens, [8, 0], [9, 5], tables, 16)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **LOGITS)
    pools.assert_equal()


def test_decode_step_and_greedy_decode_steps(models):
    jcfg, tcfg, jp, tp = models
    tokens, tables = _scenario(models)
    pools = _Pools(jcfg, tcfg)
    _prefill(models, pools, tokens, [0, 0], [10, 7], tables, 16)
    bt = np.asarray([t[:4] for t in tables] + [[0] * 4], np.int32)  # + padded lane
    tok = np.asarray([tokens[0][10], tokens[1][7], 0], np.int32)
    pos = np.asarray([10, 7, 0], np.int32)
    sl = np.asarray([11, 8, 0], np.int32)
    t = torch.from_numpy
    jlog, pools.jk, pools.jv = jl.decode_step(
        jp, jcfg, *map(jnp.asarray, (tok, pos)), pools.jk, pools.jv,
        *map(jnp.asarray, (bt, sl)), page_size=PS, interpret=True,
    )
    tlog, pools.tk, pools.tv = tl.decode_step(
        tp, tcfg, t(tok), t(pos), pools.tk, pools.tv, t(bt), t(sl), page_size=PS
    )
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **LOGITS)
    pools.assert_equal()

    n = 3
    temp, top_k, top_p = np.zeros(3, np.float32), np.zeros(3, np.int32), np.ones(3, np.float32)
    pos, sl = pos + 1, np.where(sl > 0, sl + 1, 0).astype(np.int32)
    tok = np.asarray(np.argmax(np.asarray(jlog), -1), np.int32)
    jtoks, pools.jk, pools.jv = jl.decode_steps(
        jp, jcfg, *map(jnp.asarray, (tok, pos)), pools.jk, pools.jv,
        *map(jnp.asarray, (bt, sl, temp, top_k, top_p)), jax.random.PRNGKey(0),
        page_size=PS, num_steps=n, interpret=True,
    )
    ttoks, pools.tk, pools.tv = tl.decode_steps(
        tp, tcfg, t(tok), t(pos), pools.tk, pools.tv,
        *map(t, (bt, sl, temp, top_k, top_p)), torch.Generator().manual_seed(0),
        page_size=PS, num_steps=n,
    )
    np.testing.assert_array_equal(_np(ttoks)[:2], np.asarray(jtoks)[:2])
    pools.assert_equal()
