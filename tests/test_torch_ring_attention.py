"""The port's ring attention and sequence-parallel prefill against the JAX
package's, on the CPU (``tests/test_ring_attention.py``'s cases).

The port runs its sp shards on the CPU device; JAX runs them over
``conftest.py``'s 8 host devices. Tolerances as in JAX's tests: the ring
against single-device causal attention atol 2e-5 in float32 and 3e-2 in
bfloat16; sp prefill logits atol 2e-4 / rtol 2e-3 and pools atol 1e-5 /
rtol 1e-4 against the single-device ``"xla"`` prefill; engine greedy
tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.ops.attention import causal_prefill_attention as j_causal
from llm_d_kv_cache_manager_tpu.parallel import MeshConfig as JMeshConfig
from llm_d_kv_cache_manager_tpu.parallel import make_mesh as j_make_mesh
from llm_d_kv_cache_manager_tpu.parallel import sharding as jsharding
from llm_d_kv_cache_manager_tpu.parallel.ring_attention import ring_attention as j_ring
from llm_d_kv_cache_manager_tpu.server import (
    BlockManagerConfig as JBM,
    Engine as JEngine,
    EngineConfig as JEC,
    SamplingParams as JSP,
)
from llm_d_kv_cache_manager_tpu_torch.models import convert as t_convert
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.ops.attention import causal_prefill_attention
from llm_d_kv_cache_manager_tpu_torch.parallel import (
    MeshConfig,
    make_mesh,
    ring_attention,
    shard_kv_pools,
    shard_params,
)
from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import gather_kv_pools
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig as TBM,
    Engine as TEngine,
    EngineConfig as TEC,
    SamplingParams as TSP,
)

RING = dict(atol=2e-5)
SP_LOGITS = dict(atol=2e-4, rtol=2e-3)
SP_POOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(sp=1, tp=1):
    return make_mesh(MeshConfig(sp=sp, tp=tp), devices=["cpu"] * (sp * tp))


def _qkv(rng, b, s, n_q, n_kv, d):
    return (rng.standard_normal((b, s, n_q, d)).astype(np.float32),
            rng.standard_normal((b, s, n_kv, d)).astype(np.float32),
            rng.standard_normal((b, s, n_kv, d)).astype(np.float32))


def _jax_ring(q, k, v, n):
    mesh = JMesh(np.array(jax.devices()[:n]), axis_names=("sp",))
    return np.asarray(j_ring(*(jnp.asarray(x) for x in (q, k, v)), mesh))


class TestRingAttention:
    @pytest.mark.parametrize("n_shards", [2, 4, 8])
    def test_matches_single_device_and_jax(self, n_shards):
        q, k, v = _qkv(np.random.default_rng(0), 2, 64, 4, 4, 16)
        t = [torch.from_numpy(x) for x in (q, k, v)]
        got = ring_attention(*t, cpu_mesh(sp=n_shards)).numpy()
        np.testing.assert_allclose(got, causal_prefill_attention(*t).numpy(), **RING)
        np.testing.assert_allclose(got, _jax_ring(q, k, v, n_shards), **RING)

    def test_gqa(self):
        q, k, v = _qkv(np.random.default_rng(1), 1, 32, 8, 2, 16)
        t = [torch.from_numpy(x) for x in (q, k, v)]
        got = ring_attention(*t, cpu_mesh(sp=4)).numpy()
        np.testing.assert_allclose(got, causal_prefill_attention(*t).numpy(), **RING)
        np.testing.assert_allclose(got, _jax_ring(q, k, v, 4), **RING)

    def test_bf16(self):
        q, k, v = _qkv(np.random.default_rng(2), 1, 32, 4, 4, 16)
        t = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
        got = ring_attention(*t, cpu_mesh(sp=4))
        assert got.dtype == torch.bfloat16
        ref = np.asarray(j_causal(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))), np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, atol=3e-2)

    def test_grad_shapes(self):
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(np.random.default_rng(3), 1, 32, 4, 4, 16))
        ring_attention(q, k, v, cpu_mesh(sp=4)).sum().backward()
        assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())

    def test_indivisible_seq_raises(self):
        q, k, v = (torch.from_numpy(x) for x in _qkv(np.random.default_rng(4), 1, 30, 4, 4, 16))
        with pytest.raises(ValueError, match="not divisible"):
            ring_attention(q, k, v, cpu_mesh(sp=4))

    def test_causality(self):
        q, k, v = (torch.from_numpy(x) for x in _qkv(np.random.default_rng(5), 1, 32, 4, 4, 16))
        mesh = cpu_mesh(sp=4)
        base = ring_attention(q, k, v, mesh)
        k2, v2 = k.clone(), v.clone()
        k2[:, 24:] = 7.0
        v2[:, 24:] = -3.0
        pert = ring_attention(q, k2, v2, mesh)
        np.testing.assert_allclose(pert[:, :24].numpy(), base[:, :24].numpy(), **RING)
        assert not np.allclose(pert[:, 24:].numpy(), base[:, 24:].numpy())


def _setup(b=2, s=16, ctx_pages=2, page=4, total_pages=32):
    """JAX's ``TestSpPrefill._setup``: row 0 has two pages of context, row
    1 is fresh and right-padded by 4."""
    rng = np.random.default_rng(11)
    jp = jl.init_params(jax.random.PRNGKey(0), jl.TINY_LLAMA)
    tp = t_convert.params_from_jax(jax.tree.map(np.asarray, jp), tl.TINY_LLAMA, "cpu")
    cfg = tl.TINY_LLAMA
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    ctx_lens = np.asarray([ctx_pages * page, 0], np.int32)
    positions = (ctx_lens[:, None] + np.arange(s)[None]).astype(np.int32)
    valid = np.arange(s)[None] < np.asarray([[s], [s - 4]])
    page_ids = np.repeat(
        rng.permutation(np.arange(1, total_pages))[: b * (s // page)].reshape(b, -1), page, axis=1
    ).astype(np.int32)
    slot_ids = np.broadcast_to(np.arange(s) % page, (b, s)).astype(np.int32)
    bt = np.zeros((b, ctx_pages), np.int32)
    bt[0, :2] = [30, 31]
    shape = (cfg.n_layers, total_pages, page, cfg.n_kv_heads, cfg.hd)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    kp[:, 30:32] = rng.normal(size=kp[:, 30:32].shape) * 0.3
    vp[:, 30:32] = rng.normal(size=vp[:, 30:32].shape) * 0.3
    return jp, tp, (tokens, positions, valid), (kp, vp), (page_ids, slot_ids, bt, ctx_lens)


def _torch_prefill(params, mesh, inputs, pools, rest, tp=1, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in inputs + rest]
    kp, vp = (torch.from_numpy(x.copy()) for x in pools)
    if mesh is not None:
        params = shard_params(params, mesh, tl.TINY_LLAMA)
    if tp > 1:
        kp, vp = shard_kv_pools(kp, mesh), shard_kv_pools(vp, mesh)
    logits, kp, vp = tl.prefill(params, tl.TINY_LLAMA, *t[:3], kp, vp, *t[3:], mesh=mesh, **kw)
    whole = [gather_kv_pools(p) if isinstance(p, list) else p for p in (kp, vp)]
    return [logits.numpy()] + [p.numpy() for p in whole]


class TestSpPrefill:
    @pytest.mark.parametrize("sp", [2, 4])
    def test_sp_prefill_matches_single_device(self, sp):
        _, tp, inputs, pools, rest = _setup()
        ref = _torch_prefill(tp, None, inputs, pools, rest, attn_impl="xla")
        got = _torch_prefill(tp, cpu_mesh(sp=sp), inputs, pools, rest)
        np.testing.assert_allclose(got[0], ref[0], **SP_LOGITS)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a, b, **SP_POOL)

    def test_sp_prefill_matches_jax_sp(self):
        jp, tp, inputs, pools, rest = _setup()
        got = _torch_prefill(tp, cpu_mesh(sp=4), inputs, pools, rest)
        a = [jnp.asarray(x) for x in inputs + rest]
        jlog, jk, jv = jl.prefill(jp, jl.TINY_LLAMA, *a[:3], *(jnp.asarray(p) for p in pools), *a[3:],
                                  mesh=j_make_mesh(JMeshConfig(dp=1, sp=4, tp=1)), attn_impl="xla")
        np.testing.assert_allclose(got[0], np.asarray(jlog), **SP_LOGITS)
        np.testing.assert_allclose(got[1], np.asarray(jk), **SP_POOL)
        np.testing.assert_allclose(got[2], np.asarray(jv), **SP_POOL)

    def test_sp_with_tp_composes(self):
        jp, tp, inputs, pools, rest = _setup()
        mesh = cpu_mesh(sp=2, tp=2)
        got = _torch_prefill(shard_params(tp, mesh, tl.TINY_LLAMA), mesh, inputs, pools, rest, tp=2)
        ref = _torch_prefill(tp, None, inputs, pools, rest, attn_impl="xla")
        np.testing.assert_allclose(got[0], ref[0], **SP_LOGITS)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a, b, **SP_POOL)
        jmesh = j_make_mesh(JMeshConfig(dp=1, sp=2, tp=2))
        a = [jnp.asarray(x) for x in inputs + rest]
        jlog, _, _ = jl.prefill(jsharding.shard_params(jp, jmesh, jl.TINY_LLAMA), jl.TINY_LLAMA,
                                *a[:3], *(jnp.asarray(p) for p in pools), *a[3:], mesh=jmesh,
                                attn_impl="xla")
        np.testing.assert_allclose(got[0], np.asarray(jlog), **SP_LOGITS)

    def test_context_padded_to_sp(self):
        """A context table of 3 pages over sp=2 is padded with page 0,
        whose keys sit beyond every context length."""
        _, tp, inputs, pools, (page_ids, slot_ids, bt, ctx_lens) = _setup(ctx_pages=3)
        bt = bt.copy()
        bt[0] = [29, 30, 31]
        ctx_lens = np.asarray([10, 0], np.int32)
        tokens, positions, valid = inputs
        positions = (ctx_lens[:, None] + np.arange(tokens.shape[1])[None]).astype(np.int32)
        inputs = (tokens, positions, valid)
        rest = (page_ids, slot_ids, bt, ctx_lens)
        ref = _torch_prefill(tp, None, inputs, pools, rest, attn_impl="xla")
        got = _torch_prefill(tp, cpu_mesh(sp=2), inputs, pools, rest)
        np.testing.assert_allclose(got[0], ref[0], **SP_LOGITS)

    def test_sp_indivisible_chunk_raises(self):
        _, tp, inputs, pools, rest = _setup(s=16)
        with pytest.raises(ValueError, match="divisible by sp"):
            _torch_prefill(tp, cpu_mesh(sp=3), inputs, pools, rest)

    def test_sp_refuses_int8_pools(self):
        cfg = tl.TINY_LLAMA
        _, tp, inputs, _, rest = _setup()
        t = [torch.from_numpy(np.ascontiguousarray(x)) for x in inputs + rest]
        kp, vp = tl.init_kv_pages(cfg, 32, 4, "cpu", kv_quant_hbm="int8")
        ks, vs = tl.init_kv_scales(cfg, 32, "cpu")
        mesh = cpu_mesh(sp=2)
        with pytest.raises(ValueError, match="sp > 1"):
            tl.prefill(shard_params(tp, mesh, cfg), cfg, *t[:3], kp, vp, *t[3:], ks, vs, mesh=mesh)


class TestSpEngine:
    """An sp=2 engine serves a prompt longer than one shard's chunk with
    the single-device engine's tokens, and JAX's sp=2 engine's."""

    def test_sp_engine_matches_single_device_and_jax(self):
        prompt = [int(t) for t in np.random.default_rng(13).integers(0, tl.TINY_LLAMA.vocab_size, 40)]
        jp, tp, *_ = _setup()

        def run_torch(sp, tp_=1):
            mesh = cpu_mesh(sp=sp, tp=tp_) if sp * tp_ > 1 else None
            eng = TEngine(TEC(model=tl.TINY_LLAMA, block_manager=TBM(total_pages=64, page_size=4),
                              max_model_len=64, decode_batch_size=2, prefill_bucket=8, sp=sp, tp=tp_),
                          params=tp, device="cpu", mesh=mesh)
            seq = eng.add_request(prompt, TSP(max_new_tokens=5))
            eng.run_until_complete()
            assert seq.error is None
            return [int(t) for t in seq.generated_tokens]

        jeng = JEngine(JEC(model=jl.TINY_LLAMA, block_manager=JBM(total_pages=64, page_size=4),
                           max_model_len=64, decode_batch_size=2, prefill_bucket=8, sp=2,
                           interpret=True), params=jp)
        jseq = jeng.add_request(prompt, JSP(max_new_tokens=5))
        jeng.run_until_complete()
        assert run_torch(1) == run_torch(2) == run_torch(2, 2) == [int(t) for t in jseq.generated_tokens]

    def test_sp_must_divide_prefill_bucket(self):
        with pytest.raises(ValueError, match="must divide prefill_bucket"):
            TEngine(TEC(model=tl.TINY_LLAMA, block_manager=TBM(total_pages=16, page_size=4),
                        prefill_bucket=8, sp=3), device="cpu", mesh=cpu_mesh(sp=3))

    def test_sp_spec_decode_chunk_splits(self):
        """Verify rounds over sp: the chunk is a multiple of lcm(8, sp)."""
        _, tp, *_ = _setup()
        prompt = [1, 2, 3, 4, 5, 6] * 4
        outs = []
        for sp in (1, 2):
            eng = TEngine(TEC(model=dataclasses.replace(tl.TINY_LLAMA),
                              block_manager=TBM(total_pages=64, page_size=4), max_model_len=64,
                              decode_batch_size=2, prefill_bucket=8, sp=sp,
                              spec_decode="prompt_lookup"),
                          params=tp, device="cpu", mesh=cpu_mesh(sp=sp) if sp > 1 else None)
            seq = eng.add_request(prompt, TSP(max_new_tokens=8))
            eng.run_until_complete()
            outs.append([int(t) for t in seq.generated_tokens])
            assert eng.spec_stats["verify_steps"] > 0
        assert outs[0] == outs[1]
