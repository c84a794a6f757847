"""The port's sharded serving (``parallel/mesh.py``, ``parallel/sharding.py``
and the ``mesh=`` paths of ``models/llama.py`` and ``server/engine.py``)
against the JAX package's, on the CPU.

The port runs every shard of a mesh on the CPU device (the
``"same_device"`` collective); JAX runs its mesh over the 8 host devices
``conftest.py`` forces. The cases mirror ``tests/test_parallel.py``
(``TestSharding``, ``TestMoEExpertParallel``), ``tests/test_gmm.py``'s
expert-parallel kernel case and ``tests/test_engine.py``'s
``TestTensorParallelServing``. Tolerances, float32 throughout: logits
atol = rtol = 1e-4 and pools 1e-5 (``test_torch_llama.py``'s); MoE layer
outputs 2e-5 / 2e-4 (JAX's own EP case); engine greedy tokens and the
msgpack bytes of the KV events exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.kvcache.kvevents.events import EventBatch as JEventBatch
from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.models import quant as jq
from llm_d_kv_cache_manager_tpu.parallel import MeshConfig as JMeshConfig
from llm_d_kv_cache_manager_tpu.parallel import make_mesh as j_make_mesh
from llm_d_kv_cache_manager_tpu.parallel import sharding as jsharding
from llm_d_kv_cache_manager_tpu.server import (
    BlockManagerConfig as JBM,
    Engine as JEngine,
    EngineConfig as JEC,
    SamplingParams as JSP,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents.events import EventBatch as TEventBatch
from llm_d_kv_cache_manager_tpu_torch.models import convert as t_convert
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import quant as t_quant
from llm_d_kv_cache_manager_tpu_torch.parallel import (
    MeshConfig,
    ShardedParams,
    make_mesh,
    param_specs,
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
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServer, PodServerConfig

LOGITS = dict(atol=1e-4, rtol=1e-4)
POOL = dict(atol=1e-5, rtol=1e-5)
MOE = dict(atol=2e-5, rtol=2e-4)
PS = 4
PAGES = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(tp=1, sp=1):
    return make_mesh(MeshConfig(tp=tp, sp=sp), devices=["cpu"] * (tp * sp))


def _a3b_shaped():
    """16 experts, top-2: routed expert parallelism is the selected dispatch
    at tp 2 and 4 (k * tp < E)."""
    return "TINY_QWEN3_MOE", dict(n_experts=16, n_experts_per_tok=2)


CONFIGS = {
    "tiny-llama": ("TINY_LLAMA", {}),
    "tiny-llama-qkv-bias": ("TINY_LLAMA", dict(qkv_bias=True)),
    "tiny-gemma": ("TINY_GEMMA", {}),
    "tiny-qwen3-moe": ("TINY_QWEN3_MOE", {}),
    "tiny-qwen3-moe-e16": _a3b_shaped(),
    "tiny-moe-e3": ("TINY_MOE", dict(n_experts=3)),
}


@functools.lru_cache(maxsize=None)
def _model(name, quantize=None):
    preset, changes = CONFIGS[name]
    jcfg = dataclasses.replace(getattr(jl, preset), **changes)
    tcfg = dataclasses.replace(getattr(tl, preset), **changes)
    jp = jl.init_params(jax.random.PRNGKey(3), jcfg)
    if quantize:
        jp = jq.quantize_params(jp, quantize_experts=True)
    if changes.get("qkv_bias"):  # non-zero biases, so a mis-split shows
        rng = np.random.default_rng(9)
        for layer in jp["layers"]:
            for b in ("bq", "bk", "bv"):
                layer[b] = jnp.asarray(rng.normal(size=layer[b].shape) * 0.1, layer[b].dtype)
    tp = t_convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _chunk_inputs(cfg, b=2, s=16, seed=11):
    """Row 0 has 8 tokens of context in pages 22-23, row 1 is fresh and
    right-padded by 4."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    ctx = np.asarray([8, 0], np.int32)
    pos = (ctx[:, None] + np.arange(s)[None]).astype(np.int32)
    valid = np.arange(s)[None] < np.asarray([[s], [s - 4]])
    page_ids = np.repeat(np.arange(1, 1 + b * s // PS).reshape(b, -1), PS, axis=1).astype(np.int32)
    slot_ids = np.broadcast_to(np.arange(s) % PS, (b, s)).astype(np.int32)
    bt = np.asarray([[22, 23], [0, 0]], np.int32)
    return tok, pos, valid, page_ids, slot_ids, bt, ctx


def _pools(cfg, seed=12):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, PAGES, PS, cfg.n_kv_heads, cfg.hd)
    kp = np.zeros(shape, np.float32)
    vp = np.zeros(shape, np.float32)
    kp[:, 22:24] = rng.normal(size=kp[:, 22:24].shape) * 0.3
    vp[:, 22:24] = rng.normal(size=vp[:, 22:24].shape) * 0.3
    return kp, vp


def _decode_inputs():
    tables = np.zeros((2, 8), np.int32)
    tables[0, :6] = [22, 23, 1, 2, 3, 4]
    tables[1, :4] = [5, 6, 7, 8]
    pos = np.asarray([24, 12], np.int32)
    tok = np.asarray([3, 5], np.int32)
    return tok, pos, tables, pos + 1


def _jax_mesh(tp=1, sp=1):
    return j_make_mesh(JMeshConfig(dp=1, tp=tp, sp=sp))


def _run_jax(jcfg, jp, tp, sp=1, steps=False):
    kp, vp = (jnp.asarray(a) for a in _pools(jcfg))
    mesh = _jax_mesh(tp, sp) if tp * sp > 1 else None
    params = jsharding.shard_params(jp, mesh, jcfg) if tp > 1 else jp
    a = [jnp.asarray(x) for x in _chunk_inputs(jcfg)]
    logits, kp, vp = jl.prefill(params, jcfg, *a[:3], kp, vp, *a[3:], mesh=mesh, attn_impl="xla")
    tok, pos, tables, lens = (jnp.asarray(x) for x in _decode_inputs())
    dlog, kp, vp = jl.decode_step(params, jcfg, tok, pos, kp, vp, tables, lens, page_size=PS,
                                  interpret=True, mesh=mesh)
    out = [np.asarray(logits), np.asarray(dlog), np.asarray(kp), np.asarray(vp)]
    if steps:
        zf, zi = jnp.zeros(2, jnp.float32), jnp.zeros(2, jnp.int32)
        toks, kp, vp = jl.decode_steps(params, jcfg, tok + 1, pos + 1, kp, vp, tables, lens + 1,
                                       zf, zi, jnp.ones(2, jnp.float32), jax.random.PRNGKey(0),
                                       page_size=PS, num_steps=3, interpret=True, mesh=mesh)
        out += [np.asarray(toks), np.asarray(kp), np.asarray(vp)]
    return out


def _run_torch(tcfg, tparams, tp, sp=1, steps=False):
    kp, vp = (torch.from_numpy(a) for a in _pools(tcfg))
    mesh = cpu_mesh(tp, sp) if tp * sp > 1 else None
    params = shard_params(tparams, mesh, tcfg) if mesh is not None else tparams
    if tp > 1:
        kp, vp = shard_kv_pools(kp, mesh), shard_kv_pools(vp, mesh)
    a = [torch.from_numpy(np.ascontiguousarray(x)) for x in _chunk_inputs(tcfg)]
    logits, kp, vp = tl.prefill(params, tcfg, *a[:3], kp, vp, *a[3:], mesh=mesh, attn_impl="xla")
    tok, pos, tables, lens = (torch.from_numpy(x) for x in _decode_inputs())
    dlog, kp, vp = tl.decode_step(params, tcfg, tok, pos, kp, vp, tables, lens, page_size=PS,
                                  mesh=mesh)

    def whole(p):
        return (gather_kv_pools(p) if isinstance(p, list) else p).numpy().copy()

    out = [logits.numpy(), dlog.numpy(), whole(kp), whole(vp)]
    if steps:
        z = torch.zeros(2)
        toks, kp, vp = tl.decode_steps(params, tcfg, tok + 1, pos + 1, kp, vp, tables, lens + 1,
                                       z, z.int(), torch.ones(2), torch.Generator().manual_seed(0),
                                       page_size=PS, num_steps=3, mesh=mesh)
        out += [toks.numpy(), whole(kp), whole(vp)]
    return out


def _assert_outputs(t, j):
    np.testing.assert_allclose(t[0], j[0], **LOGITS)  # prefill logits
    np.testing.assert_allclose(t[1], j[1], **LOGITS)  # decode logits
    for a, b in zip(t[2:4], j[2:4]):
        np.testing.assert_allclose(a, b, **POOL)
    if len(t) > 4:
        np.testing.assert_array_equal(t[4], j[4])  # greedy decode_steps tokens
        for a, b in zip(t[5:], j[5:]):
            np.testing.assert_allclose(a, b, **POOL)


class TestSharding:
    @pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-qkv-bias", "tiny-gemma"])
    def test_tp2_prefill_decode_match_jax_tp2(self, name):
        jcfg, tcfg, jp, tp = _model(name)
        _assert_outputs(_run_torch(tcfg, tp, tp=2, steps=True), _run_jax(jcfg, jp, tp=2, steps=True))

    def test_tp2_matches_single_device(self):
        jcfg, tcfg, jp, tp = _model("tiny-llama")
        _assert_outputs(_run_torch(tcfg, tp, tp=2, steps=True), _run_torch(tcfg, tp, tp=1, steps=True))

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_param_specs_equal_jax(self, name):
        jcfg, tcfg, _, _ = _model(name)
        for tp in (1, 2):
            jspecs = jsharding.param_specs(jcfg, tp)
            as_tuples = jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert param_specs(tcfg, tp) == as_tuples

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_specs_cover_tree(self, name):
        _, tcfg, _, tp = _model(name)
        specs = param_specs(tcfg, 2)
        assert set(specs) == set(tp)
        for layer, spec in zip(tp["layers"], specs["layers"]):
            assert set(layer) == set(spec)

    def test_tp_actually_partitions(self):
        _, cfg, _, tp = _model("tiny-llama")
        sharded = shard_params(tp, cpu_mesh(tp=2), cfg)
        assert isinstance(sharded, ShardedParams)
        d, q_out = cfg.hidden_size, cfg.n_heads * cfg.hd
        shards = sharded.row(0)
        assert {s["layers"][0]["wq"].shape for s in shards} == {(d, q_out // 2)}
        assert {s["layers"][0]["wo"].shape for s in shards} == {(q_out // 2, d)}
        assert {s["embed"].shape for s in shards} == {(cfg.vocab_size // 2, d)}
        assert {s["lm_head"].shape for s in shards} == {(d, cfg.vocab_size // 2)}
        assert all(s["final_norm"].shape == (d,) for s in shards)
        # On the tree's own device a shard is a view: the weights are held once.
        base = tp["layers"][0]["wq"].untyped_storage().data_ptr()
        assert all(s["layers"][0]["wq"].untyped_storage().data_ptr() == base for s in shards)
        pools = shard_kv_pools(torch.zeros(2, 4, PS, cfg.n_kv_heads, cfg.hd), cpu_mesh(tp=2))
        assert [p.shape[3] for p in pools] == [cfg.n_kv_heads // 2] * 2
        assert all(p.is_contiguous() for p in pools)

    def test_quantized_scale_follows_codes(self):
        _, cfg, _, tp = _model("tiny-qwen3-moe-e16", quantize="int8")
        shard = shard_params(tp, cpu_mesh(tp=2), cfg).row(0)[1]
        wq, wo, wg = (shard["layers"][0][k] for k in ("wq", "wo", "w_gate"))
        full = tp["layers"][0]
        assert wq.scale.shape == (1, full["wq"].shape[1] // 2)  # column split
        assert torch.equal(wo.scale, full["wo"].scale)  # row split: replicated
        assert wg.q.shape[0] == wg.scale.shape[0] == cfg.n_experts // 2
        assert torch.equal(wg.scale, full["w_gate"].scale[cfg.n_experts // 2:])

    def test_uneven_split_raises(self):
        cfg = dataclasses.replace(tl.TINY_LLAMA, vocab_size=255)
        params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="not divisible by tp=2"):
            shard_params(params, cpu_mesh(tp=2), cfg)

    def test_pools_must_be_per_shard(self):
        _, cfg, _, tp = _model("tiny-llama")
        kp, vp = (torch.from_numpy(a) for a in _pools(cfg))
        a = [torch.from_numpy(np.ascontiguousarray(x)) for x in _chunk_inputs(cfg)]
        mesh = cpu_mesh(tp=2)
        with pytest.raises(ValueError, match="per-shard lists"):
            tl.prefill(shard_params(tp, mesh, cfg), cfg, *a[:3], kp, vp, *a[3:], mesh=mesh)

    def test_mesh_takes_sharded_params(self):
        """Under ``mesh=`` the params are ``shard_params``' trees for that
        mesh: a plain tree, or trees sharded over another mesh, raise."""
        _, cfg, _, tp = _model("tiny-llama")
        kp, vp = (torch.from_numpy(a) for a in _pools(cfg))
        a = [torch.from_numpy(np.ascontiguousarray(x)) for x in _chunk_inputs(cfg)]
        with pytest.raises(ValueError, match="shard_params"):
            tl.prefill(tp, cfg, *a[:3], kp, vp, *a[3:], mesh=cpu_mesh(sp=2))
        with pytest.raises(ValueError, match="another mesh"):
            tl.prefill(shard_params(tp, cpu_mesh(sp=2), cfg), cfg, *a[:3], kp, vp, *a[3:],
                       mesh=cpu_mesh(tp=2))


class TestMesh:
    def test_too_few_devices_raises(self):
        with pytest.raises(ValueError, match="mesh needs 4 devices"):
            make_mesh(MeshConfig(tp=2, sp=2), devices=["cpu"] * 3)

    def test_collective_chosen_from_devices(self):
        mesh = cpu_mesh(tp=2, sp=2)
        assert mesh.collective.name == "same_device"
        assert mesh.describe() == {"dp": 1, "tp": 2, "sp": 2, "devices": ["cpu"] * 4,
                                   "collective": "same_device"}
        assert [len(row) for row in mesh.grid] == [2, 2]

    def test_distinct_cuda_devices_take_nccl(self):
        """Chosen from the devices alone (no card needed to build the mesh)."""
        mesh = make_mesh(MeshConfig(tp=2), devices=["cuda:0", "cuda:1"])
        assert mesh.collective.name == "nccl"
        assert mesh.root == torch.device("cuda", 0)

    def test_mixed_devices_refused(self):
        with pytest.raises(ValueError, match="share one device"):
            make_mesh(MeshConfig(tp=2), devices=["cpu", "meta"])

    def test_same_device_sum_is_float32_in_shard_order(self):
        coll = cpu_mesh(tp=3).collective
        parts = [torch.tensor([1.0], dtype=torch.bfloat16),
                 torch.tensor([2.0**-8], dtype=torch.bfloat16),
                 torch.tensor([2.0**-8], dtype=torch.bfloat16)]
        # Summed in bf16 each half-ulp would round away; in float32 they add
        # up to one bf16 ulp (2^-7 at 1.0).
        assert coll.sum(parts, torch.bfloat16).item() == 1.0 + 2.0**-7
        assert (parts[0] + parts[1] + parts[2]).item() == 1.0


class TestMoEExpertParallel:
    def _layer_input(self, cfg, seed=7):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(2, 8, cfg.hidden_size)).astype(np.float32)

    @pytest.mark.parametrize("tp", [2, 4])
    def test_routed_ep_matches_single_device_and_jax(self, tp):
        jcfg, tcfg, jp, tparams = _model("tiny-qwen3-moe-e16")
        x = self._layer_input(tcfg)
        mesh = cpu_mesh(tp=tp)
        layers = [s["layers"][0] for s in shard_params(tparams, mesh, tcfg).row(0)]
        got = tl._moe_mlp(layers, tcfg, torch.from_numpy(x), mesh=mesh).numpy()
        ref = tl._moe_mlp(tparams["layers"][0], tcfg, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, **MOE)
        jmesh = _jax_mesh(tp)
        jlayer = jsharding.shard_params(jp, jmesh, jcfg)["layers"][0]
        jout = jl._moe_mlp_routed_ep(jlayer, jcfg, jnp.asarray(x), jmesh)
        np.testing.assert_allclose(got, np.asarray(jout), **MOE)

    def test_routed_ep_runs_grouped_matmul_on_local_experts(self, monkeypatch):
        from llm_d_kv_cache_manager_tpu_torch.ops import gmm

        _, cfg, _, tparams = _model("tiny-qwen3-moe-e16")
        mesh = cpu_mesh(tp=4)
        layers = [s["layers"][0] for s in shard_params(tparams, mesh, cfg).row(0)]
        seen, orig = [], gmm.grouped_matmul

        def spy(lhs, rhs, group_sizes, **kw):
            seen.append((rhs.shape[0], group_sizes.shape[0], int(group_sizes.sum()), lhs.shape[0]))
            out = orig(lhs, rhs, group_sizes, **kw)
            assert not out[int(group_sizes.sum()):].any()  # the other shards' rows: zeros
            return out

        monkeypatch.setattr(gmm, "grouped_matmul", spy)
        tl._moe_mlp(layers, cfg, torch.from_numpy(self._layer_input(cfg)), mesh=mesh)
        n_rows = 2 * 8 * cfg.n_experts_per_tok
        e_local = cfg.n_experts // 4
        # Three products a shard, each over its E/tp experts and all n*k rows,
        # of which the shard's groups hold its own rows: every row in one shard.
        assert len(seen) == 12 and all(x[:2] == (e_local, e_local) and x[3] == n_rows for x in seen)
        assert sum(x[2] for x in seen[::3]) == n_rows
        assert all(seen[i][2] == seen[i + 1][2] == seen[i + 2][2] for i in range(0, 12, 3))

    def test_whole_experts_per_shard(self):
        _, cfg, _, tparams = _model("tiny-qwen3-moe")
        shards = shard_params(tparams, cpu_mesh(tp=4), cfg).row(0)
        assert {s["layers"][0]["w_gate"].shape for s in shards} == {(1, cfg.hidden_size, cfg.moe_inter)}
        assert {s["layers"][0]["w_down"].shape for s in shards} == {(1, cfg.moe_inter, cfg.hidden_size)}

    def test_indivisible_experts_fall_back_to_intermediate_sharding(self):
        jcfg, tcfg, jp, tparams = _model("tiny-moe-e3")
        shards = shard_params(tparams, cpu_mesh(tp=2), tcfg).row(0)
        assert {s["layers"][0]["w_gate"].shape for s in shards} == {
            (3, tcfg.hidden_size, tcfg.intermediate_size // 2)}
        _assert_outputs(_run_torch(tcfg, tparams, tp=2), _run_jax(jcfg, jp, tp=2))

    @pytest.mark.parametrize("name", ["tiny-qwen3-moe", "tiny-qwen3-moe-e16"])
    def test_moe_tp2_prefill_decode_match_jax_tp2(self, name):
        jcfg, tcfg, jp, tparams = _model(name)
        _assert_outputs(_run_torch(tcfg, tparams, tp=2, steps=True),
                        _run_jax(jcfg, jp, tp=2, steps=True))

    def test_dense_selected_when_k_tp_covers_experts(self, monkeypatch):
        _, cfg, _, tparams = _model("tiny-qwen3-moe")  # E=4, k=2, tp=2: k*tp >= E
        mesh = cpu_mesh(tp=2)
        layers = [s["layers"][0] for s in shard_params(tparams, mesh, cfg).row(0)]

        def boom(*a, **k):
            raise AssertionError("routed dispatch selected")

        monkeypatch.setattr(tl, "_moe_mlp_routed", boom)
        x = torch.from_numpy(self._layer_input(cfg))
        got = tl._moe_mlp(layers, cfg, x, mesh=mesh)
        ref = tl._moe_mlp_dense(tparams["layers"][0], cfg, x)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **MOE)

    def test_int8_experts_ep_match_single_device(self):
        _, cfg, _, tparams = _model("tiny-qwen3-moe-e16", quantize="int8")
        mesh = cpu_mesh(tp=2)
        layers = [s["layers"][0] for s in shard_params(tparams, mesh, cfg).row(0)]
        assert isinstance(layers[0]["w_up"], t_quant.QuantizedTensor)
        x = torch.from_numpy(self._layer_input(cfg))
        got = tl._moe_mlp(layers, cfg, x, mesh=mesh)
        ref = tl._moe_mlp(tparams["layers"][0], cfg, x)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **MOE)


class TestExpertParallelWithKernel:
    """``tests/test_gmm.py``'s case: routed EP through the grouped matmul's
    kernel wrapper (its plain version on CPU tensors) and through
    ``moe_gmm="xla"``, against JAX's megablox (interpret mode) and
    ``ragged_dot``."""

    def test_ep_kernel_matches_xla_and_jax(self):
        base_j = dataclasses.replace(jl.TINY_MOE, hidden_size=128, intermediate_size=256,
                                     n_experts=4, n_experts_per_tok=1)
        base_t = dataclasses.replace(tl.TINY_MOE, hidden_size=128, intermediate_size=256,
                                     n_experts=4, n_experts_per_tok=1)
        jp = jl.init_params(jax.random.PRNGKey(1), base_j)
        tparams = t_convert.params_from_jax(jax.tree.map(np.asarray, jp), base_t, "cpu")
        x = np.random.default_rng(7).normal(size=(2, 8, 128)).astype(np.float32)
        jmesh, mesh = _jax_mesh(2), cpu_mesh(tp=2)
        outs = {}
        for impl in ("xla", "kernel"):
            jcfg = dataclasses.replace(base_j, moe_gmm=impl)
            jlayer = jsharding.shard_params(jp, jmesh, jcfg)["layers"][0]
            outs["jax_" + impl] = np.asarray(jl._moe_mlp_routed_ep(jlayer, jcfg, jnp.asarray(x), jmesh))
        for impl in ("xla", "auto"):
            tcfg = dataclasses.replace(base_t, moe_gmm=impl)
            layers = [s["layers"][0] for s in shard_params(tparams, mesh, tcfg).row(0)]
            outs["torch_" + impl] = tl._moe_mlp_routed(layers, tcfg, torch.from_numpy(x), mesh).numpy()
        for name in ("jax_kernel", "torch_xla", "torch_auto"):
            np.testing.assert_allclose(outs[name], outs["jax_xla"], **MOE)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 256, n)]


class _Side:
    """One framework's tp engine and the events it emitted."""

    def __init__(self, torch_side, name, tp, **knobs):
        jcfg, tcfg, jp, tparams = _model(name)
        self.events = []
        sink = lambda evs: self.events.append(list(evs))  # noqa: E731
        common = dict(max_model_len=64, decode_batch_size=4, prefill_bucket=8, tp=tp, **knobs)
        if torch_side:
            self.SP, self.batch_cls = TSP, TEventBatch
            cfg = TEC(model=tcfg, block_manager=TBM(total_pages=64, page_size=PS), **common)
            self.eng = TEngine(cfg, params=tparams, on_events=sink, device="cpu",
                               mesh=cpu_mesh(tp=tp) if tp > 1 else None)
        else:
            self.SP, self.batch_cls = JSP, JEventBatch
            cfg = JEC(model=jcfg, block_manager=JBM(total_pages=64, page_size=PS),
                      interpret=True, **common)
            self.eng = JEngine(cfg, params=jp, on_events=sink)

    def serve(self, prompts, new_tokens=6):
        seqs = [self.eng.add_request(p, self.SP(max_new_tokens=new_tokens)) for p in prompts]
        self.eng.run_until_complete()
        return [([int(t) for t in s.generated_tokens], s.num_cached_prompt) for s in seqs]

    def event_bytes(self):
        return [self.batch_cls(ts=0.0, events=evs).to_payload() for evs in self.events]


class TestTensorParallelServing:
    @pytest.mark.parametrize("name", ["tiny-llama", "tiny-qwen3-moe-e16"])
    def test_tp2_engine_matches_jax_tp2_engine(self, name):
        prompts = [_prompt(20 + i, 10 + i) for i in range(3)]
        sides = [_Side(torch_side, name, tp=2) for torch_side in (True, False)]
        outs = [[s.serve(prompts), s.serve(prompts[:1])] for s in sides]
        assert outs[0] == outs[1]
        assert outs[0][1][0][1] > 0  # the repeat hit the prefix cache
        assert sides[0].eng.prefill_stats["tokens_computed"] == sides[1].eng.prefill_stats["tokens_computed"]
        assert sides[0].event_bytes() == sides[1].event_bytes()

    def test_tp2_int8_pages_match_jax_tp2(self):
        """int8 KV pages over tp=2: the scale pools split with their heads,
        so codes and scales equal JAX's sharded pools (codes exact, scales
        rtol 1e-6 as on one device)."""
        prompts = [_prompt(40 + i, 9 + 2 * i) for i in range(3)]
        sides = [_Side(torch_side, "tiny-llama", tp=2, kv_quant_hbm="int8")
                 for torch_side in (True, False)]
        assert sides[0].serve(prompts) == sides[1].serve(prompts)
        assert sides[0].event_bytes() == sides[1].event_bytes()
        teng, jeng = sides[0].eng, sides[1].eng
        assert [p.shape[-1] for p in teng.k_scales] == [tl.TINY_LLAMA.n_kv_heads // 2] * 2
        for t, j in ((teng.k_pages, jeng.k_pages), (teng.v_pages, jeng.v_pages)):
            np.testing.assert_array_equal(gather_kv_pools(t).numpy(), np.asarray(j))
        for t, j in ((teng.k_scales, jeng.k_scales), (teng.v_scales, jeng.v_scales)):
            np.testing.assert_allclose(gather_kv_pools(t).numpy(), np.asarray(j), rtol=1e-6, atol=0)

    def test_tp_greedy_matches_single_device(self):
        prompts = [_prompt(20 + i, 10 + i) for i in range(3)]
        assert _Side(True, "tiny-llama", tp=2).serve(prompts) == _Side(True, "tiny-llama", tp=1).serve(prompts)

    def test_tp_fused_decode_and_prefix_cache(self):
        side = _Side(True, "tiny-llama", tp=2, decode_steps_per_iter=4)
        p = _prompt(30, 16)
        (a, _), = side.serve([p])
        (b, cached), = side.serve([p])
        assert cached > 0 and a == b
        assert side.eng.decode_stats["dispatch"] == "eager"  # the CPU

    def test_tp_must_divide_heads(self):
        with pytest.raises(ValueError, match="must divide n_heads"):
            _Side(True, "tiny-llama", tp=3)

    def test_tp_qk_norm_model_serves(self):
        p = _prompt(35, 10)
        outs = [_Side(True, "tiny-qwen3-moe", tp=tp).serve([p], 5) for tp in (1, 2)]
        assert outs[0] == outs[1]

    def test_engine_mesh_must_match_config(self):
        _, tcfg, _, tparams = _model("tiny-llama")
        cfg = TEC(model=tcfg, block_manager=TBM(total_pages=16, page_size=PS), tp=2)
        with pytest.raises(ValueError, match="does not match"):
            TEngine(cfg, params=tparams, mesh=cpu_mesh(tp=2, sp=2))

    def test_engine_without_devices_raises(self):
        """No silent single-device serving: tp=2 with no second GPU raises."""
        cfg = TEC(model=tl.TINY_LLAMA, block_manager=TBM(total_pages=16, page_size=PS), tp=2)
        with pytest.raises(ValueError, match="mesh needs 2 devices"):
            TEngine(cfg)

    def test_tiers_and_transfer_served_over_a_mesh(self):
        """A tp=2 engine takes the host tier and the remote tier, and exports
        and imports KV (``test_torch_sharded_tiers.py`` holds them against
        JAX's tp=2 engine); an engine refuses a mesh with dp > 1."""
        _, tcfg, _, tparams = _model("tiny-llama")
        bm = TBM(total_pages=16, page_size=PS, host_pages=8)
        for knobs in (dict(block_manager=bm), dict(block_manager=TBM(total_pages=16, page_size=PS),
                                                   remote_tier=True)):
            eng = TEngine(TEC(model=tcfg, tp=2, **knobs), params=tparams, mesh=cpu_mesh(tp=2))
            assert eng.mesh.shape["tp"] == 2
        side = _Side(True, "tiny-llama", tp=2)
        p = _prompt(5, 12)
        side.serve([p])
        hashes = side.eng.block_manager.token_db.prefix_hashes(p)
        blocks = side.eng.export_kv_blocks(hashes)
        assert len(blocks) == len(hashes) == 3
        other = _Side(True, "tiny-llama", tp=2)
        assert other.eng.import_kv_blocks(blocks) == len(blocks)
        with pytest.raises(ValueError, match="dp=2"):
            TEngine(TEC(model=tcfg, block_manager=bm, tp=2), params=tparams,
                    mesh=make_mesh(MeshConfig(dp=2, tp=2), devices=["cpu"] * 4))

    def test_spec_decode_over_tp(self):
        prompt = [1, 2, 3, 4, 5, 6] * 4
        outs = [_Side(True, "tiny-llama", tp=tp, spec_decode="prompt_lookup").serve([prompt], 8)
                for tp in (1, 2)]
        assert outs[0] == outs[1]


def test_from_env_reads_tp_sp(monkeypatch):
    from llm_d_kv_cache_manager_tpu.server.serve import PodServerConfig as JPodServerConfig

    for name in ("TP", "SP"):
        monkeypatch.delenv(name, raising=False)

    def read(cls):
        e = cls.from_env().engine
        return e.tp, e.sp

    assert read(PodServerConfig) == read(JPodServerConfig) == (1, 1)
    monkeypatch.setenv("TP", "2")
    monkeypatch.setenv("SP", "4")
    assert read(PodServerConfig) == read(JPodServerConfig) == (2, 4)


def test_pod_stats_name_the_mesh():
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    side = _Side(True, "tiny-llama", tp=2)
    pod = PodServer(PodServerConfig(model_name="tiny-llama", publish_events=False), engine=side.eng)
    pod.start()

    async def scenario():
        client = TestClient(TestServer(pod.build_app()))
        await client.start_server()
        try:
            stats = await (await client.get("/stats")).json()
            resp = await client.post("/v1/completions",
                                     json={"prompt_token_ids": _prompt(4, 9), "max_tokens": 3})
            assert resp.status == 200
            return stats
        finally:
            await client.close()

    try:
        stats = asyncio.run(scenario())
    finally:
        pod.shutdown()
    assert stats["mesh"] == {"dp": 1, "tp": 2, "sp": 1, "devices": ["cpu", "cpu"],
                             "collective": "same_device", "decode_dispatch": "eager"}


#: Digests of the mesh-free path's outputs on a fixed input, taken before
#: the mesh paths were added (``_mesh_free_case``): the single-device path
#: must still give these bits.
MESH_FREE_DIGESTS = {
    "TINY_LLAMA": ("6f183dfa3d45fbbc", "e46945b52157c186", [[61, 138, 227], [98, 26, 127]]),
    "TINY_QWEN3_MOE": ("80bef0fca1f41246", "b54bc6b17e0c6bad", [[149, 75, 48], [46, 186, 250]]),
}


def _digest(*ts):
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _mesh_free_case(cfg):
    g = torch.Generator().manual_seed(7)
    p = tl.init_params(cfg, g, "cpu")
    rng = np.random.default_rng(7)
    b, s, ps, n_pages = 2, 8, 4, 16
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    ctx = torch.tensor([4, 0], dtype=torch.int32)
    pos = (ctx[:, None] + torch.arange(s)[None]).int()
    valid = torch.arange(s)[None] < torch.tensor([[8], [5]])[:, 0, None]
    kp, vp = tl.init_kv_pages(cfg, n_pages, ps, "cpu")
    kp[:, 15] = torch.randn(kp[:, 15].shape, generator=g)
    vp[:, 15] = torch.randn(vp[:, 15].shape, generator=g)
    bt = torch.tensor([[15], [0]], dtype=torch.int32)
    page_ids = torch.tensor([[1, 1, 1, 1, 2, 2, 2, 2], [3, 3, 3, 3, 4, 4, 4, 4]], dtype=torch.int32)
    slot_ids = (torch.arange(s) % ps).int().expand(b, s).contiguous()
    logits, kp, vp = tl.prefill(p, cfg, tok, pos, valid, kp, vp, page_ids, slot_ids, bt, ctx)
    tables = torch.tensor([[15, 1, 2, 5, 6], [3, 4, 7, 8, 0]], dtype=torch.int32)
    lens = torch.tensor([12, 5], dtype=torch.int32)
    toks, kp, vp = tl.decode_steps(
        p, cfg, torch.tensor([1, 2], dtype=torch.int32), lens, kp, vp, tables, lens + 1,
        torch.tensor([0.0, 1.0]), torch.tensor([0, 5], dtype=torch.int32), torch.tensor([1.0, 0.9]),
        torch.Generator().manual_seed(3), page_size=ps, num_steps=3)
    return _digest(logits), _digest(kp, vp), toks.tolist()


@pytest.mark.parametrize("name", list(MESH_FREE_DIGESTS))
def test_mesh_none_outputs_bit_equal(name):
    assert _mesh_free_case(getattr(tl, name)) == MESH_FREE_DIGESTS[name]
