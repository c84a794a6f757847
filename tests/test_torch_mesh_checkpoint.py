"""Checkpoints of sharded params and train states (``parallel/checkpoint.py``
with ``mesh=``), mirroring the JAX package's ``test_sharded_restore_onto_mesh``,
``test_train_state_sharded_restore`` and ``test_quantized_sharded_restore_onto_mesh``
(``tests/test_checkpoint.py``) on the CPU.

A restore onto a ``(dp=2, tp=2)`` mesh gives every shard its slice, shaped
as JAX's ``param_shardings`` shards the same leaf over JAX's mesh (int8
scales with the size-1 contraction axis replicated), AdamW's moments on
their parameters' splits and the step count on every copy; gathered back,
everything equals the saved tree bit for bit. A save from a mesh state
equals the mesh-free save of the gathered state, tensor for tensor, and a
resumed mesh run steps like the mesh-free resume (the loss at
``test_torch_train.py``'s float32 bar).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.parallel import MeshConfig as JMeshConfig
from llm_d_kv_cache_manager_tpu.parallel import make_mesh as j_make_mesh
from llm_d_kv_cache_manager_tpu.parallel import sharding as jsharding
from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA, QuantizedTensor, init_params
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.parallel import (
    MeshConfig,
    ShardedParams,
    gather_params,
    gather_train_state,
    load_params,
    load_train_state,
    make_mesh,
    save_params,
    save_train_state,
    shard_train_params,
)
from llm_d_kv_cache_manager_tpu_torch.parallel.train import (
    make_train_state,
    param_leaves,
    train_step,
)
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig,
    Engine,
    EngineConfig,
    SamplingParams,
)

F32 = dict(rtol=1e-5, atol=1e-6)
MODELS = {"tiny-llama": TINY_LLAMA,
          "a3b-shaped": dataclasses.replace(tl.TINY_QWEN3_MOE, n_experts=16, n_experts_per_tok=2)}
J_MODELS = {"tiny-llama": jl.TINY_LLAMA,
            "a3b-shaped": dataclasses.replace(jl.TINY_QWEN3_MOE, n_experts=16, n_experts_per_tok=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mesh22():
    return make_mesh(MeshConfig(dp=2, tp=2), devices=["cpu"] * 4)


def _flat(tree):
    out = []
    for leaf in param_leaves(tree):
        out.extend([leaf.q, leaf.scale] if isinstance(leaf, QuantizedTensor) else [leaf])
    return out


def _trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())


def _tokens(cfg, seed, shape=(4, 16)):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, shape))


def _jax_shard_shapes(name, quantize=None):
    """JAX's tree of shard shapes (as strings) under its ``param_shardings``
    over its (dp=2, tp=2) mesh: an int8 leaf's a ``QuantizedTensor`` of
    its codes' and scale's."""
    jcfg = J_MODELS[name]
    abstract = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jcfg, quantize=quantize))
    shardings = jsharding.param_shardings(j_make_mesh(JMeshConfig(dp=2, tp=2)), jcfg, abstract)
    return jax.tree.map(lambda a, s: str(tuple(s.shard_shape(a.shape))), abstract, shardings)


def _shapes_like(tree, want):
    """Walk the port's tree beside JAX's shape tree (by key) and compare."""
    if isinstance(tree, dict):
        assert sorted(tree) == sorted(want)
        for k in tree:
            _shapes_like(tree[k], want[k])
    elif isinstance(tree, list):
        assert len(tree) == len(want)
        for a, b in zip(tree, want):
            _shapes_like(a, b)
    elif isinstance(tree, QuantizedTensor):
        assert (str(tuple(tree.q.shape)), str(tuple(tree.scale.shape))) == (want.q, want.scale)
    else:
        assert str(tuple(tree.shape)) == want


def _assert_shards_like_jax(restored: ShardedParams, name, quantize=None):
    want = _jax_shard_shapes(name, quantize)
    for grid in restored.replicas:
        for tree in grid[0]:
            _shapes_like(tree, want)
            assert all(t.device.type == "cpu" and t.is_contiguous() for t in _flat(tree))


class TestShardedRestore:
    @pytest.mark.parametrize("name", list(MODELS))
    def test_sharded_restore_onto_mesh(self, tmp_path, name):
        cfg = MODELS[name]
        params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        save_params(str(tmp_path / "ckpt"), params)
        restored = load_params(str(tmp_path / "ckpt"), cfg, device="cpu", mesh=mesh22())
        assert isinstance(restored, ShardedParams) and len(restored.replicas) == 2
        _assert_shards_like_jax(restored, name)
        _trees_equal(params, gather_params(restored))
        assert not any(t.requires_grad for t in param_leaves(restored))
        # No shard shares storage with another or with the file's tensors.
        ptrs = [t.data_ptr() for t in param_leaves(restored)]
        assert len(set(ptrs)) == len(ptrs)

    def test_quantized_sharded_restore_onto_mesh(self, tmp_path):
        params = init_params(TINY_LLAMA, torch.Generator().manual_seed(6), "cpu", quantize="int8")
        save_params(str(tmp_path / "q"), params)
        restored = load_params(str(tmp_path / "q"), TINY_LLAMA, "int8", device="cpu", mesh=mesh22())
        _assert_shards_like_jax(restored, "tiny-llama", quantize="int8")
        lm_head = restored.shards[0][1]["lm_head"]
        assert isinstance(lm_head, QuantizedTensor) and lm_head.scale.shape[-2] == 1
        _trees_equal(params, gather_params(restored))

    def test_a_restore_onto_a_mesh_needs_cfg(self, tmp_path):
        save_params(str(tmp_path / "p"), init_params(TINY_LLAMA, torch.Generator().manual_seed(2), "cpu"))
        with pytest.raises(ValueError, match="needs cfg"):
            load_params(str(tmp_path / "p"), device="cpu", mesh=mesh22())

    def test_restored_params_serve_like_the_in_memory_ones_at_tp2(self, tmp_path):
        params = init_params(TINY_LLAMA, torch.Generator().manual_seed(7), "cpu")
        save_params(str(tmp_path / "p"), params)
        mesh = make_mesh(MeshConfig(tp=2), devices=["cpu"] * 2)
        restored = load_params(str(tmp_path / "p"), TINY_LLAMA, device="cpu", mesh=mesh)
        prompt = np.random.default_rng(8).integers(0, TINY_LLAMA.vocab_size, 12).tolist()

        def serve(p):
            eng = Engine(EngineConfig(model=TINY_LLAMA, tp=2, max_model_len=32, decode_batch_size=2,
                                      block_manager=BlockManagerConfig(total_pages=32, page_size=4),
                                      prefill_bucket=8),
                         params=p, device="cpu", mesh=mesh)
            seq = eng.add_request(prompt, SamplingParams(max_new_tokens=4))
            eng.run_until_complete()
            return seq.output_tokens

        tokens = serve(params)
        assert len(tokens) == 4 and serve(restored) == tokens


class TestShardedTrainState:
    @pytest.mark.parametrize("name", list(MODELS))
    def test_train_state_sharded_restore(self, tmp_path, name):
        """Params on their specs, the moments on their parameters' splits
        and the step count on every copy; gathered back, bit-equal."""
        cfg = MODELS[name]
        state = make_train_state(cfg, 3, device="cpu")
        state, _ = train_step(state, cfg, _tokens(cfg, 0))
        save_train_state(str(tmp_path / "train"), state)
        resumed = load_train_state(str(tmp_path / "train"), cfg, device="cpu", mesh=mesh22())
        assert resumed.step == state.step == 1
        _assert_shards_like_jax(resumed.params, name)
        for p in param_leaves(resumed.params):
            st = resumed.optimizer.state[p]
            assert p.requires_grad and float(st["step"]) == 1.0 and st["step"].device.type == "cpu"
            assert st["exp_avg"].shape == p.shape and st["exp_avg_sq"].shape == p.shape
        steps = {id(resumed.optimizer.state[p]["step"]) for p in param_leaves(resumed.params)}
        assert len(steps) == len(param_leaves(resumed.params))  # one count a copy
        back = gather_train_state(resumed)
        _trees_equal(state.params, back.params)
        for p, q in zip(param_leaves(state.params), param_leaves(back.params)):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(state.optimizer.state[p][key], back.optimizer.state[q][key])

    def test_mesh_save_equals_mesh_free_save_of_the_gathered_state(self, tmp_path):
        cfg = MODELS["a3b-shaped"]
        state = make_train_state(cfg, 4, device="cpu", mesh=mesh22())
        for s in range(2):
            state, _ = train_step(state, cfg, _tokens(cfg, s))
        save_train_state(str(tmp_path / "mesh"), state)
        save_train_state(str(tmp_path / "free"), gather_train_state(state))
        a = torch.load(str(tmp_path / "mesh"), weights_only=True)
        b = torch.load(str(tmp_path / "free"), weights_only=True)
        assert a["step"] == b["step"] == 2
        _trees_equal(a["params"], b["params"])
        assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
        assert sorted(a["optimizer"]["state"]) == sorted(b["optimizer"]["state"])
        for i, st in a["optimizer"]["state"].items():
            assert list(st) == list(b["optimizer"]["state"][i]) == ["step", "exp_avg", "exp_avg_sq"]
            for key in st:
                assert torch.equal(st[key], b["optimizer"]["state"][i][key])

    def test_restored_onto_mesh_and_onto_no_mesh_are_bit_equal_and_resume(self, tmp_path):
        cfg = MODELS["a3b-shaped"]
        state = make_train_state(cfg, 5, device="cpu", mesh=mesh22())
        tokens = _tokens(cfg, 5)
        state, _ = train_step(state, cfg, tokens)
        save_train_state(str(tmp_path / "train"), state)
        on_mesh = load_train_state(str(tmp_path / "train"), cfg, device="cpu", mesh=mesh22())
        free = load_train_state(str(tmp_path / "train"), cfg, device="cpu")
        for a, b in zip(param_leaves(state.params), param_leaves(on_mesh.params)):
            assert torch.equal(a, b)
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(state.optimizer.state[a][key], on_mesh.optimizer.state[b][key])
        _trees_equal(gather_params(on_mesh.params), free.params)
        # The next step: the in-memory state and the mesh restore alike bit
        # for bit, the mesh-free restore at the float32 bar.
        state, loss = train_step(state, cfg, tokens)
        on_mesh, loss_mesh = train_step(on_mesh, cfg, tokens)
        free, loss_free = train_step(free, cfg, tokens)
        assert float(loss) == float(loss_mesh)
        _trees_equal(state.params, on_mesh.params)
        np.testing.assert_allclose(float(loss_mesh), float(loss_free), **F32)
        for a, b in zip(param_leaves(gather_params(on_mesh.params)), param_leaves(free.params)):
            np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-5, atol=2e-4)

    def test_a_fresh_state_restores_onto_a_mesh(self, tmp_path):
        """A state saved before its first step has no moments yet: the
        restore onto a mesh gives an AdamW with none, which then steps."""
        state = make_train_state(TINY_LLAMA, 6, device="cpu")
        save_train_state(str(tmp_path / "train"), state)
        resumed = load_train_state(str(tmp_path / "train"), TINY_LLAMA, device="cpu", mesh=mesh22())
        assert resumed.step == 0 and not resumed.optimizer.state
        resumed, loss = train_step(resumed, TINY_LLAMA, _tokens(TINY_LLAMA, 6))
        assert np.isfinite(float(loss)) and resumed.step == 1
