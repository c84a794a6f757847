"""Checkpoint round trips of the port (``parallel/checkpoint.py``), mirroring
the JAX package's ``tests/test_checkpoint.py`` on the CPU: params and train
state come back bit-equal, a resumed run equals the uninterrupted one bit
for bit (the same float32 operations on the same device), int8 params keep
their ``QuantizedTensor`` nodes, and restored int8 params serve the same
greedy tokens. The sharded-restore cases are in
``test_torch_mesh_checkpoint.py``.
"""

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA, QuantizedTensor, init_params
from llm_d_kv_cache_manager_tpu_torch.parallel import (
    load_params,
    load_train_state,
    save_params,
    save_train_state,
)
from llm_d_kv_cache_manager_tpu_torch.parallel.train import make_train_state, param_leaves, train_step
from llm_d_kv_cache_manager_tpu_torch.server import (
    BlockManagerConfig,
    Engine,
    EngineConfig,
    SamplingParams,
)


def _params(seed, **kw):
    return init_params(TINY_LLAMA, torch.Generator().manual_seed(seed), "cpu", **kw)


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


def _tokens(seed, shape=(2, 16)):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, TINY_LLAMA.vocab_size, shape))


class TestCheckpoint:
    def test_params_roundtrip(self, tmp_path):
        params = _params(0)
        save_params(str(tmp_path / "ckpt"), params)
        restored = load_params(str(tmp_path / "ckpt"), device="cpu")
        _trees_equal(params, restored)
        assert list(restored) == list(params)
        assert not any(t.requires_grad for t in param_leaves(restored))
        _trees_equal(params, load_params(str(tmp_path / "ckpt"), TINY_LLAMA, device="cpu"))

    def test_train_state_roundtrip_and_resume(self, tmp_path):
        state = make_train_state(TINY_LLAMA, 2, device="cpu")
        tokens = _tokens(0)
        state, _ = train_step(state, TINY_LLAMA, tokens)
        save_train_state(str(tmp_path / "train"), state)

        resumed = load_train_state(str(tmp_path / "train"), TINY_LLAMA, device="cpu")
        assert resumed.step == state.step == 1
        _trees_equal(state.params, resumed.params)
        for p, q in zip(param_leaves(state.params), param_leaves(resumed.params)):
            a, b = state.optimizer.state[p], resumed.optimizer.state[q]
            assert sorted(a) == sorted(b) == ["exp_avg", "exp_avg_sq", "step"]
            for key in a:
                assert torch.equal(a[key], b[key]) and a[key].device == b[key].device

        # Training continues deterministically from the restored state.
        next_a, loss_a = train_step(state, TINY_LLAMA, tokens)
        next_b, loss_b = train_step(resumed, TINY_LLAMA, tokens)
        assert float(loss_a) == float(loss_b)
        _trees_equal(next_a.params, next_b.params)

    def test_resumed_run_equals_uninterrupted(self, tmp_path):
        tokens = [_tokens(s) for s in range(4)]
        straight = make_train_state(TINY_LLAMA, 3, device="cpu")
        for t in tokens:
            straight, loss_straight = train_step(straight, TINY_LLAMA, t)
        state = make_train_state(TINY_LLAMA, 3, device="cpu")
        for t in tokens[:2]:
            state, _ = train_step(state, TINY_LLAMA, t)
        save_train_state(str(tmp_path / "train"), state)
        state = load_train_state(str(tmp_path / "train"), TINY_LLAMA, device="cpu")
        for t in tokens[2:]:
            state, loss = train_step(state, TINY_LLAMA, t)
        assert state.step == straight.step == 4 and float(loss) == float(loss_straight)
        _trees_equal(straight.params, state.params)

    def test_restore_onto_a_mesh_is_accepted(self, tmp_path):
        """A mesh-free save restores onto a (dp=2, tp=2) mesh of CPU shards
        and gathers back bit-equal (``test_torch_mesh_checkpoint.py`` holds
        the shards against JAX's)."""
        from llm_d_kv_cache_manager_tpu_torch.parallel import (
            MeshConfig,
            gather_train_state,
            make_mesh,
        )

        state = make_train_state(TINY_LLAMA, 4, device="cpu")
        state, _ = train_step(state, TINY_LLAMA, _tokens(4))
        save_train_state(str(tmp_path / "train"), state)
        mesh = make_mesh(MeshConfig(dp=2, tp=2), devices=["cpu"] * 4)
        resumed = load_train_state(str(tmp_path / "train"), TINY_LLAMA, device="cpu", mesh=mesh)
        assert resumed.step == 1 and resumed.params.mesh is mesh
        back = gather_train_state(resumed)
        _trees_equal(state.params, back.params)
        for p, q in zip(param_leaves(state.params), param_leaves(back.params)):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(state.optimizer.state[p][key], back.optimizer.state[q][key])


class TestQuantizedCheckpoint:
    def test_quantized_roundtrip_exact(self, tmp_path):
        params = _params(3, quantize="int8")
        save_params(str(tmp_path / "q"), params)
        restored = load_params(str(tmp_path / "q"), TINY_LLAMA, quantize="int8", device="cpu")
        # The same QuantizedTensor nodes, bit-identical codes and scales.
        for layer, rlayer in zip(params["layers"], restored["layers"]):
            assert {k: type(v) for k, v in layer.items()} == {k: type(v) for k, v in rlayer.items()}
        assert isinstance(restored["lm_head"], QuantizedTensor)
        _trees_equal(params, restored)
        with pytest.raises(ValueError, match="quantize='int8'"):
            load_params(str(tmp_path / "q"), TINY_LLAMA, device="cpu")
        # With no cfg the tree comes back as saved: int8 weights as dicts.
        raw = load_params(str(tmp_path / "q"), device="cpu")
        assert sorted(raw["lm_head"]) == ["q", "scale"]

    def test_quantized_restore_serves_identical_tokens(self, tmp_path):
        params = _params(4, quantize="int8")
        save_params(str(tmp_path / "q"), params)
        restored = load_params(str(tmp_path / "q"), TINY_LLAMA, quantize="int8", device="cpu")
        prompt = np.random.default_rng(5).integers(0, TINY_LLAMA.vocab_size, 12).tolist()

        def serve(p):
            eng = Engine(
                EngineConfig(
                    model=TINY_LLAMA,
                    block_manager=BlockManagerConfig(total_pages=32, page_size=4),
                    max_model_len=32,
                    decode_batch_size=2,
                    prefill_bucket=8,
                    quantize=None,  # params are already quantized
                ),
                params=p,
                device="cpu",
            )
            seq = eng.add_request(prompt, SamplingParams(max_new_tokens=4))
            eng.run_until_complete()
            return seq.output_tokens

        tokens = serve(params)
        assert len(tokens) == 4 and serve(restored) == tokens
