"""The port's training step (``parallel/train.py``, ``ops.
causal_prefill_attention``, ``models.convert.train_state_from_jax``)
against the JAX package's, on the CPU, on the same parameters (JAX's
``init_params`` carried over with ``params_from_jax``) and the same numpy
tokens.

The JAX side runs ``jax.value_and_grad(loss_fn)`` and its jitted
``train_step`` (optax AdamW); its routed MoE on the CPU is
``jax.lax.ragged_dot`` under ``jax.grad``, the port's is ``GroupedMatmul``
with the plain backward. Tolerances (float32 throughout):
- attention and the loss: rtol 1e-5, atol 1e-6 (the same float32
  operations in other orders);
- gradients: rtol 1e-4, atol 1e-6 (the backward sums the same products in
  other orders through a few layers, and the softmax over the vocabulary
  subtracts nearly equal terms);
- parameters after AdamW steps: rtol 1e-5 plus atol 2·lr a step. Adam
  divides a moment by the root of the squared one, so an element whose
  gradient is within rounding noise of zero can step by up to lr either
  way in the two packages; every other element steps alike. The losses of
  later steps still agree to rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.ops.attention import causal_prefill_attention as j_attention
from llm_d_kv_cache_manager_tpu.parallel import train as jt
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import params_from_jax, train_state_from_jax
from llm_d_kv_cache_manager_tpu_torch.ops import causal_prefill_attention
from llm_d_kv_cache_manager_tpu_torch.parallel import train as tt

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
PRESETS = ("TINY_LLAMA", "TINY_GEMMA", "TINY_MOE", "TINY_QWEN3_MOE")
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tokens(cfg, seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _models(preset, seed=0, **replace):
    """(JAX cfg, port cfg, JAX params, port params carried over)."""
    jcfg = dataclasses.replace(getattr(jl, preset), **replace)
    tcfg = dataclasses.replace(getattr(tl, preset), **replace)
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def test_causal_prefill_attention_matches_jax():
    """GQA group 2, absolute positions that do not start at 0, padding
    keys, and one row fully padded (JAX's NaN softmax zeroed)."""
    rng = np.random.default_rng(1)
    b, s, n_q, n_kv, d = 3, 9, 4, 2, 16
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for h in (n_q, n_kv, n_kv))
    positions = (np.arange(s)[None, :] + np.array([[0], [5], [2]])).astype(np.int32)
    valid = np.ones((b, s), bool)
    valid[1, 6:] = False
    valid[2, :] = False
    ref = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      positions=jnp.asarray(positions), valid=jnp.asarray(valid))
    out = causal_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        positions=torch.from_numpy(positions), valid=torch.from_numpy(valid),
    )
    assert out.shape == (b, s, n_q, d)
    assert not out[2].any() and np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    plain = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = causal_prefill_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(plain), **F32)


def test_fully_padded_rows_give_finite_gradients():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 5, 2, 8)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    valid = torch.tensor([[True] * 5, [False] * 5])
    causal_prefill_attention(q, k, v, valid=valid).sum().backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
    assert not q.grad[1].any()


@pytest.mark.parametrize("preset", PRESETS)
def test_loss_and_every_gradient_match_jax(preset):
    jcfg, tcfg, jp, tp = _models(preset)
    tokens = _tokens(tcfg)
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(jp, jcfg, jnp.asarray(tokens))
    tt.trainable(tp)
    loss = tt.loss_fn(tp, tcfg, torch.from_numpy(tokens))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    leaves = tt.param_leaves(tp)
    jleaves = _leaves(jgrads)
    assert len(leaves) == len(jleaves)
    for p, g in zip(leaves, jleaves):
        assert p.grad is not None and p.grad.shape == g.shape
        np.testing.assert_allclose(p.grad.numpy(), g, **GRAD)


@pytest.mark.parametrize("preset", ("TINY_LLAMA", "TINY_QWEN3_MOE"))
def test_three_adamw_steps_match_optax(preset):
    jcfg, tcfg, jp, tp = _models(preset, seed=1)
    tokens = _tokens(tcfg, seed=1)
    jstate = jt.TrainState(jp, jt.make_optimizer(LR).init(jp), jnp.zeros((), jnp.int32))
    tstate = tt.TrainState(tt.trainable(tp), tt.make_optimizer(tp, LR), 0)
    for step in range(3):
        jstate, jloss = jt.train_step(jstate, jcfg, jnp.asarray(tokens), LR)
        tstate, loss = tt.train_step(tstate, tcfg, torch.from_numpy(tokens), LR)
        np.testing.assert_allclose(float(loss), float(jloss), **F32)
        for p, j in zip(tt.param_leaves(tstate.params), _leaves(jstate.params)):
            np.testing.assert_allclose(p.detach().numpy(), j, rtol=1e-5,
                                       atol=2 * LR * (step + 1))
    assert tstate.step == int(jstate.step) == 3


def test_a_carried_jax_state_steps_like_jax():
    """Two JAX steps, the state carried into the port with
    ``train_state_from_jax`` (params, optax's count / mu / nu), then one
    more step on each side."""
    jcfg, tcfg, jp, _ = _models("TINY_QWEN3_MOE", seed=2)
    tokens = jnp.asarray(_tokens(tcfg, seed=2))
    jstate = jt.TrainState(jp, jt.make_optimizer(LR).init(jp), jnp.zeros((), jnp.int32))
    for _ in range(2):
        jstate, _ = jt.train_step(jstate, jcfg, tokens, LR)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, "cpu", lr=LR)
    assert tstate.step == 2
    adam = jstate.opt_state[0]
    for p, mu, nu in zip(tt.param_leaves(tstate.params), _leaves(adam.mu), _leaves(adam.nu)):
        st = tstate.optimizer.state[p]
        assert float(st["step"]) == 2.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu)
    jstate, jloss = jt.train_step(jstate, jcfg, tokens, LR)
    tstate, loss = tt.train_step(tstate, tcfg, torch.from_numpy(np.asarray(tokens)), LR)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    for p, j in zip(tt.param_leaves(tstate.params), _leaves(jstate.params)):
        np.testing.assert_allclose(p.detach().numpy(), j, rtol=1e-5, atol=2 * LR)


@pytest.mark.parametrize("preset", ("TINY_MOE", "TINY_QWEN3_MOE"))
def test_routed_and_dense_moe_gradients_are_equal(preset):
    _, tcfg, _, tp = _models(preset, seed=3)
    tokens = torch.from_numpy(_tokens(tcfg, seed=3))
    grads = {}
    for dispatch in ("routed", "dense"):
        cfg = dataclasses.replace(tcfg, moe_dispatch=dispatch)
        params = tt.detached(tp)
        tt.trainable(params)
        tt.loss_fn(params, cfg, tokens).backward()
        grads[dispatch] = [p.grad for p in tt.param_leaves(params)]
    for a, b in zip(grads["routed"], grads["dense"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_qk_norm_params_receive_gradient():
    """The training forward shares the serving path's q/k projection, Qwen3
    qk-norm included (mirrors ``tests/test_parallel.py``)."""
    cfg = dataclasses.replace(tl.TINY_LLAMA, qk_norm=True)
    state = tt.make_train_state(cfg, 4, device="cpu")
    tt.loss_fn(state.params, cfg, torch.from_numpy(_tokens(cfg, seed=14, shape=(2, 8)))).backward()
    assert float(state.params["layers"][0]["q_norm"].grad.abs().sum()) > 0


def test_a_few_steps_lower_the_loss_also_over_a_mesh():
    """Four steps lower the loss on one device and over a (dp=2, tp=2)
    mesh of CPU shards (``tests/test_torch_mesh_train.py`` holds the mesh
    against JAX's); a mesh the params are not sharded over is refused, and
    so is training over sp > 1."""
    from llm_d_kv_cache_manager_tpu_torch.parallel import MeshConfig, make_mesh

    cfg = tl.TINY_QWEN3_MOE
    tokens = torch.from_numpy(_tokens(cfg, seed=5))
    mesh = make_mesh(MeshConfig(dp=2, tp=2), devices=["cpu"] * 4)
    for m in (None, mesh):
        state = tt.make_train_state(cfg, torch.Generator().manual_seed(5), lr=1e-3, device="cpu",
                                    mesh=m)
        losses = []
        for _ in range(4):
            state, loss = tt.train_step(state, cfg, tokens, lr=1e-3, mesh=m)
            losses.append(float(loss))
        assert losses[-1] < losses[0] and state.step == 4
    with pytest.raises(ValueError, match="another mesh"):
        tt.train_step(state, cfg, tokens, mesh=make_mesh(MeshConfig(tp=4), devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="sp > 1"):
        tt.make_train_state(cfg, 5, device="cpu",
                            mesh=make_mesh(MeshConfig(tp=2, sp=2), devices=["cpu"] * 4))


def test_plain_grouped_matmul_differentiates_like_grouped_matmul():
    """``moe_gmm="xla"`` (the plain version under autograd, the card's
    gradient reference) and the default path (``GroupedMatmul``'s plain
    backward on the CPU) give the same gradients."""
    _, tcfg, _, tp = _models("TINY_QWEN3_MOE", seed=6)
    tokens = torch.from_numpy(_tokens(tcfg, seed=6))
    grads = {}
    for gmm in ("auto", "xla"):
        params = tt.trainable(tt.detached(tp))
        tt.loss_fn(params, dataclasses.replace(tcfg, moe_gmm=gmm), tokens).backward()
        grads[gmm] = [p.grad for p in tt.param_leaves(params)]
    for a, b in zip(grads["auto"], grads["xla"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)
