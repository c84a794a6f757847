"""The port's mesh training (``parallel/train.py`` over ``make_mesh(MeshConfig(dp,
tp))``, ``parallel/sharding.py``'s training shard and batch split) against
the JAX package's ``train_step`` jitted over its (dp, tp) mesh, on the CPU.

The port's shards all run on the CPU device (``devices=["cpu"] * n``, the
``"same_device"`` collective); JAX's mesh is conftest's 8 host devices. The
cases mirror ``tests/test_parallel.py``'s ``TestShardedTraining`` and the
training cases of ``TestMoEExpertParallel``: TINY_LLAMA at dp=4×tp=2 and
dp=2×tp=2, TINY_MOE at dp=2×tp=4 (the dense selection), E=3 at tp=2 (the
split-width fallback) and the a3b-shaped E=16 top-2 at dp=2×tp=4 (routed
expert parallelism). Weights come from JAX's ``init_params`` through
``params_from_jax``, tokens from numpy seeds. Bars are
``test_torch_train.py``'s, float32 throughout:

- the loss: rtol 1e-5, atol 1e-6 (``F32``), against JAX's mesh loss and
  against the port's mesh-free loss;
- every gathered gradient: rtol 1e-4, atol 1e-6 (``GRAD``);
- forward logits: JAX's own 1e-4 (``LOGITS``);
- parameters after AdamW steps: rtol 1e-5 plus atol 2·lr a step (Adam's
  near-zero gradients, ``test_torch_train.py`` says why).

The port's invariant beside them: after the steps every copy of a
replicated leaf and every dp replica of every leaf are bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.parallel import MeshConfig as JMeshConfig
from llm_d_kv_cache_manager_tpu.parallel import make_mesh as j_make_mesh
from llm_d_kv_cache_manager_tpu.parallel import sharding as jsharding
from llm_d_kv_cache_manager_tpu.parallel import train as jt
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import params_from_jax, train_state_from_jax
from llm_d_kv_cache_manager_tpu_torch.ops import gmm as tgmm
from llm_d_kv_cache_manager_tpu_torch.parallel import (
    MeshConfig,
    ShardedParams,
    batch_sharding,
    gather_params,
    make_mesh,
    shard_batch,
    shard_train_params,
)
from llm_d_kv_cache_manager_tpu_torch.parallel import train as tt

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
LOGITS = dict(rtol=1e-4, atol=1e-4)
LR = 1e-4

#: (port preset, replacements): the models of JAX's training cases
MODELS = {
    "tiny-llama": ("TINY_LLAMA", {}),
    "tiny-moe": ("TINY_MOE", {}),
    "tiny-moe-e3": ("TINY_MOE", dict(n_experts=3)),
    "a3b-shaped": ("TINY_QWEN3_MOE", dict(n_experts=16, n_experts_per_tok=2)),
}
#: (model, dp, tp, batch): JAX's meshes and batches for each
CASES = {
    "llama-dp4-tp2": ("tiny-llama", 4, 2, 8),
    "llama-dp2-tp2": ("tiny-llama", 2, 2, 4),
    "moe-dp2-tp4-dense": ("tiny-moe", 2, 4, 4),
    "moe-e3-dp2-tp2-split-width": ("tiny-moe-e3", 2, 2, 4),
    "a3b-dp2-tp4-routed-ep": ("a3b-shaped", 2, 4, 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(name, seed=0):
    preset, changes = MODELS[name]
    jcfg = dataclasses.replace(getattr(jl, preset), **changes)
    tcfg = dataclasses.replace(getattr(tl, preset), **changes)
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _tokens(cfg, batch, seed=0, s=16):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, s)).astype(np.int32)


def cpu_mesh(dp=1, tp=1, sp=1):
    return make_mesh(MeshConfig(dp=dp, tp=tp, sp=sp), devices=["cpu"] * (dp * tp * sp))


def _jax_mesh(dp, tp):
    return j_make_mesh(JMeshConfig(dp=dp, tp=tp))


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _jax_state(jp, jcfg, jmesh):
    params = jsharding.shard_params(jp, jmesh, jcfg)
    opt_state = jax.jit(jt.make_optimizer(LR).init)(params)
    return jt.TrainState(params, opt_state, jnp.zeros((), jnp.int32))


def _jax_tokens(tokens, jmesh):
    return jax.device_put(jnp.asarray(tokens), jsharding.batch_sharding(jmesh))


def _port_state(tparams, tcfg, mesh):
    params = tt.trainable(shard_train_params(tparams, mesh, tcfg))
    return tt.TrainState(params, tt.make_optimizer(params, LR), 0)


def _assert_copies_bit_equal(sharded: ShardedParams):
    """Every dp replica equal to the first, leaf for leaf, and every copy
    of a replicated leaf equal to the first shard's."""
    from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import leaf_specs

    first = [tt.param_leaves(tree) for tree in sharded.replicas[0][0]]
    for grid in sharded.replicas[1:]:
        for a, tree in zip(first, grid[0]):
            for x, y in zip(a, tt.param_leaves(tree)):
                assert torch.equal(x, y)
    specs = leaf_specs(sharded.replicas[0][0][0], sharded.specs)
    for i, spec in enumerate(specs):
        if "tp" not in spec:
            for leaves in first[1:]:
                assert torch.equal(leaves[i], first[0][i])


class TestMesh:
    def test_dp_tp_grid_in_jax_axis_order(self):
        devs = [torch.device("cpu")] * 8
        mesh = make_mesh(MeshConfig(dp=2, tp=2, sp=2), devices=devs)
        assert mesh.shape == {"dp": 2, "sp": 2, "tp": 2}
        assert len(mesh.replicas) == 2 and mesh.grid is mesh.replicas[0]
        assert [len(r) for r in mesh.grid] == [2, 2]
        rep = mesh.replica(1)
        assert rep.shape == {"dp": 1, "sp": 2, "tp": 2} and rep.collective is mesh.collective
        assert mesh.describe()["dp"] == 2 and len(mesh.describe()["devices"]) == 8

    def test_dp_mesh_builds_over_cpu_devices(self):
        mesh = make_mesh(MeshConfig(dp=2, tp=2), devices=["cpu"] * 4)
        assert mesh.collective.name == "same_device" and len(mesh.devices) == 4

    def test_too_few_devices_for_dp(self):
        with pytest.raises(ValueError, match="mesh needs 8 devices"):
            make_mesh(MeshConfig(dp=4, tp=2), devices=["cpu"] * 4)

    def test_reduce_grads_is_float32_in_order_into_every_part(self):
        mesh = cpu_mesh(dp=2, tp=2)
        parts = [torch.tensor([1.0, 2.0 ** -9], dtype=torch.bfloat16) for _ in range(3)]
        mesh.collective.reduce_grads(parts)
        want = (torch.tensor([1.0, 2.0 ** -9]) * 3).to(torch.bfloat16)
        for p in parts:
            assert torch.equal(p, want)

    def test_same_device_sum_is_differentiable(self):
        coll = cpu_mesh(tp=2).collective
        parts = [torch.randn(3, dtype=torch.bfloat16, requires_grad=True) for _ in range(2)]
        coll.sum(parts, torch.bfloat16).float().sum().backward()
        for p in parts:
            assert torch.equal(p.grad, torch.ones(3, dtype=torch.bfloat16))


class TestBatchAndShard:
    def test_batch_splits_over_dp(self):
        assert batch_sharding() == ("dp",)
        tokens = torch.arange(8 * 3).reshape(8, 3)
        parts = shard_batch(tokens, cpu_mesh(dp=4, tp=2))
        assert [p.tolist() for p in parts] == [tokens[2 * d : 2 * d + 2].tolist() for d in range(4)]

    def test_uneven_batch_raises(self):
        with pytest.raises(ValueError, match="split evenly"):
            shard_batch(torch.zeros((3, 4), dtype=torch.int32), cpu_mesh(dp=2))

    @pytest.mark.parametrize("case", ["llama-dp2-tp2", "a3b-dp2-tp4-routed-ep"])
    def test_every_shard_owns_its_leaves_and_gathers_back(self, case):
        name, dp, tp, _ = CASES[case]
        _, tcfg, _, tparams = _model(name)
        sharded = shard_train_params(tparams, cpu_mesh(dp=dp, tp=tp), tcfg)
        leaves = tt.param_leaves(sharded)
        assert len(leaves) == dp * tp * len(tt.param_leaves(tparams))
        assert len({t.data_ptr() for t in leaves}) == len(leaves)
        assert all(t.is_contiguous() for t in leaves)
        back = gather_params(sharded)
        for a, b in zip(tt.param_leaves(back), tt.param_leaves(tparams)):
            assert torch.equal(a, b)

    def test_sp_is_refused_in_training(self):
        _, tcfg, _, tparams = _model("tiny-llama")
        mesh = cpu_mesh(dp=1, tp=2, sp=2)
        with pytest.raises(ValueError, match="sp > 1"):
            tt.make_train_state(tcfg, 0, device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="sp > 1"):
            tt.loss_fn(shard_train_params(tparams, mesh, tcfg), tcfg,
                       torch.from_numpy(_tokens(tcfg, 2)))

    def test_plain_params_with_a_mesh_raise(self):
        _, tcfg, _, tparams = _model("tiny-llama")
        with pytest.raises(ValueError, match="shard_train_params"):
            tt.loss_fn(tparams, tcfg, torch.from_numpy(_tokens(tcfg, 2)), mesh=cpu_mesh(dp=2))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_jax_mesh(case):
    """One forward and backward: the loss against JAX's over its mesh and
    the port's mesh-free loss; every gathered (reduced) gradient against
    JAX's gradient and the mesh-free one."""
    name, dp, tp, batch = CASES[case]
    jcfg, tcfg, jp, tparams = _model(name, seed=1)
    tokens = _tokens(tcfg, batch, seed=1)
    jmesh = _jax_mesh(dp, tp)
    jparams = jsharding.shard_params(jp, jmesh, jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.loss_fn), static_argnames=("cfg", "mesh"))(
        jparams, jcfg, _jax_tokens(tokens, jmesh), mesh=jmesh)

    free = tt.trainable(tt.detached(tparams))
    free_loss = tt.loss_fn(free, tcfg, torch.from_numpy(tokens))
    free_loss.backward()

    sharded = tt.trainable(shard_train_params(tparams, cpu_mesh(dp=dp, tp=tp), tcfg))
    loss = tt.loss_fn(sharded, tcfg, torch.from_numpy(tokens))
    loss.backward()
    tt.reduce_grads(sharded)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    np.testing.assert_allclose(float(loss.detach()), float(free_loss.detach()), **F32)
    grads = tt.gather_grads(sharded)
    jleaves = _leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, j, p in zip(grads, jleaves, tt.param_leaves(free)):
        assert g is not None and g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), j, **GRAD)
        np.testing.assert_allclose(g.numpy(), p.grad.numpy(), **GRAD)


@pytest.mark.parametrize("case", ["moe-dp2-tp4-dense", "moe-e3-dp2-tp2-split-width",
                                  "a3b-dp2-tp4-routed-ep"])
def test_moe_sharded_forward_matches_jax_and_single_device(case):
    name, dp, tp, batch = CASES[case]
    jcfg, tcfg, jp, tparams = _model(name, seed=2)
    tokens = _tokens(tcfg, batch, seed=2)
    jmesh = _jax_mesh(dp, tp)
    ref = jax.jit(jt._forward_logits, static_argnames=("cfg", "mesh"))(
        jsharding.shard_params(jp, jmesh, jcfg), jcfg, _jax_tokens(tokens, jmesh), mesh=jmesh)
    with torch.no_grad():
        free = tt._forward_logits(tparams, tcfg, torch.from_numpy(tokens))
        out = tt._forward_logits(shard_train_params(tparams, cpu_mesh(dp=dp, tp=tp), tcfg), tcfg,
                                 torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGITS)
    np.testing.assert_allclose(out.numpy(), free.numpy(), **LOGITS)


@pytest.mark.parametrize("case,steps", [("llama-dp4-tp2", 5), ("moe-dp2-tp4-dense", 4),
                                        ("a3b-dp2-tp4-routed-ep", 4)])
def test_adamw_steps_match_jax_mesh_and_copies_stay_bit_equal(case, steps):
    """JAX's ``test_train_step_runs_and_learns`` / ``test_moe_train_step_runs``
    / ``test_routed_ep_train_step_learns`` on both packages: each step's
    loss against JAX's mesh step, the gathered parameters after each step,
    a falling loss, and every copy bit-equal at the end."""
    name, dp, tp, batch = CASES[case]
    jcfg, tcfg, jp, tparams = _model(name, seed=3)
    tokens = _tokens(tcfg, batch, seed=3)
    jmesh = _jax_mesh(dp, tp)
    jstate = _jax_state(jp, jcfg, jmesh)
    jtok = _jax_tokens(tokens, jmesh)
    state = _port_state(tparams, tcfg, cpu_mesh(dp=dp, tp=tp))
    losses = []
    for step in range(steps):
        jstate, jloss = jt.train_step(jstate, jcfg, jtok, LR, mesh=jmesh)
        state, loss = tt.train_step(state, tcfg, torch.from_numpy(tokens), LR)
        losses.append(float(loss))
        np.testing.assert_allclose(float(loss), float(jloss), **F32)
        for p, j in zip(tt.param_leaves(gather_params(state.params)), _leaves(jstate.params)):
            np.testing.assert_allclose(p.numpy(), j, rtol=1e-5, atol=2 * LR * (step + 1))
    assert losses[-1] < losses[0]
    assert state.step == int(jstate.step) == steps
    _assert_copies_bit_equal(state.params)


@pytest.mark.parametrize("case", ["llama-dp2-tp2", "a3b-dp2-tp4-routed-ep"])
def test_mesh_steps_match_mesh_free_steps(case):
    """Three AdamW steps over the mesh and on one device, from the same
    weights: the losses at F32 and the parameters at the AdamW bar."""
    name, dp, tp, batch = CASES[case]
    _, tcfg, _, tparams = _model(name, seed=4)
    tokens = torch.from_numpy(_tokens(tcfg, batch, seed=4))
    free = tt.trainable(tt.detached(tparams))
    free_state = tt.TrainState(free, tt.make_optimizer(free, LR), 0)
    state = _port_state(tparams, tcfg, cpu_mesh(dp=dp, tp=tp))
    for step in range(3):
        free_state, free_loss = tt.train_step(free_state, tcfg, tokens, LR)
        state, loss = tt.train_step(state, tcfg, tokens, LR)
        np.testing.assert_allclose(float(loss), float(free_loss), **F32)
        for p, q in zip(tt.param_leaves(gather_params(state.params)), tt.param_leaves(free)):
            np.testing.assert_allclose(p.numpy(), q.detach().numpy(), rtol=1e-5,
                                       atol=2 * LR * (step + 1))
    _assert_copies_bit_equal(state.params)


def test_a_carried_jax_mesh_state_steps_like_jax():
    """Two JAX steps over a (dp=2, tp=4) mesh on the routed-EP model; the
    state (whole numpy leaves) carried over by ``train_state_from_jax``,
    placed on the port's mesh by ``shard_train_state``, then one more step
    on each side."""
    name, dp, tp, batch = CASES["a3b-dp2-tp4-routed-ep"]
    jcfg, tcfg, jp, _ = _model(name, seed=5)
    tokens = _tokens(tcfg, batch, seed=5)
    jmesh = _jax_mesh(dp, tp)
    jstate = _jax_state(jp, jcfg, jmesh)
    jtok = _jax_tokens(tokens, jmesh)
    for _ in range(2):
        jstate, _ = jt.train_step(jstate, jcfg, jtok, LR, mesh=jmesh)
    carried = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, "cpu", lr=LR)
    state = tt.shard_train_state(carried, cpu_mesh(dp=dp, tp=tp), tcfg)
    assert state.step == 2
    back = tt.gather_train_state(state)
    for p, q in zip(tt.param_leaves(back.params), tt.param_leaves(carried.params)):
        assert torch.equal(p, q.detach())
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(back.optimizer.state[p][key], carried.optimizer.state[q][key])
    jstate, jloss = jt.train_step(jstate, jcfg, jtok, LR, mesh=jmesh)
    state, loss = tt.train_step(state, tcfg, torch.from_numpy(tokens), LR)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    for p, j in zip(tt.param_leaves(gather_params(state.params)), _leaves(jstate.params)):
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-5, atol=2 * LR)
    _assert_copies_bit_equal(state.params)


def test_expert_shard_routes_rows_past_the_last_group():
    """On an expert shard (tp=4 of E=16, top-2) most rows belong to other
    shards' experts and sort past the shard's last group: the routed layer
    runs the grouped matmul over them and its backward must ignore them."""
    from llm_d_kv_cache_manager_tpu_torch.models import llama as model

    _, tcfg, _, tparams = _model("a3b-shaped", seed=6)
    sharded = shard_train_params(tparams, cpu_mesh(dp=1, tp=4), tcfg)
    seen = []
    orig = tgmm.GroupedMatmul.apply

    def spy(lhs, rhs, group_sizes, row_group_ids=None):
        seen.append((lhs.shape[0], int(group_sizes.sum()), rhs.shape[0]))
        return orig(lhs, rhs, group_sizes, row_group_ids)

    tgmm.GroupedMatmul.apply = spy
    try:
        tt.trainable(sharded)
        tt.loss_fn(sharded, tcfg, torch.from_numpy(_tokens(tcfg, 2, seed=6))).backward()
    finally:
        tgmm.GroupedMatmul.apply = orig
    assert seen and all(e == 4 for _, _, e in seen)
    assert all(in_groups < rows for rows, in_groups, _ in seen)
    assert sum(in_groups for _, in_groups, _ in seen) * 4 == sum(rows for rows, _, _ in seen)
    del model


@pytest.mark.parametrize("past", [1, 37])
def test_plain_grouped_matmul_backward_ignores_rows_past_the_last_group(past):
    """``GroupedMatmul``'s plain backward (the CPU's, and the card's
    reference): ``dlhs`` rows past the last group are zero, and ``drhs``
    equals the backward over the in-group rows alone."""
    g = torch.Generator().manual_seed(past)
    sizes = torch.tensor([3, 0, 5, 2], dtype=torch.int32)
    n_in = int(sizes.sum())
    lhs = torch.randn((n_in + past, 8), generator=g, requires_grad=True)
    rhs = torch.randn((4, 8, 6), generator=g, requires_grad=True)
    dout = torch.randn((n_in + past, 6), generator=g)
    tgmm.GroupedMatmul.apply(lhs, rhs, sizes).backward(dout)
    assert not lhs.grad[n_in:].any()
    lhs2 = lhs.detach()[:n_in].clone().requires_grad_(True)
    rhs2 = rhs.detach().clone().requires_grad_(True)
    tgmm.GroupedMatmul.apply(lhs2, rhs2, sizes).backward(dout[:n_in])
    assert torch.equal(rhs.grad, rhs2.grad)
    assert torch.equal(lhs.grad[:n_in], lhs2.grad)
