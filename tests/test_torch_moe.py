"""The port's MoE FFN (``models/llama.py``: ``_moe_gates``,
``_moe_mlp_routed``, ``_moe_mlp_dense``) against the JAX package's, on the
CPU, for TINY_MOE and TINY_QWEN3_MOE, with full-precision and with int8
expert stacks (``quantize="int8", quantize_experts=True``); the JAX
parameters are carried over with ``params_from_jax``. The whole model on
these configs (prefill and decode logits, greedy tokens) is held in
``tests/test_torch_llama.py``, whose model fixture carries them as cases.

Tolerances: gate indices exact; float32 values rtol 1e-5, atol 1e-5 (the
same products summed in other orders, and for int8 experts ``(x @ q) *
scale`` against JAX's ``x @ (q * scale)`` on the CPU — both exact products
in float32, rounded differently once); bfloat16 activations 2e-2 (a few
bf16 roundings of O(1) values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import params_from_jax

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CASES = {
    "tiny-moe": ("TINY_MOE", None),
    "tiny-qwen3-moe": ("TINY_QWEN3_MOE", None),
    "tiny-moe-int8": ("TINY_MOE", "int8"),
    "tiny-qwen3-moe-int8": ("TINY_QWEN3_MOE", "int8"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layers(name, **replace):
    preset, quantize = CASES[name]
    jcfg = dataclasses.replace(getattr(jl, preset), **replace)
    tcfg = dataclasses.replace(getattr(tl, preset), **{
        k: (torch.bfloat16 if v is jnp.bfloat16 else v) for k, v in replace.items()
    })
    jp = jl.init_params(jax.random.PRNGKey(5), jcfg, quantize=quantize,
                        quantize_experts=quantize is not None)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp["layers"][0], tp["layers"][0]


@pytest.fixture(params=list(CASES), scope="module")
def moe(request):
    return _layers(request.param)


def _x(cfg, shape, seed=11):
    x = np.random.default_rng(seed).standard_normal((*shape, cfg.hidden_size)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("shape", [(1, 1), (3, 17)])
def test_gates_match(moe, shape):
    jcfg, tcfg, jlayer, tlayer = moe
    jx, tx = _x(jcfg, shape)
    jv, ji = jl._moe_gates(jlayer, jcfg, jx)
    tv, ti = tl._moe_gates(tlayer, tcfg, tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (3, 17)])
def test_routed_and_dense_match_jax(moe, shape):
    jcfg, tcfg, jlayer, tlayer = moe
    jx, tx = _x(jcfg, shape)
    routed = tl._moe_mlp_routed(tlayer, tcfg, tx)
    dense = tl._moe_mlp_dense(tlayer, tcfg, tx)
    np.testing.assert_allclose(routed.numpy(), np.asarray(jl._moe_mlp_routed(jlayer, jcfg, jx)), **F32)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jl._moe_mlp_dense(jlayer, jcfg, jx)), **F32)
    # The routed dispatch against the dense oracle, as the JAX tests hold it.
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), **F32)


@pytest.mark.parametrize("name", ["tiny-qwen3-moe", "tiny-qwen3-moe-int8"])
def test_routed_bfloat16_matches_jax(name):
    jcfg, tcfg, jlayer, tlayer = _layers(name, dtype=jnp.bfloat16)
    jx, tx = _x(jcfg, (2, 9), seed=3)
    out = tl._moe_mlp(tlayer, tcfg, tx.to(torch.bfloat16))
    ref = jl._moe_mlp(jlayer, jcfg, jx.astype(jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **BF16)


def test_unknown_dispatch_rejected():
    jcfg, tcfg, _, tlayer = _layers("tiny-moe")
    x = torch.zeros((1, 2, tcfg.hidden_size))
    with pytest.raises(ValueError, match="moe_dispatch"):
        tl._moe_mlp(tlayer, dataclasses.replace(tcfg, moe_dispatch="nope"), x)


def test_routed_group_sizes_count_every_assignment(monkeypatch):
    """The routed layer's group sizes come from ``scatter_add_`` (no host
    read): every (token, slot) pair lands in its expert's group, padded
    rows included, and all three products get the same sizes."""
    jcfg, tcfg, _, tlayer = _layers("tiny-qwen3-moe")
    seen = []
    orig = tl._grouped_dot

    def spy_dot(cfg, row_group_ids):
        gdot = orig(cfg, row_group_ids)

        def spy(lhs, w, group_sizes):
            seen.append(group_sizes.clone())
            return gdot(lhs, w, group_sizes)

        return spy

    monkeypatch.setattr(tl, "_grouped_dot", spy_dot)
    _, tx = _x(jcfg, (2, 5))
    _, topi = tl._moe_gates(tlayer, tcfg, tx.reshape(10, -1))
    tl._moe_mlp_routed(tlayer, tcfg, tx)
    expect = np.bincount(topi.reshape(-1).numpy(), minlength=tcfg.n_experts)
    assert len(seen) == 3
    for gs in seen:
        assert gs.dtype == torch.int32
        np.testing.assert_array_equal(gs.numpy(), expect)
