"""The port's weight quantizer (``models/quant.py``) against the JAX
package's, on the same numpy weights.

Codes must be exactly equal (same f32 division, both round half to even);
scales are allclose at 1e-7 relative (one f32 division each). ``materialize``
is compared in float32 (exact products) and in bfloat16 (the scale is
rounded to bf16 before the multiply on both sides, so again exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import TINY_MOE as J_TINY_MOE
from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.models import quant as jq
from llm_d_kv_cache_manager_tpu_torch.models import TINY_MOE as T_TINY_MOE
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import quant as tq

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _weight(shape, dtype, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 0, :3] = 0.0  # a column whose max is set by the other rows
    if len(shape) == 2:
        w[:, 5] = 0.0  # an all-zero output channel: scale from the 1e-8 floor
    return jnp.asarray(w, JDT[dtype]), torch.from_numpy(w).to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 40)])
def test_quantize_tensor_codes_equal_scales_close(shape, dtype):
    jw, tw = _weight(shape, dtype)
    jqt = jq.quantize_tensor(jw)
    tqt = tq.quantize_tensor(tw)
    assert tqt.q.dtype == torch.int8 and tqt.scale.dtype == torch.float32
    assert tqt.shape == tw.shape and tqt.ndim == len(shape)
    assert tuple(tqt.scale.shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_allclose(tqt.scale.numpy(), np.asarray(jqt.scale), rtol=1e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_materialize_matches(dtype):
    jw, tw = _weight((40, 24), dtype, seed=1)
    jm = jq.materialize(jq.quantize_tensor(jw), JDT[dtype])
    tm = tq.materialize(tq.quantize_tensor(tw), TDT[dtype])
    assert tm.dtype == TDT[dtype]
    np.testing.assert_array_equal(tm.float().numpy(), np.asarray(jm, np.float32))
    assert tq.materialize(tw, TDT[dtype]) is tw  # full precision passes through


def _tree():
    jp = jl.init_params(jax.random.PRNGKey(0), J_TINY_MOE)
    from llm_d_kv_cache_manager_tpu_torch.models import params_from_jax

    return jp, params_from_jax(jax.tree.map(np.asarray, jp), T_TINY_MOE, "cpu")


@pytest.mark.parametrize("quantize_experts", [False, True])
def test_quantize_params_skips_stacks_and_router(quantize_experts):
    jp, tp = _tree()
    jqp = jq.quantize_params(jp, quantize_experts=quantize_experts)
    tqp = tq.quantize_params(tp, quantize_experts=quantize_experts)
    for jlayer, tlayer in zip(jqp["layers"], tqp["layers"]):
        assert set(jlayer) == set(tlayer)
        for name in jlayer:
            j_is = isinstance(jlayer[name], jq.QuantizedTensor)
            assert isinstance(tlayer[name], tq.QuantizedTensor) == j_is, name
            if j_is:
                np.testing.assert_array_equal(tlayer[name].q.numpy(), np.asarray(jlayer[name].q))
        assert not isinstance(tlayer["router"], tq.QuantizedTensor)
        stacked = isinstance(tlayer["w_gate"], tq.QuantizedTensor)
        assert stacked == quantize_experts
        assert isinstance(tlayer["wq"], tq.QuantizedTensor)
    assert isinstance(tqp["lm_head"], tq.QuantizedTensor)
    assert not isinstance(tqp["embed"], tq.QuantizedTensor)
    assert tq.is_quantized(tqp) and not tq.is_quantized(tp)
    assert tq.param_bytes(tqp) == jq.param_bytes(jqp)
    assert tq.param_bytes(tp) == jq.param_bytes(jp)


def test_init_params_quantizes_at_creation():
    gen = torch.Generator().manual_seed(0)
    p = tl.init_params(T_TINY_MOE, gen, "cpu", quantize="int8", quantize_experts=True)
    layer = p["layers"][0]
    assert all(isinstance(layer[n], tq.QuantizedTensor) for n in ("wq", "wo", "w_gate", "w_down"))
    assert isinstance(p["lm_head"], tq.QuantizedTensor)
    assert not isinstance(layer["router"], tq.QuantizedTensor)
    assert not isinstance(p["embed"], tq.QuantizedTensor)
    assert layer["w_gate"].shape == (4, 64, 96)
    p = tl.init_params(T_TINY_MOE, torch.Generator().manual_seed(0), "cpu", quantize="int8")
    assert not isinstance(p["layers"][0]["w_up"], tq.QuantizedTensor)
    with pytest.raises(ValueError, match="quantize mode"):
        tl.init_params(T_TINY_MOE, torch.Generator(), "cpu", quantize="int4")
