"""The backward of the port's grouped matmul (``ops.GroupedMatmul``) against
the JAX package's, on the CPU, on the same numpy inputs.

On the CPU the Function's backward takes the plain versions of K4^T
(``grouped_matmul_plain`` over ``rhs^T``) and K6
(``grouped_matmul_tgmm_plain``). The JAX side differentiates its
``grouped_matmul`` twice: with ``use_kernel=True, interpret=True``, which
is megablox ``gmm``'s ``custom_vjp`` (its backward runs megablox ``gmm``
with ``transpose_rhs=True`` and ``tgmm`` in Pallas interpret mode), and
with ``use_kernel=False``, ``jax.lax.ragged_dot`` under ``jax.grad``.
Tolerances: float32, rtol 1e-5 + atol 1e-5 (the same exact products
summed over at most 128 terms in another order); bfloat16, one bf16 ulp
of the result (2^-7 relative) + 1e-6, since both sides round one float32
sum to bf16. ``torch.autograd.gradcheck`` runs in float64 at its default
tolerances.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.ops.gmm import grouped_matmul as j_gmm
from llm_d_kv_cache_manager_tpu_torch import ops as t_ops
from llm_d_kv_cache_manager_tpu_torch.models import TINY_QWEN3_MOE
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models.quant import quantize_tensor

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2.0**-7, atol=1e-6)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: every case routes all its rows (sum == rows), as training does; each
#: sum is a multiple of 8, the row tile megablox tgmm is given below
SIZES = {
    "uneven_with_empty": [40, 0, 25, 60, 10, 30, 20, 15],
    "mostly_empty": [0, 0, 64, 0, 0, 0, 0, 64],
    "uniform": [16] * 8,
    "tiny_groups": [1, 2, 3, 4, 5, 6, 7, 12],
}
E, D, F = 8, 128, 256
#: the backend module (the package exports the custom_vjp ``gmm`` under the
#: same name)
megablox = importlib.import_module("jax.experimental.pallas.ops.tpu.megablox.gmm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed, sizes, dtype, extra_rows=0):
    """lhs [rows, D], w [E, D, F], the output's cotangent [rows, F] and the
    group sizes, as numpy; ``extra_rows`` rows lie past every group."""
    rng = np.random.default_rng(seed)
    rows = sum(sizes) + extra_rows
    lhs = rng.normal(size=(rows, D)).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32)
    cot = rng.normal(size=(rows, F)).astype(np.float32)
    return lhs, w, cot, np.asarray(sizes, np.int32)


def _torch_grads(lhs, w, cot, sizes, dtype):
    tl_ = torch.from_numpy(lhs).to(TDT[dtype]).requires_grad_(True)
    tw = torch.from_numpy(w).to(TDT[dtype]).requires_grad_(True)
    out = t_ops.GroupedMatmul.apply(tl_, tw, torch.from_numpy(sizes))
    out.backward(torch.from_numpy(cot).to(TDT[dtype]))
    return tl_.grad, tw.grad


def _jax_grads(lhs, w, cot, sizes, dtype, use_kernel):
    def f(a, b):
        out = j_gmm(a, b, jnp.asarray(sizes), interpret=True, use_kernel=use_kernel)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(cot))

    return jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs, JDT[dtype]), jnp.asarray(w, JDT[dtype]))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SIZES))
def test_grads_match_megablox_vjp_and_ragged_dot(case, dtype):
    lhs, w, cot, sizes = _problem(3, SIZES[case], dtype)
    if dtype == "bfloat16":
        # The cotangent as the bf16 output's gradient arrives: bf16 values.
        cot = np.array(jnp.asarray(cot, jnp.bfloat16).astype(jnp.float32))
    dlhs, dw = _torch_grads(lhs, w, cot, sizes, dtype)
    assert dlhs.dtype == TDT[dtype] and dw.dtype == TDT[dtype]
    for use_kernel in (True, False):
        jdlhs, jdw = _jax_grads(lhs, w, cot, sizes, dtype, use_kernel)
        np.testing.assert_allclose(_np(dlhs), _np(jdlhs), **TOL[dtype])
        np.testing.assert_allclose(_np(dw), _np(jdw), **TOL[dtype])
    empty = [g for g, n in enumerate(SIZES[case]) if n == 0]
    assert not dw[empty].any()


def test_rows_past_the_last_group_get_zero_input_gradient():
    """The port's contract for rows no group owns: zero output, so zero
    input gradient, and no share in any expert's gradient. (megablox leaves
    those rows of ``dlhs`` unwritten; ``ragged_dot``'s gradient is zero
    there, and both hold the in-group rows.)"""
    sizes = SIZES["uneven_with_empty"]
    lhs, w, cot, gs = _problem(4, sizes, "float32", extra_rows=13)
    dlhs, dw = _torch_grads(lhs, w, cot, gs, "float32")
    n = sum(sizes)
    assert not dlhs[n:].any()
    jdlhs, jdw = _jax_grads(lhs, w, cot, gs, "float32", use_kernel=False)
    np.testing.assert_allclose(_np(dlhs), _np(jdlhs), **TOL["float32"])
    np.testing.assert_allclose(_np(dw), _np(jdw), **TOL["float32"])
    kdlhs, kdw = _jax_grads(lhs[:n], w, cot[:n], gs, "float32", use_kernel=True)
    np.testing.assert_allclose(_np(dlhs[:n]), _np(kdlhs), **TOL["float32"])
    np.testing.assert_allclose(_np(dw), _np(kdw), **TOL["float32"])


@pytest.mark.parametrize("case", list(SIZES))
def test_tgmm_plain_matches_megablox_tgmm(case):
    """K6's plain version against megablox ``tgmm`` itself (interpret
    mode): ``lhs^T`` over each group's rows by ``dout``, zeros for an empty
    group."""
    lhs, _, dout, sizes = _problem(5, SIZES[case], "float32")
    ref = megablox.tgmm(
        jnp.asarray(lhs).T, jnp.asarray(dout), jnp.asarray(sizes),
        preferred_element_type=jnp.float32, tiling=(8, 128, 128), interpret=True,
    )
    out = t_ops.grouped_matmul_tgmm_plain(
        torch.from_numpy(lhs), torch.from_numpy(dout), torch.from_numpy(sizes)
    )
    assert out.shape == (E, D, F) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL["float32"])


def test_gradcheck_float64():
    """Finite differences in float64: uneven, empty and one-row groups."""
    rng = np.random.default_rng(6)
    gs = torch.tensor([3, 0, 1, 4], dtype=torch.int32)
    lhs = torch.from_numpy(rng.normal(size=(8, 5))).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(4, 5, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: t_ops.GroupedMatmul.apply(a, b, gs), (lhs, w)
    )


def test_quantized_rhs_refuses_a_gradient():
    """An int8 expert stack has no backward (JAX's int8 kernel has no VJP):
    the forward runs, asking for a gradient through it raises."""
    rng = np.random.default_rng(7)
    sizes = torch.tensor([3, 5], dtype=torch.int32)
    lhs = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)).requires_grad_(True)
    q = quantize_tensor(torch.from_numpy(rng.normal(size=(2, 16, 8)).astype(np.float32)))
    rgi = torch.repeat_interleave(torch.arange(2), sizes.long())
    out = t_ops.GroupedMatmul.apply(lhs, q, sizes, rgi)
    ref = t_ops.grouped_matmul_plain(lhs.detach(), q, sizes, row_group_ids=rgi)
    assert torch.equal(out.detach(), ref)
    with pytest.raises(NotImplementedError, match="quantized"):
        out.sum().backward()


def test_cuda_wrappers_refuse_cpu_tensors_and_never_count():
    before = {n: w.launches for n, w in t_ops.COUNTED.items()}
    lhs = torch.zeros((16, 64), dtype=torch.bfloat16)
    dout = torch.zeros((16, 32), dtype=torch.bfloat16)
    rhs = torch.zeros((2, 64, 32), dtype=torch.bfloat16)
    gs = torch.tensor([8, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.grouped_matmul_bf16_t(dout, rhs, gs)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.grouped_matmul_tgmm(lhs, dout, gs)
    # The CPU backward takes the plain versions and counts nothing.
    a = lhs.float().requires_grad_(True)
    b = rhs.float().requires_grad_(True)
    t_ops.GroupedMatmul.apply(a, b, gs).sum().backward()
    assert a.grad is not None and b.grad is not None
    assert {n: w.launches for n, w in t_ops.COUNTED.items()} == before
    assert "grouped_matmul_bf16_t" in t_ops.COUNTED and "grouped_matmul_tgmm" in t_ops.COUNTED


def test_plans_are_integers_only():
    # K6: persistent blocks, one an SM, over 128 d x 256 f tiles, group
    # outermost: 128 groups x 16 x 3 (gate-up) or x 6 x 8 (down) tiles.
    assert t_ops.plan_grouped_matmul_tgmm(128, 2048, 768, 132) == {
        "grid": (132, 1, 1), "threads": 384, "tile": (128, 256, 64), "stages": 3,
        "smem": 214064, "tiles": 6144}
    assert t_ops.plan_grouped_matmul_tgmm(128, 768, 2048, 132)["tiles"] == 6144
    assert t_ops.plan_grouped_matmul_tgmm(2, 128, 256, 132)["grid"] == (2, 1, 1)
    # K4^T always takes K4's prefill path, whose kernel alone reads rhs
    # transposed; K4 itself keeps its decode path for few rows.
    assert t_ops.plan_grouped_matmul(64, 128, 768, 2048, False, 132)["path"] == "decode"
    assert t_ops.plan_grouped_matmul(64, 128, 768, 2048, False, 132,
                                     transpose_rhs=True)["path"] == "prefill"


def test_serving_calls_keep_the_direct_path():
    """``_grouped_dot`` goes through ``GroupedMatmul`` only under autograd
    (grad enabled and an operand that requires grad); serving calls get a
    plain tensor with no graph, as before."""
    cfg = TINY_QWEN3_MOE
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(cfg, gen, "cpu")
    w = params["layers"][0]["w_gate"]
    gs = torch.tensor([4, 0, 3, 1], dtype=torch.int32)
    x = torch.randn((8, cfg.hidden_size), generator=gen)
    gdot = tl._grouped_dot(cfg, torch.repeat_interleave(torch.arange(4), gs.long()))
    assert gdot(x, w, gs).grad_fn is None
    w.requires_grad_(True)
    with torch.no_grad():
        assert gdot(x, w, gs).grad_fn is None
    out = gdot(x, w, gs)
    assert type(out.grad_fn).__name__ == "GroupedMatmulBackward"
    assert torch.equal(out.detach(), t_ops.grouped_matmul_plain(x, w.detach(), gs))
