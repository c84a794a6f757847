"""The port's grouped matmul (``ops/gmm.py``) against the JAX package's, on
the CPU, on the same numpy inputs.

On the CPU ``grouped_matmul`` takes ``grouped_matmul_plain``; the JAX side
runs megablox ``gmm`` and its own int8 kernel in Pallas interpret mode (as
``tests/test_gmm.py`` runs them) and ``jax.lax.ragged_dot``
(``use_kernel=False``). Tolerances: float32, rtol 1e-5 + atol 1e-5 (the
same exact products summed over d=256 in another order); bfloat16, one
bf16 ulp of the result (2^-7 relative) + 1e-6, since both sides round one
float32 sum to bf16 and the sums differ only in their last f32 bits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models.quant import quantize_tensor as j_quantize
from llm_d_kv_cache_manager_tpu.ops.gmm import grouped_matmul as j_gmm
from llm_d_kv_cache_manager_tpu_torch import ops as t_ops
from llm_d_kv_cache_manager_tpu_torch.models import TINY_MOE, llama as tl
from llm_d_kv_cache_manager_tpu_torch.models.quant import quantize_tensor

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2.0**-7, atol=1e-6)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SIZES = {
    "uneven_with_empty": [40, 0, 25, 60, 10, 30, 20, 15],
    "mostly_empty": [0, 0, 128, 0, 0, 0, 0, 128],
    "uniform": [32] * 8,
    "tiny_groups": [1, 2, 3, 4, 5, 6, 7, 8],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed, E, d, f, sizes, dtype, extra_rows=0):
    """The JAX test's inputs (``tests/test_gmm.py::_problem``), as numpy,
    handed to both sides; ``extra_rows`` rows lie past every group (fewer
    rows than the sizes sum to when negative)."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes)
    rows = int(sizes.sum()) + extra_rows
    lhs = rng.normal(size=(rows, d)).astype(np.float32)
    w = (rng.normal(size=(E, d, f)) * 0.1).astype(np.float32)
    rgi = np.repeat(np.arange(E), sizes).astype(np.int32)
    rgi = np.concatenate([rgi, np.full(max(extra_rows, 0), E - 1, np.int32)])[:rows]
    j = (jnp.asarray(lhs, JDT[dtype]), jnp.asarray(w, JDT[dtype]),
         jnp.asarray(sizes, jnp.int32), jnp.asarray(rgi))
    t = (torch.from_numpy(lhs).to(TDT[dtype]), torch.from_numpy(w).to(TDT[dtype]),
         torch.from_numpy(sizes.astype(np.int32)), torch.from_numpy(rgi))
    return j, t


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SIZES))
def test_bf16_form_matches_megablox_and_ragged_dot(case, dtype):
    (jl_, jw, jgs, _), (tl_, tw, tgs, _) = _problem(1, 8, 256, 384, SIZES[case], dtype)
    out = t_ops.grouped_matmul(tl_, tw, tgs)
    assert out.dtype == TDT[dtype] and out.shape == (tl_.shape[0], 384)
    megablox = j_gmm(jl_, jw, jgs, interpret=True)
    oracle = j_gmm(jl_, jw, jgs, use_kernel=False)
    np.testing.assert_allclose(_np(out), _np(megablox), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["uneven_with_empty", "tiny_groups"])
def test_int8_form_matches_jax_int8_kernel(case, dtype):
    (jl_, jw, jgs, jrgi), (tl_, tw, tgs, trgi) = _problem(2, 8, 256, 384, SIZES[case], dtype)
    jq = j_quantize(jw)
    tq = quantize_tensor(tw)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    out = t_ops.grouped_matmul(tl_, tq, tgs, row_group_ids=trgi)
    ref = j_gmm(jl_, jq, jgs, row_group_ids=jrgi, interpret=True)
    assert out.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


def test_padding_rows_past_every_group_are_zero():
    """``tests/test_gmm.py::test_non_tile_multiple_rows_padding_sliced``'s
    200-row problem, plus 13 rows beyond the last group: the JAX oracle
    gives them zeros, and so does the port."""
    sizes = [13, 7, 29, 3, 0, 11, 5, 132]
    (jl_, jw, jgs, jrgi), (tl_, tw, tgs, trgi) = _problem(4, 8, 256, 128, sizes, "float32", 13)
    out = t_ops.grouped_matmul(tl_, tw, tgs)
    oracle = j_gmm(jl_, jw, jgs, use_kernel=False)
    assert out.shape == (213, 128)
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL["float32"])
    assert (out[200:] == 0).all()
    qout = t_ops.grouped_matmul(tl_, quantize_tensor(tw), tgs, row_group_ids=trgi)
    assert qout.shape == (213, 128) and torch.isfinite(qout).all() and (qout[200:] == 0).all()


def test_int8_requires_row_group_ids():
    _, (tl_, tw, tgs, _) = _problem(3, 8, 256, 384, [32] * 8, "bfloat16")
    for fn in (t_ops.grouped_matmul, t_ops.grouped_matmul_plain):
        with pytest.raises(ValueError, match="row_group_ids required for quantized rhs"):
            fn(tl_, quantize_tensor(tw), tgs)


def test_moe_gmm_knob():
    """'kernel' refuses CPU tensors (no interpret mode here); 'xla' is the
    plain version; an unknown value raises naming the knob."""
    _, (tl_, tw, tgs, trgi) = _problem(5, 8, 64, 32, SIZES["tiny_groups"], "float32")
    auto = tl._grouped_dot(TINY_MOE, trgi)(tl_, tw, tgs)
    xla = tl._grouped_dot(dataclasses.replace(TINY_MOE, moe_gmm="xla"), trgi)(tl_, tw, tgs)
    torch.testing.assert_close(xla, auto, rtol=0, atol=0)
    kernel = tl._grouped_dot(dataclasses.replace(TINY_MOE, moe_gmm="kernel"), trgi)
    with pytest.raises(ValueError, match="moe_gmm='kernel' needs CUDA"):
        kernel(tl_, tw, tgs)
    with pytest.raises(ValueError, match="moe_gmm"):
        tl._grouped_dot(dataclasses.replace(TINY_MOE, moe_gmm="ragged"), trgi)


def test_cuda_wrappers_refuse_cpu_tensors_and_never_count():
    _, (tl_, tw, tgs, _) = _problem(6, 8, 64, 32, [4] * 8, "bfloat16")
    q = quantize_tensor(tw)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.grouped_matmul_bf16(tl_, tw, tgs)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.grouped_matmul_int8(tl_, q.q, q.scale, tgs)
    assert t_ops.grouped_matmul_bf16.launches == 0 and t_ops.grouped_matmul_int8.launches == 0
    assert t_ops.grouped_matmul_bf16.last_plan is None and t_ops.grouped_matmul_int8.last_plan is None


#: group-size forms of the kernels' chip checks, at test size: (sizes, rows
#: past the last group, negative where the sizes sum past the rows)
EDGE_SIZES = {
    # every row in one group, the other groups empty
    "one_expert": ([0, 0, 0, 200, 0, 0, 0, 0], 0),
    # ragged sizes summing under the rows: tiles straddle groups, zero tail
    "ragged_under_rows": ([37, 1, 70, 5, 23, 2, 61, 9], 19),
    # sizes summing past the rows: the last groups are cut at the rows
    "over_rows": ([40, 0, 25, 60, 10, 30, 20, 15], -47),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(EDGE_SIZES))
def test_group_size_forms_match_megablox_and_ragged_dot(case, dtype):
    sizes, extra = EDGE_SIZES[case]
    (jl_, jw, jgs, _), (tl_, tw, tgs, _) = _problem(7, 8, 256, 384, sizes, dtype, extra)
    out = t_ops.grouped_matmul_plain(tl_, tw, tgs)
    assert out.shape == (tl_.shape[0], 384)
    # megablox leaves rows past the last group unwritten; ragged_dot zeroes them
    in_groups = min(sum(sizes), tl_.shape[0])
    megablox = j_gmm(jl_, jw, jgs, interpret=True)
    oracle = j_gmm(jl_, jw, jgs, use_kernel=False)
    np.testing.assert_allclose(_np(out)[:in_groups], _np(megablox)[:in_groups], **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL[dtype])
    assert (out[in_groups:] == 0).all()


#: Qwen3-30B-A3B's expert products (128 experts, top-8): (rows, d, f) of
#: the chip check's call forms
QWEN3_FORMS = {
    "prefill/gate_up": (65536, 2048, 768), "prefill/down": (65536, 768, 2048),
    "decode/gate_up": (64, 2048, 768), "decode/down": (64, 768, 2048),
    "edge/gate_up": (5001, 2048, 768), "edge/down": (5001, 768, 2048),
}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("form", list(QWEN3_FORMS))
def test_plan_takes_the_expected_path_at_qwen3_forms(form, quantized):
    rows, d, f = QWEN3_FORMS[form]
    plan = t_ops.plan_grouped_matmul(rows, 128, d, f, quantized, 132)
    assert plan["path"] == form.split("/")[0].replace("edge", "prefill")
    if plan["path"] == "decode":
        width = plan["tile"][1]
        assert width == (128 if quantized else 64)
        assert plan["grid"] == (-(-f // width), 129, 1)
    else:
        assert plan["grid"] == (132, 1, 1) and plan["threads"] == 384


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n_groups", [1, 8, 128, 1024])
def test_plan_path_threshold_is_16_rows_a_group(n_groups, quantized):
    below = t_ops.plan_grouped_matmul(16 * n_groups - 1, n_groups, 64, 256, quantized, 132)
    at = t_ops.plan_grouped_matmul(16 * n_groups, n_groups, 64, 256, quantized, 132)
    assert (below["path"], at["path"]) == ("decode", "prefill")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("rows,n_groups,f,sm_count", [
    (16, 1, 256, 132), (300, 2, 256, 132), (2048, 128, 768, 132),
    (65536, 128, 2048, 132), (65536, 8, 8192, 114), (100000, 1024, 16, 1),
])
def test_plan_grid_is_persistent_and_smem_fits(rows, n_groups, f, sm_count, quantized):
    """A prefill launch never asks for more blocks than SMs, nor more than
    the group-aligned tiles there can be; every plan's shared memory fits
    the H100's 227 KiB a block (the decode path's in 48 KiB of static
    shared memory)."""
    plan = t_ops.plan_grouped_matmul(rows, n_groups, 64, f, quantized, sm_count)
    tm, tn, _ = plan["tile"]
    if plan["path"] == "prefill":
        upper = (-(-rows // tm) + n_groups + 1) * -(-f // tn)
        assert 1 <= plan["grid"][0] <= min(sm_count, upper)
        assert plan["smem"] <= 232448
    else:
        assert plan["smem"] <= 48 * 1024
        assert plan["grid"][1] == n_groups + 1 and plan["grid"][0] * tn >= f


@pytest.mark.parametrize("quantized,d,f,ok", [
    (False, 8, 8, True), (False, 12, 8, False), (False, 8, 12, False),
    (True, 8, 16, True), (True, 8, 8, False), (True, 4, 16, False),
])
def test_plan_refuses_widths_tma_cannot_tile(quantized, d, f, ok):
    """TMA needs every row stride to be a multiple of 16 bytes: ``d * 2``
    for lhs, ``f`` times the element size for the expert stack."""
    if ok:
        t_ops.plan_grouped_matmul(4096, 8, d, f, quantized, 132)
    else:
        with pytest.raises(ValueError, match="multiples of 16 bytes"):
            t_ops.plan_grouped_matmul(4096, 8, d, f, quantized, 132)
