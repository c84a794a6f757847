"""The split-KV decode algorithm of ``csrc/paged_decode.cu`` (K1 / K1q), on
the CPU, against the JAX package:

- ``plan_decode_splits``, the host-side split planner, as a pure function
  of ints: every page of the table in exactly one split, at least one
  block per SM at the serving shapes, one split for a one-page table;
- ``paged_attention_split_plain`` (per-split partial ``(m, l, acc)``, then
  the log-sum-exp merge with the fresh token, the kernel's two passes in
  plain PyTorch) for several split counts against the JAX
  ``paged_attention`` (its Pallas kernel in interpret mode) and, without
  a fresh token, the JAX ``paged_attention_reference``, on the same numpy
  inputs: splits with no keys, more splits than pages, ``seq_len`` 0,
  ``seq_len`` 1 with fresh K/V, GQA groups 4 and 8, bf16-width float32
  pools and int8 pools with per-page scales.

Tolerances: float32 pools atol = rtol = 1e-5 (``TestPagedAttention``'s
bar); int8 pools 2e-5 (``test_kv_quant_hbm``'s kernel suite).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import quant as jq
from llm_d_kv_cache_manager_tpu.ops.paged_attention import (
    paged_attention as j_paged,
    paged_attention_reference as j_paged_ref,
)
from llm_d_kv_cache_manager_tpu_torch import ops as t_ops

F32 = dict(atol=1e-5, rtol=1e-5)
INT8 = dict(atol=2e-5, rtol=2e-5)
H100_SMS = 132


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the split planner ------------------------------------------------------------
@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("max_pages", [1, 2, 3, 7, 16, 100, 128, 256, 257, 2048])
@pytest.mark.parametrize("batch,n_kv", [(1, 1), (1, 8), (8, 4), (8, 8), (64, 8)])
def test_planner_assigns_every_page_to_one_split(batch, n_kv, max_pages, page_size):
    splits, pps = t_ops.plan_decode_splits(batch, n_kv, max_pages, page_size, H100_SMS)
    owner = [p // pps for p in range(max_pages)]
    assert all(0 <= z < splits for z in owner)  # every page in exactly one split
    assert splits == max(owner) + 1  # and no split past the table's end
    assert (splits - 1) * pps < max_pages <= splits * pps


@pytest.mark.parametrize("batch,n_kv", [(8, 8), (8, 4), (1, 8)])
def test_planner_fills_the_card_at_serving_shapes(batch, n_kv):
    splits, _ = t_ops.plan_decode_splits(batch, n_kv, 128, 16, H100_SMS)
    assert batch * n_kv * splits >= H100_SMS


@pytest.mark.parametrize("batch,n_kv", [(1, 1), (8, 8), (1, 8)])
def test_planner_one_page_table_is_one_split(batch, n_kv):
    assert t_ops.plan_decode_splits(batch, n_kv, 1, 16, H100_SMS) == (1, 1)


# -- the two-pass algorithm against the JAX kernel -----------------------------------
PS, MAXP, N_KV, D = 4, 10, 2, 32
#: history lengths: empty, one token (with the fresh token: history 0), a
#: partial page, pages that fit in fewer splits than the grid has, full
SEQ_LENS = [0, 1, 7, 13, 40]


@functools.lru_cache(maxsize=None)
def _case(group: int, fresh: bool, quant: bool):
    """Inputs and the JAX outputs of one (group, fresh, int8) case."""
    rng = np.random.default_rng(group * 4 + 2 * fresh + quant)
    B, n_q, P = len(SEQ_LENS), N_KV * group, len(SEQ_LENS) * MAXP + 3
    q = rng.standard_normal((B, n_q, D)).astype(np.float32)
    bt = (rng.permutation(P - 1)[: B * MAXP].reshape(B, MAXP) + 1).astype(np.int32)
    sl = np.asarray(SEQ_LENS, np.int32)
    fk = rng.standard_normal((B, N_KV, D)).astype(np.float32) if fresh else None
    fv = rng.standard_normal((B, N_KV, D)).astype(np.float32) if fresh else None
    if quant:
        kp = rng.integers(-127, 128, (P, PS, N_KV, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, PS, N_KV, D)).astype(np.int8)
        ks = rng.uniform(0.01, 0.2, (P, N_KV)).astype(np.float32)
        vs = rng.uniform(0.01, 0.2, (P, N_KV)).astype(np.float32)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp = (rng.standard_normal((P, PS, N_KV, D)) * 0.3).astype(np.float32)
        vp = rng.standard_normal((P, PS, N_KV, D)).astype(np.float32)
        scales = {}
    extra = (fk, fv) if fresh else ()
    jk = np.asarray(j_paged(*map(jnp.asarray, (q, kp, vp, bt, sl) + extra),
                            **{k: jnp.asarray(v) for k, v in scales.items()}, interpret=True))
    jref = None
    if not fresh:  # the JAX oracle has no fresh-token form
        wk = jq.dequantize_kv_pool(kp, scales["k_scale"], np.float32) if quant else kp
        wv = jq.dequantize_kv_pool(vp, scales["v_scale"], np.float32) if quant else vp
        jref = np.asarray(j_paged_ref(*map(jnp.asarray, (q, wk, wv, bt, sl))))
    return (q, kp, vp, bt, sl, extra, scales), jk, jref


#: (splits, pages_per_split): one split; two; three uneven (the last shorter);
#: one page each; more splits than the table has pages (the tail empty)
SPLITS = [(1, MAXP), (2, 5), (3, 4), (MAXP, 1), (MAXP + 3, 1)]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("fresh", [False, True], ids=["history", "fresh"])
@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("splits,pps", SPLITS, ids=[f"{s}x{p}" for s, p in SPLITS])
def test_split_plain_matches_jax(splits, pps, group, fresh, quant):
    (q, kp, vp, bt, sl, extra, scales), jk, jref = _case(group, fresh, quant)
    got = t_ops.paged_attention_split_plain(
        _t(q), _t(kp), _t(vp), _t(bt), _t(sl), *map(_t, extra),
        splits=splits, pages_per_split=pps, **{k: _t(v) for k, v in scales.items()},
    ).numpy()
    tol = INT8 if quant else F32
    np.testing.assert_allclose(got, jk, **tol)
    if jref is not None:
        np.testing.assert_allclose(got, jref, **tol)
    assert not got[0].any()  # seq_len 0: zeros
    if fresh:  # seq_len 1 with the fresh token: its V exactly
        np.testing.assert_allclose(got[1], np.repeat(extra[1][1], group, axis=0), **tol)


def test_split_plain_5d_pool_layer_and_planner_split():
    """The 5-D pool read at ``layer``, split as the wrapper would split it
    on the card, equals the single-pass plain version."""
    rng = np.random.default_rng(9)
    L, B, n_q, P = 3, 2, 8, 24
    q = _t(rng.standard_normal((B, n_q, D)).astype(np.float32))
    kp = _t(rng.standard_normal((L, P, PS, N_KV, D)).astype(np.float32))
    vp = _t(rng.standard_normal((L, P, PS, N_KV, D)).astype(np.float32))
    bt = _t((rng.permutation(P - 1)[: B * MAXP].reshape(B, MAXP) + 1).astype(np.int32))
    sl = _t(np.asarray([29, 40], np.int32))
    splits, pps = t_ops.plan_decode_splits(B, N_KV, MAXP, PS, H100_SMS)
    assert splits > 1
    for layer in range(L):
        got = t_ops.paged_attention_split_plain(q, kp, vp, bt, sl, splits=splits,
                                                pages_per_split=pps, layer=layer)
        ref = t_ops.paged_attention_reference(q, kp, vp, bt, sl, layer=layer)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32)


def test_split_plain_refuses_splits_that_miss_pages():
    (q, kp, vp, bt, sl, _, _), _, _ = _case(4, False, False)
    with pytest.raises(ValueError, match="cover"):
        t_ops.paged_attention_split_plain(_t(q), _t(kp), _t(vp), _t(bt), _t(sl),
                                          splits=2, pages_per_split=4)
