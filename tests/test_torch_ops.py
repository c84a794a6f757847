"""The port's ops (``llm_d_kv_cache_manager_tpu_torch.ops``) against the JAX
package's, on the CPU: the same numpy inputs through both.

Tolerances: float32 inputs atol = rtol = 1e-5 (the two frameworks sum in
different orders); bfloat16 inputs 2e-2, compared in float32 (one bf16
rounding of O(1) outputs). Greedy and the top-k/top-p masks are exact.
Where the JAX function reaches a Pallas kernel it runs in interpret mode,
as the JAX package's own tests run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.ops import attention as j_attn
from llm_d_kv_cache_manager_tpu.ops import rmsnorm as j_rms
from llm_d_kv_cache_manager_tpu.ops import rope as j_rope
from llm_d_kv_cache_manager_tpu.ops import sampling as j_samp
from llm_d_kv_cache_manager_tpu.ops.flash_prefill import flash_prefill_paged as j_flash
from llm_d_kv_cache_manager_tpu.ops.paged_attention import (
    paged_attention as j_paged,
    paged_attention_reference as j_paged_ref,
)
from llm_d_kv_cache_manager_tpu_torch import ops as t_ops
from llm_d_kv_cache_manager_tpu_torch.ops import sampling as t_samp
from llm_d_kv_cache_manager_tpu_torch.ops.rope import RopeScalingConfig

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


class TestNormRopeSampling:
    @pytest.mark.parametrize("offset", [0.0, 1.0])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rms_norm(self, offset, dtype):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 5, 64)).astype(np.float32)
        w = rng.standard_normal(64).astype(np.float32)
        jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
        ref = j_rms.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-5, offset)
        got = t_ops.rms_norm(_t(x, td), _t(w, td), 1e-5, offset)
        assert got.dtype == td
        np.testing.assert_allclose(_np(got), _np(ref), **(F32 if dtype == "float32" else BF16))

    @pytest.mark.parametrize("scaling", [None, RopeScalingConfig()], ids=["plain", "llama3"])
    def test_rope(self, scaling):
        j_scaling = None if scaling is None else j_rope.RopeScalingConfig()
        inv_t = t_ops.rope_frequencies(128, 500_000.0, scaling)
        inv_j = j_rope.rope_frequencies(128, 500_000.0, j_scaling)
        np.testing.assert_array_equal(inv_t, inv_j)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 7, 4, 128)).astype(np.float32)
        pos = rng.integers(0, 6000, (2, 7)).astype(np.int32)
        ref = j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_j))
        got = t_ops.apply_rope(_t(x), _t(pos), _t(inv_t))
        np.testing.assert_allclose(_np(got), _np(ref), **F32)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_filtered_logits_exact(self, seed):
        rng = np.random.default_rng(seed)
        rows, vocab = 6, 97
        logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
        temperature = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 2.0], np.float32)
        top_k = np.array([0, 5, 0, 40, 1, 0], np.int32)
        top_p = np.array([1.0, 1.0, 0.9, 0.5, 1.0, 0.3], np.float32)
        ref = j_samp._filtered_logits(*map(jnp.asarray, (logits, temperature, top_k, top_p)))
        got = t_samp._filtered_logits(*map(_t, (logits, temperature, top_k, top_p)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def test_greedy_sampling_exact(self):
        rng = np.random.default_rng(3)
        logits = rng.standard_normal((5, 300)).astype(np.float32)
        logits[2, 7] = logits[2, 9] = 50.0  # tie: the first index wins in both
        z = np.zeros(5, np.float32)
        ref = j_samp.sample_tokens(
            jnp.asarray(logits), jnp.asarray(z), jnp.zeros(5, jnp.int32),
            jnp.ones(5, jnp.float32), __import__("jax").random.PRNGKey(0),
        )
        got = t_ops.sample_tokens(
            _t(logits), _t(z), torch.zeros(5, dtype=torch.int32),
            torch.ones(5), torch.Generator().manual_seed(0),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got.dtype == torch.int32

    def test_sampled_distribution(self):
        """temperature > 0: only the distribution can be held (jax.random
        and torch.Generator never share bits): empirical frequencies over
        many draws match the filtered softmax within 0.01."""
        rng = np.random.default_rng(4)
        base = rng.standard_normal(12).astype(np.float32)
        n = 40_000
        logits = np.tile(base, (n, 1))
        temp = np.full(n, 0.8, np.float32)
        top_k = np.full(n, 6, np.int32)
        top_p = np.full(n, 0.95, np.float32)
        got = t_ops.sample_tokens(
            _t(logits), _t(temp), _t(top_k), _t(top_p), torch.Generator().manual_seed(1)
        ).numpy()
        masked = np.asarray(j_samp._filtered_logits(*map(jnp.asarray, (logits[:1], temp[:1], top_k[:1], top_p[:1]))))[0]
        p = np.exp(masked - masked.max())
        p /= p.sum()
        freq = np.bincount(got, minlength=12) / n
        np.testing.assert_allclose(freq, p, atol=0.01)
        assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(p))


def _pool_setup(seed, B, NH, NKV, D, PS, NPAGES, MAXP):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NH, D)).astype(np.float32)
    k = (rng.standard_normal((NPAGES, PS, NKV, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((NPAGES, PS, NKV, D)).astype(np.float32)
    bt = rng.permutation(NPAGES)[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    return q, k, v, bt


class TestPagedAttention:
    @pytest.mark.parametrize(
        "B,NH,NKV,D,PS,MAXP,lens",
        [
            (1, 1, 1, 128, 16, 2, [17]),
            (3, 8, 2, 128, 16, 4, [5, 64, 33]),
            (2, 4, 4, 64, 8, 3, [24, 1]),  # MHA (group=1)
            (4, 8, 1, 128, 16, 2, [32, 31, 16, 9]),  # MQA
            (3, 4, 2, 64, 8, 3, [0, 11, 24]),  # zero-length lane, partial page
        ],
    )
    def test_matches_jax_kernel_and_reference(self, B, NH, NKV, D, PS, MAXP, lens):
        q, k, v, bt = _pool_setup(0, B, NH, NKV, D, PS, B * MAXP + 2, MAXP)
        sl = np.asarray(lens, np.int32)
        jargs = tuple(map(jnp.asarray, (q, k, v, bt, sl)))
        ref = j_paged_ref(*jargs)
        jk = j_paged(*jargs, interpret=True)
        targs = tuple(map(_t, (q, k, v, bt, sl)))
        got = t_ops.paged_attention(*targs)
        np.testing.assert_allclose(_np(got), _np(jk), **F32)
        np.testing.assert_allclose(_np(got), _np(ref), **F32)
        np.testing.assert_allclose(_np(t_ops.paged_attention_reference(*targs)), _np(ref), **F32)
        assert t_ops.paged_attention.launches == 0  # CPU tensors never launch
        for i, n in enumerate(lens):
            if n == 0:
                assert float(got[i].abs().max()) == 0.0

    def test_5d_pool_layer_form(self):
        rng = np.random.default_rng(7)
        L, B, NH, NKV, D, PS, MAXP = 3, 2, 4, 2, 64, 8, 3
        NPAGES = B * MAXP + 1
        q = rng.standard_normal((B, NH, D)).astype(np.float32)
        k5 = rng.standard_normal((L, NPAGES, PS, NKV, D)).astype(np.float32)
        v5 = rng.standard_normal((L, NPAGES, PS, NKV, D)).astype(np.float32)
        bt = rng.permutation(NPAGES)[: B * MAXP].reshape(B, MAXP).astype(np.int32)
        sl = np.asarray([13, 20], np.int32)
        for li in range(L):
            ref = j_paged(*map(jnp.asarray, (q, k5, v5, bt, sl)), layer=li, interpret=True)
            got = t_ops.paged_attention(*map(_t, (q, k5, v5, bt, sl)), layer=li)
            np.testing.assert_allclose(_np(got), _np(ref), **F32)

    def test_partial_last_page_poison_masked(self):
        B, NH, NKV, D, PS, MAXP = 1, 2, 1, 64, 8, 2
        q, k, v, bt = _pool_setup(3, B, NH, NKV, D, PS, B * MAXP + 2, MAXP)
        last = int(bt[0, 1])
        k[last, 3:] = 1e4
        v[last, 3:] = 1e4
        sl = np.asarray([11], np.int32)
        ref = j_paged_ref(*map(jnp.asarray, (q, k, v, bt, sl)))
        got = t_ops.paged_attention(*map(_t, (q, k, v, bt, sl)))
        np.testing.assert_allclose(_np(got), _np(ref), **F32)
        assert float(got.abs().max()) < 100.0

    def test_bfloat16(self):
        q, k, v, bt = _pool_setup(2, 2, 8, 2, 128, 16, 6, 2)
        sl = np.asarray([20, 32], np.int32)
        ref = j_paged(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                      jnp.asarray(bt), jnp.asarray(sl), interpret=True)
        got = t_ops.paged_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)), _t(bt), _t(sl))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(ref), **BF16)

    @pytest.mark.parametrize("seq_lens", [[1, 6, 8], [3, 0, 5]], ids=["live", "inactive-lane"])
    def test_fresh_kv_form(self, seq_lens):
        """Deferred-write contract (TestFreshKV): history-only pages + the
        current token's K/V as arguments, against the JAX kernel in the same
        form, across 5-D layers."""
        rng = np.random.default_rng(11)
        L, b, nq, nkv, d, ps, pages, maxp = 2, 3, 8, 4, 32, 4, 32, 6
        q = rng.standard_normal((b, nq, d)).astype(np.float32)
        kp = rng.standard_normal((L, pages, ps, nkv, d)).astype(np.float32)
        vp = rng.standard_normal((L, pages, ps, nkv, d)).astype(np.float32)
        bt = (rng.permutation(pages - 1)[: b * maxp].reshape(b, maxp) + 1).astype(np.int32)
        sl = np.asarray(seq_lens, np.int32)
        fk = rng.standard_normal((b, nkv, d)).astype(np.float32)
        fv = rng.standard_normal((b, nkv, d)).astype(np.float32)
        for li in range(L):
            ref = j_paged(*map(jnp.asarray, (q, kp, vp, bt, sl, fk, fv)), layer=li, interpret=True)
            got = t_ops.paged_attention(*map(_t, (q, kp, vp, bt, sl, fk, fv)), layer=li)
            np.testing.assert_allclose(_np(got), _np(ref), **F32)
            for i, n in enumerate(seq_lens):
                if n == 0:
                    assert float(got[i].abs().max()) == 0.0


PS = 8


def _prefill_setup(rng, b, s, n_q, n_kv, d, total_pages, max_ctx_pages, ctx_lens, n_valid):
    q = rng.standard_normal((b, s, n_q, d)).astype(np.float32)
    k = rng.standard_normal((b, s, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, n_kv, d)).astype(np.float32)
    kp = rng.standard_normal((total_pages, PS, n_kv, d)).astype(np.float32)
    vp = rng.standard_normal((total_pages, PS, n_kv, d)).astype(np.float32)
    perm = rng.permutation(total_pages - 1)[: b * max_ctx_pages] + 1
    bt = perm.reshape(b, max_ctx_pages).astype(np.int32)
    return q, k, v, kp, vp, bt, np.asarray(ctx_lens, np.int32), np.asarray(n_valid, np.int32)


def _compare_prefill(args, tol=F32, dtype=None):
    q, k, v, kp, vp, bt, cl, nv = args
    b, s = q.shape[:2]
    cast_j = (lambda a: jnp.asarray(a, jnp.bfloat16)) if dtype == "bf16" else jnp.asarray
    cast_t = (lambda a: _t(a, torch.bfloat16)) if dtype == "bf16" else _t
    fj = [cast_j(a) for a in (q, k, v, kp, vp)] + [jnp.asarray(a) for a in (bt, cl, nv)]
    ft = [cast_t(a) for a in (q, k, v, kp, vp)] + [_t(a) for a in (bt, cl, nv)]
    positions = cl[:, None] + np.arange(s)[None, :]
    valid = np.arange(s)[None, :] < nv[:, None]
    mask = valid[:, :, None, None]

    # The kernel's plain version vs the JAX kernel (padded rows zero in both).
    jk = j_flash(*fj, interpret=True)
    got = t_ops.flash_prefill_paged(*ft)
    np.testing.assert_allclose(_np(got), _np(jk), **tol)
    assert t_ops.flash_prefill_paged.launches == 0
    # prefill_with_paged_context vs JAX's, with explicit positions / valid.
    jr = j_attn.prefill_with_paged_context(
        *fj[:7], positions=jnp.asarray(positions), valid=jnp.asarray(valid)
    )
    tr = t_ops.prefill_with_paged_context(
        *ft[:7], positions=_t(positions), valid=_t(valid)
    )
    np.testing.assert_allclose(_np(tr), _np(jr), **tol)
    np.testing.assert_allclose(_np(got) * mask, _np(jr) * mask, **tol)


class TestFlashPrefill:
    @pytest.mark.parametrize("n_q,n_kv", [(8, 2), (4, 4), (8, 1)], ids=["gqa", "mha", "mqa"])
    def test_head_geometries_with_context(self, n_q, n_kv):
        args = _prefill_setup(np.random.default_rng(0), 2, 24, n_q, n_kv, 16, 64, 4, [32, 17], [24, 24])
        _compare_prefill(args)

    def test_cold_prefill_right_padded(self):
        args = _prefill_setup(np.random.default_rng(1), 2, 32, 4, 2, 16, 16, 2, [0, 0], [32, 20])
        _compare_prefill(args)

    def test_zero_width_context_table(self):
        rng = np.random.default_rng(2)
        q, k, v, kp, vp, _, _, _ = _prefill_setup(rng, 2, 16, 4, 2, 16, 4, 1, [0, 0], [16, 16])
        args = (q, k, v, kp, vp, np.zeros((2, 0), np.int32), np.zeros(2, np.int32),
                np.asarray([16, 13], np.int32))
        _compare_prefill(args)

    def test_multi_block_and_fully_padded_row(self):
        args = _prefill_setup(np.random.default_rng(3), 3, 64, 4, 2, 16, 64, 6, [48, 5, 0], [64, 40, 0])
        _compare_prefill(args)

    def test_bfloat16(self):
        args = _prefill_setup(np.random.default_rng(4), 1, 16, 4, 2, 16, 16, 2, [9], [16])
        _compare_prefill(args, tol=BF16, dtype="bf16")
