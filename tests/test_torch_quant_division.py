"""The port's two int8 scale divisions against the JAX package's, on inputs
whose quotients by 127 a float32 reciprocal product misses.

CUDA divides a tensor by a Python scalar as a product with the scalar's
float32 reciprocal, which misses the true quotient by one ulp for about
one value in twenty, and an int8 code may then move by one. The port
divides by a 0-dim tensor instead. On the CPU torch divides exactly either
way, so each case runs twice: as it is, and with a Python-scalar divisor
turned into that reciprocal product (``_scalar_division_as_cuda``). Both
runs must give the JAX package's scales and codes bit for bit:

- ``quantize_tensor`` (int8 weights);
- ``_quantized_scatter_kv_all_layers`` (the int8 KV write).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu.models import quant as jq
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.models import quant as tq

PS = 4


def _missed_by_reciprocal(n, seed):
    """``n`` float32 magnitudes whose quotient by 127 differs from their
    product with the float32 reciprocal of 127."""
    a = np.random.default_rng(seed).uniform(1e-2, 4.0, 50 * n).astype(np.float32)
    recip = np.float32(1) / np.float32(127)
    a = a[a / np.float32(127) != a * recip][:n]
    assert len(a) == n
    return a


@pytest.fixture(params=["exact", "as_cuda"])
def division(request, monkeypatch):
    if request.param == "as_cuda":
        real = torch.Tensor.__truediv__

        def reciprocal_product(self, other):
            if isinstance(other, (int, float)) and self.dtype == torch.float32:
                return self * torch.tensor(np.float32(1) / np.float32(other))
            return real(self, other)

        monkeypatch.setattr(torch.Tensor, "__truediv__", reciprocal_product)
    return request.param


def test_reciprocal_product_misses_the_quotient():
    """The emulation does what the fixture claims, so the cases below
    would see a scalar divisor."""
    a = torch.from_numpy(_missed_by_reciprocal(8, seed=0))
    real = torch.Tensor.__truediv__
    recip = torch.tensor(np.float32(1) / np.float32(127))
    assert not torch.equal(real(a, 127.0), a * recip)


def test_quantize_tensor_equals_jax(division):
    amax = _missed_by_reciprocal(48, seed=1)
    rng = np.random.default_rng(2)
    w = (rng.uniform(-1, 1, (32, 48)) * amax).astype(np.float32)
    w[3] = amax  # each column's max, a value the reciprocal misses
    w[4] = -amax * np.float32(0.5)  # codes at exactly half a step: the tie rounds
    jqt = jq.quantize_tensor(jnp.asarray(w))
    tqt = tq.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    np.testing.assert_array_equal(tqt.scale.numpy()[0], amax / np.float32(127))
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))


def test_int8_kv_write_equals_jax(division):
    """A prefill write of two sequences into fresh pages: every token's
    per-head magnitude is one the reciprocal misses."""
    L, P, n_kv, hd, b, s = 2, 8, 2, 8, 2, 8
    rng = np.random.default_rng(3)
    mags = _missed_by_reciprocal(L * b * s * n_kv, seed=4).reshape(L, b, s, n_kv, 1)
    fresh = (rng.uniform(-1, 1, (L, b, s, n_kv, hd)) * mags).astype(np.float32)
    fresh[..., 0] = mags[..., 0]
    pages = np.zeros((L, P, PS, n_kv, hd), np.int8)
    scales = np.zeros((L, P, n_kv), np.float32)
    page_ids = np.asarray([[1] * 4 + [2] * 4, [5] * 4 + [6] * 4], np.int32)
    positions = np.tile(np.arange(s), (b, 1)).astype(np.int32)
    slot_ids = positions % PS
    valid = np.ones((b, s), bool)
    jp, js = jl._quantized_scatter_kv_all_layers(
        *map(jnp.asarray, (pages, scales, fresh, page_ids, slot_ids, valid, positions))
    )
    tp, ts = torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy())
    tl._quantized_scatter_kv_all_layers(
        tp, ts, *map(torch.from_numpy, (fresh, page_ids, slot_ids, valid, positions))
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
