"""The port's prefill ``attn_impl`` against the JAX package's, on the CPU,
in float32.

A ``valid`` mask with holes (a padding token inside a row) is honoured
token by token by ``attn_impl="xla"``, JAX's default path: the port's
``"xla"`` (and ``"auto"``, which is ``"xla"`` on CPU tensors) must match
it, logits atol = rtol = 1e-4 and pools 1e-5 (``test_torch_llama.py``'s
tolerances). The kernel path (``"pallas"``) sees a per-row count of valid
tokens only, so it is held on the right-padded mask, where its plain
version must give the very bits of ``"xla"``, and ``LLMD_CHECK_PREFILL_MASK``
must refuse a mask with holes on it. ``EngineConfig.prefill_attn`` takes
JAX's values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jl
from llm_d_kv_cache_manager_tpu_torch.models import convert as t_convert
from llm_d_kv_cache_manager_tpu_torch.models import llama as tl
from llm_d_kv_cache_manager_tpu_torch.server import BlockManagerConfig, Engine, EngineConfig
from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams

LOGITS = dict(atol=1e-4, rtol=1e-4)
POOL = dict(atol=1e-5, rtol=1e-5)
PS = 4
PAGES = 8
HOLED = [1, 1, 0, 1, 1, 1, 0, 0]
PREFIX = [1, 1, 1, 1, 1, 1, 0, 0]


@pytest.fixture(scope="module")
def tiny():
    jp = jl.init_params(jax.random.PRNGKey(3), jl.TINY_LLAMA)
    tp = t_convert.params_from_jax(jax.tree.map(np.asarray, jp), tl.TINY_LLAMA, "cpu")
    return jp, tp


def _inputs(mask):
    rng = np.random.default_rng(5)
    tok = rng.integers(0, tl.TINY_LLAMA.vocab_size, (1, 8)).astype(np.int32)
    pos = np.arange(8, dtype=np.int32)[None]
    valid = np.asarray([mask], bool)
    page_ids = (1 + pos // PS).astype(np.int32)
    slot_ids = (pos % PS).astype(np.int32)
    ctx_bt = np.zeros((1, 0), np.int32)
    ctx_lens = np.zeros((1,), np.int32)
    return tok, pos, valid, page_ids, slot_ids, ctx_bt, ctx_lens


def _torch_prefill(tp, mask, **kw):
    kp, vp = tl.init_kv_pages(tl.TINY_LLAMA, PAGES, PS, "cpu")
    args = [torch.from_numpy(a) for a in _inputs(mask)]
    logits, kp, vp = tl.prefill(tp, tl.TINY_LLAMA, *args[:3], kp, vp, *args[3:], **kw)
    return logits, kp, vp


def _jax_prefill(jp, mask):
    kp, vp = jl.init_kv_pages(jl.TINY_LLAMA, PAGES, PS)
    a = [jnp.asarray(x) for x in _inputs(mask)]
    return jl.prefill(jp, jl.TINY_LLAMA, *a[:3], kp, vp, *a[3:])  # default attn_impl="xla"


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("mask", [HOLED, PREFIX], ids=["holed", "prefix"])
def test_xla_matches_jax_default(tiny, impl, mask):
    jp, tp = tiny
    jlog, jk, jv = _jax_prefill(jp, mask)
    tlog, tk, tv = _torch_prefill(tp, mask, attn_impl=impl)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **POOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **POOL)


def test_kernel_path_miscomputes_holes_that_xla_honours(tiny):
    """Why the kernel path has a contract: on the holed mask it attends to
    the hole (it sees a count), so its logits leave JAX's."""
    jp, tp = tiny
    jlog = np.asarray(_jax_prefill(jp, HOLED)[0])
    tlog = _torch_prefill(tp, HOLED, attn_impl="pallas")[0].numpy()
    assert np.abs(tlog - jlog).max() > 1e-2


def test_prefix_mask_bit_equal_across_paths(tiny):
    _, tp = tiny
    a = _torch_prefill(tp, PREFIX, attn_impl="xla")
    b = _torch_prefill(tp, PREFIX, attn_impl="pallas")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_check_env_refuses_holes_on_kernel_path(tiny, monkeypatch):
    _, tp = tiny
    monkeypatch.setenv("LLMD_CHECK_PREFILL_MASK", "1")
    with pytest.raises(ValueError, match="right-padded prefix"):
        _torch_prefill(tp, HOLED, attn_impl="pallas")
    _torch_prefill(tp, PREFIX, attn_impl="pallas")  # the contract holds
    _torch_prefill(tp, HOLED, attn_impl="xla")  # no contract to check


def test_unknown_attn_impl_raises(tiny):
    with pytest.raises(ValueError, match="attn_impl"):
        _torch_prefill(tiny[1], PREFIX, attn_impl="flash")


def _engine(**kw):
    return Engine(EngineConfig(model=tl.TINY_LLAMA,
                               block_manager=BlockManagerConfig(total_pages=32, page_size=PS),
                               max_model_len=32, decode_batch_size=2, prefill_bucket=8, **kw),
                  device="cpu")


@pytest.mark.parametrize("value,resolved", [("auto", "xla"), ("xla", "xla"), ("pallas", "pallas")])
def test_engine_prefill_attn_values(value, resolved):
    eng = _engine(prefill_attn=value)
    assert eng.prefill_attn == resolved
    prompt = [int(t) for t in np.random.default_rng(1).integers(0, 256, 13)]
    seq = eng.add_request(prompt, SamplingParams(max_new_tokens=4))
    eng.run_until_complete()
    assert seq.error is None and len(seq.generated_tokens) == 4


def test_engine_unknown_prefill_attn_raises():
    with pytest.raises(ValueError, match="prefill_attn"):
        _engine(prefill_attn="flash")


def test_engine_kernel_path_on_int8_pages_serves_as_xla():
    """On int8 pages the kernel path reads the context widened first, so
    ``"pallas"`` with ``kv_quant_hbm`` is served (JAX refuses it: its
    kernel would read the int8 codes full-width) and gives the plain
    path's tokens."""
    prompt = [int(t) for t in np.random.default_rng(2).integers(0, 256, 21)]
    out = {}
    for impl in ("xla", "pallas"):
        eng = _engine(prefill_attn=impl, kv_quant_hbm="int8")
        seqs = [eng.add_request(prompt, SamplingParams(max_new_tokens=5)) for _ in range(2)]
        eng.run_until_complete()
        out[impl] = [s.generated_tokens for s in seqs]
    assert out["xla"] == out["pallas"]


def test_engine_int8_pages_refuse_sp():
    with pytest.raises(ValueError, match="sp > 1"):
        _engine(kv_quant_hbm="int8", sp=2)
