"""The decode fast path's parity harness on the other model forms: the 15
scenarios of ``test_torch_engine.py`` with fused sampling and pipelined
4-step bursts (``decode_fused_sampling=True, decode_pipeline=True,
decode_steps_per_iter=4``) on TINY_QWEN3_MOE with int8 weights and int8
experts, and on TINY_LLAMA over int8 KV pages, the port's CPU engine
against the JAX engine (interpret mode) on the same parameters. Tokens,
finish reasons, ``tokens_computed``, free pages and KV-event bytes equal;
int8 pools hold equal codes and scales within rtol 1e-6 (see
``test_torch_engine.py``). TINY_LLAMA at four knob sets is in
``test_torch_decode_fastpath.py``.
"""

import pytest
import torch

from test_torch_decode_fastpath import KNOB_SETS, assert_fast_path_parity
from test_torch_engine import SCENARIOS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize(
    "model,name",
    [pytest.param(m, n, id=f"{m}-{n}") for m in ("tiny-qwen3-moe-int8", "tiny-llama-kvq")
     for n in SCENARIOS],
)
def test_fast_path_parity_models(model, name):
    assert_fast_path_parity(model, KNOB_SETS["fused_pipelined_k4"], name)
