"""The plain reference against the port at toy widths on the CPU, and the
control (the reference in float8) against the check's limit."""

import json
from types import SimpleNamespace

import pytest
import torch

from perfbench import check
from perfbench.spec import HERE, architecture
from perfbench.weights import Weights, draw_block

from helpers import TINY

CONFIGS = ("tiny_qwen3_moe", "tiny_qwen3", "tiny_qwen2")


def _arch_m(name):
    """The tiny configuration's architecture (the tests' own files first)
    and its record."""
    hf = json.loads((TINY / "configs" / f"{name}.json").read_text())["config"]
    mt = hf["model_type"]
    arch = architecture(mt, TINY if (TINY / "architectures" / f"{mt}.py").exists() else HERE)
    return arch, arch.dims(hf)


def _port_last_logits(arch, m, params, tokens):
    """The port's prefill over ``tokens`` (one row, cold): the logits of
    its last position."""
    from llm_d_kv_cache_manager_tpu_torch.models import llama

    cfg, ps, s = arch.engine_model(m), 16, len(tokens)
    k_pages, v_pages = llama.init_kv_pages(cfg, s // ps + 2, ps, "cpu")
    pos = torch.arange(s)[None]
    out = llama.prefill(params, cfg, torch.tensor([tokens]), pos, torch.ones(1, s, dtype=torch.bool),
                        k_pages, v_pages, pos // ps + 1, pos % ps,
                        torch.zeros(1, 0, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    return out[0][0].float()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port(name):
    (arch, m), seed = _arch_m(name), 2**31 + 77
    w = Weights(arch, m, seed, "cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, m.vocab, (45,), generator=gen).tolist()
    want = [20, 33, 44]
    ref = arch.forward(m, lambda b: draw_block(arch, m, seed, b, "cpu"), [tokens], [want], "cpu")[0]
    for i, p in enumerate(want):
        port = _port_last_logits(arch, m, w.params, tokens[: p + 1])
        torch.testing.assert_close(ref[i], port, rtol=1e-4, atol=1e-4)


def test_weights_redrawn_alone_equal_the_tree():
    (arch, m), seed = _arch_m("tiny_qwen3_moe"), 5
    w = Weights(arch, m, seed, "cpu")
    for b in range(m.layers + 1):
        blk = draw_block(arch, m, seed, b, "cpu")
        tree = w.params if b == 0 else w.params["layers"][b - 1]
        for name, t in blk.items():
            assert torch.equal(t, tree[name]), (b, name)
    old = w.params["layers"][0]["wq"].clone()
    w.refill(seed + 1)
    assert not torch.equal(old, w.params["layers"][0]["wq"])
    assert torch.equal(w.params["layers"][0]["wq"], draw_block(arch, m, seed + 1, 1, "cpu")["wq"])


def _greedy_requests(arch, m, seed, n_req=3, prompt=40, answer=30):
    """Requests whose served tokens are the reference's own greedy choice."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n_req):
        toks = torch.randint(0, m.vocab, (prompt,), generator=gen).tolist()
        for _ in range(answer):
            lg = arch.forward(m, lambda b: draw_block(arch, m, seed, b, "cpu"), [toks], [[len(toks) - 1]],
                              "cpu")
            toks.append(int(lg[0].argmax()))
        out.append(SimpleNamespace(prompt=toks[:prompt], answer_len=answer,
                                   seq=SimpleNamespace(generated_tokens=toks[prompt:])))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails_the_limit(name):
    """The tiny cells' limit (``logit_gap``) passes the reference's
    own tokens and fails the float8 control's."""
    (arch, m), seed = _arch_m(name), 11
    limit = json.loads((TINY / "workloads" / f"{name}.tiny_sessions.json").read_text())["check"]["logit_gap"]
    picked = _greedy_requests(arch, m, seed)
    assert check.served_gap(arch, m, seed, picked, "cpu")["logit_gap"] <= limit
    assert check.control_gap(arch, m, seed, picked, "cpu")["logit_gap"] > 3 * limit
