"""A whole run on the CPU at toy widths: the harness's look for a card
skipped, everything else as on the chip; a sound run is correct, and a run
whose timed path alters a token where it is produced is not."""

import io
import json
import time

import pytest

from perfbench import run as run_mod
from perfbench.bench import forbidden_modules
from perfbench.spec import load_cell

from helpers import tiny_tree

CELLS = ("tiny_qwen3_moe.tiny_sessions", "tiny_qwen3.tiny_sessions")


def _run(tmp_path, name, trace=False, seconds=2.0, seed=2**31 + 99):
    root, bench = tiny_tree(tmp_path)
    cell = load_cell(name, root=root, benchmark=bench)
    out, err = io.StringIO(), io.StringIO()
    rc = run_mod.run_cell(cell, seed, seconds, trace, "cpu", time.monotonic(), out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tmp_path, name):
    result, err = _run(tmp_path, name)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "ttft_p50_ms", "ttft_p95_ms", "tpot_p95_ms",
                                      "output_tok_per_s"}
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check failed_requests 0 limit 0")
    assert forbidden_modules() == []


def test_traced_run_reads_per_layer_metrics(tmp_path):
    result, _ = _run(tmp_path, CELLS[0], trace=True)
    assert result["correct"] is True
    # the CPU has no profiler slice: the device readers find nothing to read
    assert {"queue_wait_ms_p95", "prefix_hit_share", "decode_step_ms", "mfu.decode",
            "mfu.prefill"} <= set(result["metrics"])


def _alter_decoded_token(monkeypatch):
    from llm_d_kv_cache_manager_tpu_torch.models import llama

    orig = llama.decode_steps
    calls = {"n": 0}

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] % 3:
            return out
        toks = out[0].clone()
        toks[:, -1] = (toks[:, -1] + 1) % args[1].vocab_size
        return (toks,) + tuple(out[1:])

    monkeypatch.setattr(llama, "decode_steps", altered)


def _alter_first_token(monkeypatch):
    from llm_d_kv_cache_manager_tpu_torch.server.engine import Engine

    orig = Engine._sample

    def altered(self, logits, seqs):
        toks = orig(self, logits, seqs)
        return (toks + 1) % logits.shape[-1]

    monkeypatch.setattr(Engine, "_sample", altered)


@pytest.mark.parametrize("fault", [_alter_decoded_token, _alter_first_token])
def test_altered_token_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    result, err = _run(tmp_path, CELLS[0])
    assert result["correct"] is False, err
    assert result["checks"]["logit_gap"]["value"] > result["checks"]["logit_gap"]["limit"]
