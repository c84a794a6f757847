"""BENCHMARK.json against the benchmark's rules, and cells found by name:
a cell, configuration, mix and metric added as new files alone."""

import json
import re
import time
import io

import pytest

from perfbench import check
from perfbench import run as run_mod
from perfbench.spec import HERE, load_cell, metric, traffic_kind

from helpers import REPO, TINY, tiny_tree

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell to
    # compile and 1200 spare, within 43,200 s with the full 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43_200
    assert cells <= 24 and len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert json.loads((REPO / c["file"]).read_text())["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    assert "setup_s" in names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda e: e["name"])
def test_each_metric_has_its_reader(entry):
    mod = metric(entry["name"])
    assert mod.UNIT == entry["unit"]
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
    if entry["name"].endswith("_roofline"):
        assert mod.KERNELS and callable(mod.work) and entry["unit"] == "%"


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_each_cell_found_by_name(entry):
    cell = load_cell(entry["name"])
    assert cell.rate > 0 and cell.check
    assert set(cell.check) <= set(check.NUMBERS) and min(cell.check.values()) > 0
    assert traffic_kind(cell.mix["kind"]).build
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_cell_added_from_new_files_only(tmp_path):
    """A copy of the tree plus new files (a configuration, a mix, a cell and
    a metric) runs the new cell and reads the new metric, with no file of
    the tree edited."""
    root, bench = tiny_tree(tmp_path, cells=("tiny_qwen3.tiny_sessions",))
    (root / "metrics" / "prompt_tokens_mean.py").write_text(
        "LAYER = 'pod server'\nUNIT = 'tokens'\nMOVES = 'ttft_p50_ms'\n\n"
        "def read(run):\n    s = run.sample\n    return sum(len(r.prompt) for r in s) / len(s)\n")
    bench["per_layer"].append({"name": "prompt_tokens_mean", "unit": "tokens", "better": "lower",
                               "source": "program_counter", "layer": "pod server",
                               "moves": "ttft_p50_ms", "workloads": ["tiny_qwen3.tiny_sessions"]})
    before = {p.name: p.read_bytes() for p in HERE.rglob("*.py") if "tests" not in p.parts}
    cell = load_cell("tiny_qwen3.tiny_sessions", root=root, benchmark=bench)
    out, err = io.StringIO(), io.StringIO()
    assert run_mod.run_cell(cell, 123, 2.0, True, "cpu", time.monotonic(), out=out, err=err) == 0
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"] is True and result["metrics"]["prompt_tokens_mean"]["value"] > 0
    assert before == {p.name: p.read_bytes() for p in HERE.rglob("*.py") if "tests" not in p.parts}


def test_architecture_added_from_new_files_only(tmp_path):
    """A copy of the tree plus a new architecture as new files only (a
    Qwen2-type model: q, k, v biases, no qk-norm; its architecture, its
    plain reference, a configuration and a cell) runs the new cell
    ``correct`` on the CPU, with no file of the tree edited."""
    root, bench = tiny_tree(tmp_path, cells=("tiny_qwen2.tiny_sessions",))
    new = {"architectures/qwen2.py", "reference/qwen2.py", "configs/tiny_qwen2.json",
           "workloads/tiny_qwen2.tiny_sessions.json"}
    added = set()
    for p in root.rglob("*"):
        rel = p.relative_to(root)
        if not p.is_file() or "__pycache__" in rel.parts:
            continue
        if (HERE / rel).exists():
            assert p.read_bytes() == (HERE / rel).read_bytes(), rel
        else:
            added.add(rel.as_posix())
    assert new <= added and all((TINY / a).is_file() for a in added)
    before = {p: p.read_bytes() for p in HERE.rglob("*.py") if "tests" not in p.parts}
    cell = load_cell("tiny_qwen2.tiny_sessions", root=root, benchmark=bench)
    out, err = io.StringIO(), io.StringIO()
    assert run_mod.run_cell(cell, 2**31 + 5, 2.0, True, "cpu", time.monotonic(), out=out, err=err) == 0
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"] is True, err.getvalue()
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["checks"]["logit_gap"]["value"] <= result["checks"]["logit_gap"]["limit"]
    assert {"mfu.decode", "mfu.prefill", "prefix_hit_share"} <= set(result["metrics"])
    assert before == {p: p.read_bytes() for p in HERE.rglob("*.py") if "tests" not in p.parts}
