"""A benchmark tree with the tiny test cells added, built from new files
only (``tests/tiny/``), as a later change would add a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
PERFBENCH = HERE.parent
REPO = PERFBENCH.parent
TINY = HERE / "tiny"


def tiny_tree(tmp: Path, cells=("tiny_qwen3_moe.tiny_sessions", "tiny_qwen3.tiny_sessions")):
    """(root, benchmark): a copy of ``perfbench/`` under ``tmp`` with the
    tiny files dropped into its folders, and BENCHMARK.json's contents
    with the tiny cells appended to its workloads and metric lists."""
    root = tmp / "perfbench"
    shutil.copytree(PERFBENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for sub in ("architectures", "configs", "reference", "traffic", "workloads"):
        for f in (TINY / sub).iterdir():
            if f.is_file():
                shutil.copy(f, root / sub / f.name)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in cells:
        config, traffic = name.split(".")
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "tests"})
        for m in bench["per_layer"]:
            m["workloads"].append(name)
    return root, bench
