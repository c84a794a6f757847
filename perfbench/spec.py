"""Finds everything a cell needs by name.

``BENCHMARK.json`` at the repository root lists the cells and metrics. A
cell ``<name>`` is ``workloads/<name>.json`` here (its configuration, mix,
rate and the limit of its check); its configuration is
``configs/<config>.json``; its mix is ``traffic/<traffic>.json``, whose
``kind`` names the generator ``traffic_kinds/<kind>.py``; the
configuration's ``model_type`` names its architecture
``architectures/<model_type>.py``; each metric is read by
``metrics/<metric>.py``. A new cell, configuration, architecture, mix,
kind or metric is a new file and an entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    rate: float
    profile_s: float
    check: dict  # the check's numbers (``check.py``) and each one's limit
    check_tokens: int  # served tokens the check's sample aims for
    config: dict  # the configuration file
    mix: dict  # the traffic mix file
    end_to_end: list[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: list[dict]
    root: Path

    @property
    def hf(self) -> dict:
        return self.config["config"]

    @property
    def pod(self) -> dict:
        return self.config["pod"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = HERE, benchmark: Optional[dict] = None) -> Cell:
    """The cell ``name`` as ``root`` (this directory by default) and
    ``benchmark`` (``root``'s parent's ``BENCHMARK.json`` by default)
    define it."""
    bench = benchmark if benchmark is not None else _json(root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = _json(root / "workloads" / f"{name}.json")
    if (w["config"], w["traffic"], w["chips"]) != (entry["config"], entry["traffic"], entry["chips"]):
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json's entry")
    return Cell(
        name=name,
        chips=w["chips"],
        rate=float(w["rate"]),
        profile_s=float(w["profile_s"]),
        check=w["check"],
        check_tokens=w["check_tokens"],
        config=_json(root / "configs" / f"{w['config']}.json"),
        mix=_json(root / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` (its name may hold dots, as a metric's
    does) as a module of its own, entered in ``sys.modules`` (a dataclass
    in it looks its module up there)."""
    modname = "perfbench_" + re.sub(r"\W", "_", str(path.relative_to(path.parent.parent)))
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: Path = HERE) -> ModuleType:
    return load_module(root / "metrics" / f"{name}.py")


def traffic_kind(kind: str, root: Path = HERE) -> ModuleType:
    return load_module(root / "traffic_kinds" / f"{kind}.py")


def architecture(model_type: str, root: Path = HERE) -> ModuleType:
    return load_module(root / "architectures" / f"{model_type}.py")
