"""Drift test for the modules the PyTorch port copies from the JAX package.

The port imports nothing of ``llm_d_kv_cache_manager_tpu``, so it keeps its
own copies of the framework-free modules its main path needs. Each copy
must equal its original once import lines (and blank lines, which move
with them) are set aside, so a later fix to one side cannot silently
diverge from the other. The only other differences allowed are listed here
explicitly: the copies carry no development-history tags (a parenthesised
pull-request or issue label with its number) in their comments, and the
copy of ``token_processor.py``
leaves out the optional native ``hashcore`` branch (the port hashes with
hashlib only).
"""

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "llm_d_kv_cache_manager_tpu"
PORT_PKG = ROOT / "llm_d_kv_cache_manager_tpu_torch"

COPIES = [
    "utils/logging.py",
    "kvcache/kvblock/cbor.py",
    "kvcache/kvblock/keys.py",
    "kvcache/kvblock/token_processor.py",
    "kvcache/kvevents/events.py",
    "kvcache/kvevents/publisher.py",
    "server/sequence.py",
    "server/block_manager.py",
    "server/scheduler.py",
    "kvcache/transfer/protocol.py",
    "kvcache/transfer/client.py",
    "kvcache/transfer/service.py",
    "kvcache/transfer/cost_model.py",
    "kvcache/metrics/collector.py",
    "obs/lifecycle.py",
]

#: Original text the copy leaves out, per file (exact, in order).
OMITTED = {
    "kvcache/kvblock/token_processor.py": [
        "The hot loop optionally dispatches to the C++ native kernel\n"
        "(``native/hashcore.cpp``) via ``native.hashcore``; the pure-Python path here\n"
        "is the audited fallback and the parity oracle for tests.\n",
        "    # Use the C++ native kernel when available.\n"
        "    use_native: bool = True\n",
        "        self._native = None\n"
        "        if self.config.use_native:\n"
        "            try:\n"
        "                from ...native import hashcore\n"
        "\n"
        "                if hashcore.available():\n"
        "                    self._native = hashcore\n"
        "            except Exception:\n"
        "                self._native = None\n",
        "        if self._native is not None:\n"
        "            return self._native.chain_hashes(\n"
        "                self._init_hash, tokens, self.config.block_size\n"
        "            )\n",
    ],
}


_TAG = r"\b(?:PR|ISSUE) \d+"


def _strip_history_tags(text: str) -> str:
    text = re.sub(r"\((?:PR|ISSUE) \d+; ", "(", text)
    text = re.sub(r" \((?:PR|ISSUE) \d+\)", "", text)
    return re.sub(r", (?:PR|ISSUE) \d+\)", ")", text)


def _code_lines(text: str) -> list[str]:
    """Lines with import statements (incl. parenthesised continuations) and
    blank lines removed, history tags stripped."""
    out, in_import = [], False
    for line in _strip_history_tags(text).splitlines():
        s = line.strip()
        if in_import:
            in_import = not s.endswith(")")
            continue
        if s.startswith("import ") or (s.startswith("from ") and " import " in s):
            in_import = s.endswith("(")
            continue
        if s:
            out.append(line)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    original = (JAX_PKG / rel).read_text()
    for snippet in OMITTED.get(rel, []):
        assert original.count(snippet) == 1, f"omitted snippet no longer in {rel}: {snippet!r}"
        original = original.replace(snippet, "")
    copy = (PORT_PKG / rel).read_text()
    assert _code_lines(copy) == _code_lines(original)


def test_import_filter_sees_moved_imports():
    """The filter drops function-local imports too (the copies make msgpack
    and zmq lazy), and keeps everything else."""
    text = "import a\nfrom b import (\n    c,\n)\ndef f():\n    import msgpack\n\n    return 1\n"
    assert _code_lines(text) == ["def f():", "    return 1"]


def test_history_tags_fully_stripped():
    original = (JAX_PKG / "kvcache/kvevents/events.py").read_text()
    assert re.search(_TAG, original)
    assert not re.search(_TAG, _strip_history_tags(original))
    for rel in COPIES:
        assert not re.search(_TAG, (PORT_PKG / rel).read_text()), rel
