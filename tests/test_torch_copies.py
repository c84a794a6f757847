"""Drift test for the modules the PyTorch port copies from the JAX package.

The port imports nothing of ``llm_d_kv_cache_manager_tpu``, so it keeps its
own copies of the framework-free modules its main path needs. Each copy
must equal its original once import lines (and blank lines, which move
with them) are set aside, so a later fix to one side cannot silently
diverge from the other. The only other differences allowed are listed here
explicitly:

- the copies carry no development-history tags (a pull-request or issue
  label with its number) in their comments: ``_strip_history_tags`` takes
  them out of both sides the same way;
- a command line naming a module of the JAX package names the port's;
- the two native-library loaders resolve their library through the port's
  ``native.build`` (built from the port's own byte-equal C++ sources into
  ``build/native/``) instead of next to the loader (``ADAPTED``).
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
    # The scoring plane.
    "utils/lru.py",
    "native/hashcore.py",
    "native/lruindex.py",
    "kvcache/kvblock/index.py",
    "kvcache/kvblock/in_memory.py",
    "kvcache/kvblock/cost_aware.py",
    "kvcache/kvblock/instrumented.py",
    "kvcache/kvblock/native_memory.py",
    "kvcache/kvblock/redis_index.py",
    "kvcache/scorer.py",
    "kvcache/indexer.py",
    "kvcache/kvevents/health.py",
    "kvcache/kvevents/pool.py",
    "kvcache/kvevents/zmq_subscriber.py",
    "tokenization/tokenizer.py",
    "tokenization/pool.py",
    "tokenization/prefixstore/indexer.py",
    "tokenization/prefixstore/lru_store.py",
    "tokenization/prefixstore/trie_store.py",
    "preprocessing/chat_completions.py",
    "obs/tracing.py",
    "obs/audit.py",
    "kvcache/sharding.py",
    "kvcache/predictor.py",
    "obs/federation.py",
    "kvcache/controller/mrc.py",
    "server/api.py",
    # The fleet contract.
    "kvcache/router.py",
    # The fleet's control loops.
    "obs/slo.py",
    "obs/flight.py",
    "kvcache/controller/fleet.py",
    "kvcache/controller/inprocess.py",
    "kvcache/controller/__init__.py",
    "server/sampling.py",
    # The knob-gated fleet glue: roles, the remote tier, integrity, tenants.
    "kvcache/disagg/__init__.py",
    "kvcache/disagg/coordinator.py",
    "kvcache/transfer/remote_store.py",
    "kvcache/integrity.py",
    "server/qos.py",
]

#: Sources copied byte for byte.
BYTE_COPIES = ["native/hashcore.cpp", "native/lruindex.cpp"]

#: Original text the copy leaves out, per file (exact, in order).
OMITTED: dict[str, list[str]] = {}

#: Original text the copy replaces, per file: (original, copy), each exact.
ADAPTED = {
    "native/hashcore.py": [
        (
            "    return os.path.join(os.path.dirname(__file__), _LIB_NAME)\n",
            "    return build.built_library(_LIB_NAME)\n",
        ),
    ],
    "native/lruindex.py": [
        (
            "    path = os.path.join(os.path.dirname(__file__), _LIB_NAME)\n",
            "    path = build.built_library(_LIB_NAME)\n",
        ),
    ],
}

_TAG = r"\b(?:PR|ISSUE)[ -]\d+"
_NUM = r"(?:PR|ISSUE)[ -]\d+(?:[-/]\d+)*"

#: (pattern, replacement) in order: each turns one form of history tag in
#: the JAX package's prose into the port's wording.
_TAG_FORMS = [
    (rf"\({_NUM}[;,] ", "("),
    (rf"\s+\({_NUM}(?: \w+)?\)", ""),
    (rf", {_NUM}\)", ")"),
    (rf"Since {_NUM} the ", "The "),
    (rf"\ba pre-{_NUM}\b", "an older"),
    (rf"\bpre-{_NUM}\b", "earlier"),
    (rf"\bthe {_NUM} ", "the "),
    (rf"\bthe {_NUM}\n(\s*)", r"the\n\1"),
    (rf"\b{_NUM} ", ""),
    (r"\bPRs \d+-\d+ ", ""),
]


def _strip_history_tags(text: str) -> str:
    for pattern, repl in _TAG_FORMS:
        text = re.sub(pattern, repl, text)
    return text


def _port_wording(text: str) -> str:
    """The original as the port words it: no history tags, and commands
    that run a module of the JAX package run the port's."""
    return _strip_history_tags(text).replace(
        "python -m llm_d_kv_cache_manager_tpu.", "python -m llm_d_kv_cache_manager_tpu_torch."
    )


def _code_lines(text: str) -> list[str]:
    """Lines with import statements (incl. parenthesised continuations) and
    blank lines removed."""
    out, in_import = [], False
    for line in text.splitlines():
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


def _expected_copy(rel: str) -> str:
    original = (JAX_PKG / rel).read_text()
    for snippet in OMITTED.get(rel, []):
        assert original.count(snippet) == 1, f"omitted snippet no longer in {rel}: {snippet!r}"
        original = original.replace(snippet, "")
    for before, after in ADAPTED.get(rel, []):
        assert original.count(before) == 1, f"adapted line no longer in {rel}: {before!r}"
        original = original.replace(before, after)
    return _port_wording(original)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    copy = (PORT_PKG / rel).read_text()
    assert _code_lines(copy) == _code_lines(_expected_copy(rel))


@pytest.mark.parametrize("rel", BYTE_COPIES)
def test_native_source_is_byte_equal(rel):
    assert (PORT_PKG / rel).read_bytes() == (JAX_PKG / rel).read_bytes()


def test_nothing_omitted():
    """Every copy keeps all of its original's code."""
    assert OMITTED == {}
    assert set(ADAPTED) <= set(COPIES)


def test_import_filter_sees_moved_imports():
    """The filter drops function-local imports too (the copies make msgpack
    and zmq lazy), and keeps everything else."""
    text = "import a\nfrom b import (\n    c,\n)\ndef f():\n    import msgpack\n\n    return 1\n"
    assert _code_lines(text) == ["def f():", "    return 1"]


#: Each form of tag the normaliser knows, as (tagged, plain). ``P`` and
#: ``I`` stand for the pull-request and issue labels, so that this file
#: carries no tag itself.
TAG_CASES = [
    ("request tracing (P 5): mint", "request tracing: mint"),
    ("(KV_INTEGRITY, I 19) a block", "(KV_INTEGRITY) a block"),
    ("federation (I 20, ``OBS_FED``).", "federation (``OBS_FED``)."),
    ("OBS_METRICS (P 10 satellite): the", "OBS_METRICS: the"),
    ("lifecycle/MRC plane\n(P 14), tenant QoS", "lifecycle/MRC plane, tenant QoS"),
    ("try:  # P-11 symbol: exact", "try:  # symbol: exact"),
    ("None on a pre-P-11 library", "None on an older library"),
    ("the pre-I-20 shape", "the earlier shape"),
    ("Since I 14 the join also", "The join also"),
    ("matching the P 1-4 convention", "matching the convention"),
    ("rides the P 3/4/9\n    heartbeat", "rides the\n    heartbeat"),
    ("and P 3 resync rather", "and resync rather"),
]


@pytest.mark.parametrize("tagged, plain", TAG_CASES)
def test_history_tag_forms(tagged, plain):
    tagged = re.sub(r"\bP\b", "PR", re.sub(r"\bI\b", "ISSUE", tagged))
    assert re.search(_TAG, tagged)
    assert _strip_history_tags(tagged) == plain


def test_history_tags_fully_stripped():
    for rel in COPIES:
        original = (JAX_PKG / rel).read_text()
        assert not re.search(_TAG, _strip_history_tags(original)), rel
        assert not re.search(_TAG, (PORT_PKG / rel).read_text()), rel
