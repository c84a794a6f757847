"""Cached HuggingFace tokenizer with byte-offset encode.

Parity with reference ``pkg/tokenization/tokenizer.go``: an LRU of loaded
tokenizers (default 20, ``tokenizer.go:31``), single-flight model loading
(``:86-107``), and ``encode`` returning token ids plus **byte** offsets into
the prompt's UTF-8 encoding (``:110-123`` — the prefix store depends on byte
offsets, see SURVEY §7 hard-part (e)).

Where the reference binds the Rust ``tokenizers`` crate through cgo, we use
the same Rust core through its Python binding (the ``tokenizers`` wheel,
already a dependency of ``transformers``). The binding returns *character*
offsets, so we convert to byte offsets here.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional, Sequence

from ..utils import get_logger
from ..utils.lru import LRUCache
from .prefixstore.indexer import Offset

log = get_logger("tokenization.tokenizer")

DEFAULT_TOKENIZER_CACHE_SIZE = 20


@dataclass
class HFTokenizerConfig:
    # Max loaded tokenizers kept in memory.
    tokenizers_cache_size: int = DEFAULT_TOKENIZER_CACHE_SIZE
    # HF hub auth token / cache dir, passed through to the loader.
    huggingface_token: Optional[str] = None
    tokenizers_cache_dir: Optional[str] = None


class Tokenizer(ABC):
    @abstractmethod
    def encode(self, prompt: str, model_name: str) -> tuple[list[int], list[Offset]]:
        """Return (token ids, byte offsets) for ``prompt``."""

    def decode(self, token_ids: Sequence[int], model_name: str) -> Optional[str]:
        """Detokenize, or None if this tokenizer cannot produce text (the
        serving path then returns token ids only)."""
        return None


def char_offsets_to_byte_offsets(prompt: str, offsets: Sequence[Offset]) -> list[Offset]:
    """Convert character-based (lo, hi) offsets into UTF-8 byte offsets.

    Builds a prefix-sum of per-character byte lengths once, then maps each
    offset pair — O(len(prompt) + len(offsets)).
    """
    byte_at = [0] * (len(prompt) + 1)
    total = 0
    for i, ch in enumerate(prompt):
        total += len(ch.encode("utf-8"))
        byte_at[i + 1] = total
    n = len(prompt)
    return [(byte_at[min(lo, n)], byte_at[min(hi, n)]) for lo, hi in offsets]


class CachedHFTokenizer(Tokenizer):
    """LRU-cached HF (Rust-core) tokenizers with single-flight loads."""

    def __init__(self, config: Optional[HFTokenizerConfig] = None):
        self.config = config or HFTokenizerConfig()
        self._cache: LRUCache[str, object] = LRUCache(self.config.tokenizers_cache_size)
        self._mu = threading.Lock()
        self._load_locks: dict[str, threading.Lock] = {}  # guarded_by: _mu

    def _load(self, model_name: str):
        from tokenizers import Tokenizer as HFTokenizer  # Rust core, lazy import

        kwargs = {}
        if self.config.huggingface_token:
            kwargs["auth_token"] = self.config.huggingface_token
        return HFTokenizer.from_pretrained(model_name, **kwargs)

    def _get_tokenizer(self, model_name: str):
        tok = self._cache.get(model_name)
        if tok is not None:
            return tok
        # single-flight: one loader per model, concurrent callers wait
        with self._mu:
            lock = self._load_locks.setdefault(model_name, threading.Lock())
        with lock:
            tok = self._cache.get(model_name)
            if tok is None:
                log.debug("loading tokenizer", model=model_name)
                tok = self._load(model_name)
                self._cache.put(model_name, tok)
        return tok

    def encode(self, prompt: str, model_name: str) -> tuple[list[int], list[Offset]]:
        tok = self._get_tokenizer(model_name)
        enc = tok.encode(prompt)
        return list(enc.ids), char_offsets_to_byte_offsets(prompt, enc.offsets)

    def decode(self, token_ids: Sequence[int], model_name: str) -> str:
        """Detokenize (the serving path's response text)."""
        tok = self._get_tokenizer(model_name)
        return tok.decode(list(token_ids), skip_special_tokens=True)
