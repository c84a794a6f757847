"""Prefix-store interface (reference ``pkg/tokenization/prefixstore/indexer.go:39-48``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Sequence

#: (low, high) byte offsets of a token within the original prompt string.
Offset = tuple[int, int]


@dataclass
class Config:
    # Maximum number of blocks per model cache (reference lru_store.go:33).
    cache_size: int = 500_000
    # Prompt bytes per block (reference lru_store.go:31).
    block_size: int = 256
    # Trie-store node budget per model (ContainedTokenStore only; one node
    # per prompt character, so this is a character — not block — capacity).
    # ~1M nodes is a comparable memory footprint to the LRU defaults above.
    trie_max_nodes: int = 1_000_000


class Indexer(ABC):
    """Caches text-prefix → tokens so repeated shared prefixes skip the
    tokenizer."""

    @abstractmethod
    def add_tokenization(
        self,
        model_name: str,
        prompt: str,
        tokens: Sequence[int],
        offsets: Sequence[Offset],
    ) -> None:
        """Record the full tokenization of ``prompt``. ``offsets`` are byte
        offsets into the UTF-8 encoding of ``prompt``, parallel to
        ``tokens``."""

    @abstractmethod
    def find_longest_contained_tokens(
        self, prompt: str, model_name: str
    ) -> tuple[list[int], float]:
        """Return (tokens, covered-byte ratio) for the longest cached prefix
        of ``prompt``."""
