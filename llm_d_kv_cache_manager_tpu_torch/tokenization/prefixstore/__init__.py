"""Text-prefix → token cache, skipping re-tokenization of shared prefixes.

Parity with reference ``pkg/tokenization/prefixstore``.
"""

from .indexer import Indexer, Config
from .lru_store import LRUTokenStore
from .trie_store import ContainedTokenStore

__all__ = ["Indexer", "Config", "LRUTokenStore", "ContainedTokenStore"]
