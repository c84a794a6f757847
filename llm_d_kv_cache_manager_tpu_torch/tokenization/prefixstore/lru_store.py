"""Default prefix store: chained-xxhash64 byte blocks with LRU eviction.

Parity with reference ``pkg/tokenization/prefixstore/lru_store.go``:

- the prompt's UTF-8 bytes are chunked into ``block_size`` (256) byte blocks,
  no partial blocks;
- block key = xxhash64 over (previous block hash as 8 little-endian bytes ++
  block bytes), chained from 0 (``lru_store.go:116-132``);
- a block stores the tokens whose ``[, high]`` byte offset falls within the
  block's end (``:138-146``) — i.e. tokens fully determined by the prompt up
  to that byte;
- lookup walks the chain until the first miss and reports the covered-byte
  ratio (``:160-205``).
"""

from __future__ import annotations

import struct
import threading
from typing import Optional, Sequence

import xxhash

from ...utils.lru import LRUCache
from .indexer import Config, Indexer, Offset


class LRUTokenStore(Indexer):
    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config()
        if self.config.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self._mu = threading.Lock()
        self._stores: dict[str, LRUCache[int, list[int]]] = {}  # guarded_by: _mu

    def _model_cache(self, model_name: str, create: bool) -> Optional[LRUCache]:
        with self._mu:
            cache = self._stores.get(model_name)
            if cache is None and create:
                cache = LRUCache(self.config.cache_size)
                self._stores[model_name] = cache
            return cache

    @staticmethod
    def _chain_hash(prev: int, chunk: bytes) -> int:
        h = xxhash.xxh64()
        h.update(struct.pack("<Q", prev))
        h.update(chunk)
        return h.intdigest()

    def add_tokenization(
        self,
        model_name: str,
        prompt: str,
        tokens: Sequence[int],
        offsets: Sequence[Offset],
    ) -> None:
        if not prompt or not tokens:
            return
        if len(tokens) != len(offsets):
            raise ValueError("tokens and offsets must be parallel")

        cache = self._model_cache(model_name, create=True)
        prompt_bytes = prompt.encode("utf-8")
        bs = self.config.block_size

        token_idx = 0
        prev_hash = 0
        for start in range(0, len(prompt_bytes) - bs + 1, bs):
            end = start + bs
            block_hash = self._chain_hash(prev_hash, prompt_bytes[start:end])
            prev_hash = block_hash

            block_tokens: list[int] = []
            while token_idx < len(tokens) and offsets[token_idx][1] <= end:
                block_tokens.append(int(tokens[token_idx]))
                token_idx += 1
            cache.put(block_hash, block_tokens)

    def find_longest_contained_tokens(
        self, prompt: str, model_name: str
    ) -> tuple[list[int], float]:
        cache = self._model_cache(model_name, create=False)
        if cache is None:
            return [], 0.0

        contained: list[int] = []
        prompt_bytes = prompt.encode("utf-8")
        bs = self.config.block_size
        prev_hash = 0
        overlap_ratio = 0.0
        for start in range(0, len(prompt_bytes) - bs + 1, bs):
            end = start + bs
            block_hash = self._chain_hash(prev_hash, prompt_bytes[start:end])
            prev_hash = block_hash
            block = cache.get(block_hash)
            if block is None:
                break  # early-stop at first miss
            contained.extend(block)
            overlap_ratio = end / len(prompt_bytes)
        return contained, overlap_ratio
